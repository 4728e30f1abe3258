// K4 at head dim 192 (nemotron-4-340b): prefill_attention.cu with only
// that head dim instantiated, a library of its own, so that its widest
// tensor-core tiles (24 n-tiles a warp) compile beside the other head
// dims instead of after them. prefill_attention.py loads it for Dh 192.
#define PREFILL_WIDE 1
#include "prefill_attention.cu"
