#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device — the card, its power limit, the toolchain; every kernel
   built from ``src/repro_torch/kernels/csrc`` with nvcc, one process
   per source, all started together; per library the ptxas registers
   of each instantiation and its SASS count of tensor-core MMAs,
   cp.async (LDGSTS), ldmatrix, 128-bit global loads and int -> float
   conversions;
2. kernels — each kernel against its plain PyTorch version at the
   paths' shapes, in bf16 and float32, with its time per call (CUDA
   events, host launch cost included), its device time per call
   (``torch.profiler``), the plain version's time, one PyTorch library
   call's where one computes the same function (both times), and the
   bound the card's roofline allows for the work the kernel's
   ``cost()`` counts at the case's real lengths; for every kernel also
   both times
   cold in L2, kernel and library, round-robin over copies of its
   operands that exceed the L2; K5 with the residual add fused
   (``add_rmsnorm``) at the decode, prefill and W4 rows, its ``s``
   bitwise torch's ``x + a`` and its ``h`` bitwise the kernel without
   the add on ``s``, beside the lone ``x + a`` (the launch floor); the
   paged decode (K2) must also be
   bitwise equal to the contiguous one (K1) on the same rows, and the
   prefill over a cache (K4) to its second run and to a run over a
   block-table gather of the same rows from a larger pool; the int4
   GEMV (K6) at phi3-mini's projection shapes, K1 / K2 / K3 / K4 at its
   head dim 96, K1 / K2 also at the W4 step's one-row call; K1 / K2 /
   K3 / K4 at phase 7's head dim 128 (GQA 48/8 and MHA 16/16), K3 also
   after the vlm's 256-row image prefix; phase 8's shapes: K1 over the
   rolling 4096-slot cache (GQA 32/8 at Dh 128 and Dh 80, lengths on both
   sides of the window), K1 as whisper's cross-attention decode (1500
   rows, 20 heads of 64, no self partial), K3 at Dh 80 over 6000 tokens
   with the 4096 window, and non-causal over whisper's 1500 encoder
   positions (self, and cross from a 256-token bucket); phase 9's
   shapes: K1 and K3 at zamba2-2.7b's shared block, MHA 32 x Dh 80 (K1
   over 8 ragged slots at capacity 2048 with the self partial, K3
   causal over a 1024-token bucket), K5 at its gated norm's (8, 5120)
   without the add and its layer norm's (8, 2560) with it; phase 16's
   shapes (nemotron-4-340b: head dim 192, GQA 96/8, G 12): K1 and K2
   over 8 slots at capacity 2048, K4's verify window and 256-token
   chunk, K3 over 512 tokens (hot times only);
3. engine, float32 gate — full-width qwen1.5-0.5b, 12 of its 24 layers
   (``QWEN_F32_LAYERS``, as in phases 6, 10a and 13a; random weights from a
   seed) served greedily by ``ServingEngine``: contiguous + blocking
   must equal the port's own batch-1 prefill + decode_step loop, and
   paged + blocking, chunked and speculative on both backends must
   equal contiguous + blocking;
4. engine, bf16 runs — 16 seeded requests through 8 slots on contiguous
   + blocking, paged + chunked and paged + speculative: tok/s, TTFT,
   inter-token latency, resident KV, chunk dispatches, acceptance; the
   first prefill's and the first chunked prefill's logits held against
   runs through the plain versions;
5. W4A16 mobile decode — full-width phi3-mini-3.8b in bf16, every
   projection int4 at group 128: a 512-token prefill, then 16
   teacher-forced W16 ``decode_step``s beside ``w4_decode_step``s
   (``examples/torch_w4_mobile_decode.py``): per-step fidelity and wall
   ms, the prefill's and every W4 step's logits held against runs
   through the plain versions;
6. request surface — full-width qwen1.5-0.5b again (12 layers in
   float32, 8 in bf16), float32 for the
   stream gates: the overload trace replayed under FIFO and SLO on
   both backends (SLO streams == FIFO streams, >= 1 preemption, chat
   p99 TTFT <= 0.04 virtual s under SLO and > 0.04 under FIFO, tokens
   per step >= 0.95x FIFO's); prefix caching on against off for 8
   requests on a 512-token preamble, blocking and chunked, and the
   sharedprefix trace (equal streams, hit tokens equal to the host's
   block-aligned matches); the four fixed preemption plans with the
   prefix index on; telemetry on against off (equal tokens, a valid
   trace, every dispatch joined); then bf16: an export -> import round
   trip (``torch.equal`` rows), seeded temperature sampling (same seed,
   same stream, also under preemption; another seed, another stream)
   and the device time of a cold against a warm admission. Every pool
   must balance after its drain;
7. families — the MoE and vlm families at full width, random weights
   from the seed, one model at a time: (a) float32, 4 layers deep,
   deepseek-moe-16b (its dense layer 0 and 3 MoE layers) and
   internvl2-26b through phase 3's gates, deepseek at capacity factor
   E / k, where no dispatch can drop a routed slot; then deepseek at
   its config's 1.25 on the same six configurations, the dropped slots
   per dispatch kind printed, only paged == contiguous gated; (b) bf16
   (deepseek 8 layers, internvl2 12; ``BF16_LAYERS``), both models: the
   first prefill's logits, whole and
   chunked, against the plain versions (an MoE's plain run replays the
   kernel run's experts; the tokens its own routing would move may be
   at most twice those that one-ulp noise at every MoE input moves in
   the plain path), phase 4's three serving runs, and one decode
   step of 8 live slots traced by ``torch.profiler``; (c) dbrx-132b,
   2 layers, LayerNorm: a 512-token prefill and 8 decode steps with
   exact launches (no K5) and every step's logits against the plain
   versions, its routing flips held as in (b). Each model's step ends the process past 420 s;
8. window — the rolling sliding window and whisper at full width,
   random weights from the seed, one model at a time (h2o-danube-1.8b,
   mistral-7b, whisper-large-v3): (a) float32, 4 layers deep (whisper 4
   + 4), 4 requests of 16 new tokens over a capacity of 8192 (SWA
   prompts of 600, 4090, 4500 and 6000 tokens at the 4096 window: two
   roll in prefill, one fills the window while it decodes; whisper's of
   17–200): contiguous + blocking equal to the batch-1 loop, the
   requested paged, chunked and speculative runs each warning as the
   reference does and giving the same streams, the overload trace under
   FIFO and SLO (>= 1 preemption, equal streams), export -> import of
   every live slot ``torch.equal`` (past the window; with the cross
   K/V); (b) bf16 at full depth (mistral at 8 layers): the first
   prefill's logits and a
   rolling one's with 8 decode steps past the window (whisper: a
   200-token prompt over seeded frames) against the plain versions, 8
   requests of 64 new tokens on contiguous + blocking, and one decode
   step of 8 live slots traced by ``torch.profiler``;
9. recurrent — zamba2-2.7b (Mamba2 and the shared attention block) and
   xlstm-350m (mLSTM / sLSTM) at full width, random weights from the
   seed, one model at a time: (a) float32, zamba2 12 layers deep (2
   groups of 6, two shared-block applications), xlstm 8 layers deep (one
   super-block), 4
   requests of 17, 300, 700 and 1000 tokens, 16 new each, over 8 slots
   at capacity 2048: contiguous + blocking equal to the batch-1 loop;
   admission bucketed from 16 against exact-length, the same streams and
   every leaf each admission splices ``torch.equal``; the requested
   paged, chunked and speculative runs each warning as the reference
   does and giving the same streams; the overload trace under FIFO and
   SLO (>= 1 preemption, equal streams); export -> import of every live
   slot ``torch.equal`` leaf by leaf; (b) bf16 (zamba2 at 18 layers,
   xlstm at 8): the first
   prefill and 8 decode steps, every K1 / K3 / K5 call held to its
   plain version on its own inputs and the logits to the plain
   versions' within the larger of 3e-2 and twice what one-ulp noise at
   the plain path's kernel outputs moves them, 8
   requests of 256–1023 tokens (64 new each) on contiguous + blocking,
   one decode step of 8 live slots and one 1024-token prefill traced by
   ``torch.profiler``. Each model's step ends the process past 420 s;
10. cluster — the disaggregated prefill/decode cluster
   (``serving/cluster.py``) with every worker on the one card (the
   round-robin warning asserted; the weights held once, the cluster's
   allocation no more than its workers' caches): (a) float32, qwen1.5-
   0.5b at phase 3's width and depth on phase 3's traffic through 1 prefill
   + 2 decode workers on both backends, decode worker 0 killed after
   step 2, and through 1 + 3 with a drain and then a kill (two hops),
   its streams equal to phase 3's; deepseek-moe-16b (4 layers, capacity
   factor E / k) and internvl2-26b (4 layers; its packets carry the 256
   image positions) on the paged cache with a kill, zamba2-2.7b (12
   layers), xlstm-350m, whisper-large-v3 (4 + 4) and h2o-danube-1.8b (4
   layers; its 4500-token slot migrates rolled) requesting it, warned
   onto the contiguous fallback, with a drain — each against its own
   single blocking engine; every run's ``kv_transfer_bytes`` equal to
   its packets' bytes, one decode dispatch per worker step, every pool
   balanced; (b) bf16 qwen at 8 layers: phase 4's traffic through
   1 + 2 paged workers against the single paged engine (equal streams;
   each handoff's bytes, export and import ms and GB/s; TTFT, ITL and
   tok/s side by side; a decode worker's step against the single
   engine's by device time), phase 6's shared-preamble requests through
   2 + 2 workers with prefix caching (routed by affinity, equal to the
   single engine with prefix caching), the mixshift trace autoscaling
   both ways (equal to the single engine's replay), the overload trace
   SLO-aware against FIFO (equal streams) and a short trace replayed
   twice with auto-drain under the virtual clock (identical schedules,
   no drain). Each step ends the process past 420 s;
11. cost model — (a) every family the port serves, at its phase's
   config, priced at full width on meta tensors (nothing
   allocated; ``repro_torch.core.costmodel``): a 1024-position
   prefill, the ragged decode of 8 rows at 2048 positions on both
   backends, a 256-token chunk over a 2048-position history and the
   gamma-4 verify where the family has them — FLOPs, bytes, weight
   bytes and KV bytes per position printed; no "other" op above 4096
   B, no kernel priced at zero FLOPs, the decode's weight bytes equal
   to the params leaves it reads and its KV bytes per position 8 x
   ``kv_bytes_per_token`` (plus the block tables on the paged cache);
   (b) ``audit_engine`` / ``assert_no_drift`` over the dispatch logs of
   the engines of phases 3, 4 and 6 (blocking, chunked and speculative
   on both backends, SLO, prefix caching): every dispatch priced, one
   target dispatch a step; (c) phase 4's traffic on bf16 qwen, paged +
   chunked 256, with telemetry on: ``dispatch_calibration`` against one
   card (``DGX_H100`` / 8: 989.5 TFLOP/s, 3350 GB/s), every kind's
   measured / predicted finite and >= 0.95; then one decode step of 8
   live slots traced by ``torch.profiler``, no kernel's device time
   under 1 / 1.05 of the bound of its ``cost()`` at the step's lengths;
12. simulator — host work only (``repro_torch.core.simulator`` traces on
   meta tensors): (a) ``LLMSimulator.serve(trace=)`` over the replays
   phases 6 and 10 ran on the card (the overload trace on both backends
   under FIFO and SLO, the sharedprefix trace with prefix caching on
   and off, the mixshift cluster autoscaling) with their engine
   settings: admission order, preemption log, steps, decode steps,
   every request's virtual TTFT and token count, prefix hits, hit
   tokens and evictions, and the cluster's rescale log, handoffs,
   migrations and transferred KV bytes (the packets' too) equal to the
   card's; (b) the paper's scenarios (``run_cloud`` for llama2-70b and
   mixtral-8x22b, GQA and MHA; ``run_mobile`` for llama2-7b and
   mistral-7b; the 1000 / 1000 runs) within every band of the
   reference's paper-claims test, each ratio printed; (c) printed, no
   gate: the simulator on one card of ``DGX_H100`` against 11c's
   profiled decode step (whole device time) and phase 4's contiguous +
   blocking TTFT p50 and ITL p50.
13. mesh — ``EngineConfig.mesh`` with every shard on the one card
   (``devices=("cuda:0",) * n``: the same sharded code and kernels as
   across cards, a gather a local copy): K1 split by position over the
   (1, 3) fallback's shards at its shapes, bitwise K1 over the whole
   cache and within phase 2's tolerance of the plain version, and K4's
   partials over the same shards merged in rank order (a verify window
   and a chunk: every shard the same bits, within tolerance of the
   plain version over the whole history); (a)
   float32 qwen at phase 3's width and depth on its traffic at (2, 2)
   — contiguous and paged blocking and paged chunked 256 — equal to
   phase 3's streams, and the sequence-sharded fallback (16 KV heads
   over model 3, capacity 1152) equal to one engine of that capacity;
   (b) float32 deepseek-moe-16b, 4 layers at capacity factor E / k, at
   (1, 2) (32 experts a rank), equal to phase 7a's streams; (c) bf16
   qwen at 8 layers at (1, 4) on phase 4's traffic (TTFT, ITL), then
   the first prompt's prefill and 8 greedy steps through the mesh with
   every K1 / K3 / K5 call of every shard held to its plain version on
   its own inputs (as 9b), each step's logits held to one device's on
   the same tokens (3e-2, argmax equal or a tie); (d) float32
   whisper-large-v3 (4 + 4 layers), zamba2-2.7b (12) and xlstm-350m (8)
   at (1, 2) on 8a's and 9a's traffic, equal to those phases' one-device
   streams, each mesh engine's dispatch audit clean — Mamba2 and the
   mLSTM split by heads over model (rank 0 holds half the columns and
   half the state's heads); (e) float32 deepseek-moe-16b, 4 layers at
   capacity factor 1.25, at (2, 1), speculative on the paged cache:
   the streams and every dispatch's dropped slots equal to the
   one-device engine's, some dispatch dropping. Every run's
   launches are exactly the mesh path's (a prefill or chunk on one data
   replica's model ranks, a decode on every rank), one target dispatch
   a step, the KV partitioned (but xlstm's, which has none).
14. train — single-device training, in a process of its own (cuBLAS's
   deterministic workspace set before CUDA starts): (a) K5's backward
   K5b in phase 2's table at qwen's training rows (8192 x 1024, with and
   without the add) and zamba2's widths (2560, 5120), bitwise against
   its own second run; (b) float32 qwen at full width and depth, B 2 x
   S 2048, remat full: one ``loss_fn`` and backward through K5 / K5b
   against the plain path (loss within 1e-5, every gradient leaf
   normwise within 1e-4 of its norm plus 1e-6 of the whole gradient's,
   97 K5 and 49 K5b launches), then microbatch 2 against 1; (c) bf16
   qwen at B 4 x S 2048 through ``launch.train``: 20 steps checkpointed
   every 10, then the same run failing at step 13 under
   ``RestartPolicy``, its final state bitwise the first's under
   ``torch.use_deterministic_algorithms``; step wall, device ms, idle
   share, tokens/s, peak allocation, a profiled step's top kernels;
   ``launch.serve --ckpt-dir`` from that checkpoint; every other
   family's smoke config one float32 step against the plain path; (d)
   ``examples/torch_train_100m.py --full-100m``, 100 steps, the last 5
   losses' mean at least 0.3 below the first 5's.

15. mesh_train — training over a mesh on the one card, in phase 14's
   process: a CUDA training mesh takes one device per rank, so (1, 1)
   and (1, 1, 1) meshes on ``cuda:0``; one float32 step of the
   smoke-depth zamba2, xlstm and whisper bitwise the one-device step
   (params, AdamW state, metrics) with the same K5 / K5b launches, and
   a checkpoint of the mesh state saved from its shards read into the
   one-device trainer's state bitwise (at most 60 s). Then the
   reference's two activation placements at (1, 2), the float32 smoke
   qwen (vocab 256): training over ``cuda:0`` and the CPU (one device a
   rank) — the vocab-split logits' loss within 1e-6 of the gathered
   logits' and every gradient leaf within 14b's gate, and act_shard
   "dmodel" and "seq" the loss and gradients of "none" bit for bit once
   each norm's input gradient is taken, chunk by chunk, from the rank
   that holds the chunk — and serving on ``cuda:0`` twice (qwen at full
   width, 2 layers), "dmodel" and "seq" streams equal to "none"'s (at
   most 60 s). The four-card runs are
   ``scripts/torch_mesh_train_card.py``,
   ``scripts/torch_mesh_train_families_card.py`` and
   ``scripts/torch_act_split_card.py``.

16. nemotron — nemotron-4-340b in bf16 at full width, 2 of its 96
   layers (32.8 GB; LayerNorm, squared ReLU, head dim 192, GQA 96/8):
   a 512-token prefill (K3), the same prompt as 256-token chunks (K4),
   8 greedy decode steps (K1) and a verify window over the prefill's
   cache (K4's split shape), each's logits held to the plain versions'
   (3e-2, argmax equal or a tie); then 8 seeded requests of 64–512
   tokens, 8 new each, on both caches under blocking, chunked 256 and
   speculative gamma 4, every K1–K4 call held to its plain version on
   its own inputs, exact launches.

17. dryrun — the dry-run and roofline tooling against the card (at
   most 60 s): (a) ``make_mesh((1, 1))`` and ``make_mesh((2, 2),
   devices=["cuda:0"] * 4)`` run on the card, ``make_production_mesh()``
   refuses one card for 256, and builds on 256 ``meta`` devices; (b)
   bf16 qwen1.5-0.5b at full width and depth — a decode of 8 slots at
   capacity 2048, a 1 x 1024 prefill and one train step at B 4 x S 2048
   (remat full) — each dry-run at (1, 1) against the same step on the
   card: argument bytes within 1% + 2 MiB of ``memory_allocated`` after
   placement, the predicted peak within [0.85, 1.5] of
   ``max_memory_allocated`` over the step, and the step's device time
   at least 0.95 of the roofline bound at the H100 constants; (c) bf16
   qwen at 8 layers on (2, 2), the card named four times: a decode and
   a prefill's collectives per rank, kind and shape, from the card run,
   equal the dry-run's meta rank run of the same cell. (The train
   step's is held on four cards by ``scripts/torch_dryrun_card.py``: a
   training mesh takes one card per rank.) Every step of (b) and (c) on
   the card runs with the launch counts zeroed just before it and held
   just after to what the step must launch (:func:`dryrun_expected`).

Every engine, cluster and mesh run and every W4 step checks each
kernel's launch count against what its path must launch. The four-card
runs of mesh serving are ``scripts/torch_mesh_card.py`` and
``scripts/torch_mesh_serve_families_card.py``.

The line before last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. It needs CUDA and the repository's
``src/`` and ``examples/`` beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core bf16
              "float32": 67e12}         # fp32 outside the tensor cores
# kernel vs plain version: float32 differs only in summation order;
# bf16 outputs may differ by a rounding step (1 ulp is 2^-8 relative)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCH = "qwen1.5-0.5b"
SEED = 0
# qwen's depth in the float32 runs that hold streams to each other —
# phases 3, 6, 10a and 13a, one depth for all — cut for the run's time
QWEN_F32_LAYERS = 12


def qwen_f32_cfg():
    """Full-width float32 qwen at ``QWEN_F32_LAYERS`` layers."""
    from repro_torch.configs import registry
    return registry.get_config(ARCH).replace(dtype="float32",
                                             n_layers=QWEN_F32_LAYERS)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events around the launches (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


DEVICE_TRIES = 3   # fresh profiler traces before a device time is missing
device_misses = 0  # traces that held no device time, over the whole run


def device_ms(fn, *, reps: int = 20) -> float | None:
    """Device time per call: the kernels' summed device time in a
    ``torch.profiler`` trace of ``reps`` calls (after a warm-up), over
    ``reps`` — what ``time_ms`` reads without the host's launch cost.
    A trace that holds no device activity (CUPTI now and then hands the
    profiler an empty activity buffer) is taken again, fresh, up to
    ``DEVICE_TRIES`` times; None (not measured) only if every try is
    empty. Misses are counted in ``device_misses``."""
    global device_misses
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        device_misses += 1
    return None


COLD_BYTES = 120e6    # what a round of copies streams: > 2x the 50 MB L2


def cold_copies(nbytes: float) -> int:
    """Copies of an operand set of ``nbytes`` that one round-robin round
    must visit so that each copy is evicted from L2 before its next
    call."""
    return max(2, -(-int(COLD_BYTES) // max(int(nbytes), 1)))


def round_robin(fns):
    """One call per step, to each of ``fns`` (kernels on different
    copies of their operands) in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def cold_times(fns) -> tuple[float, float | None]:
    """(ms, device ms) per call over ``fns`` taken round-robin, in
    multiples of a whole round: each call finds its operands cold in L2,
    as a step streaming the model's weights or caches finds them."""
    reps = len(fns) * max(1, -(-20 // len(fns)))
    fn = round_robin(fns)
    return time_ms(fn, reps=reps), device_ms(fn, reps=reps)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

def _instantiation(mangled: str) -> str:
    """``kernel<args>`` from a mangled kernel name (float, bf16, int and
    file-local struct template arguments), or the mangled name itself."""
    for m in re.finditer(r"\d+", mangled):  # <length><identifier>
        end = m.end() + int(m.group())
        if not mangled[m.end():end].endswith("_kernel"):
            continue
        if mangled[end:end + 1] == "E":            # not a template
            return mangled[m.end():end]
        if mangled[end:end + 1] == "I" and "EEv" in mangled[end:]:
            break
    else:
        return mangled
    kernel, rest = mangled[m.end():end], mangled[end + 1:]
    rest = rest[:rest.index("EEv")]
    args = []
    while rest:
        if rest.startswith("13__nv_bfloat16"):
            args.append("bf16")
            rest = rest[15:]
        elif rest.startswith("f"):
            args.append("f32")
            rest = rest[1:]
        elif re.match(r"NS_\d+", rest):          # a struct of the file
            m = re.match(r"NS_(\d+)", rest)
            args.append(rest[m.end():m.end() + int(m.group(1))])
            rest = rest[m.end() + int(m.group(1)) + 1:]
        elif rest.startswith(("Li", "Lb")) and "E" in rest:
            args.append(rest[2:rest.index("E")])
            rest = rest[rest.index("E") + 1:]
        elif re.match(r"S\d*_", rest):   # a repeat of an earlier type:
            args.append("bf16")            # bf16 is the only one named
            rest = rest[re.match(r"S\d*_", rest).end():]
        else:
            return mangled
    return f"{kernel}<{','.join(args)}>"


def ptxas_summary(log_text: str) -> list:
    """One ``kernel<args>=registers/static smem bytes[/spills]`` entry
    per instantiation in an ``nvcc -Xptxas -v`` log (dynamic shared
    memory is set at launch and does not appear here)."""
    out, name, spill = [], None, ""
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = _instantiation(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and m.group(1) + m.group(2) != "00":
            spill = f"/spill{m.group(1)}+{m.group(2)}B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name is not None:
            out.append(f"{name}={m.group(1)}r/{m.group(2) or 0}B{spill}")
            name = None
    return out


# tensor-core MMA, cp.async, ldmatrix, 128-bit global loads, int ->
# float conversions
SASS_OPS = {"HMMA": r"\bHMMA\b", "LDGSTS": r"\bLDGSTS\b",
            "LDSM": r"\bLDSM\b", "LDG.E.128": r"\bLDG\.E\.128\b",
            "I2F": r"\bI2FP?\b"}


def sass_counts(so: Path) -> str:
    """How many of each ``SASS_OPS`` instruction the library's machine
    code holds (``cuobjdump -sass``)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return "cuobjdump_not_found"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts = {op: len(re.findall(pat, sass)) for op, pat in SASS_OPS.items()}
    return ",".join(f"{op}:{n}" for op, n in counts.items())


def phase_device() -> str:
    import torch
    from repro_torch.kernels import _build
    card = card_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        so = _build.library_path(name)
        text = so.with_suffix(".log").read_text()
        log("build", kernel=name, lib=so.name,
            nvcc_seconds=_build.build_seconds(text), sass=sass_counts(so),
            ptxas=" ".join(ptxas_summary(text)))
    log("build", seconds=f"{build_s:.1f}", parallel_nvcc=len(_build.SOURCES))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _flat(out):
    """A kernel's output, or its tuple of outputs, as one float32
    vector (for the comparison only, never timed)."""
    import torch
    if isinstance(out, tuple):
        return torch.cat([t.float().flatten() for t in out])
    return out.float()


def _equal(a, b) -> bool:
    """``torch.equal`` of two outputs or tuples of outputs."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


def _compare(name, case, dtype_name, got, want, *, ms, plain_ms, lib_ms,
             dev_ms, lib_dev_ms, nbytes, flops):
    import torch
    outs = got if isinstance(got, tuple) else (got,)
    # an output rounded to bf16 is held to bf16's tolerance
    tol = TOL["bfloat16" if any(t.dtype == torch.bfloat16 for t in outs)
              else dtype_name]
    got, want = _flat(got), _flat(want)
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=tol, rtol=tol)
    bms, by = bound_ms(nbytes, flops, dtype_name)
    log("kernels", kernel=name, case=case, dtype=dtype_name,
        max_abs_err=f"{err:.3e}", tol=tol, ok=ok, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
        device_ms="null" if dev_ms is None else f"{dev_ms:.4f}",
        library_device_ms="null" if lib_dev_ms is None
        else f"{lib_dev_ms:.4f}",
        bound_ms=f"{bms:.6f}", bound_by=by)
    if not ok:
        raise AssertionError(f"{name} {case} {dtype_name}: max |err| "
                             f"{err:.3e} exceeds {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bms,
            "bound_by": by}


def _cold(name, case, dtype_name, kfns, lfns) -> dict:
    """Kernel and library times with every call's operands cold in L2:
    round-robin over ``len(kfns)`` copies of the weights or caches."""
    import torch
    ms, dev = cold_times(kfns)
    lib_ms, lib_dev = (None, None) if lfns is None else cold_times(lfns)
    res = {"cold_ms": ms, "cold_device_ms": dev, "library_cold_ms": lib_ms,
           "library_cold_device_ms": lib_dev, "cold_copies": len(kfns)}
    log("kernels", kernel=name, case=case, dtype=dtype_name,
        cold_copies=len(kfns), **{k: "null" if v is None else f"{v:.4f}"
                                  for k, v in res.items()
                                  if k != "cold_copies"})
    del kfns, lfns
    torch.cuda.empty_cache()
    return res


def sdpa(q, k, v, mask=None, causal=True):
    """``scaled_dot_product_attention`` on the model's (B, S, H, Dh)
    layout (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=g > 1).transpose(1, 2)


def decode_cases(gen, dtype, b, cap, hq, hkv, dh, bs=16, first_len=None):
    """K1 over a ragged contiguous cache with the self partial, and K2
    on the same rows in a pool of scattered blocks (bitwise K1); row 0
    holds ``first_len`` positions (default: the capacity). Library
    yardstick of both: SDPA over cache ++ self with a boolean mask —
    the mask, the concatenation and, for K2, the table gather built
    here, outside the timed call."""
    import torch
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_decode_attention as kpdec
    from repro_torch.kernels import ref
    nb, w = b * cap // bs, cap // bs
    q = _rand(gen, (b, 1, hq, dh), dtype)
    kc = _rand(gen, (b, cap, hkv, dh), dtype)
    vc = _rand(gen, (b, cap, hkv, dh), dtype)
    ek = _rand(gen, (b, 1, hkv, dh), dtype)
    ev = _rand(gen, (b, 1, hkv, dh), dtype)
    lens = torch.randint(1, cap + 1, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens[0] = cap if first_len is None else first_len
    tot = int(lens.sum().item())
    dec_flops, dec_bytes = kdec.cost(q.shape, kc.shape, dtype, lens)
    pos = torch.arange(cap + 1, device="cuda")
    mask = ((pos[None, :] < lens[:, None]) | (pos[None, :] == cap)
            )[:, None, None, :]                     # (B, 1, 1, C + 1)
    k_cat, v_cat = torch.cat([kc, ek], 1), torch.cat([vc, ev], 1)

    def k1_cold():
        caches = [(kc.clone(), vc.clone())
                  for _ in range(cold_copies(dec_bytes))]
        cats = [(torch.cat([k, ek], 1), torch.cat([v, ev], 1))
                for k, v in caches]
        return ([lambda k=k, v=v: kdec.decode_attention(
                    q, k, v, lens, extra_k=ek, extra_v=ev)
                 for k, v in caches],
                [lambda k=k, v=v: sdpa(q, k, v, mask) for k, v in cats])

    cases = [(
        "decode_attention",
        f"B={b},C={cap},Hq={hq},Hkv={hkv},Dh={dh},sum_len={tot},self",
        lambda: kdec.decode_attention(q, kc, vc, lens, extra_k=ek,
                                      extra_v=ev),
        lambda: ref.decode_attention(q, kc, vc, lens, extra_k=ek,
                                     extra_v=ev),
        lambda: sdpa(q, k_cat, v_cat, mask),
        dec_bytes, dec_flops, [], {"cold": k1_cold})]
    # K2: the same rows in a pool of NB blocks, at a seeded random
    # permutation of block ids; entries past each row's length are
    # sentinels (NB)
    perm = torch.randperm(nb, generator=gen, device="cuda")
    tab = perm.reshape(b, w).to(torch.int32)
    kp = torch.empty((nb, bs, hkv, dh), dtype=dtype, device="cuda")
    vp = torch.empty_like(kp)
    kp[tab.reshape(-1).long()] = kc.reshape(b * w, bs, hkv, dh)
    vp[tab.reshape(-1).long()] = vc.reshape(b * w, bs, hkv, dh)
    n_blk = (lens.long() + bs - 1) // bs
    tab[torch.arange(w, device="cuda")[None, :] >= n_blk[:, None]] = nb
    kg = torch.cat([ref.gather_kv_blocks(kp, tab), ek], 1)
    vg = torch.cat([ref.gather_kv_blocks(vp, tab), ev], 1)
    k2_flops, k2_bytes = kpdec.cost(q.shape, kp.shape, tab.shape, dtype,
                                    lens)

    def k2_cold():
        pools = [(kp.clone(), vp.clone())
                 for _ in range(cold_copies(dec_bytes))]
        views = [(kg.clone(), vg.clone()) for _ in pools]
        return ([lambda k=k, v=v: kpdec.paged_decode_attention(
                    q, k, v, tab, lens, extra_k=ek, extra_v=ev)
                 for k, v in pools],
                [lambda k=k, v=v: sdpa(q, k, v, mask) for k, v in views])

    cases.append((
        "paged_decode_attention",
        f"B={b},C={cap},bs={bs},NB={nb},Hq={hq},Hkv={hkv},Dh={dh},"
        f"sum_len={tot},self,scattered",
        lambda: kpdec.paged_decode_attention(q, kp, vp, tab, lens,
                                             extra_k=ek, extra_v=ev),
        lambda: ref.paged_decode_attention(q, kp, vp, tab, lens,
                                           extra_k=ek, extra_v=ev),
        lambda: sdpa(q, kg, vg, mask),
        k2_bytes, k2_flops,
        # K1 on the dense copy of the same rows: bitwise equal
        [("K1_on_the_same_rows",
          lambda: kdec.decode_attention(q, kc, vc, lens, extra_k=ek,
                                        extra_v=ev))], {"cold": k2_cold}))
    return cases


def gathered_history(gen, kh, hist_len, bs=16, extra_w=2):
    """``kh``'s rows in a pool twice the size they need, at seeded
    scattered block ids, read back through block tables ``extra_w``
    blocks wider than the capacity (entries past each row's length are
    the sentinel): the dense view a paged chunk or verify dispatch
    gathers, longer than ``kh`` and holding other blocks' data past the
    lengths."""
    import torch
    from repro_torch.kernels import ref
    b, cap = kh.shape[:2]
    w = cap // bs + extra_w
    nb = 2 * b * w
    tab = torch.randperm(nb, generator=gen, device="cuda")[:b * w].reshape(
        b, w).to(torch.int32)
    pool = _rand(gen, (nb, bs, *kh.shape[2:]), kh.dtype)
    pool[tab[:, :cap // bs].reshape(-1).long()] = kh.reshape(
        -1, bs, *kh.shape[2:])
    n_blk = (hist_len.long() + bs - 1) // bs
    tab[torch.arange(w, device="cuda")[None, :] >= n_blk[:, None]] = nb
    return ref.gather_kv_blocks(pool, tab)


def prefill_cases(gen, dtype, dh, specs, cap=2048):
    """K4 at (case, B, S, Hq, Hkv, hist_len or None for ragged rows, one
    near capacity), each with two bitwise checks: a second run, and the
    history read through a block-table gather of a larger pool. Library
    yardstick: SDPA over history ++ self with a boolean mask, both built
    here, outside the timed call."""
    import torch
    from repro_torch.kernels import prefill_attention as kpre
    from repro_torch.kernels import ref
    cases = []
    for case, bq, s, hq, hkv, hist in specs:
        q = _rand(gen, (bq, s, hq, dh), dtype)
        kh = _rand(gen, (bq, cap, hkv, dh), dtype)
        vh = _rand(gen, (bq, cap, hkv, dh), dtype)
        ks = _rand(gen, (bq, s, hkv, dh), dtype)
        vs = _rand(gen, (bq, s, hkv, dh), dtype)
        if hist is None:  # ragged per-row history, one row near capacity
            hl = torch.randint(1, cap - s + 1, (bq,), generator=gen,
                               device="cuda", dtype=torch.int32)
            hl[0] = cap - s
        else:
            hl = torch.tensor([hist], dtype=torch.int32, device="cuda")
        tot = int(hl.sum().item())
        k_cat, v_cat = torch.cat([kh, ks], 1), torch.cat([vh, vs], 1)
        pos = torch.arange(cap + s, device="cuda")
        rel = torch.arange(s, device="cuda")
        mask = torch.where(pos[None, None, :] < cap,
                           pos[None, None, :] < hl[:, None, None],
                           pos[None, None, :] - cap <= rel[None, :, None])
        mask = mask[:, None]                        # (B, 1, S, C + S)
        kg, vg = gathered_history(gen, kh, hl), gathered_history(gen, vh, hl)
        shape = "tiles"  # the launch shape; for splits, how many are read
        if kpre.launch_plan(bq, s, cap, hq, dh, dtype).splits:
            shape = f"splits={sum(kpre.live_splits(hl, bq, cap))}"
        flops, nbytes = kpre.cost(q.shape, kh.shape, dtype, hl)

        def make(q, kh, vh, ks, vs, hl=hl, m=mask):
            kc, vc = torch.cat([kh, ks], 1), torch.cat([vh, vs], 1)
            return (lambda: kpre.prefill_attention(q, kh, vh, hl, ks, vs),
                    lambda: sdpa(q, kc, vc, m))

        cases.append((
            "prefill_attention",
            f"{case},B={bq},S={s},C={cap},hist_len="
            f"{hist if hist is not None else 'ragged'},sum_hist={tot},"
            f"Hq={hq},Hkv={hkv},Dh={dh},{shape}",
            lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                kpre.prefill_attention(q, kh, vh, hl, ks, vs),
            lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                ref.prefill_attention(q, kh, vh, hl, ks, vs),
            lambda q=q, k=k_cat, v=v_cat, m=mask: sdpa(q, k, v, m),
            nbytes, flops,
            [("second_run",
              lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                  kpre.prefill_attention(q, kh, vh, hl, ks, vs)),
             (f"block_table_gather_C={kg.shape[1]}",
              lambda q=q, kg=kg, vg=vg, hl=hl, ks=ks, vs=vs:
                  kpre.prefill_attention(q, kg, vg, hl, ks, vs))],
            {"cold": cold_of(nbytes, make, q, kh, vh, ks, vs)}))
    return cases


def cold_of(nbytes, make, *tensors):
    """A cold factory for ``_cold``: ``make(*copy)`` -> (kernel fn,
    library fn or None) on each of ``cold_copies(nbytes)`` copies of
    ``tensors``."""
    def cold():
        pairs = [make(*(t.clone() for t in tensors))
                 for _ in range(cold_copies(nbytes))]
        lib = [lf for _, lf in pairs]
        return [kf for kf, _ in pairs], None if None in lib else lib
    return cold


def add_rmsnorm_case(gen, m, d, xdt, adt, hdt, label=""):
    """K5 with the residual add at (m, d), (x, a, h) dtypes: (s, h)
    against the plain version; bitwise, torch's ``x + a`` and the kernel
    without the add on it; library: ``x + a`` then ``F.rms_norm`` (cast
    to h's dtype where it differs); the lone ``x + a`` as the launch
    floor; cold: copies of x, a and w. Bytes: x and a read, s and h
    written, w once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    x, a = _rand(gen, (m, d), xdt), _rand(gen, (m, d), adt)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(xdt)
    flops, nbytes = krn.cost(x.shape, xdt, add_dtype=adt, out_dtype=hdt)

    def kern(x=x, a=a, w=w):
        return krn.add_rmsnorm(x, a, w, out_dtype=hdt)

    def lib(x=x, a=a, w=w):
        out = F.rms_norm(x + a, (d,), w, eps=1e-6)
        return out if hdt == xdt else out.to(hdt)

    names = ",".join(str(t).removeprefix("torch.") for t in (xdt, adt, hdt))
    return (
        "add_rmsnorm", f"{label}M={m},d={d},x+a->h={names}", kern,
        lambda: ref.add_rmsnorm(x, a, w, out_dtype=hdt), lib,
        nbytes, flops,
        [("x_plus_a_then_the_kernel_without_a",
          lambda: (x + a, krn.add_rmsnorm(x + a, None, w,
                                          out_dtype=hdt)[1]))],
        {"cold": cold_of(nbytes, lambda *c: (lambda: kern(*c),
                                              lambda: lib(*c)), x, a, w),
         "floor": lambda: x + a})


def rmsnorm_case(gen, m, d, dtype, label=""):
    """K5 without the add at (m, d) against the plain version; library:
    ``F.rms_norm``; cold: copies of x and w. Bytes: x read, h written,
    w once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    x = _rand(gen, (m, d), dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    flops, nbytes = krn.cost(x.shape, dtype)
    return (
        "rmsnorm", f"{label}M={m},d={d}",
        lambda: krn.rmsnorm(x, w), lambda: ref.rmsnorm(x, w),
        lambda: F.rms_norm(x, (d,), w, eps=1e-6), nbytes, flops, [],
        {"cold": cold_of(nbytes, lambda x, w: (
            lambda: krn.rmsnorm(x, w),
            lambda: F.rms_norm(x, (d,), w, eps=1e-6)), x, w)})


def kernel_cases(gen, dtype):
    """(name, case, kernel_fn, plain_fn, library_fn|None, bytes, flops,
    same[, opts]) at the paths' shapes for one dtype; ``same`` lists
    (label, fn) of kernel runs whose output must be bitwise equal to the
    first; ``opts`` may hold ``cold`` (a factory of round-robin kernel
    and library calls on copies beyond the L2), ``floor`` (the lone
    elementwise op a fused kernel absorbs)."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    d = 1024
    cases = [rmsnorm_case(gen, m, d, dtype) for m in (8, 512)]
    # the fused add: qwen's decode rows and its prefill bucket, in the
    # serving dtype (the float32 gates' in float32)
    for m in (8, 1024):
        cases.append(add_rmsnorm_case(gen, m, d, dtype, dtype, dtype))

    s, dh = 512, 64
    for case, hq, hkv, window in (("causal", 16, 16, None),
                                  ("gqa", 8, 2, None),
                                  ("window", 16, 16, 128)):
        q = _rand(gen, (1, s, hq, dh), dtype)
        k = _rand(gen, (1, s, hkv, dh), dtype)
        v = _rand(gen, (1, s, hkv, dh), dtype)
        pos = torch.arange(s, device="cuda")
        ok = pos[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[None, :] > pos[:, None] - window
        mask = ok if window is not None else None
        flops, nbytes = kfa.cost(q.shape, k.shape, dtype, causal=True,
                                 window=window)
        cases.append((
            "flash_attention",
            f"B=1,S={s},Hq={hq},Hkv={hkv},Dh={dh},{case}",
            lambda q=q, k=k, v=v, w=window: kfa.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, w=window: ref.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, m=mask: sdpa(q, k, v, m),
            nbytes, flops, [],
            {"cold": cold_of(nbytes, lambda q, k, v, w=window, m=mask: (
                lambda: kfa.flash_attention(q, k, v, causal=True, window=w),
                lambda: sdpa(q, k, v, m)), q, k, v)}))

    b, cap = 8, 2048
    for case, hq, hkv in (("mha", 16, 16), ("gqa", 8, 2)):
        cases += decode_cases(gen, dtype, b, cap, hq, hkv, dh)

    # K4: one chunk over a cached history, then a ragged verify (MHA and
    # GQA 8/2); then K3 at the qwen prefill's 1024-token bucket
    cases += prefill_cases(gen, dtype, dh, (("chunk", 1, 256, 16, 16, 768),
                                            ("chunk,gqa", 1, 256, 8, 2, 768),
                                            ("verify", 8, 5, 16, 16, None),
                                            ("verify,gqa", 8, 5, 8, 2, None)))
    s, hq = 1024, 16
    q, k, v = (_rand(gen, (1, s, hq, dh), dtype) for _ in range(3))
    flops, nbytes = kfa.cost(q.shape, k.shape, dtype)
    cases.append((
        "flash_attention", f"B=1,S={s},Hq={hq},Hkv={hq},Dh={dh},causal",
        lambda: kfa.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention(q, k, v, causal=True),
        lambda: sdpa(q, k, v),
        nbytes, flops, [],
        {"cold": cold_of(nbytes, lambda q, k, v: (
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(q, k, v)), q, k, v)}))
    return cases


def int4pack_library(x, packed, scales, group):
    """PyTorch's int4 weight-only GEMM (``aten._weight_int4pack_mm``)
    on the same weight as a library yardstick: repacked here, outside
    the timed call, into its (N, K/2) uint8 input — unsigned nibbles
    q = v + 8, even k in the high nibble — which it dequantizes as
    (q - 8) * scale + zero, with zero = 0 and the scales rounded to
    bf16. Returns (fn, note), or (None, why) when the installed PyTorch
    refuses the shape or disagrees with the plain version."""
    import torch
    from repro_torch.kernels import ref
    q = ref.unpack_int4(packed).t().to(torch.int32) + 8          # (N, K)
    w_u8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
    sz = torch.stack([scales, torch.zeros_like(scales)], -1).to(
        torch.bfloat16).contiguous()                         # (K/g, N, 2)
    try:
        w4d = torch.ops.aten._convert_weight_to_int4pack(w_u8, 8)
        got = torch.ops.aten._weight_int4pack_mm(x, w4d, group, sz).float()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    want = ref.quant_gemv(x, packed, scales, group=group).float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=TOL["bfloat16"],
                          rtol=TOL["bfloat16"]):
        return None, ("disagrees with the plain version: "
                      f"max_abs_err={err:.3e}")
    return (lambda: torch.ops.aten._weight_int4pack_mm(x, w4d, group, sz)
            ), f"max_abs_err={err:.3e}"


# K6 at the W4 path's projection shapes of phi3-mini-3.8b (d 3072,
# d_ff 8192), then B=8, group 64 and a ragged column tile
QUANT_SHAPES = (("w_gate", 1, 3072, 8192, 128),
                ("w_down", 1, 8192, 3072, 128),
                ("wq", 1, 3072, 3072, 128),
                ("w_gate", 8, 3072, 8192, 128),
                ("w_gate", 1, 3072, 8192, 64),
                ("ragged_N", 1, 3072, 3000, 128))


def w4_path_cases(gen, dtype):
    """The W4 path's kernels and phi3-mini's serving shapes (its own
    generator, so the earlier cases' inputs stay as they were): K6 at
    ``QUANT_SHAPES``; K3, K1 (with K2 bitwise K1) and K4 chunk and verify
    at phi3-mini's head dim 96 and 32 heads."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import quant_gemv as kqg
    from repro_torch.kernels import ref
    dname = str(dtype).removeprefix("torch.")
    cases = []
    for label, b, k, n, group in QUANT_SHAPES:
        case = f"{label},B={b},K={k},N={n},group={group}"
        x = _rand(gen, (b, k), dtype)
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        packed, scales = ref.quantize_int4(w, group=group)
        lib = None
        if dtype == torch.bfloat16:
            lib, note = int4pack_library(x, packed, scales, group)
            w_deq = (ref.unpack_int4(packed).float()
                     * scales.repeat_interleave(group, 0)).to(dtype)
            log("kernels", kernel="quant_gemv", case=case, dtype=dname,
                library="aten._weight_int4pack_mm", library_note=note,
                w16_matmul_ms=f"{time_ms(lambda: x @ w_deq):.4f}")
            del w_deq
        flops, nbytes = kqg.cost(x.shape, packed.shape, dtype, group=group)

        def cold(x=x, packed=packed, scales=scales, group=group,
                 nbytes=nbytes, lib=lib):
            ws = [(packed.clone(), scales.clone())
                  for _ in range(cold_copies(nbytes))]
            libs = None
            if lib is not None:
                libs = [int4pack_library(x, p, s, group)[0] for p, s in ws]
                libs = None if None in libs else libs
            return ([lambda p=p, s=s: kqg.quant_gemv(x, p, s, group=group)
                     for p, s in ws], libs)

        cases.append((
            "quant_gemv", case,
            lambda x=x, p=packed, s=scales, g=group: kqg.quant_gemv(
                x, p, s, group=g),
            lambda x=x, p=packed, s=scales, g=group: ref.quant_gemv(
                x, p, s, group=g),
            lib, nbytes, flops, [], {"cold": cold}))

    s, h, dh = 512, 32, 96
    q = _rand(gen, (1, s, h, dh), dtype)
    k = _rand(gen, (1, s, h, dh), dtype)
    v = _rand(gen, (1, s, h, dh), dtype)
    flops, nbytes = kfa.cost(q.shape, k.shape, dtype)
    cases.append((
        "flash_attention", f"B=1,S={s},Hq={h},Hkv={h},Dh={dh},causal",
        lambda: kfa.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention(q, k, v, causal=True),
        lambda: sdpa(q, k, v),
        nbytes, flops, [],
        {"cold": cold_of(nbytes, lambda q, k, v: (
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(q, k, v)), q, k, v)}))
    if dtype == torch.float32:
        # K5 at the W4 step's norm: float32 residual, K6's bf16 output
        # added, bf16 h for K6
        cases.append(add_rmsnorm_case(gen, 1, 3072, torch.float32,
                                      torch.bfloat16, torch.bfloat16))
    cases += decode_cases(gen, dtype, 8, 2048, h, h, dh)
    # K1 and K2 at the W4 step's call: one row, 512 of 1024 positions
    cases += decode_cases(gen, dtype, 1, 1024, h, h, dh, first_len=512)
    # K4 at phi3-mini's head dim: its chunked-prefill and verify shapes
    cases += prefill_cases(gen, dtype, dh, (("chunk", 1, 256, h, h, 768),
                                            ("verify", 8, 5, h, h, None)))
    return cases


def families_cases(gen, dtype):
    """Phase 7's attention shapes (its own generator): head dim 128,
    GQA 48/8 (internvl2-26b, dbrx-132b: G 6) and MHA 16/16
    (deepseek-moe-16b). K1 and K2 over 8 slots at capacity 2048; K4's
    verify window (gamma 4), its 256-token chunk over a history and
    internvl2's first chunk (256 image positions + 256 tokens, no
    history); K3 at the vlm buckets after the 256-row image prefix
    (S = 256 + 32, 256 + 1024), dbrx's 512-token prefill and
    deepseek's 1024-token bucket."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    dh = 128
    cases = []
    for hq, hkv in ((48, 8), (16, 16)):
        cases += decode_cases(gen, dtype, 8, 2048, hq, hkv, dh)
    cases += prefill_cases(gen, dtype, dh, (
        ("verify,g6", 8, 5, 48, 8, None),
        ("verify,mha", 8, 5, 16, 16, None),
        ("chunk,g6", 1, 256, 48, 8, 768),
        ("chunk,g6,image_prefix", 1, 512, 48, 8, 0)))
    for s, hq, hkv in ((288, 48, 8), (1280, 48, 8), (512, 48, 8),
                       (1024, 16, 16)):
        q = _rand(gen, (1, s, hq, dh), dtype)
        k = _rand(gen, (1, s, hkv, dh), dtype)
        v = _rand(gen, (1, s, hkv, dh), dtype)
        flops, nbytes = kfa.cost(q.shape, k.shape, dtype)
        cases.append((
            "flash_attention", f"B=1,S={s},Hq={hq},Hkv={hkv},Dh={dh},causal",
            lambda q=q, k=k, v=v: kfa.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: ref.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: sdpa(q, k, v),
            nbytes, flops, [],
            {"cold": cold_of(nbytes, lambda q, k, v: (
                lambda: kfa.flash_attention(q, k, v, causal=True),
                lambda: sdpa(q, k, v)), q, k, v)}))
    return cases


def rolling_decode_case(gen, dtype, b, cap, hq, hkv, dh, lens, label):
    """K1 over a rolling cache of ``cap`` == window slots, with the self
    partial: a row is valid to min(len, C), and a full row's slot
    len % C — the position one window back — is masked; two runs are
    the same bits. Library yardstick: SDPA over cache ++ self with that
    mask, built here, outside the timed call. Bytes: the rows the masks
    keep, read once."""
    import torch
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    q = _rand(gen, (b, 1, hq, dh), dtype)
    kc = _rand(gen, (b, cap, hkv, dh), dtype)
    vc = _rand(gen, (b, cap, hkv, dh), dtype)
    ek = _rand(gen, (b, 1, hkv, dh), dtype)
    ev = _rand(gen, (b, 1, hkv, dh), dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    slot = torch.arange(cap, device="cuda")[None, :]
    keep = (slot < ln.clamp(max=cap)[:, None]) & ~(
        (ln[:, None] >= cap) & (slot == (ln % cap)[:, None]))
    mask = torch.cat([keep, torch.ones((b, 1), dtype=torch.bool,
                                       device="cuda")], 1)[:, None, None, :]
    rows = int(keep.sum().item())
    flops, nbytes = kdec.cost(q.shape, kc.shape, dtype, lens, window=cap)
    k_cat, v_cat = torch.cat([kc, ek], 1), torch.cat([vc, ev], 1)

    def kern(kc=kc, vc=vc):
        return kdec.decode_attention(q, kc, vc, ln, extra_k=ek, extra_v=ev,
                                     window=cap)

    def cold():
        caches = [(kc.clone(), vc.clone())
                  for _ in range(cold_copies(nbytes))]
        cats = [(torch.cat([k, ek], 1), torch.cat([v, ev], 1))
                for k, v in caches]
        return ([lambda k=k, v=v: kern(k, v) for k, v in caches],
                [lambda k=k, v=v: sdpa(q, k, v, mask) for k, v in cats])

    return ("decode_attention",
            f"{label},rolling,B={b},C=window={cap},Hq={hq},Hkv={hkv},"
            f"Dh={dh},lens={'/'.join(map(str, lens))},rows={rows},self",
            kern,
            lambda: ref.decode_attention(q, kc, vc, ln, extra_k=ek,
                                         extra_v=ev, window=cap),
            lambda: sdpa(q, k_cat, v_cat, mask), nbytes,
            flops, [("second_run", kern)],
            {"cold": cold})


def flash_case(gen, dtype, label, sq, skv, hq, hkv, dh, *, causal,
               window=None):
    """K3 at (sq, skv): causal with an optional window, or non-causal
    (whisper's encoder and cross-attention). Library: SDPA with the same
    mask (a boolean one for a window, built outside the timed call).
    Operations: the (query, key) pairs the masks keep."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    q = _rand(gen, (1, sq, hq, dh), dtype)
    k = _rand(gen, (1, skv, hkv, dh), dtype)
    v = _rand(gen, (1, skv, hkv, dh), dtype)
    kw = dict(causal=causal, window=window)
    mask = None
    if window is not None:
        qp = torch.arange(sq, device="cuda")[:, None]
        kp = torch.arange(skv, device="cuda")[None, :]
        mask = (kp <= qp) & (kp > qp - window)
    flops, nbytes = kfa.cost(q.shape, k.shape, dtype, causal=causal,
                             window=window)

    def lib(q=q, k=k, v=v):
        return sdpa(q, k, v, mask, causal=causal)

    return ("flash_attention",
            f"{label},B=1,Sq={sq},Skv={skv},Hq={hq},Hkv={hkv},Dh={dh},"
            + ("causal" if causal else "non_causal")
            + (f",window={window}" if window else ""),
            lambda: kfa.flash_attention(q, k, v, **kw),
            lambda: ref.flash_attention(q, k, v, **kw), lib,
            nbytes, flops, [],
            {"cold": cold_of(nbytes, lambda q, k, v: (
                lambda: kfa.flash_attention(q, k, v, **kw),
                lambda: lib(q, k, v)), q, k, v)})


def nemotron_cases(gen, dtype):
    """Phase 16's attention shapes (its own generator): nemotron-4-340b's
    head dim 192 and GQA 96/8 (G 12). K1 and K2 over 8 slots at capacity
    2048; K4's verify window (gamma 4) and its 256-token chunk over a
    768-position history; K3 over a 512-token prompt."""
    dh, hq, hkv = 192, 96, 8
    cases = decode_cases(gen, dtype, 8, 2048, hq, hkv, dh)
    cases += prefill_cases(gen, dtype, dh, (
        ("verify,g12", 8, 5, hq, hkv, None),
        ("chunk,g12", 1, 256, hq, hkv, 768)))
    cases.append(flash_case(gen, dtype, "nemotron", 512, 512, hq, hkv, dh,
                            causal=True))
    # hot times only, 5 calls a timed round: the script's time is scarce
    return [c[:8] + ({"reps": 5},) for c in cases]


# phase 8's rolling decode rows: both sides of the 4096-position window
ROLLING_LENS = (600, 4090, 4095, 4096, 4097, 4500, 6000, 8191)


def window_audio_cases(gen, dtype):
    """Phase 8's attention shapes (their own generator): K1 over the
    rolling 4096-slot cache at GQA 32/8, Dh 128 (mistral-7b) and Dh 80
    (h2o-danube-1.8b); K1 as whisper's cross-attention decode (8 rows
    over the fixed 1500-row encoder cache, 20 heads of 64, no self
    partial); K3 at Dh 80 over a 6000-token prompt with the 4096 window,
    and non-causal over whisper's 1500 encoder positions, self (the
    encoder) and cross (a 256-token bucket against them)."""
    import torch
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    cases = [rolling_decode_case(gen, dtype, 8, 4096, 32, 8, dh,
                                 ROLLING_LENS, name)
             for name, dh in (("mistral", 128), ("danube", 80))]
    b, t, h, dh = 8, 1500, 20, 64
    q = _rand(gen, (b, 1, h, dh), dtype)
    kc, vc = _rand(gen, (b, t, h, dh), dtype), _rand(gen, (b, t, h, dh),
                                                       dtype)
    flops, nbytes = kdec.cost(q.shape, kc.shape, dtype, t, self_kv=False)

    def cross(kc=kc, vc=vc):
        return kdec.decode_attention(q, kc, vc, t)

    cases.append((
        "decode_attention",
        f"whisper_cross,B={b},C={t},Hq={h},Hkv={h},Dh={dh},len={t},"
        f"splits={kdec.launch_plan(b, h, t).splits},no_self",
        cross, lambda: ref.decode_attention(q, kc, vc, t),
        lambda: sdpa(q, kc, vc, causal=False), nbytes, flops,
        [("second_run", cross)],
        {"cold": cold_of(nbytes, lambda kc, vc: (
            lambda: cross(kc, vc),
            lambda: sdpa(q, kc, vc, causal=False)), kc, vc)}))
    cases.append(flash_case(gen, dtype, "danube_window", 6000, 6000, 32, 8,
                            80, causal=True, window=4096))
    cases.append(flash_case(gen, dtype, "whisper_encoder", 1500, 1500, 20,
                            20, 64, causal=False))
    cases.append(flash_case(gen, dtype, "whisper_cross", 256, 1500, 20, 20,
                            64, causal=False))
    return cases


def recurrent_cases(gen, dtype):
    """Phase 9's kernel shapes (their own generator): zamba2-2.7b's
    shared attention block, MHA 32 x Dh 80 — K1 over 8 slots at capacity
    2048 (ragged lengths, the self partial) and K3 causal over a
    1024-token bucket, no window — and K5 at its Mamba2 widths: the
    gated norm at d_in 5120 (no add) and the layer norm at d 2560 with
    the residual add, 8 rows each."""
    cases = decode_cases(gen, dtype, 8, 2048, 32, 32, 80)[:1]   # K1 only
    cases.append(flash_case(gen, dtype, "zamba2", 1024, 1024, 32, 32, 80,
                            causal=True))
    cases.append(rmsnorm_case(gen, 8, 5120, dtype, "zamba2_gated,"))
    cases.append(add_rmsnorm_case(gen, 8, 2560, dtype, dtype, dtype,
                                  "zamba2_ln,"))
    return cases


def add_rmsnorm_bwd_case(gen, m, d, dtype, *, add, label):
    """K5b at (m, d) in ``dtype`` — with the forward's add (and a
    cotangent of s along the residual) or without — against the plain
    version, bitwise against its own second run (gw included: per-block
    partials summed in a fixed order); library: torch's autograd
    backward of ``F.rms_norm`` after ``x + a``, its graph built once;
    cold: copies of s, gh, gs and w. Bytes (``bwd_cost``): s, gh, gs and
    w read, gx, ga and gw written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    x, a, gh, gs = (_rand(gen, (m, d), dtype) for _ in range(4))
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    adt = dtype if add else None
    s = x + a if add else x
    g_s = gs if add else None
    flops, nbytes = krn.bwd_cost(s.shape, dtype, add_dtype=adt,
                                 residual=add)
    xl, al, wl = (t.clone().requires_grad_() for t in (x, a, w))
    sl = xl + al if add else xl
    hl = F.rms_norm(sl, (d,), wl, eps=1e-6)
    outs, cots, ins = (([sl, hl], [gs, gh], [xl, al, wl]) if add
                       else ([hl], [gh], [xl, wl]))

    def kern(s=s, gh=gh, g_s=g_s, w=w):
        return krn.add_rmsnorm_bwd(s, w, gh, g_s, add_dtype=adt)

    def lib():
        return torch.autograd.grad(outs, ins, cots, retain_graph=True)

    def plain():
        gx, ga, gw = ref.add_rmsnorm_bwd(s, w, gh, g_s, add_dtype=adt)
        return (gx, gw) if ga is None else (gx, ga, gw)

    def kern_out():
        gx, ga, gw = kern()
        return (gx, gw) if ga is None else (gx, ga, gw)

    return (
        "add_rmsnorm_bwd",
        f"{label}M={m},d={d},{'x+a,gs' if add else 'x'}", kern_out, plain,
        lib, nbytes, flops, [("its_second_run", kern_out)],
        {"cold": cold_of(nbytes, lambda s, gh, w, g_s=None: (
            lambda: kern(s, gh, g_s, w), None), s, gh, w,
            *(() if g_s is None else (g_s,)))})


def backward_cases(gen, dtype):
    """Phase 14's backward kernel, K5b, at its training shapes: qwen's
    8192 rows (B 4 x S 2048) at d 1024 with the add and the residual's
    cotangent (every norm after the first), and without the add (layer
    0's ``ln1``); zamba2-2.7b's d 2560 (its layer norm, with the add)
    and 5120 (its gated norm, without)."""
    return [add_rmsnorm_bwd_case(gen, 8192, 1024, dtype, add=True,
                                 label="qwen_train,"),
            add_rmsnorm_bwd_case(gen, 8192, 1024, dtype, add=False,
                                 label="qwen_train,"),
            add_rmsnorm_bwd_case(gen, 8192, 2560, dtype, add=True,
                                 label="zamba2_ln,"),
            add_rmsnorm_bwd_case(gen, 8192, 5120, dtype, add=False,
                                 label="zamba2_gated,")]


def phase_kernels() -> dict:
    """Every kernel vs its plain version, both dtypes. Returns, per
    kernel, the bf16 numbers at its first (main-path) shape and the
    largest error seen."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen_w4 = torch.Generator(device="cuda").manual_seed(SEED + 13)
    gen_fam = torch.Generator(device="cuda").manual_seed(SEED + 18)
    gen_win = torch.Generator(device="cuda").manual_seed(SEED + 19)
    gen_rec = torch.Generator(device="cuda").manual_seed(SEED + 20)
    gen_bwd = torch.Generator(device="cuda").manual_seed(SEED + 25)
    gen_nem = torch.Generator(device="cuda").manual_seed(SEED + 29)
    t0 = time.perf_counter()
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name, case, kfn, pfn, lfn, nbytes, flops, same, *opts in (
                kernel_cases(gen, dtype) + w4_path_cases(gen_w4, dtype)
                + families_cases(gen_fam, dtype)
                + window_audio_cases(gen_win, dtype)
                + recurrent_cases(gen_rec, dtype)
                + backward_cases(gen_bwd, dtype)
                + nemotron_cases(gen_nem, dtype)):
            opts = opts[0] if opts else {}
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            for label, fn in same:
                equal = _equal(got, fn())
                log("kernels", kernel=name, case=case, dtype=dname,
                    bitwise_equal=equal, against=label)
                if not equal:
                    raise AssertionError(f"{name} {case} {dname}: not "
                                         f"bitwise equal to {label}")
            reps = opts.get("reps", 20)   # calls a timed round
            res = _compare(
                name, case, dname, got, want, ms=time_ms(kfn, reps=reps),
                plain_ms=time_ms(pfn, reps=reps),
                lib_ms=None if lfn is None else time_ms(lfn, reps=reps),
                dev_ms=device_ms(kfn, reps=reps),
                lib_dev_ms=None if lfn is None else device_ms(lfn,
                                                               reps=reps),
                nbytes=nbytes, flops=flops)
            if "cold" in opts:
                res.update(_cold(name, case, dname, *opts["cold"]()))
            if "floor" in opts:
                res.update(floor_ms=time_ms(opts["floor"]),
                           floor_device_ms=device_ms(opts["floor"]))
                log("kernels", kernel=name, case=case, dtype=dname,
                    floor_ms=res["floor_ms"],
                    floor_device_ms=res["floor_device_ms"])
            row = rows.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
            row["cases"].append({"case": case, "dtype": dname, **res})
            if dname == "bfloat16" and "ms" not in row:
                row.update({k: v for k, v in res.items()
                            if k != "max_abs_err"}, case=case)
    log("kernels", device_time_misses=device_misses,
        device_time_tries=DEVICE_TRIES,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel ops to their plain versions for a
    reference run on the card (this script's comparison only; the
    package itself never falls back)."""
    from repro_torch.kernels import ops, ref
    # ops.rmsnorm goes through ops.add_rmsnorm
    names = ("add_rmsnorm", "flash_attention", "decode_attention",
             "decode_attention_shard", "paged_decode_attention",
             "prefill_attention", "prefill_attention_shard", "quant_gemv")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def routes(replay=None):
    """The experts each MoE routing call picks, in call order: recorded
    (``replay`` None; yields the list of (N, k) ids), or replayed from
    ``replay`` — the weights are then this run's own router
    probabilities at the recorded experts, renormalised, and the yielded
    list counts, per call, the tokens whose expert set this run's own
    routing would have changed. A bf16 comparison of kernels against
    their plain versions replays the kernel run's routes: the plain
    run's rounding moves a near-tie of the top-k to another expert now
    and then, a discrete jump that says nothing of the kernels (this
    script's comparison only)."""
    import torch
    from repro_torch.models import moe as M
    route = M.route
    seen = []

    def recording(router_w, x, top_k):
        w, ids = route(router_w, x, top_k)
        seen.append(ids)
        return w, ids

    def replaying(router_w, x, top_k):
        _, own = route(router_w, x, top_k)
        ids = replay[len(seen)]
        seen.append((own.sort(-1).values != ids.sort(-1).values)
                    .any(-1).sum())
        w = torch.softmax(x.float() @ router_w, dim=-1).gather(1, ids)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids

    M.route = recording if replay is None else replaying
    try:
        yield seen
    finally:
        M.route = route


def route_flips(seen) -> int:
    return int(sum(int(n) for n in seen))


@contextlib.contextmanager
def nudged_moe_inputs(seed=SEED):
    """Every MoE layer's input moved by one ulp of its dtype, away from
    or toward zero at a seeded random choice per element (zeros stay):
    rounding noise of the size a kernel's differs from its plain
    version's, put in at every MoE layer (this script's measurement
    only)."""
    import torch
    from repro_torch.models import moe as M
    apply_moe = M.apply_moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}

    def nudged(p, cfg, x):
        up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        bits = x.contiguous().view(ints[x.dtype])
        moved = (bits + torch.where(up, 1, -1).to(bits.dtype)).view(x.dtype)
        return apply_moe(p, cfg, torch.where(x == 0, x, moved))

    M.apply_moe = nudged
    try:
        yield
    finally:
        M.apply_moe = apply_moe


# the kernels' routing flips against the plain versions' may be at most
# this many times those of the plain path under one-ulp noise at every
# MoE input (:func:`nudged_moe_inputs`)
FLIP_WITNESS_FACTOR = 2


def flip_gate(phase, picked, flips, run) -> None:
    """``picked``: the kernel run's experts per routing call; ``flips``:
    per call, the tokens whose experts the plain run's own routing moves
    while it replays them. The witness: ``run()`` through the plain
    versions, recording its experts, then again under one-ulp noise
    (:func:`nudged_moe_inputs`) replaying them. Fails past
    ``FLIP_WITNESS_FACTOR`` times the witness's flips."""
    with plain_kernels(), routes() as base:
        run()
    with plain_kernels(), nudged_moe_inputs(), routes(replay=base) as seen:
        run()
    routed = sum(int(i.shape[0]) for i in picked)
    flips, witness = route_flips(flips), route_flips(seen)
    log(phase, routing_calls=len(picked), routed_tokens=routed,
        route_flips_kernels_vs_plain=flips,
        route_flips_plain_vs_plain_one_ulp=witness,
        flip_share=f"{flips / routed:.4f}",
        witness_share=f"{witness / routed:.4f}",
        limit=f"{FLIP_WITNESS_FACTOR} x witness",
        note="each plain run replays the first run's experts")
    if flips > FLIP_WITNESS_FACTOR * witness:
        raise AssertionError(
            f"{phase}: the kernels move {flips} of {routed} routes against "
            f"the plain versions, more than {FLIP_WITNESS_FACTOR} x the "
            f"{witness} that one-ulp noise moves in the plain path")


def model_batch(toks, images=None) -> dict:
    batch = {"tokens": toks}
    if images is not None:
        batch["images"] = images
    return batch


def straight_line_generate(params, cfg, prompt, n_new, capacity):
    """Batch-1 prefill + greedy decode_step loop (the engine's oracle),
    after the engine's zero image prefix on a vlm, over its zero frames
    on whisper."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import stub_frames, stub_images
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    batch = model_batch(toks, stub_images(cfg, "cuda"))
    if cfg.family == "audio":
        batch["frames"] = stub_frames(cfg, "cuda")
    logits, cache = MD.prefill(params, cfg, batch, capacity)
    cur = torch.argmax(logits, -1)[:, None]
    out = [int(cur[0, 0])]
    for _ in range(n_new - 1):
        logits, cache = MD.decode_step(params, cfg, cur, cache)
        cur = torch.argmax(logits, -1)[:, None]
        out.append(int(cur[0, 0]))
    return out


def path_shape(cfg) -> tuple[int, int]:
    """(K5 launches per dispatch, attention layers) of ``cfg``'s path.
    A decoder of L layers: 2L + 1 RMSNorms (none on a LayerNorm model),
    L attention layers. Zamba2 (L Mamba2 layers in G groups): each
    layer's ``ln`` and gated norm, the shared block's two norms per
    group and the final norm, 2L + 2G + 1; G attention layers (the
    shared block's applications). xLSTM (n blocks): each block's two
    RMSNorms (an mLSTM's ``norm`` and ``out_norm``, an sLSTM's ``norm``
    and ``ff_norm``), 2n — its final norm is LayerNorm, in plain torch
    — and no attention."""
    from repro_torch.models import model as MD
    rms_final = 1 if cfg.norm == "rmsnorm" else 0
    if cfg.family == "hybrid":
        g = MD.n_groups(cfg)
        return 2 * cfg.n_layers + 2 * g + rms_final, g
    if cfg.family == "ssm":
        n_super, n_inner = MD.xlstm_dims(cfg)
        blocks = n_super * (n_inner + (1 if cfg.slstm_every else 0))
        return 2 * blocks + rms_final, 0
    return (2 * cfg.n_layers + 1 if rms_final else 0), cfg.n_layers


def expected_launches(eng, one: int = 1, every: int = 1
                      ) -> tuple[dict, set]:
    """(launches per kernel, the kernels that must have run) of every
    run ``eng`` has made, each one-request dispatch (a prefill or chunk,
    the draft's prefill) launching on ``one`` device and every batched
    one (a decode, a verify, a draft decode) on ``every`` — 1 on one
    device; a mesh's ranks (:func:`mesh_expected_launches`). Target
    model (:func:`path_shape`: R RMSNorms per dispatch, L attention
    layers): R RMSNorms per dispatch, L flash prefills per blocking
    prefill, L split-KV decodes (contiguous) or L paged decodes per
    decode step, L prefill-over-cache launches per chunk and per verify
    dispatch; on whisper (E encoder layers) each prefill is 2L + E flash
    launches (self, cross, encoder) and each decode step 2L split-KV
    decodes (self, cross). Draft (k layers): its :func:`path_shape`
    RMSNorms per dispatch (2k + 1, none on a LayerNorm model), k flash
    prefills per draft prefill, k split-KV decodes per draft decode (its
    shadow cache is contiguous)."""
    s = eng.summary()
    cfg = eng.cfg
    norms, n = path_shape(cfg)
    audio = cfg.family == "audio"
    k = eng.draft_cfg.n_layers if eng.draft_cfg is not None else 0
    draft_norms = path_shape(eng.draft_cfg)[0] if k else 0
    decodes = s["decode_dispatches"] - s["verify_dispatches"]
    draft_decodes = s["draft_dispatches"] - s["draft_prefills"]
    requests = s["prefills"] + s["prefill_chunk_dispatches"]
    paged = s["kv_cache"] == "paged"
    want = {
        "rmsnorm": (norms * (one * requests
                             + every * s["decode_dispatches"])
                    + draft_norms * (one * s["draft_prefills"]
                                     + every * draft_decodes)),
        "flash_attention": one * ((2 * n + cfg.n_encoder_layers if audio
                                   else n) * s["prefills"]
                                  + k * s["draft_prefills"]),
        "decode_attention": every * ((0 if paged else
                                      (2 if audio else 1) * n * decodes)
                                     + k * draft_decodes),
        "paged_decode_attention": every * n * decodes if paged else 0,
        "prefill_attention": n * (one * s["prefill_chunk_dispatches"]
                                  + every * s["verify_dispatches"]),
        "quant_gemv": 0,
    }
    # the kernels this path must have launched at least once
    path = set()
    if n:
        path.add("flash_attention" if s["prefills"] else "prefill_attention")
    if norms:
        path.add("rmsnorm")
    if s["prefill_chunk_dispatches"]:   # chunks and warm prefix admissions
        path.add("prefill_attention")
    if s["scheduler"] == "speculative":
        path |= {"decode_attention", "prefill_attention"}
    elif n:
        path.add("paged_decode_attention" if paged else "decode_attention")
    return want, path


def _launch_gate(phase, counts, want, path) -> None:
    log(phase, launches=json.dumps(counts), expected=json.dumps(want),
        path=",".join(sorted(path)))
    if counts != want or not all(counts[name] for name in path):
        raise AssertionError(f"{phase}: kernel launches {counts} != {want} "
                             f"or a kernel of {sorted(path)} never ran")


def check_launches(phase, eng, counts) -> None:
    """Every kernel of the path ran, exactly as often as the path says
    (:func:`expected_launches`)."""
    _launch_gate(phase, counts, *expected_launches(eng))


def run_engine(params, cfg, prompts, max_new, **ecfg):
    """Serve ``prompts`` on a fresh engine (8 slots, capacity 2048 unless
    ``ecfg`` says otherwise); returns (engine, counts) with the launch
    counts of exactly this run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(params, cfg, EngineConfig(
        **{"max_batch": 8, "max_seq_len": 2048, **ecfg},
        max_new_tokens=max_new))
    for p in prompts:
        eng.submit(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    keep_for_audit(eng)
    return eng, ops.launch_counts()


# engine configurations (EngineConfig fields) held to contiguous +
# blocking in the float32 gate; phase 4 serves the paged ones in bf16
CHUNK_TOKENS = 256
CHUNKED = {"scheduler": "chunked", "chunk_tokens": CHUNK_TOKENS}
SPECULATIVE = {"scheduler": "speculative", "spec_gamma": 4}
GATE_CONFIGS = {
    "paged+blocking": {"kv_cache": "paged"},
    "contiguous+chunked": CHUNKED,
    "paged+chunked": {"kv_cache": "paged", **CHUNKED},
    "contiguous+speculative": SPECULATIVE,
    "paged+speculative": {"kv_cache": "paged", **SPECULATIVE},
}


def _check_engine(phase, eng, counts, n_requests):
    s = eng.summary()
    check_launches(phase, eng, counts)
    if s["decode_dispatches"] != s["decode_steps"]:
        raise AssertionError(f"{phase}: target dispatches "
                             f"{s['decode_dispatches']} != steps "
                             f"{s['decode_steps']}")
    if s["requests"] != n_requests:
        raise AssertionError(f"{phase}: {s['requests']} of {n_requests} "
                             "requests finished")
    if s["kv_cache"] == "paged":
        target_peak = s["peak_resident_kv_bytes"] - s["draft_kv_bytes"]
        if not target_peak < s["contiguous_kv_bytes"]:
            raise AssertionError(f"{phase}: paged peak {target_peak} B not "
                                 f"below {s['contiguous_kv_bytes']} B")
    return s


def stream_gates(phase, params, cfg, prompts, label_extra=None,
                 total=None) -> dict:
    """contiguous + blocking == the batch-1 prefill + decode_step loop,
    then every GATE_CONFIGS run == contiguous + blocking (16 new tokens
    each); each engine run's launches go into ``total`` where given.
    Returns the streams they all gave (rid -> tokens)."""
    import torch
    extra = label_extra or {}
    total = {} if total is None else total
    eng, counts = run_engine(params, cfg, prompts, 16)
    s = _check_engine(phase, eng, counts, len(prompts))
    _add(total, counts)
    base = {r.rid: r.output for r in eng.finished}
    for i, p in enumerate(prompts):
        want = straight_line_generate(params, cfg, p, 16, 2048)
        log(phase, **extra, request=i, prompt_len=len(p),
            equal=base[i] == want, tokens=base[i][:8])
        if base[i] != want:
            raise AssertionError(f"{phase} request {i}: engine {base[i]} "
                                 f"!= straight-line {want}")
    log(phase, **extra, config="contiguous+blocking", requests=s["requests"],
        tokens=s["tokens"], decode_dispatches=s["decode_dispatches"],
        decode_steps=s["decode_steps"], prefills=s["prefills"],
        streams_equal=True)
    del eng
    for label, kw in GATE_CONFIGS.items():
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 16, **kw)
        s = _check_engine(f"{phase} {label}", eng, counts, len(prompts))
        _add(total, counts)
        got = {r.rid: r.output for r in eng.finished}
        log(phase, **extra, config=label, streams_equal=got == base,
            decode_dispatches=s["decode_dispatches"],
            decode_steps=s["decode_steps"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            draft_dispatches=s["draft_dispatches"],
            accepted_per_step=f"{s['accepted_tokens_per_step']:.3f}",
            peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
            contiguous_kv_bytes=s["contiguous_kv_bytes"])
        if got != base:
            raise AssertionError(f"{phase} {label}: streams {got} != "
                                 f"contiguous blocking {base}")
        del eng
    return base


def gate_prompts(cfg):
    """Phase 3's traffic: 4 seeded prompts of 17–1000 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (17, 200, 511, 1000)]


def phase_engine_f32() -> dict:
    """Phase 3; returns the gated streams (phase 10 holds the cluster to
    them)."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = qwen_f32_cfg()
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    with auditing("engine_f32"):
        return stream_gates("engine_f32", params, cfg, gate_prompts(cfg))


def _first_logits(params, cfg, prompt, chunk, images=None):
    """The prompt's logits through bucketed prefill and through chunked
    prefill over a one-slot contiguous cache (the engine's route); a
    vlm's ``images`` go before the prompt, in the first chunk."""
    import numpy as np
    import torch
    from repro_torch.models import model as MD
    n = len(prompt)
    pre = 0 if images is None else images.shape[1]
    nb = 16
    while nb < n:
        nb *= 2
    toks = np.zeros((1, nb), np.int32)
    toks[0, :n] = prompt
    whole, _ = MD.prefill(
        params, cfg, model_batch(torch.as_tensor(toks, device="cuda"), images),
        None, logit_index=pre + n - 1)
    cache = MD.init_cache(cfg, 1, 2048, device="cuda")
    done = 0
    while done < n:
        m = min(chunk, n - done)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :m] = prompt[done:done + m]
        first = done == 0 and images is not None
        at = done + (pre if done else 0)     # the chunk's first position
        rows = m + (pre if first else 0)
        logits, ks, vs = MD.prefill_chunk(
            params, cfg,
            model_batch(torch.as_tensor(toks, device="cuda"),
                        images if first else None),
            cache["k"], cache["v"], at, logit_index=rows - 1)
        cache["k"][:, :, at:at + rows] = ks[:, :, :rows]
        cache["v"][:, :, at:at + rows] = vs[:, :, :rows]
        done += m
    return whole, logits


def logit_gates(phase, params, cfg, prompt, images=None) -> None:
    """The first prefill's logits, whole and chunked, through the kernels
    against the plain versions: normwise <= 3e-2, same argmax. An MoE
    model's plain run takes the kernel run's routes (:func:`routes`),
    and the tokens whose experts its own routing would have moved are
    held to :func:`flip_gate`."""
    def first():
        return _first_logits(params, cfg, prompt, CHUNK_TOKENS, images)

    with routes() as picked:
        got = first()
    with plain_kernels(), routes(replay=picked) as flips:
        want = first()
    for what, g, w in (("prefill", got[0], want[0]),
                       ("chunked_prefill", got[1], want[1])):
        _logit_gate(f"{phase} {what}", g, w)
        log(phase, logits=what, prompt_len=len(prompt),
            image_prefix=0 if images is None else images.shape[1],
            chunk=CHUNK_TOKENS,
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            rel_err=f"{((g - w).norm() / w.norm()).item():.3e}",
            tol=TOL["bfloat16"], argmax_equal=True)
    if picked:
        flip_gate(phase, picked, flips, first)


def serve_prompts(cfg):
    """Phase 4's traffic: 16 seeded prompts of 32–1024 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in rng.integers(32, 1025, size=16)]


def serve_bf16(phase, params, cfg, prompts, card, total) -> None:
    """The 16 requests (64 new tokens each) on contiguous + blocking,
    paged + chunked and paged + speculative, each checked (launches,
    dispatches, requests, paged KV) and reported; adds the launches to
    ``total``."""
    import torch
    run_engine(params, cfg, prompts[:2], 4)  # warm-up (allocator, cuBLAS)
    for label in ("contiguous+blocking", "paged+chunked",
                  "paged+speculative"):
        kw = GATE_CONFIGS.get(label, {})
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 64, **kw)
        s = _check_engine(f"{phase} {label}", eng, counts, 16)
        SERVED[phase, label] = s
        for r in eng.finished:
            if len(r.output) != 64:
                raise AssertionError(f"{phase} {label} request {r.rid}: "
                                     f"{len(r.output)} tokens")
        log(phase, config=label, requests=s["requests"],
            tokens=s["tokens"], tok_per_s=f"{s['tokens_per_s']:.1f}",
            ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
            ttft_p99_ms=f"{s['ttft_p99_s'] * 1e3:.1f}",
            itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
            itl_p99_ms=f"{s['itl_p99_s'] * 1e3:.2f}",
            decode_steps=s["decode_steps"], prefills=s["prefills"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            verify_dispatches=s["verify_dispatches"],
            draft_dispatches=s["draft_dispatches"],
            acceptance=f"{s['accepted_tokens_per_step']:.3f}",
            peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
            draft_kv_bytes=s["draft_kv_bytes"],
            contiguous_kv_bytes=s["contiguous_kv_bytes"],
            launches=json.dumps(counts), card=f"'{card}'")
        _add(total, counts)
        del eng


def phase_engine_bf16(card: str) -> dict:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{ARCH} serves in {cfg.dtype}, not bfloat16")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    # the first prefill, whole and chunked, through the kernels and
    # through the plain versions
    logit_gates("engine_bf16", params, cfg, prompts[0])
    total: dict = {}
    with auditing("engine_bf16"):
        serve_bf16("engine_bf16", params, cfg, prompts, card, total)
    return total


# ---------------------------------------------------------------------------
# phase 5: the W4A16 mobile decode path at full width
# ---------------------------------------------------------------------------

W4_ARCH = "phi3-mini-3.8b"
W4_GROUP = 128
W4_PROMPT = 512
W4_CAPACITY = 1024
W4_STEPS = 16


def _logit_gate(what, got, want) -> float:
    """Normwise relative error of ``got`` against ``want`` within the
    bf16 tolerance, and the same argmax in every row."""
    import torch
    rel = ((got - want).norm() / want.norm()).item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not (rel <= TOL["bfloat16"] and same):
        raise AssertionError(f"{what}: relative error {rel:.3e} (tolerance "
                             f"{TOL['bfloat16']}), argmax equal {same}")
    return rel


def phase_w4(card: str) -> dict:
    """Full-width phi3-mini-3.8b in bf16 (seeded weights), every
    projection quantized to int4 at group 128: a 512-token prefill at
    capacity 1024, then 16 teacher-forced steps of the W16
    ``decode_step`` beside ``w4_decode_step``, through
    ``examples/torch_w4_mobile_decode.py``. Gates: the prefill logits
    and every W4 step's logits against the same run through the plain
    versions, and the exact launches of each W4 step. Returns the launch
    counts of the prefill and the teacher-forced run."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO / "examples"))
    import torch_w4_mobile_decode as tw4
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.models import w4
    cfg = registry.get_config(W4_ARCH)
    if cfg.dtype != "bfloat16" or cfg.d_head != 96:
        raise AssertionError(f"{W4_ARCH}: dtype {cfg.dtype}, Dh "
                             f"{cfg.d_head}; expected bfloat16 and 96")
    n = cfg.n_layers
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    qp = w4.quantize_params(params, W4_GROUP)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    packed = scales = dense = 0
    for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            packed += qp["layers"][sub][name]["packed"].numel()
            scales += qp["layers"][sub][name]["scales"].numel() * 4
            dense += params["layers"][sub][name].numel() * 2
    log("w4", arch=W4_ARCH, layers=n, d_model=cfg.d_model,
        heads=cfg.n_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, group=W4_GROUP, quantize_s=f"{quant_s:.1f}",
        packed_bytes=packed, scale_bytes=scales, bf16_proj_bytes=dense,
        proj_byte_ratio=f"{dense / (packed + scales):.3f}")

    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(1, W4_PROMPT)),
        dtype=torch.int32, device="cuda")
    batch = {"tokens": prompt}
    with plain_kernels():
        want, _ = MD.prefill(params, cfg, batch, None)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits, cache = MD.prefill(params, cfg, batch, W4_CAPACITY)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    want_prefill = {k: 0 for k in total} | {"flash_attention": n,
                                            "rmsnorm": 2 * n + 1}
    if total != want_prefill:
        raise AssertionError(f"w4 prefill launches {total} != "
                             f"{want_prefill}")
    rel = _logit_gate("w4 bf16 prefill logits", logits, want)
    log("w4", logits="prefill", prompt_len=W4_PROMPT, rel_err=f"{rel:.3e}",
        tol=TOL["bfloat16"], argmax_equal=True,
        launches=json.dumps(total))

    tw4.teacher_forced(params, qp, cfg, logits, cache, 2, W4_GROUP)  # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = tw4.teacher_forced(params, qp, cfg, logits, cache, W4_STEPS,
                             W4_GROUP)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    per_step = {k: 0 for k in counts} | {"quant_gemv": 7 * n,
                                         "rmsnorm": 2 * n + 1,
                                         "decode_attention": n}
    want_run = {k: 0 for k in counts} | {
        "quant_gemv": 7 * n * W4_STEPS,
        "rmsnorm": (2 * n + 1) * 2 * W4_STEPS,
        "decode_attention": n * 2 * W4_STEPS}
    log("w4", launches=json.dumps(counts), expected=json.dumps(want_run),
        per_w4_step=json.dumps(res["w4_launches"][0]),
        expected_per_w4_step=json.dumps(per_step))
    if counts != want_run or any(c != per_step for c in res["w4_launches"]):
        raise AssertionError(f"w4: launches {counts} != {want_run}, or a "
                             f"W4 step's launches != {per_step}")
    with plain_kernels():
        plain = tw4.teacher_forced(params, qp, cfg, logits, cache, W4_STEPS,
                                   W4_GROUP, tokens=res["tokens"])
    corr, mad = [], []
    for i in range(W4_STEPS):
        c, m = tw4.fidelity(res["w16"][i], res["w4"][i])
        corr.append(c)
        mad.append(m)
        rel = _logit_gate(f"w4 step {i} logits", res["w4"][i],
                          plain["w4"][i])
        rel16 = ((res["w16"][i] - plain["w16"][i]).norm()
                 / plain["w16"][i].norm()).item()
        log("w4", step=i, token=int(res["tokens"][i][0, 0]),
            corr=f"{c:.4f}", max_abs_dlogprob=f"{m:.4f}",
            w16_ms=f"{res['w16_ms'][i]:.2f}", w4_ms=f"{res['w4_ms'][i]:.2f}",
            w4_vs_plain_rel_err=f"{rel:.3e}",
            w16_vs_plain_rel_err=f"{rel16:.3e}")
    log("w4", steps=W4_STEPS, min_corr=f"{min(corr):.4f}",
        max_abs_dlogprob=f"{max(mad):.4f}",
        w16_ms_median=f"{statistics.median(res['w16_ms']):.2f}",
        w4_ms_median=f"{statistics.median(res['w4_ms']):.2f}",
        w4_plain_ms_median=f"{statistics.median(plain['w4_ms']):.2f}",
        tol=TOL["bfloat16"], card=f"'{card}'")
    for name, c in counts.items():
        total[name] += c
    return total


# ---------------------------------------------------------------------------
# phase 6: the serving engine's request surface at full width
# ---------------------------------------------------------------------------

QUANTUM = 0.01          # virtual seconds per engine step (trace replay)
CHAT_TTFT_SLO = 0.04    # the overload trace's chat TTFT target
PREAMBLE = 512          # shared-prefix run: 32 blocks of 16
BS = 16
# the trace replays phase 12a holds the simulator's schedule mirror to:
# phases 6 and 10 append {label, cfg, trace, rep, kw (serve(trace=)'s
# engine settings), cluster (the cluster's own counters, or absent)}
MIRRORED: list = []
# phase 4's serving summaries by (phase, config), and 11c's profiled
# decode step, for phase 12c
SERVED: dict = {}
PROFILED_STEP: dict = {}


def counted(fn):
    """(fn(), the kernel launches fn made), the counts reset just before
    and read just after."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def _add(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def _engine(params, cfg, telemetry=None, **kw):
    from repro_torch.serving import EngineConfig, ServingEngine
    kw.setdefault("eos_token", -1)
    return ServingEngine(params, cfg, EngineConfig(**kw),
                         telemetry=telemetry)


def _outputs(eng) -> dict:
    return {r.rid: r.output for r in eng.finished}


def _pool_balanced(what, kv) -> None:
    """Every alias released, every block free or a resident shared one."""
    if kv.name != "paged":
        return
    prefix = kv.prefix
    shared = prefix.resident_blocks if prefix is not None else 0
    refs = list(prefix._refs.values()) if prefix is not None else []
    if (any(refs) or kv.allocator.allocated_blocks != shared
            or kv.allocator.free_blocks + shared != kv.allocator.num_blocks
            or kv._reserved.any()):
        raise AssertionError(
            f"{what}: pool unbalanced — free {kv.allocator.free_blocks} + "
            f"shared {shared} vs {kv.allocator.num_blocks} blocks, "
            f"allocated {kv.allocator.allocated_blocks}, refcounts "
            f"{sorted(set(refs))}, reserved {int(kv._reserved.sum())}")


def _shared_blocks(a, b, bs=BS) -> int:
    """Leading 16-token blocks of ``a`` equal to ``b``'s, capped where
    the prefix index caps a match of ``a`` against registered ``b``."""
    n = min((len(a) - 1) // bs, len(b) // bs)
    k = 0
    while k < n and (a[k * bs:(k + 1) * bs] == b[k * bs:(k + 1) * bs]).all():
        k += 1
    return k


def slo_runs(params, cfg, total) -> dict:
    """The overload trace under FIFO (blocking) and SLO on both backends,
    max_batch 4, capacity 96 (the reference test's engine)."""
    from repro_torch.serving.workload import make_named_trace, replay
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=SEED)
    reps = {}
    for kv in ("paged", "contiguous"):
        for sched in ("blocking", "slo"):
            eng = _engine(params, cfg, max_batch=4, max_seq_len=96,
                          max_new_tokens=16, scheduler=sched, kv_cache=kv)
            rep, counts = counted(lambda: replay(eng, tr,
                                                 step_quantum_s=QUANTUM))
            MIRRORED.append(dict(label=f"overload {kv}+{sched}", cfg=cfg,
                                 trace=tr, rep=rep,
                                 kw=dict(scheduler=sched, kv_cache=kv)))
            if sched == "slo":
                keep_for_audit(eng)
            check_launches(f"request_surface slo {kv}+{sched}", eng, counts)
            _pool_balanced(f"overload {kv}+{sched}", eng.kv)
            _add(total, counts)
            reps[kv, sched] = rep
            s = rep["summary"]
            chat = s["by_tenant"]["chat"]
            log("request_surface", run=f"overload {kv}+{sched}",
                requests=len(tr), steps=rep["steps"], tokens=rep["tokens"],
                preemptions=s["preemptions"],
                preempted_kv_bytes=s["preempted_kv_bytes"],
                chat_ttft_p99_s=f"{chat['ttft_p99_s']:.4f}",
                chat_slo_attainment=f"{chat['slo_attainment']:.3f}",
                tokens_per_step=f"{rep['tokens'] / rep['steps']:.4f}")
    base = reps["contiguous", "blocking"]["outputs"]
    for kv in ("paged", "contiguous"):
        fifo, slo = reps[kv, "blocking"], reps[kv, "slo"]
        ratio = ((slo["tokens"] / slo["steps"])
                 / (fifo["tokens"] / fifo["steps"]))
        p99 = (slo["summary"]["by_tenant"]["chat"]["ttft_p99_s"],
               fifo["summary"]["by_tenant"]["chat"]["ttft_p99_s"])
        log("request_surface", gate=f"slo {kv}",
            slo_streams_equal_fifo=slo["outputs"] == fifo["outputs"],
            equal_contiguous_fifo=fifo["outputs"] == base,
            preemptions=slo["summary"]["preemptions"],
            chat_p99_slo_fifo=f"{p99[0]:.4f},{p99[1]:.4f}",
            throughput_ratio=f"{ratio:.4f}")
        if not (slo["outputs"] == fifo["outputs"] == base
                and slo["summary"]["preemptions"] >= 1
                and len(slo["preemption_log"])
                == slo["summary"]["preemptions"]
                and p99[0] <= CHAT_TTFT_SLO < p99[1] and ratio >= 0.95):
            raise AssertionError(f"SLO gate on {kv}: streams equal "
                                 f"{slo['outputs'] == fifo['outputs']}, "
                                 f"preemptions "
                                 f"{slo['summary']['preemptions']}, chat "
                                 f"p99 {p99}, throughput ratio {ratio}")
    return reps


def _drive_staged(eng, prompts):
    """Prompt 0 alone until its prefill is done (its blocks registered
    with prefix caching on), then the rest; run to the end."""
    eng.submit(prompts[0])
    while eng.waiting or eng.prefilling:
        eng.step()
    for p in prompts[1:]:
        eng.submit(p)
    eng.run()


def prefix_runs(params, cfg, total) -> None:
    """8 requests sharing a 512-token preamble with 32–256-token tails,
    prefix caching on against off, blocking and chunked (256), and the
    sharedprefix trace on a 6-block pool, on the paged backend."""
    import numpy as np
    from repro_torch.serving.workload import make_named_trace, replay
    rng = np.random.default_rng(SEED + 6)
    pre = rng.integers(0, cfg.vocab_size, size=PREAMBLE)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=n)]).astype(np.int32)
               for n in rng.integers(32, 257, size=8)]
    runs = {}
    for sched, kw in (("blocking", {}), ("chunked", CHUNKED)):
        for on in (False, True):
            eng = _engine(params, cfg, max_batch=8, max_seq_len=2048,
                          max_new_tokens=32, kv_cache="paged",
                          kv_block_size=BS, prefix_cache=on,
                          **{"scheduler": sched, **kw})
            _, counts = counted(lambda: _drive_staged(eng, prompts))
            if on:
                keep_for_audit(eng, "prefix")
            check_launches(f"request_surface prefix {sched} on={on}", eng,
                           counts)
            _pool_balanced(f"prefix {sched} on={on}", eng.kv)
            _add(total, counts)
            runs[sched, on] = (eng.summary(), _outputs(eng), counts)
        # the host's own block-aligned matches: blocking admits (and
        # registers) one request after another; chunked binds requests
        # 1..7 together, when only request 0's blocks are registered
        earlier = (lambda i: range(i)) if sched == "blocking" else (
            lambda i: range(min(i, 1)))
        want = sum(max([_shared_blocks(prompts[i], prompts[j])
                        for j in earlier(i)] or [0]) * BS
                   for i in range(len(prompts)))
        (off_s, off_o, off_c), (on_s, on_o, on_c) = (runs[sched, False],
                                                     runs[sched, True])
        log("request_surface", gate=f"prefix {sched}",
            streams_equal=on_o == off_o, prefix_hits=on_s["prefix_hits"],
            prefix_hit_tokens=on_s["prefix_hit_tokens"],
            host_hit_tokens=want,
            prefix_hit_rate=f"{on_s['prefix_hit_rate']:.4f}",
            k3_prefills_off_on=f"{off_s['prefills']},{on_s['prefills']}",
            chunk_dispatches_off_on=(f"{off_s['prefill_chunk_dispatches']},"
                                     f"{on_s['prefill_chunk_dispatches']}"),
            prefill_dispatches_saved=(
                off_s["prefills"] + off_s["prefill_chunk_dispatches"]
                - on_s["prefills"] - on_s["prefill_chunk_dispatches"]),
            k4_launches_off_on=(f"{off_c['prefill_attention']},"
                                f"{on_c['prefill_attention']}"),
            resident_shared_kv_bytes=on_s["resident_shared_kv_bytes"])
        if not (on_o == off_o and on_s["prefix_hit_tokens"] == want > 0):
            raise AssertionError(f"prefix {sched}: streams equal "
                                 f"{on_o == off_o}, hit tokens "
                                 f"{on_s['prefix_hit_tokens']} != {want}")
    if runs["chunked", True][1] != runs["blocking", True][1]:
        raise AssertionError("prefix: chunked streams != blocking streams")
    tr = make_named_trace("sharedprefix", vocab_size=cfg.vocab_size, seed=1)
    outs = {}
    for on in (False, True):
        eng = _engine(params, cfg, max_batch=4, max_seq_len=96,
                      max_new_tokens=16, kv_cache="paged", kv_block_size=BS,
                      kv_blocks=6, prefix_cache=on)
        rep, counts = counted(lambda: replay(eng, tr, step_quantum_s=QUANTUM))
        MIRRORED.append(dict(label=f"sharedprefix on={on}", cfg=cfg, trace=tr,
                             rep=rep, kw=dict(kv_cache="paged",
                                              kv_block_size=BS, kv_blocks=6,
                                              prefix_cache=on)))
        check_launches(f"request_surface sharedprefix on={on}", eng, counts)
        _pool_balanced(f"sharedprefix on={on}", eng.kv)
        _add(total, counts)
        outs[on] = rep["outputs"]
        s = rep["summary"]
        log("request_surface", run=f"sharedprefix on={on}", requests=len(tr),
            steps=rep["steps"], prefix_hits=s["prefix_hits"],
            prefix_hit_tokens=s["prefix_hit_tokens"],
            prefix_evictions=s["prefix_evictions"],
            ttft_p99_s=f"{s['ttft_p99_s']:.4f}")
    if outs[True] != outs[False]:
        raise AssertionError("sharedprefix: streams differ with prefix "
                             "caching on")


# the reference test's fixed preemption plans (an entry per engine step:
# None, or the index among live slots of the victim)
PLANS = ((), (0,) * 24, (None, 1, None, 0, 3, None, 2) * 3,
         (None, None, None, 1, 1, 1, 1, 1))


def _drive_plan(eng, prompts, plan):
    for p in prompts:
        eng.submit(p)
    it = 0
    while eng.has_work():
        if it >= 500:
            raise AssertionError("preemption interleaving did not drain")
        live = [i for i, r in enumerate(eng.slot_req) if r is not None]
        if live and it < len(plan) and plan[it] is not None:
            eng.preempt_slot(live[plan[it] % len(live)])
        eng.step()
        it += 1


def interleaving_runs(params, cfg, total) -> None:
    """The four fixed preemption plans, paged with prefix caching on
    (8-block pool, 2 slots): streams equal to a run with no preemption
    and no prefix caching; no leak."""
    import numpy as np
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab_size, size=3 * BS)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, size=n)])
               for n in (4, 7, 9, 12, 5)]
    kw = dict(max_batch=2, max_seq_len=96, max_new_tokens=5,
              kv_cache="paged", kv_block_size=BS)
    ref = _engine(params, cfg, **kw)
    _, counts = counted(lambda: _drive_plan(ref, prompts, ()))
    _add(total, counts)
    want = _outputs(ref)
    for k, plan in enumerate(PLANS):
        eng = _engine(params, cfg, prefix_cache=True, kv_blocks=8, **kw)
        _, counts = counted(lambda: _drive_plan(eng, prompts, plan))
        check_launches(f"request_surface plan {k}", eng, counts)
        _pool_balanced(f"plan {k}", eng.kv)
        _add(total, counts)
        got = _outputs(eng)
        log("request_surface", plan=k, preemptions=eng.preemptions,
            streams_equal=got == want,
            prefix_hits=eng.summary()["prefix_hits"])
        if got != want:
            raise AssertionError(f"plan {k}: {got} != {want}")


def export_import_bf16(params, cfg) -> None:
    """A bf16 ``export_slot`` -> ``import_slot`` into another slot gives
    rows ``torch.equal`` to the originals, on both backends and across
    them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, cfg.vocab_size, size=300).astype(np.int32)
    engines = {}
    for kv in ("paged", "contiguous"):
        eng = _engine(params, cfg, max_batch=4, max_seq_len=2048,
                      max_new_tokens=64, kv_cache=kv)
        eng.submit(prompt)
        for _ in range(5):
            eng.step()
        engines[kv] = eng
    for src, dst in (("paged", "paged"), ("contiguous", "contiguous"),
                     ("paged", "contiguous"), ("contiguous", "paged")):
        a, b = engines[src], engines[dst]
        n = int(a.slot_pos[0])
        pkt = a.kv.export_slot(0, n)
        slot = 3 if dst == src else 2
        b.kv.import_slot(pkt, slot, len(prompt), 64)
        back = b.kv.export_slot(slot, n)
        same = all(torch.equal(pkt[x][:, :, :n], back[x][:, :, :n])
                   for x in ("k", "v"))
        log("request_surface", export_import=f"{src}->{dst}",
            dtype=str(pkt["k"].dtype), positions=n,
            kv_bytes=pkt["kv_bytes"], rows_equal=same)
        if not same or pkt["k"].dtype != torch.bfloat16:
            raise AssertionError(f"bf16 export {src} -> import {dst}: rows "
                                 f"equal {same}, dtype {pkt['k'].dtype}")
        b.kv.free(slot)


def sampled(params, cfg, prompts, seed, plan=(), total=None):
    eng = _engine(params, cfg, max_batch=4, max_seq_len=2048,
                  max_new_tokens=16, kv_cache="paged", sample="temperature",
                  temperature=0.8, top_k=50, seed=seed)
    _, counts = counted(lambda: _drive_plan(eng, prompts, plan))
    check_launches(f"request_surface sampled seed={seed}", eng, counts)
    _add(total, counts)
    return eng


def cuda_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def sampling_runs(params, cfg, total) -> None:
    """Temperature 0.8, top-k 50 on bf16 paged: the same seed twice, the
    same seed under a preemption plan, another seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 130, 260, 75, 500, 20)]
    a = sampled(params, cfg, prompts, 7, total=total)
    b = sampled(params, cfg, prompts, 7, total=total)
    c = sampled(params, cfg, prompts, 7, plan=PLANS[2], total=total)
    d = sampled(params, cfg, prompts, 8, total=total)
    oa, ob, oc, od = (_outputs(e) for e in (a, b, c, d))
    logits = torch.randn(4, cfg.vocab_size, device="cuda")
    per_step = cuda_kernels(lambda: a._sample(
        logits, a.slot_seed, a.slot_rid, a.slot_pos))
    log("request_surface", sampling="temperature=0.8 top_k=50",
        same_seed_equal=oa == ob, preempted_equal=oa == oc,
        preemptions=c.preemptions, other_seed_differs=oa != od,
        sampler_kernels_per_step=per_step,
        sample_calls_per_decode_step=1)
    if not (oa == ob == oc and oa != od and c.preemptions >= 1):
        raise AssertionError(f"sampling: same seed {oa == ob}, preempted "
                             f"{oa == oc} ({c.preemptions}), other seed "
                             f"differs {oa != od}")


def telemetry_runs(params, cfg, total) -> None:
    """Greedy float32, paged + chunked: telemetry on gives the tokens of
    the run with it off; the trace validates and every dispatch joins."""
    import numpy as np
    from repro_torch.serving import (Telemetry, join_coverage,
                                     validate_trace_events)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (17, 200, 511, 1000)]
    outs = []
    for tel in (None, Telemetry()):
        eng = _engine(params, cfg, telemetry=tel, max_batch=8,
                      max_seq_len=2048, max_new_tokens=16, kv_cache="paged",
                      **CHUNKED)
        for p in prompts:
            eng.submit(p)
        _, counts = counted(eng.run)
        check_launches(f"request_surface telemetry={tel is not None}", eng,
                       counts)
        _add(total, counts)
        outs.append(_outputs(eng))
    problems = [validate_trace_events(tel.tracer.trace_events(clock=c))
                for c in ("wall", "virtual")]
    joined = join_coverage(eng, tel)
    slow = ", ".join(f"{sp.name}:{sp.wall_dur_s * 1e3:.2f}ms"
                     for sp in tel.tracer.slowest(5))
    log("request_surface", telemetry="on vs off",
        tokens_equal=outs[0] == outs[1], trace_problems=sum(map(len, problems)),
        join_coverage=f"{joined[0]}/{joined[1]}",
        spans=len(tel.tracer.spans), slowest=f"'{slow}'")
    if not (outs[0] == outs[1] and problems == [[], []]
            and joined[0] == joined[1] > 0):
        raise AssertionError(f"telemetry: tokens equal {outs[0] == outs[1]},"
                             f" trace problems {problems}, join {joined}")


def admission_device_ms(params, cfg) -> None:
    """bf16 device time of one cold admission (512-token preamble + 64-
    token tail: a 1024-bucket prefill, K3) against one warm admission of
    the same preamble with another tail (a 64-token chunk over the 512
    shared positions, K4), each admission alone under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 9)
    eng = _engine(params, cfg, max_batch=1, max_seq_len=2048,
                  max_new_tokens=2, kv_cache="paged", prefix_cache=True)

    def admit_ms(prompt):
        """(device ms, the five kernels with the most device time)."""
        eng.submit(prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.scheduler.admit(eng)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in rows)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
        eng.run()
        return (us / 1e3 if us > 0 else None,
                "; ".join(f"{e.key[:48]} x{e.count} "
                          f"{e.self_device_time_total / 1e3:.4f}"
                          for e in top))

    cold, warm = [], []
    for rep in range(4):          # rep 0 warms the allocator and cuBLAS
        pre = rng.integers(0, cfg.vocab_size, size=PREAMBLE)
        tails = rng.integers(0, cfg.vocab_size, size=(2, 64))
        c = admit_ms(np.concatenate([pre, tails[0]]).astype(np.int32))
        w = admit_ms(np.concatenate([pre, tails[1]]).astype(np.int32))
        if rep:
            cold.append(c)
            warm.append(w)
    s = eng.summary()
    log("request_surface", admission="bf16 cold vs warm, 512 + 64 tokens",
        cold_device_ms=",".join(f"{x:.4f}" if x else "none"
                                for x, _ in cold),
        warm_device_ms=",".join(f"{x:.4f}" if x else "none"
                                for x, _ in warm),
        prefix_hits=s["prefix_hits"], prefills=s["prefills"],
        chunk_dispatches=s["prefill_chunk_dispatches"])
    for what, runs in (("cold", cold), ("warm", warm)):
        log("request_surface", admission_top_kernels=what,
            ms=f"'{runs[-1][1]}'")
    if s["prefix_hits"] != 4 or s["prefills"] != 4:
        raise AssertionError(f"admission timing: {s['prefix_hits']} warm, "
                             f"{s['prefills']} cold admissions of 4 each")


def phase_request_surface(card: str) -> dict:
    """Full-width qwen1.5-0.5b (``QWEN_F32_LAYERS`` deep in float32,
    ``QWEN_CUT_LAYERS`` in bf16): SLO preemption, prefix caching,
    preemption interleavings and telemetry in float32 (the conditions of
    phase 3's gates); sampling, export/import and admission device time
    in bf16. Returns the launch counts of its engine runs."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    t0 = time.perf_counter()
    total: dict = {}
    cfg = qwen_f32_cfg()
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    with auditing("request_surface"):
        slo_runs(params, cfg, total)
        prefix_runs(params, cfg, total)
    interleaving_runs(params, cfg, total)
    telemetry_runs(params, cfg, total)
    del params
    torch.cuda.empty_cache()
    cfg = registry.get_config(ARCH).replace(n_layers=QWEN_CUT_LAYERS)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    export_import_bf16(params, cfg)
    sampling_runs(params, cfg, total)
    admission_device_ms(params, cfg)
    log("request_surface", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 7: the MoE and vlm families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "internvl2-26b")
# the bf16 runs of phases 7b, 8b and 9b cut these models' depth for the
# run's time (full width; the rest run at full depth): deepseek its dense
# layer and 7 MoE layers of 27, internvl2 12 of 48, mistral 8 of 32,
# zamba2 3 of its 9 groups of 6, xlstm one of its 3 super-blocks
BF16_LAYERS = {"deepseek-moe-16b": 8, "internvl2-26b": 12, "mistral-7b": 8,
               "zamba2-2.7b": 18, "xlstm-350m": 8}
# qwen's depth in the bf16 cluster (10b) and mesh (13c) runs, which hold
# themselves to engines of the same depth (cut for the run's time)
QWEN_CUT_LAYERS = 8


def bf16_cfg(arch):
    """The full-width bf16 config of ``arch`` at its ``BF16_LAYERS``
    depth."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    return cfg.replace(n_layers=BF16_LAYERS.get(arch, cfg.n_layers))
GATED: dict = {}       # arch -> 7a's gated float32 streams (phase 13)
GATE_LAYERS = 4        # 7a's depth: deepseek keeps its dense layer 0
DBRX_LAYERS = 2        # 7c's depth
STEP_SECONDS = 420     # each step of phase 7 ends the process past this


@contextlib.contextmanager
def step_deadline(seconds=STEP_SECONDS):
    """SIGALRM's default action ends the process: a hung kernel costs
    minutes, not the call."""
    import signal
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)


def dropless(cfg):
    """``cfg`` at capacity factor E / k, where no dispatch can drop a
    routed slot (every expert's capacity is the token count)."""
    return cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)


@contextlib.contextmanager
def _drop_wrappers(record):
    """Wrappers around the port's ``moe.apply_moe`` and the engine's
    ``_dispatch`` (this script's measurement only; the outputs are the
    unwrapped ones) that call ``record(kind, dispatch number, count)``
    with the routed slots each MoE layer drops past its experts'
    capacity (a device tensor). On a mesh a data replica's rows count at
    their places in the whole dispatch (the capacity and slot offsets
    ``apply_moe`` takes) — on the rank of model index 0 of each replica
    where the rows split over data, else on the call's first rank (every
    rank of a replica, or of the mesh, computes the same rows) — so the
    counts add up as one device's."""
    import threading
    from repro_torch.distributed import hints as H
    from repro_torch.models import moe as M
    from repro_torch.serving import engine as E
    seq = [0, None]   # the dispatch's number and kind
    lock = threading.Lock()
    apply_moe, dispatch = M.apply_moe, E.ServingEngine._dispatch

    def counts_here():
        mesh = H.current_mesh()
        if mesh is None:
            return True
        rank = mesh.rank()
        if H.data_ranks() > 1:
            return mesh.coords(rank)[-1] == 0
        return rank == min(mesh.current_call().ranks)

    def counted(p, cfg, x):
        xf = x.reshape(-1, x.shape[-1])
        _, ids = M.route(p["router"], xf, cfg.moe_top_k)
        pos = (M.slot_positions(ids, cfg.n_experts)
               + H.slot_offsets(ids, cfg.n_experts))
        cap = M._capacity(xf.shape[0] * H.data_ranks(), cfg)
        if counts_here():
            with lock:
                record(seq[1], seq[0], (pos >= cap).sum())
        return apply_moe(p, cfg, x)

    def tagged(self, kind, *args):
        seq[0], seq[1] = seq[0] + 1, kind
        return dispatch(self, kind, *args)

    M.apply_moe, E.ServingEngine._dispatch = counted, tagged
    try:
        yield
    finally:
        M.apply_moe, E.ServingEngine._dispatch = apply_moe, dispatch


@contextlib.contextmanager
def counting_drops():
    """Routed slots dropped past an expert's capacity, per dispatch kind,
    while the engine runs (:func:`_drop_wrappers`). Yields {kind: [count
    tensors]}."""
    drops: dict = {}
    with _drop_wrappers(lambda kind, _, n: drops.setdefault(kind,
                                                             []).append(n)):
        yield drops


@contextlib.contextmanager
def counting_dispatch_drops():
    """{dispatch number: routed slots dropped} while an engine runs, its
    MoE layers summed (:func:`_drop_wrappers`, on one device or a mesh);
    summed on the host once the run is over: yields a dict filled at
    exit."""
    parts: dict = {}
    out: dict = {}
    try:
        with _drop_wrappers(lambda _, i, n: parts.setdefault(i,
                                                              []).append(n)):
            yield out
    finally:
        out.update({i: sum(int(t.item()) for t in v)
                    for i, v in parts.items()})


def drop_runs(params, cfg, prompts, total) -> None:
    """7a at the config's capacity factor: every gate configuration with
    its dropped slots per dispatch kind; only paged + blocking ==
    contiguous + blocking is gated (the same dispatch shapes)."""
    import torch
    runs = {}
    for label, kw in {"contiguous+blocking": {}, **GATE_CONFIGS}.items():
        torch.cuda.empty_cache()
        with counting_drops() as drops:
            eng, counts = run_engine(params, cfg, prompts, 16, **kw)
        _check_engine(f"families_f32 {label}", eng, counts, len(prompts))
        _add(total, counts)
        runs[label] = {r.rid: r.output for r in eng.finished}
        log("families_f32", arch=cfg.name, depth=cfg.n_layers,
            capacity_factor=cfg.moe_capacity_factor, config=label,
            gated=label == "paged+blocking",
            equal_to_blocking=runs[label] == runs["contiguous+blocking"],
            dropped_slots=json.dumps({k: int(sum(v).item())
                                      for k, v in drops.items()}),
            moe_calls=json.dumps({k: len(v) for k, v in drops.items()}))
        del eng
    if runs["paged+blocking"] != runs["contiguous+blocking"]:
        raise AssertionError(f"{cfg.name} at capacity factor "
                             f"{cfg.moe_capacity_factor}: paged + blocking "
                             "!= contiguous + blocking")


def phase_families_f32() -> dict:
    """7a: float32 stream gates at full width, 4 layers deep — for MoE at
    capacity factor E / k, then the same runs at the config's."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    total: dict = {}
    for arch in FAMILY_ARCHS:
        with step_deadline():
            cfg = registry.get_config(arch).replace(dtype="float32",
                                                    n_layers=GATE_LAYERS)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            prompts = gate_prompts(cfg)
            gate_cfg, extra = cfg, {"arch": arch, "depth": GATE_LAYERS}
            if cfg.is_moe:
                gate_cfg = dropless(cfg)
                extra["capacity_factor"] = \
                    f"{gate_cfg.moe_capacity_factor:.4g}"
            with counting_drops() as drops:
                GATED[arch] = stream_gates("families_f32", params, gate_cfg,
                                           prompts, extra, total)
            if any(int(sum(v).item()) for v in drops.values()):
                raise AssertionError(f"{arch}: a slot dropped at E / k")
            if cfg.is_moe:
                log("families_f32", arch=arch, note="capacity factor 1.25 "
                    "runs below: streams other than paged + blocking are "
                    "printed, not gated")
                drop_runs(params, cfg, prompts, total)
            del params
            torch.cuda.empty_cache()
    return total


def phase_families_bf16(card: str) -> dict:
    """7b: bf16 at full width, ``BF16_LAYERS`` deep, one model at a
    time: logits
    against the plain versions, phase 4's serving runs, and one decode
    step of 8 live slots traced by ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import profile
    total: dict = {}
    for arch in FAMILY_ARCHS:
        with step_deadline():
            cfg = bf16_cfg(arch)
            t0 = time.perf_counter()
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            torch.cuda.synchronize()
            log("families_bf16", arch=arch, layers=cfg.n_layers,
                params=cfg.param_count(),
                weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
                init_s=f"{time.perf_counter() - t0:.1f}")
            prompts = serve_prompts(cfg)
            images = None
            if cfg.family == "vlm":   # a seeded prefix, not the zero stub
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                images = (torch.randn((1, cfg.n_image_tokens, cfg.d_model),
                                      generator=gen, device="cuda")
                          * 0.1).to(torch.bfloat16)
            logit_gates(f"families_bf16 {arch}", params, cfg, prompts[0],
                        images)
            serve_bf16(f"families_bf16 {arch}", params, cfg, prompts, card,
                       total)
            eng = profile.live_engine(params, cfg,
                                      np.random.default_rng(SEED))
            profile.measure(f"{arch}_decode", 3, eng.step, top=14)
            del eng, params
            torch.cuda.empty_cache()
    return total


def phase_dbrx(card: str) -> dict:
    """7c: dbrx-132b at full width, 2 layers (LayerNorm, 16 experts
    top-4, GQA 48/8): a 512-token prefill and 8 greedy decode steps
    with exact launches (no K5: LayerNorm has none), then the same
    tokens and experts (:func:`routes`) through the plain versions:
    every step's logits normwise <= 3e-2 with the same argmax, and the
    routing flips held to :func:`flip_gate`."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    cfg = registry.get_config("dbrx-132b").replace(n_layers=DBRX_LAYERS)
    assert cfg.norm == "layernorm" and cfg.dtype == "bfloat16"
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 512)),
                             dtype=torch.int32, device="cuda")
    n_steps = 8

    def run(feed=None):
        logits, cache = MD.prefill(params, cfg, {"tokens": prompt}, 1024)
        out, toks = [logits], []
        for i in range(n_steps):
            tok = (feed[i] if feed is not None
                   else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
            toks.append(tok)
            logits, cache = MD.decode_step(params, cfg, tok, cache)
            out.append(logits)
        return out, toks

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with routes() as picked:
        got, toks = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n = cfg.n_layers
    want = {"rmsnorm": 0, "flash_attention": n,
            "decode_attention": n_steps * n, "paged_decode_attention": 0,
            "prefill_attention": 0, "quant_gemv": 0}
    log("families_dbrx", launches=json.dumps(counts),
        expected=json.dumps(want),
        note="LayerNorm model: K5 (RMSNorm) is not launched, by design")
    if counts != want:
        raise AssertionError(f"dbrx launches {counts} != {want}")
    with plain_kernels(), routes(replay=picked) as flips:
        ref_out, _ = run(feed=toks)
    for i, (g, w) in enumerate(zip(got, ref_out)):
        rel = _logit_gate(f"dbrx {'prefill' if i == 0 else f'step {i}'}",
                          g, w)
        log("families_dbrx", logits="prefill" if i == 0 else f"decode_{i}",
            rel_err=f"{rel:.3e}",
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            tol=TOL["bfloat16"], argmax_equal=True)
    flip_gate("families_dbrx", picked, flips, lambda: run(feed=toks))
    log("families_dbrx", arch=cfg.name, layers=n, prompt_len=512,
        decode_steps=n_steps, wall_s=f"{wall:.3f}",
        weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
        card=f"'{card}'")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_families(card: str) -> dict:
    t0 = time.perf_counter()
    total = phase_families_f32()
    _add(total, phase_families_bf16(card))
    with step_deadline():
        _add(total, phase_dbrx(card))
    log("families", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 8: the rolling sliding window and whisper at full width
# ---------------------------------------------------------------------------

WINDOW_ARCHS = ("h2o-danube-1.8b", "mistral-7b", "whisper-large-v3")
# arch -> (config, prompts, streams, engine config) of 8a's whisper and
# 9a's float32 runs, which phase 13 serves again over a mesh
FAMILY_STREAMS: dict = {}
WINDOW_LAYERS = 4      # 8a's depth (whisper: 4 encoder + 4 decoder layers)
WINDOW_CAPACITY = 8192
# 8a's SWA prompts at the 4096 window: two roll in prefill, 4090 + 16
# new tokens fills the window while it decodes, 600 stays inside it
SWA_GATE_LENS = (600, 4090, 4500, 6000)
SWA_SERVE_LENS = SWA_GATE_LENS + (1000, 2048, 4096, 5000)
AUDIO_GATE_LENS = (17, 60, 120, 200)
AUDIO_SERVE_LENS = AUDIO_GATE_LENS + (33, 90, 150, 180)
FALLBACK_WARNINGS = {
    "paged+blocking": ({"kv_cache": "paged"},
                       "paged KV cache unsupported for family="),
    "contiguous+chunked": (CHUNKED, "chunked scheduling unsupported for "
                           "family="),
    "contiguous+speculative": (SPECULATIVE, "speculative scheduling "
                               "unsupported for family="),
}


def window_prompts(cfg, lens, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def window_fallbacks(phase, params, cfg, prompts, base, total,
                     capacity=WINDOW_CAPACITY) -> None:
    """Each requested paged / chunked / speculative run warns as the
    reference does, runs contiguous + blocking (and builds no draft),
    and gives ``base``."""
    import warnings
    for label, (kw, msg) in FALLBACK_WARNINGS.items():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            eng, counts = run_engine(params, cfg, prompts, 16,
                                     max_seq_len=capacity, **kw)
        said = [str(w.message) for w in seen if msg in str(w.message)]
        _check_engine(f"{phase} {label}", eng, counts, len(prompts))
        _add(total, counts)
        got = {r.rid: r.output for r in eng.finished}
        log(phase, arch=cfg.name, requested=label, warned=bool(said),
            ran=f"{eng.kv.name}+{eng.scheduler.name}",
            streams_equal=got == base)
        if not said or got != base or eng.kv.name != "contiguous" \
                or eng.scheduler.name != "blocking" \
                or eng.draft_kv is not None:
            raise AssertionError(f"{phase} {cfg.name} {label}: warned "
                                 f"{said}, ran {eng.kv.name}+"
                                 f"{eng.scheduler.name}, streams equal "
                                 f"{got == base}")
        del eng


def window_slo(phase, params, cfg, total) -> None:
    """The overload trace (phase 6's engine: 4 slots, capacity 96) under
    FIFO and SLO: at least one preemption, SLO streams == FIFO's."""
    from repro_torch.serving.workload import make_named_trace, replay
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=SEED)
    reps = {}
    for sched in ("blocking", "slo"):
        eng = _engine(params, cfg, max_batch=4, max_seq_len=96,
                      max_new_tokens=16, scheduler=sched)
        reps[sched], counts = counted(
            lambda: replay(eng, tr, step_quantum_s=QUANTUM))
        check_launches(f"{phase} slo {sched}", eng, counts)
        _add(total, counts)
    fifo, slo = reps["blocking"], reps["slo"]
    n = slo["summary"]["preemptions"]
    log(phase, arch=cfg.name, run="overload fifo vs slo", preemptions=n,
        preempted_kv_bytes=slo["summary"]["preempted_kv_bytes"],
        slo_streams_equal_fifo=slo["outputs"] == fifo["outputs"])
    if n < 1 or slo["outputs"] != fifo["outputs"]:
        raise AssertionError(f"{phase} {cfg.name}: SLO preemptions {n}, "
                             "streams equal "
                             f"{slo['outputs'] == fifo['outputs']}")


def window_export_import(phase, params, cfg, prompts,
                         capacity=WINDOW_CAPACITY) -> None:
    """Every live slot exported and imported into a free one gives its
    packet back ``torch.equal``, leaf by leaf — past the window on a
    rolling cache (the 4090-token prompt's slot crosses it during the
    steps), with the cross K/V on whisper, with every state leaf on a
    recurrent model."""
    import torch
    eng = _engine(params, cfg, max_batch=8, max_seq_len=capacity,
                  max_new_tokens=64)
    for p in prompts:
        eng.submit(p)
    for _ in range(10):
        eng.step()
    cap = eng.kv._cache["k"].shape[2] if "k" in eng.kv._cache else 0
    for slot in range(len(prompts)):
        n = int(eng.slot_pos[slot])
        pkt = eng.kv.export_slot(slot, n)
        dst = len(prompts) + slot
        eng.kv.import_slot(pkt, dst, len(prompts[slot]), 64)
        back = eng.kv.export_slot(dst, n)
        leaves = sorted(k for k in pkt if k not in ("n_valid", "kv_bytes"))
        same = all(torch.equal(pkt[x], back[x]) for x in leaves)
        log(phase, arch=cfg.name, export_import=f"slot {slot}->{dst}",
            positions=n, capacity=cap, rolled=bool(cap) and n >= cap,
            leaves=",".join(leaves), kv_bytes=pkt["kv_bytes"],
            rows_equal=same)
        if not same:
            raise AssertionError(f"{phase} {cfg.name} slot {slot}: "
                                 "export -> import rows differ")
        eng.kv.free(dst)


def phase_window_f32() -> dict:
    """8a: float32 at full width, 4 layers deep: contiguous + blocking
    against the batch-1 loop, the three requested fallbacks, the SLO
    replay and export / import."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    total: dict = {}
    for arch in WINDOW_ARCHS:
        with step_deadline():
            t0 = time.perf_counter()
            cfg = registry.get_config(arch).replace(
                dtype="float32", n_layers=WINDOW_LAYERS)
            if cfg.family == "audio":
                cfg = cfg.replace(n_encoder_layers=WINDOW_LAYERS)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            lens = (AUDIO_GATE_LENS if cfg.family == "audio"
                    else SWA_GATE_LENS)
            prompts = window_prompts(cfg, lens, SEED)
            eng, counts = run_engine(params, cfg, prompts, 16,
                                     max_seq_len=WINDOW_CAPACITY)
            s = _check_engine("window_f32", eng, counts, len(prompts))
            _add(total, counts)
            base = {r.rid: r.output for r in eng.finished}
            del eng
            for i, p in enumerate(prompts):
                want = straight_line_generate(params, cfg, p, 16,
                                              WINDOW_CAPACITY)
                log("window_f32", arch=arch, request=i, prompt_len=len(p),
                    equal=base[i] == want, tokens=base[i][:8])
                if base[i] != want:
                    raise AssertionError(f"window_f32 {arch} request {i}: "
                                         f"engine {base[i]} != "
                                         f"straight-line {want}")
            log("window_f32", arch=arch, depth=WINDOW_LAYERS,
                window=cfg.sliding_window, config="contiguous+blocking",
                requests=s["requests"], decode_steps=s["decode_steps"],
                launches=json.dumps(counts), streams_equal=True)
            if cfg.family == "audio":
                FAMILY_STREAMS[arch] = (cfg, prompts, base,
                                        {"max_seq_len": WINDOW_CAPACITY})
            window_fallbacks("window_f32", params, cfg, prompts, base, total)
            window_slo("window_f32", params, cfg, total)
            window_export_import("window_f32", params, cfg, prompts)
            log("window_f32", arch=arch,
                seconds=f"{time.perf_counter() - t0:.1f}")
            del params
            torch.cuda.empty_cache()
    return total


WINDOW_STEPS = 8       # 8b's decode steps past the window


def _tie_gate(what, got, want, tol=TOL["bfloat16"]) -> tuple:
    """Normwise relative error of ``got`` against ``want`` within
    ``tol`` (the bf16 tolerance), and the same argmax in every row — or,
    where the
    argmax differs, a tie at rounding level: the plain run's logits of
    the two tokens closer than the two runs differ anywhere in that row,
    so their order is inside the rounding the comparison allows. Returns
    (error, [(row, plain margin, row's max |got - want|)] of the ties)."""
    rel = ((got - want).norm() / want.norm()).item()
    ga, wa = got.argmax(-1), want.argmax(-1)
    ties = []
    for r in (ga != wa).nonzero().flatten().tolist():
        margin = (want[r, wa[r]] - want[r, ga[r]]).item()
        noise = (got[r] - want[r]).abs().max().item()
        ties.append((r, margin, noise))
        if margin > noise:
            raise AssertionError(f"{what} row {r}: argmax {int(ga[r])} "
                                 f"against {int(wa[r])}, plain margin "
                                 f"{margin:.3e} > the row's max error "
                                 f"{noise:.3e}")
    if rel > tol:
        raise AssertionError(f"{what}: relative error {rel:.3e} (tolerance "
                             f"{tol:.3e})")
    return rel, ties


@contextlib.contextmanager
def ulp_noise(seed=SEED):
    """Inside :func:`plain_kernels`: every bf16 output of the kernel ops
    a model path runs — K1's, K3's and K5's normalised ``h`` (its ``s``
    is ``x + a`` bitwise on both routes) — moved by one ulp, a seeded
    random sign per nonzero element: the rounding a kernel may differ by
    from its plain version. This script's witness only."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(t):
        if t.dtype != torch.bfloat16:
            return t
        step = torch.randint(0, 2, t.shape, generator=gen, device="cuda",
                             dtype=torch.int16) * 2 - 1
        bits = t.view(torch.int16)
        return torch.where(t != 0, bits + step, bits).view(torch.bfloat16)

    saved = {n: getattr(ops, n) for n in ("add_rmsnorm", "flash_attention",
                                          "decode_attention")}
    ops.add_rmsnorm = lambda *a, **k: (
        lambda s, h: (s, nudge(h)))(*saved["add_rmsnorm"](*a, **k))
    ops.flash_attention = lambda *a, **k: nudge(
        saved["flash_attention"](*a, **k))
    ops.decode_attention = lambda *a, **k: nudge(
        saved["decode_attention"](*a, **k))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


CHECKED_OPS = ("add_rmsnorm", "flash_attention", "decode_attention")
ATTENTION_OPS = ("flash_attention", "decode_attention",
                 "paged_decode_attention", "prefill_attention")


@contextlib.contextmanager
def checked_kernels(errs: dict, names=CHECKED_OPS):
    """Every call of the kernel ops ``names`` a model path runs (by
    default K1, K3, K5) also runs its plain version on the same inputs
    and must agree within phase 2's bf16 tolerance; ``errs`` collects,
    per op, (calls, largest |kernel - plain|). Holds each launch of a
    full-depth run to its plain version where the run's logits cannot be
    held tightly (this script's check only; the plain versions launch no
    kernel)."""
    import torch
    from repro_torch.kernels import ops, ref
    saved = {n: getattr(ops, n) for n in names}

    def checked(name, pick):
        def call(*a, **k):
            got = saved[name](*a, **k)
            g = pick(got).float()
            w = pick(getattr(ref, name)(*a, **k)).float()
            err = (g - w).abs().max().item() if g.numel() else 0.0
            n, worst = errs.get(name, (0, 0.0))
            errs[name] = (n + 1, max(worst, err))
            tol = TOL["bfloat16"]
            if not torch.allclose(g, w, atol=tol, rtol=tol):
                raise AssertionError(f"{name} call {n}: max |kernel - "
                                     f"plain| {err:.3e} exceeds {tol}")
            return got
        return call

    for name in names:
        setattr(ops, name, checked(name, (lambda out: out[1])
                                   if name == "add_rmsnorm"
                                   else (lambda out: out)))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def window_logits(phase, params, cfg, prompt, capacity=WINDOW_CAPACITY,
                  witness=False) -> None:
    """8b: a prefill (whisper's over seeded frames) and ``WINDOW_STEPS``
    greedy decode steps through the kernels, then the same tokens
    through the plain versions: every step's logits normwise <= 3e-2,
    the same argmax but for ties at rounding level (:func:`_tie_gate`;
    each is printed with its margin).

    With ``witness`` (9b), every kernel call of the kernel run is also
    held to its plain version on its own inputs (:func:`checked_kernels`),
    the plain versions run the same tokens a second time under one-ulp
    noise at every kernel op's output (:func:`ulp_noise`), and each
    step's limit is the larger of 3e-2 and ``FLIP_WITNESS_FACTOR`` times
    the witness's own error: on a model whose logits move further than
    3e-2 under rounding-level noise of the plain path itself, the bound
    is what that noise moves, as phase 7 gates the routing flips."""
    import torch
    from repro_torch.models import model as MD
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    batch = {"tokens": toks}
    if cfg.family == "audio":
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch["frames"] = (torch.randn((1, cfg.encoder_len, cfg.d_model),
                                       generator=gen, device="cuda")
                           * 0.1).to(torch.bfloat16)

    def run(feed=None):
        logits, cache = MD.prefill(params, cfg, batch, capacity)
        out, fed = [logits], []
        for i in range(WINDOW_STEPS):
            tok = (feed[i] if feed is not None
                   else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
            fed.append(tok)
            logits, cache = MD.decode_step(params, cfg, tok, cache)
            out.append(logits)
        return out, fed

    calls: dict = {}
    with (checked_kernels(calls) if witness else contextlib.nullcontext()):
        got, fed = run()
    with plain_kernels():
        want, _ = run(feed=fed)
        if witness:
            with ulp_noise():
                noisy, _ = run(feed=fed)
    wit = ([((n - w).norm() / w.norm()).item() for n, w in zip(noisy, want)]
           if witness else [0.0] * len(want))
    rels, ties, tols = [], [], []
    for i, (g, w) in enumerate(zip(got, want)):
        tols.append(max(TOL["bfloat16"], FLIP_WITNESS_FACTOR * wit[i]))
        rel, tied = _tie_gate(f"{phase} {cfg.name} logits {i}", g, w,
                              tols[-1])
        rels.append(rel)
        ties += [f"{i}:{m:.3e}<{n:.3e}" for _, m, n in tied]
    extra = {}
    if witness:
        extra = dict(
            checked_calls=",".join(f"{n}:{c}" for n, (c, _) in
                                   sorted(calls.items())),
            checked_max_abs_err=",".join(f"{n}:{e:.3e}" for n, (_, e) in
                                         sorted(calls.items())),
            witness_rel_prefill=f"{wit[0]:.3e}",
            witness_rel_steps_max=f"{max(wit[1:]):.3e}",
            limit_prefill=f"{tols[0]:.3e}",
            limit_steps_min=f"{min(tols[1:]):.3e}",
            within_3e_2=max(rels) <= TOL["bfloat16"])
    log(phase, arch=cfg.name, prompt_len=len(prompt),
        rolled=cfg.sliding_window is not None
        and len(prompt) >= cfg.sliding_window,
        decode_steps=WINDOW_STEPS,
        rel_err_prefill=f"{rels[0]:.3e}",
        rel_err_steps_max=f"{max(rels[1:]):.3e}", tol=TOL["bfloat16"],
        **extra, argmax_flips=len(ties),
        ties="none" if not ties else ",".join(ties))


def phase_window_bf16(card: str) -> dict:
    """8b: bf16 at full width and depth (mistral at ``BF16_LAYERS``), one
    model at a time: logits of
    the first prefill and of a rolling one with 8 steps past the window
    (whisper: a 200-token prompt over seeded frames) against the plain
    versions, 8 requests of 64 new tokens on contiguous + blocking, and
    one decode step of 8 live slots traced by ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import profile
    total: dict = {}
    for arch in WINDOW_ARCHS:
        with step_deadline():
            t0 = time.perf_counter()
            cfg = bf16_cfg(arch)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            torch.cuda.synchronize()
            log("window_bf16", arch=arch, layers=cfg.n_layers,
                params=cfg.param_count(),
                weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
                init_s=f"{time.perf_counter() - t0:.1f}")
            audio = cfg.family == "audio"
            lens = AUDIO_SERVE_LENS if audio else SWA_SERVE_LENS
            prompts = window_prompts(cfg, lens, SEED + 1)
            # the first prefill, and one that rolls (6000 tokens) with
            # its steps past the window; whisper's 200-token prompt
            for i in ((3,) if audio else (0, 3)):
                window_logits("window_bf16", params, cfg, prompts[i])
            torch.cuda.empty_cache()
            eng, counts = run_engine(params, cfg, prompts, 64,
                                     max_seq_len=WINDOW_CAPACITY)
            s = _check_engine(f"window_bf16 {arch}", eng, counts, 8)
            _add(total, counts)
            log("window_bf16", arch=arch, config="contiguous+blocking",
                requests=s["requests"], tokens=s["tokens"],
                tok_per_s=f"{s['tokens_per_s']:.1f}",
                ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
                ttft_p99_ms=f"{s['ttft_p99_s'] * 1e3:.1f}",
                itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
                itl_p99_ms=f"{s['itl_p99_s'] * 1e3:.2f}",
                decode_steps=s["decode_steps"], prefills=s["prefills"],
                contiguous_kv_bytes=s["contiguous_kv_bytes"],
                launches=json.dumps(counts), card=f"'{card}'")
            del eng
            torch.cuda.empty_cache()
            eng = profile.live_engine(params, cfg,
                                      np.random.default_rng(SEED),
                                      lens=lens,
                                      max_seq_len=WINDOW_CAPACITY)
            profile.measure(f"{arch}_decode", 3, eng.step, top=14)
            log("window_bf16", arch=arch,
                seconds=f"{time.perf_counter() - t0:.1f}")
            del eng, params
            torch.cuda.empty_cache()
    return total


def phase_window(card: str) -> dict:
    t0 = time.perf_counter()
    total = phase_window_f32()
    _add(total, phase_window_bf16(card))
    log("window", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 9: the recurrent families at full width
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("zamba2-2.7b", "xlstm-350m")
ZAMBA_GATE_LAYERS = 12    # 9a's zamba2 depth: 2 groups of 6 Mamba2 layers
XLSTM_GATE_LAYERS = 8     # 9a's xlstm depth: one super-block of 7 mLSTMs
#                           and the sLSTM (of 3; cut for the run's time)
RECURRENT_CAPACITY = 2048
RECURRENT_GATE_LENS = (17, 300, 700, 1000)


def recurrent_gate_cfg(arch):
    """9a's float32 config: zamba2 at 12 of its 54 layers (2 shared-block
    applications), xlstm-350m at 8 of its 24 (one super-block)."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).replace(dtype="float32")
    return cfg.replace(n_layers=ZAMBA_GATE_LAYERS if cfg.family == "hybrid"
                       else XLSTM_GATE_LAYERS)


def bucket_gate(phase, params, cfg, prompts, base, total) -> None:
    """Admission bucketed from 16 and at the exact length: both give
    ``base``, and every leaf each admission splices is ``torch.equal``
    between the two — the state leaves whole, zamba2's shared-block K/V
    rows up to the prompt (a bucket's pad rows past it are masked by the
    slot's length)."""
    import torch
    spliced = {}
    for bucket in (16, 0):
        eng = _engine(params, cfg, max_batch=8,
                      max_seq_len=RECURRENT_CAPACITY, max_new_tokens=16,
                      prefill_bucket_min=bucket)
        seen, splice = [], eng.kv.splice

        def recording(rows, *args, _seen=seen, _splice=splice, **kw):
            _seen.append({k: v.clone() for k, v in rows.items()
                          if k != "len"})
            return _splice(rows, *args, **kw)

        eng.kv.splice = recording
        for p in prompts:
            eng.submit(p)
        _, counts = counted(eng.run)
        del eng.kv.splice    # the class's again: no cycle keeps the cache
        _check_engine(f"{phase} bucket {bucket}", eng, counts, len(prompts))
        _add(total, counts)
        if _outputs(eng) != base:
            raise AssertionError(f"{phase} {cfg.name} bucket {bucket}: "
                                 f"streams {_outputs(eng)} != {base}")
        spliced[bucket] = seen
        del eng
    for i, (a, b) in enumerate(zip(spliced[0], spliced[16])):
        n = len(prompts[i])
        same = {}
        for name, x in a.items():
            y = b[name]
            if name in ("k", "v"):
                y = y[:, :, :n]
            same[name] = x.shape == y.shape and bool(torch.equal(x, y))
        log(phase, arch=cfg.name, bucketed_vs_exact=f"request {i}",
            prompt_len=n, leaves=",".join(sorted(same)),
            leaves_equal=all(same.values()))
        if not all(same.values()) or len(spliced[0]) != len(prompts):
            raise AssertionError(f"{phase} {cfg.name} request {i}: "
                                 f"bucketed != exact leaves {same}")


def phase_recurrent_f32() -> dict:
    """9a: float32 at full width (zamba2 12 layers deep, xlstm full
    depth): contiguous + blocking against the batch-1 loop, bucketed ==
    exact, the three requested fallbacks, the SLO replay and export /
    import."""
    import torch
    from repro_torch.models import model as MD
    total: dict = {}
    for arch in RECURRENT_ARCHS:
        with step_deadline():
            t0 = time.perf_counter()
            cfg = recurrent_gate_cfg(arch)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            prompts = window_prompts(cfg, RECURRENT_GATE_LENS, SEED)
            eng, counts = run_engine(params, cfg, prompts, 16)
            s = _check_engine("recurrent_f32", eng, counts, len(prompts))
            _add(total, counts)
            base = _outputs(eng)
            del eng
            for i, p in enumerate(prompts):
                want = straight_line_generate(params, cfg, p, 16,
                                              RECURRENT_CAPACITY)
                log("recurrent_f32", arch=arch, request=i,
                    prompt_len=len(p), equal=base[i] == want,
                    tokens=base[i][:8])
                if base[i] != want:
                    raise AssertionError(f"recurrent_f32 {arch} request "
                                         f"{i}: engine {base[i]} != "
                                         f"straight-line {want}")
            log("recurrent_f32", arch=arch, layers=cfg.n_layers,
                config="contiguous+blocking", requests=s["requests"],
                decode_steps=s["decode_steps"], prefills=s["prefills"],
                launches=json.dumps(counts), streams_equal=True)
            FAMILY_STREAMS[arch] = (cfg, prompts, base, {})
            bucket_gate("recurrent_f32", params, cfg, prompts, base, total)
            window_fallbacks("recurrent_f32", params, cfg, prompts, base,
                             total, capacity=RECURRENT_CAPACITY)
            window_slo("recurrent_f32", params, cfg, total)
            window_export_import("recurrent_f32", params, cfg, prompts,
                                 capacity=RECURRENT_CAPACITY)
            log("recurrent_f32", arch=arch,
                seconds=f"{time.perf_counter() - t0:.1f}")
            del params
            torch.cuda.empty_cache()
    return total


def phase_recurrent_bf16(card: str) -> dict:
    """9b: bf16 at full width, ``BF16_LAYERS`` deep, one model at a time:
    logits of
    the first prefill and 8 decode steps against the plain versions, 8
    requests of 256–1023 tokens (64 new each) on contiguous + blocking,
    one decode step of 8 live slots and one 1024-token prefill traced by
    ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import profile
    total: dict = {}
    for arch in RECURRENT_ARCHS:
        with step_deadline():
            t0 = time.perf_counter()
            cfg = bf16_cfg(arch)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            torch.cuda.synchronize()
            log("recurrent_bf16", arch=arch, layers=cfg.n_layers,
                params=cfg.param_count(),
                weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
                init_s=f"{time.perf_counter() - t0:.1f}")
            lens = np.random.default_rng(SEED).integers(256, 1024, size=8)
            prompts = window_prompts(cfg, lens, SEED + 1)
            window_logits("recurrent_bf16", params, cfg, prompts[0],
                          capacity=RECURRENT_CAPACITY, witness=True)
            torch.cuda.empty_cache()
            eng, counts = run_engine(params, cfg, prompts, 64)
            s = _check_engine(f"recurrent_bf16 {arch}", eng, counts, 8)
            _add(total, counts)
            log("recurrent_bf16", arch=arch, config="contiguous+blocking",
                requests=s["requests"], tokens=s["tokens"],
                tok_per_s=f"{s['tokens_per_s']:.1f}",
                ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
                ttft_p99_ms=f"{s['ttft_p99_s'] * 1e3:.1f}",
                itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
                itl_p99_ms=f"{s['itl_p99_s'] * 1e3:.2f}",
                decode_steps=s["decode_steps"], prefills=s["prefills"],
                contiguous_kv_bytes=s["contiguous_kv_bytes"],
                launches=json.dumps(counts), card=f"'{card}'")
            del eng
            torch.cuda.empty_cache()
            rng = np.random.default_rng(SEED)
            eng = profile.live_engine(params, cfg, rng)
            profile.measure(f"{arch}_decode", 3, eng.step, top=14)
            toks = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                device="cuda")
            profile.measure(f"{arch}_prefill", 1, lambda: eng._prefill_one(
                params, {"tokens": toks}, 1023, 1024), top=14)
            log("recurrent_bf16", arch=arch,
                seconds=f"{time.perf_counter() - t0:.1f}")
            del eng, params
            torch.cuda.empty_cache()
    return total


def phase_recurrent(card: str) -> dict:
    t0 = time.perf_counter()
    total = phase_recurrent_f32()
    _add(total, phase_recurrent_bf16(card))
    log("recurrent", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 10: the disaggregated prefill/decode cluster at full width
# ---------------------------------------------------------------------------

CARD = "cuda:0"    # the one card: every worker goes on it, round-robin
ROUND_ROBIN = "workers share devices round-robin"
PAGED_FALLBACK = FALLBACK_WARNINGS["paged+blocking"][1]
# 10a's other families: (arch, depth cut or None, capacity, prompt
# lengths or None for phase 3's, fault on decode worker 0 after step 2).
# Each requests the paged cache; the recurrent, audio and window models
# take the reference's contiguous fallback. Danube's 4500-token prompt
# comes first, so it lands on decode worker 0 and migrates rolled.
# the leaves a packet of each family carries, each a slot's row of the
# cache leaf on that leaf's own batch axis
PACKET_LEAVES = {"hybrid": {"k", "v", "ssm", "conv"},
                 "ssm": {"mlstm", "slstm_c", "slstm_n", "slstm_h"},
                 "audio": {"k", "v", "cross_k", "cross_v"}}
CLUSTER_FAMILIES = (
    ("deepseek-moe-16b", GATE_LAYERS, 2048, None, "kill"),
    ("internvl2-26b", GATE_LAYERS, 2048, None, "kill"),
    ("zamba2-2.7b", ZAMBA_GATE_LAYERS, RECURRENT_CAPACITY,
     RECURRENT_GATE_LENS, "drain"),
    ("xlstm-350m", XLSTM_GATE_LAYERS, RECURRENT_CAPACITY,
     RECURRENT_GATE_LENS, "drain"),
    ("whisper-large-v3", WINDOW_LAYERS, WINDOW_CAPACITY, AUDIO_GATE_LENS,
     "drain"),
    ("h2o-danube-1.8b", WINDOW_LAYERS, WINDOW_CAPACITY,
     (4500, 600, 1000, 2048), "drain"),
)


def make_cluster(params, cfg, *, n_prefill=1, n_decode=2, ccfg=None,
                 **ecfg):
    """A cluster on the card (8 slots, capacity 2048 unless ``ecfg`` says
    otherwise) whose construction issued the round-robin warning (one
    card, three or more workers); returns (cluster, the messages of every
    warning its construction issued)."""
    import warnings
    from repro_torch.serving import ClusterConfig, ClusterEngine, EngineConfig
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        clu = ClusterEngine(
            params, cfg,
            EngineConfig(**{"max_batch": 8, "max_seq_len": 2048, **ecfg}),
            ClusterConfig(n_prefill=n_prefill, n_decode=n_decode,
                          devices=(CARD,), **(ccfg or {})))
    said = [str(w.message) for w in seen]
    if not any(ROUND_ROBIN in m for m in said):
        raise AssertionError(f"cluster of {n_prefill} + {n_decode} workers "
                             f"on one card: no round-robin warning in {said}")
    return clu, said


def _workers(clu):
    return clu.prefill_workers + clu.decode_workers


def record_packets(clu, timed=False):
    """Wrap every worker engine's ``_pack_slot`` / ``_unpack_slot`` (this
    script's measurement only) to record each packet: the request, its
    prompt length, ``n_valid``, ``kv_bytes`` and its leaves' shapes and —
    ``timed`` — the export and import wall ms, the card synchronised
    around each.
    Returns (records, restore), ``restore()`` unwrapping them."""
    import torch
    records = []

    def sync():
        if timed:
            torch.cuda.synchronize()

    for w in _workers(clu):
        eng = w.eng
        pack, unpack = eng._pack_slot, eng._unpack_slot

        def packing(slot, _pack=pack):
            sync()
            t0 = time.perf_counter()
            pkt = _pack(slot)
            sync()
            records.append({
                "id": id(pkt), "rid": pkt.req.rid,
                "prompt_len": len(pkt.req.prompt),
                "n_valid": pkt.kv["n_valid"], "kv_bytes": pkt.kv["kv_bytes"],
                "shapes": {k: tuple(v.shape) for k, v in pkt.kv.items()
                           if isinstance(v, torch.Tensor)},
                "export_ms": (time.perf_counter() - t0) * 1e3})
            return pkt

        def unpacking(pkt, slot, _unpack=unpack):
            sync()
            t0 = time.perf_counter()
            _unpack(pkt, slot)
            sync()
            rec = next(r for r in reversed(records) if r["id"] == id(pkt))
            rec["import_ms"] = (time.perf_counter() - t0) * 1e3

        eng._pack_slot, eng._unpack_slot = packing, unpacking

    def restore():
        for w in _workers(clu):
            del w.eng._pack_slot, w.eng._unpack_slot

    return records, restore


def check_cluster_launches(phase, clu, counts) -> None:
    """The cluster's launches are its worker engines' summed
    (:func:`expected_launches` of each), and every kernel of its path
    ran: K3 where a prompt was prefilled whole, K4 where one was
    admitted warm, the decode kernel of its cache, K5 on an RMSNorm
    model."""
    want: dict = {}
    for w in _workers(clu):
        _add(want, expected_launches(w.eng)[0])
    norms, n = path_shape(clu.cfg)
    s = clu.summary()
    path = {"rmsnorm"} if norms else set()
    if n:
        path.add("paged_decode_attention" if s["kv_cache"] == "paged"
                 else "decode_attention")
        if s["prefills"]:
            path.add("flash_attention")
        if any(w.eng.prefill_chunk_dispatches for w in _workers(clu)):
            path.add("prefill_attention")
    _launch_gate(phase, counts, want, path)


def serve_cluster(phase, clu, drive, total, timed=False):
    """``drive()`` the cluster with its packets recorded; the launches
    are checked and added to ``total``. Returns (drive's result, the
    packet records)."""
    records, restore = record_packets(clu, timed)
    try:
        out, counts = counted(drive)
    finally:
        restore()
    check_cluster_launches(phase, clu, counts)
    _add(total, counts)
    return out, records


def cluster_gates(phase, clu, records, want, n_requests, **extra) -> dict:
    """The cluster's streams are ``want``; every request finished; one
    decode dispatch per worker step; ``kv_transfer_bytes`` is the sum of
    the packets' ``kv_bytes`` and every packet was counted as a handoff
    or a migration; every paged pool balances after the drain."""
    s = clu.summary()
    got = _outputs(clu)
    sent = sum(r["kv_bytes"] for r in records)
    log(phase, **extra, streams_equal=got == want, requests=s["requests"],
        handoffs=s["handoffs"], migrations=s["migrations"],
        max_migration_hops=s["max_migration_hops"],
        kv_transfer_bytes=s["kv_transfer_bytes"], packet_bytes=sent,
        dispatches_per_step=s["dispatches_per_step"],
        decode_steps=s["decode_steps"], workers_alive=s["workers_alive"],
        kv_cache=s["kv_cache"])
    if not (got == want and s["requests"] == n_requests
            and s["dispatches_per_step"] == 1.0
            and s["kv_transfer_bytes"] == sent > 0
            and s["handoffs"] + s["migrations"] == len(records)):
        raise AssertionError(
            f"{phase} {extra}: streams equal {got == want}, requests "
            f"{s['requests']} of {n_requests}, dispatches per step "
            f"{s['dispatches_per_step']}, transfer bytes "
            f"{s['kv_transfer_bytes']} against packets {sent}, "
            f"{s['handoffs']} + {s['migrations']} of {len(records)} packets")
    for w in _workers(clu):
        _pool_balanced(f"{phase} {w.role}{w.idx}", w.eng.kv)
    return s


def fault_after(kind, moved=None):
    """A drive: two cluster steps, then ``kind`` ("kill" or "drain")
    decode worker 0 — the positions of its live slots appended to
    ``moved`` — then run to the end."""
    def drive(clu):
        for _ in range(2):
            clu.step()
        w = clu.decode_workers[0]
        if moved is not None:
            moved.extend(int(w.eng.slot_pos[i]) for i in w.live_slots())
        getattr(clu, f"{kind}_worker")(0)
        clu.run()
    return drive


def drain_then_kill(clu):
    """Hops to 2: drain a loaded decode worker after one step, place its
    packets, then kill a worker holding one of the moved streams."""
    clu.step()
    clu.drain_worker(next(i for i, w in enumerate(clu.decode_workers)
                          if w.live_slots()))
    clu.step()
    moved = {rid for rid, h in clu._req_hops.items() if h == 1}
    clu.kill_worker(next(
        i for i, w in enumerate(clu.decode_workers)
        if w.alive and not w.draining
        and any(w.eng.slot_req[j].rid in moved for j in w.live_slots())))
    clu.run()


def cluster_qwen_f32(base, total) -> None:
    """10a on qwen1.5-0.5b, float32, phase 3's width and depth, its
    traffic: 1 + 2 workers on both backends with decode worker 0 killed
    after step 2, then 1 + 3 with a drain and a kill (two hops); streams
    against phase 3's. The cluster's construction may allocate the
    workers' caches, not more copies of the weights."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving.kv_cache import contiguous_kv_bytes
    cfg = qwen_f32_cfg()
    before = torch.cuda.memory_allocated()
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    weights = torch.cuda.memory_allocated() - before
    prompts = gate_prompts(cfg)
    cache = contiguous_kv_bytes(cfg, 8, 2048)
    for label, kw in (("1+2 kill", {"kv_cache": "contiguous"}),
                      ("1+2 kill", {"kv_cache": "paged"}),
                      ("1+3 drain+kill", {"kv_cache": "paged",
                                          "n_decode": 3})):
        before = torch.cuda.memory_allocated()
        clu, _ = make_cluster(params, cfg, max_new_tokens=16, **kw)
        grew = torch.cuda.memory_allocated() - before
        n_workers = len(_workers(clu))
        for p in prompts:
            clu.submit(p)
        drive = drain_then_kill if "drain" in label else fault_after("kill")
        _, records = serve_cluster("cluster_f32", clu, lambda: drive(clu),
                                   total)
        s = cluster_gates("cluster_f32", clu, records, base, len(prompts),
                          arch=ARCH, run=f"'{label}'",
                          backend=kw["kv_cache"])
        log("cluster_f32", arch=ARCH, run=f"'{label}'", workers=n_workers,
            allocated_by_cluster=grew, worker_caches=n_workers * cache,
            weight_bytes=weights,
            devices=",".join(w["device"] for w in s["per_worker"]))
        hops = 2 if "drain" in label else 1
        if not (s["migrations"] >= 1 and s["max_migration_hops"] == hops
                and grew < n_workers * cache * 1.01 + weights / 2):
            raise AssertionError(
                f"cluster_f32 {label}: migrations {s['migrations']}, hops "
                f"{s['max_migration_hops']} (want {hops}), the cluster "
                f"allocated {grew} B for {n_workers} caches of {cache} B "
                f"beside {weights} B of weights")
        del clu
        gc_empty()
    del params
    gc_empty()


def gc_empty() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def cluster_families_f32(total) -> None:
    """10a's other families, float32 at their phases' depth cuts, 4
    prompts of 8 new tokens: each cluster (1 + 2, paged requested, a
    fault on decode worker 0 after step 2) against the model's own
    single blocking engine; the fallback's warning asserted where the
    paged cache cannot hold the model; every packet carries the family's
    leaves (the recurrent state, whisper's cross K/V), each a slot's row
    on its own batch axis; a vlm packet carries its 256 image positions;
    danube's rolled slot migrates."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.models.model import TRANSFORMER_FAMILIES
    for arch, depth, cap, lens, fault in CLUSTER_FAMILIES:
        with step_deadline():
            t0 = time.perf_counter()
            cfg = registry.get_config(arch).replace(dtype="float32")
            if depth:
                cfg = cfg.replace(n_layers=depth)
            if cfg.family == "audio":
                cfg = cfg.replace(n_encoder_layers=depth)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            if cfg.is_moe:
                cfg = dropless(cfg)
            prompts = (window_prompts(cfg, lens, SEED) if lens
                       else gate_prompts(cfg))
            pageable = (cfg.family in TRANSFORMER_FAMILIES
                        and cfg.sliding_window is None)
            backend = "paged" if pageable else "contiguous"
            eng, counts = run_engine(params, cfg, prompts, 8,
                                     max_seq_len=cap, kv_cache=backend)
            _check_engine(f"cluster_f32 {arch} single", eng, counts,
                          len(prompts))
            _add(total, counts)
            want = _outputs(eng)
            del eng
            clu, said = make_cluster(params, cfg, max_seq_len=cap,
                                     max_new_tokens=8, kv_cache="paged")
            warned = any(PAGED_FALLBACK in m for m in said)
            for p in prompts:
                clu.submit(p)
            moved: list = []
            _, records = serve_cluster(
                "cluster_f32", clu,
                lambda: fault_after(fault, moved)(clu), total)
            s = cluster_gates("cluster_f32", clu, records, want,
                              len(prompts), arch=arch, depth=cfg.n_layers,
                              fault=fault, fallback_warned=warned)
            prefix = cfg.n_image_tokens if cfg.family == "vlm" else 0
            leaves = PACKET_LEAVES.get(cfg.family, {"k", "v"})
            rows_ok = all(set(r["shapes"]) == leaves for r in records)
            if backend == "contiguous":   # each leaf's own batch axis
                cache = clu.decode_workers[-1].eng.kv._cache
                axes = MD.cache_batch_axes(cache)
                for r in records:
                    for name, shape in r["shapes"].items():
                        want = list(cache[name].shape)
                        want[axes[name]] = 1
                        if name in ("k", "v"):
                            shape = shape[:2] + shape[3:]
                            del want[2]
                        rows_ok &= list(shape) == want
            log("cluster_f32", arch=arch, moved_positions=moved,
                window=cfg.sliding_window,
                packet_n_valid=[r["n_valid"] for r in records],
                image_positions=prefix,
                packet_leaves=",".join(sorted(records[0]["shapes"])),
                leaves_on_their_batch_axes=rows_ok,
                seconds=f"{time.perf_counter() - t0:.1f}")
            if not (s["migrations"] >= 1 and moved and rows_ok
                    and s["kv_cache"] == backend and warned != pageable
                    and all(r["n_valid"] >= prefix + r["prompt_len"]
                            for r in records)
                    and (not cfg.sliding_window
                         or max(moved) > cfg.sliding_window)):
                raise AssertionError(
                    f"cluster_f32 {arch}: migrations {s['migrations']}, "
                    f"moved {moved}, cache {s['kv_cache']} (fallback warned "
                    f"{warned}), packets {records}")
            del clu, params
            gc_empty()


def handoff_lines(phase, records, card) -> None:
    """Each recorded packet's bytes, export and import wall ms and the
    GB/s they imply, then their medians."""
    import numpy as np
    for r in records:
        log(phase, handoff=r["rid"], n_valid=r["n_valid"],
            kv_bytes=r["kv_bytes"], export_ms=f"{r['export_ms']:.3f}",
            import_ms=f"{r['import_ms']:.3f}",
            export_gb_s=f"{r['kv_bytes'] / r['export_ms'] / 1e6:.2f}",
            import_gb_s=f"{r['kv_bytes'] / r['import_ms'] / 1e6:.2f}")
    med = {k: float(np.median([r[k] for r in records]))
           for k in ("kv_bytes", "export_ms", "import_ms")}
    log(phase, handoffs=len(records),
        kv_bytes_total=sum(r["kv_bytes"] for r in records),
        kv_bytes_median=int(med["kv_bytes"]),
        export_ms_median=f"{med['export_ms']:.3f}",
        import_ms_median=f"{med['import_ms']:.3f}",
        export_ms_total=f"{sum(r['export_ms'] for r in records):.3f}",
        import_ms_total=f"{sum(r['import_ms'] for r in records):.3f}",
        card=f"'{card}'")


def latency_fields(s) -> dict:
    """tok/s, TTFT p50 / p99 and ITL p50 of an engine's or a cluster's
    summary (the cluster's ITL percentiles are its tenants')."""
    itl = s["by_tenant"]["default"]["itl_p50_s"]
    return {"tok_per_s": f"{s['tokens_per_s']:.1f}",
            "ttft_p50_ms": f"{s['ttft_p50_s'] * 1e3:.1f}",
            "ttft_p99_ms": f"{s['ttft_p99_s'] * 1e3:.1f}",
            "itl_p50_ms": f"{itl * 1e3:.2f}"}


def cluster_serve_bf16(params, cfg, card, total) -> None:
    """Phase 4's traffic (16 requests, 64 new) through 1 + 2 workers on
    the paged cache against the single paged engine: equal streams, the
    handoffs timed, TTFT / ITL / tok/s side by side; then a decode
    worker's step against the single engine's on the same prompts, by
    device time."""
    import numpy as np
    from repro_torch.serving import EngineConfig, ServingEngine, profile
    prompts = serve_prompts(cfg)
    eng, counts = run_engine(params, cfg, prompts, 64, kv_cache="paged")
    single = _check_engine("cluster_bf16 single", eng, counts, 16)
    _add(total, counts)
    want = _outputs(eng)
    del eng
    clu, _ = make_cluster(params, cfg, max_new_tokens=64, kv_cache="paged")
    for p in prompts:
        clu.submit(p)
    _, records = serve_cluster("cluster_bf16", clu, clu.run, total,
                               timed=True)
    s = cluster_gates("cluster_bf16", clu, records, want, 16, arch=ARCH,
                      run="'phase 4 traffic 1+2'")
    handoff_lines("cluster_bf16", records, card)
    for who, summ in (("single", single), ("cluster", s)):
        log("cluster_bf16", serving=who, **latency_fields(summ),
            requests=summ["requests"], decode_steps=summ["decode_steps"],
            card=f"'{card}'")
    del clu
    gc_empty()
    # a decode worker's step (8 live slots) against the single engine's
    # over the same 8 prompts, traced by torch.profiler
    clu, _ = make_cluster(params, cfg, max_new_tokens=10_000,
                          kv_cache="paged")
    for p in prompts:
        clu.submit(p)
    clu.step()
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=10_000,
        kv_cache="paged"))
    for p in prompts[::2]:       # decode worker 0's requests
        eng.submit(p)
    eng.step()
    w = clu.decode_workers[0]
    held = sorted(w.eng.slot_req[i].rid for i in w.live_slots())
    if held != list(range(0, 16, 2)):
        raise AssertionError(f"decode worker 0 holds {held}")
    with w.ctx():
        profile.measure("cluster_decode_worker", 3, w.eng.step, top=6)
    profile.measure("single_engine_decode", 3, eng.step, top=6)
    del clu, eng
    gc_empty()


def cluster_prefix_bf16(params, cfg, total) -> None:
    """Phase 6's 8 requests on a 512-token preamble through 2 prefill +
    2 decode workers with prefix caching: the router sends the warm
    prompts to the worker holding the preamble, each of them admitted
    through one chunk over the cached blocks (K4), exactly as the single
    engine with prefix caching admits them — whose streams the cluster's
    must equal; against the cold single engine the streams are printed
    (bf16 K4 over cached blocks and K3 over the whole prompt round
    alike only up to bf16). Every alias released after the drain."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    pre = rng.integers(0, cfg.vocab_size, size=PREAMBLE)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=n)]).astype(np.int32)
               for n in rng.integers(32, 257, size=8)]
    outs = {}
    for on in (False, True):
        eng, counts = run_engine(params, cfg, prompts, 32, kv_cache="paged",
                                 kv_block_size=BS, prefix_cache=on)
        _check_engine(f"cluster_bf16 prefix single on={on}", eng, counts, 8)
        _add(total, counts)
        outs[on] = _outputs(eng)
        del eng
    clu, _ = make_cluster(params, cfg, n_prefill=2, max_new_tokens=32,
                          kv_cache="paged", kv_block_size=BS,
                          prefix_cache=True)
    for p in prompts:
        clu.submit(p)
    _, records = serve_cluster("cluster_bf16", clu, clu.run, total)
    s = cluster_gates("cluster_bf16", clu, records, outs[True], 8,
                      arch=ARCH, run="'prefix affinity 2+2'")
    log("cluster_bf16", prefix_routed=s["prefix_routed"],
        prefix_hits=s["prefix_hits"],
        prefix_hit_tokens=s["prefix_hit_tokens"],
        equal_warm_single=_outputs(clu) == outs[True],
        equal_cold_single=_outputs(clu) == outs[False],
        warm_single_equal_cold=outs[True] == outs[False])
    if not (s["prefix_routed"] >= 1 and s["prefix_hits"] >= 1):
        raise AssertionError(f"prefix affinity: routed "
                             f"{s['prefix_routed']}, hits {s['prefix_hits']}")
    del clu
    gc_empty()


def cluster_traces_bf16(params, cfg, total) -> None:
    """The reference tests' traces on bf16 qwen: mixshift autoscaling
    (paged, 6-block pools, 1 + 3 workers, interval 4, prefill rate 2)
    against the single engine's replay; the overload trace through the
    SLO-aware router against the FIFO one; a short trace replayed twice
    with every step a straggler candidate (factor 1.0, auto-drain on)
    under the virtual clock."""
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.workload import (SLO, TenantSpec, make_trace,
                                              make_named_trace, replay)
    tr = make_named_trace("mixshift", vocab_size=cfg.vocab_size, seed=SEED)
    clu, _ = make_cluster(params, cfg, n_decode=3, max_batch=4,
                          max_seq_len=96, max_new_tokens=16,
                          kv_cache="paged", kv_block_size=BS, kv_blocks=6,
                          eos_token=-1,
                          ccfg=dict(autoscale=True, autoscale_interval=4,
                                    prefill_rate=2))
    rep, records = serve_cluster(
        "cluster_bf16", clu,
        lambda: replay(clu, tr, step_quantum_s=QUANTUM), total)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=4, max_seq_len=96, max_new_tokens=16, eos_token=-1))
    ref, counts = counted(lambda: replay(eng, tr, step_quantum_s=QUANTUM))
    check_launches("cluster_bf16 mixshift single", eng, counts)
    _add(total, counts)
    cluster_gates("cluster_bf16", clu, records, ref["outputs"],
                  len(tr.requests), arch=ARCH, run="'mixshift autoscale'")
    MIRRORED.append(dict(
        label="mixshift 1+3 autoscale", cfg=cfg, trace=tr, rep=rep,
        kw=dict(cluster=(1, 3), kv_cache="paged", kv_block_size=BS,
                kv_blocks=6, cluster_opts=dict(autoscale=True,
                                               autoscale_interval=4,
                                               prefill_rate=2)),
        cluster=dict(rescale_log=list(clu.rescale_log),
                     handoffs=clu.handoffs, migrations=clu.migrations,
                     kv_transfer_bytes=clu.kv_transfer_bytes,
                     packet_bytes=sum(r["kv_bytes"] for r in records))))
    dirs = {d for _, d in clu.rescale_log}
    n_workers = len(_workers(clu))
    log("cluster_bf16", trace="mixshift", requests=len(tr.requests),
        steps=rep["steps"], rescale_log=json.dumps(clu.rescale_log),
        handoffs=clu.handoffs, workers=n_workers,
        streams_equal_single=rep["outputs"] == ref["outputs"])
    if not (dirs == {"to_prefill", "to_decode"} and n_workers == 4
            and all(st % 4 == 0 for st, _ in clu.rescale_log)
            and clu.handoffs >= len(tr.requests)
            and rep["outputs"] == ref["outputs"]):
        raise AssertionError(f"mixshift: rescales {clu.rescale_log}, "
                             f"{n_workers} workers, {clu.handoffs} "
                             f"handoffs for {len(tr.requests)} requests")
    del clu, eng
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=SEED)
    reps = {}
    for slo in (False, True):
        clu, _ = make_cluster(params, cfg, max_batch=4, max_seq_len=96,
                              max_new_tokens=16, kv_cache="paged",
                              ccfg=dict(slo_aware=slo))
        reps[slo], _ = serve_cluster(
            "cluster_bf16", clu,
            lambda: replay(clu, tr, step_quantum_s=QUANTUM), total)
        chat = reps[slo]["summary"]["by_tenant"]["chat"]
        log("cluster_bf16", trace="overload", slo_aware=slo,
            steps=reps[slo]["steps"], tokens=reps[slo]["tokens"],
            chat_ttft_p99_s=f"{chat['ttft_p99_s']:.4f}",
            chat_slo_attainment=f"{chat['slo_attainment']:.3f}")
        del clu
    if reps[True]["outputs"] != reps[False]["outputs"]:
        raise AssertionError("overload: SLO-aware cluster streams != FIFO")
    tr = make_trace(
        (TenantSpec("t", rate_rps=25.0, prompt_len=(6, 10),
                    new_tokens=(3, 3), priority=0,
                    slo=SLO(ttft_s=float("inf"))),),
        0.3, vocab_size=cfg.vocab_size, seed=4)
    runs = []
    for _ in range(2):
        clu, _ = make_cluster(params, cfg, max_batch=2, max_seq_len=64,
                              max_new_tokens=4, eos_token=-1,
                              ccfg=dict(straggler_factor=1.0,
                                        auto_drain_stragglers=True))
        rep, _ = serve_cluster(
            "cluster_bf16", clu,
            lambda: replay(clu, tr, step_quantum_s=QUANTUM), total)
        runs.append((rep["outputs"], rep["steps"],
                     {r: q.ttft_s for r, q in rep["requests"].items()},
                     sum(len(w.monitor.events) for w in clu.decode_workers),
                     sum(w.draining for w in clu.decode_workers)))
        del clu
    log("cluster_bf16", trace="auto-drain under the virtual clock",
        requests=len(tr.requests), steps=runs[0][1],
        schedules_equal=runs[0] == runs[1],
        straggler_events=runs[0][3], drained=runs[0][4])
    if not (runs[0] == runs[1] and runs[0][0] and runs[0][3:] == (0, 0)):
        raise AssertionError(f"auto-drain replay: {runs}")
    gc_empty()


def phase_cluster(base, card: str) -> dict:
    """10a: float32 stream gates of the cluster (qwen against phase 3's
    streams, the other families against their own single engines); 10b:
    bf16 qwen, ``QWEN_CUT_LAYERS`` deep — serving, prefix affinity,
    autoscaling, SLO ordering and auto-drain. Returns the launch counts
    of its runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    t0 = time.perf_counter()
    total: dict = {}
    with step_deadline():
        cluster_qwen_f32(base, total)
    cluster_families_f32(total)
    t1 = time.perf_counter()
    with step_deadline():
        cfg = registry.get_config(ARCH).replace(n_layers=QWEN_CUT_LAYERS)
        params = MD.init_params(cfg, seed=SEED, device="cuda")
        cluster_serve_bf16(params, cfg, card, total)
        cluster_prefix_bf16(params, cfg, total)
        cluster_traces_bf16(params, cfg, total)
        del params
        gc_empty()
    log("cluster", seconds=f"{time.perf_counter() - t0:.1f}",
        seconds_f32=f"{t1 - t0:.1f}",
        seconds_bf16=f"{time.perf_counter() - t1:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 13: mesh serving, every shard on the one card
# ---------------------------------------------------------------------------

MESH_GATES = (((2, 2), "contiguous+blocking", {}),
              ((2, 2), "paged+blocking", {"kv_cache": "paged"}),
              ((2, 2), "paged+chunked", {"kv_cache": "paged", **CHUNKED}))
FALLBACK_MESH = (1, 3)       # qwen's 16 KV heads do not divide 3
FALLBACK_CAPACITY = 1152     # 3 shards of 384: whole 128-position splits
MOE_MESH = (1, 2)
BF16_MESH = (1, 4)
MESH_STEPS = 8           # 13c's greedy steps through the mesh, checked


def mesh_run(params, cfg, mesh, prompts, max_new, **ecfg):
    """Serve ``prompts`` on a mesh engine whose ``data * model`` shards
    all sit on the card (8 slots, capacity 2048 unless ``ecfg`` says
    otherwise); returns (engine, launch counts of exactly this run,
    wall seconds)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(params, cfg, EngineConfig(
        **{"max_batch": 8, "max_seq_len": 2048, **ecfg},
        max_new_tokens=max_new, mesh=mesh),
        devices=(CARD,) * (mesh[0] * mesh[1]))
    for p in prompts:
        eng.submit(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, ops.launch_counts(), time.perf_counter() - t0


def mesh_expected_launches(eng) -> tuple[dict, set]:
    """(launches per kernel, the kernels that must have run) of a mesh
    run: a one-request dispatch (prefill, chunk, draft prefill) runs on
    the model ranks of one data replica — on every rank where the
    weights are gathered over ``data`` or every replica holds every
    slot —, a batched one on every rank, each rank launching what one
    device would (:func:`expected_launches`); the sequence-sharded
    decode and chunk count as K1 and K4."""
    return expected_launches(eng, one=len(eng._request_ranks(0)),
                             every=eng.mesh.size)


def mesh_checks(phase, eng, counts, n_requests, partitioned=True,
                **fields) -> dict:
    """Launches exactly as the mesh path says, one target dispatch a
    step, every request finished, the KV partitioned (``partitioned``;
    an xLSTM holds none); one line with the mesh accounting."""
    s = eng.summary()
    _launch_gate(phase, counts, *mesh_expected_launches(eng))
    if s["decode_dispatches"] != s["decode_steps"]:
        raise AssertionError(f"{phase}: {s['decode_dispatches']} target "
                             f"dispatches over {s['decode_steps']} steps")
    if s["requests"] != n_requests:
        raise AssertionError(f"{phase}: {s['requests']} of {n_requests} "
                             "requests finished")
    if partitioned and s["kv_partitions"] < 2:
        raise AssertionError(f"{phase}: the KV is not partitioned")
    log(phase, mesh=f"{s['mesh'][0]}x{s['mesh'][1]}",
        kv_cache=s["kv_cache"], layout=eng.kv.layout,
        decode_steps=s["decode_steps"],
        dispatches_per_step=s["dispatches_per_step"],
        kv_partitions=s["kv_partitions"],
        peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
        resident_kv_bytes_per_device=s["resident_kv_bytes_per_device"],
        **fields)
    return s


def mesh_stream_gate(phase, got, want, what) -> None:
    log(phase, streams_equal=got == want, against=what)
    if got != want:
        raise AssertionError(f"{phase}: mesh streams {got} != {what} "
                             f"{want}")


def sharded_decode_case() -> None:
    """K1 split by position over the (1, 3) fallback's shards at its
    shapes (8 rows, 16 heads of 64, 1152 positions, lengths on both
    sides of the shard edges), bf16 and float32: every shard's result
    bitwise K1's over the whole cache (the shards hold whole splits),
    and within phase 2's tolerance of the plain version."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.kernels import decode_attention as K1
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    m = FALLBACK_MESH[1]
    mesh = DeviceMesh(FALLBACK_MESH, (CARD,) * m)
    b, cap, h, dh = 8, FALLBACK_CAPACITY, 16, 64
    c = cap // m
    lens = torch.tensor([1, 17, 383, 384, 385, 700, 1000, 1151],
                        dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        q, ek, ev = (_rand(gen, (b, 1, h, dh), dtype) for _ in range(3))
        k, v = (_rand(gen, (b, cap, h, dh), dtype) for _ in range(2))
        whole = K1.decode_attention(q, k, v, lens, extra_k=ek, extra_v=ev)
        want = ref.decode_attention(q, k, v, lens, extra_k=ek, extra_v=ev)

        def shard(r):
            with H.use_mesh(mesh, attn="seq", plan=(b, h)):
                return ops.decode_attention_shard(
                    q, k[:, r * c:(r + 1) * c].contiguous(),
                    v[:, r * c:(r + 1) * c].contiguous(), lens,
                    offset=r * c, capacity=cap, gather=H.gather_positions,
                    extra_k=ek, extra_v=ev, split=K1.split_size(b, h))

        outs = mesh.run(shard)
        err = (outs[0].float() - want.float()).abs().max().item()
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        bitwise = all(torch.equal(o, whole) for o in outs)
        log("mesh", kernel="decode_attention_shard", dtype=name,
            shards=m, positions=cap, bitwise_whole_k1=bitwise,
            max_abs_err_vs_plain=f"{err:.3e}", tol=TOL[name])
        if not bitwise or err > TOL[name]:
            raise AssertionError(f"sharded K1 ({name}): bitwise {bitwise}, "
                                 f"max |kernel - plain| {err:.3e}")
    mesh.close()


def sharded_prefill_case() -> None:
    """K4 split by position over the (1, 3) fallback's shards at a chunk
    and a verify shape (8 rows at the verify, 16 heads of 64, 1152
    positions, histories on both sides of the shard edges), bf16 and
    float32: the shards' partials merged in rank order give every shard
    the same bits, within phase 2's tolerance of the plain version over
    the whole history."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    m = FALLBACK_MESH[1]
    mesh = DeviceMesh(FALLBACK_MESH, (CARD,) * m)
    cap, h, dh = FALLBACK_CAPACITY, 16, 64
    c = cap // m
    for dtype in (torch.bfloat16, torch.float32):
        for what, b, s, hist in (
                ("verify", 8, 5, [0, 17, 383, 384, 385, 700, 1000, 1147]),
                ("chunk", 1, 256, [700])):
            hl = torch.tensor(hist, dtype=torch.int32, device="cuda")
            q = _rand(gen, (b, s, h, dh), dtype)
            ks, vs = (_rand(gen, (b, s, h, dh), dtype) for _ in range(2))
            k, v = (_rand(gen, (b, cap, h, dh), dtype) for _ in range(2))
            want = ref.prefill_attention(q, k, v, hl, ks, vs)

            def shard(r):
                with H.use_mesh(mesh, attn="seq"):
                    return ops.prefill_attention_shard(
                        q, k[:, r * c:(r + 1) * c].contiguous(),
                        v[:, r * c:(r + 1) * c].contiguous(), hl, ks, vs,
                        offset=r * c, gather=H.gather_positions)

            outs = mesh.run(shard)
            err = (outs[0].float() - want.float()).abs().max().item()
            name = "bfloat16" if dtype == torch.bfloat16 else "float32"
            same = all(torch.equal(o, outs[0]) for o in outs)
            log("mesh", kernel="prefill_attention_shard", case=what,
                dtype=name, shards=m, positions=cap, rows=b, queries=s,
                shards_bitwise_equal=same,
                max_abs_err_vs_plain=f"{err:.3e}", tol=TOL[name])
            if not same or err > TOL[name]:
                raise AssertionError(f"sharded K4 {what} ({name}): shards "
                                     f"equal {same}, max |kernel - plain| "
                                     f"{err:.3e}")
    mesh.close()


MESH_FAMILIES = ("whisper-large-v3", "zamba2-2.7b", "xlstm-350m")
FAMILY_MESH = (1, 2)


def mesh_families_f32(total) -> None:
    """13d: whisper (4 + 4 layers, 8a's traffic over capacity 8192),
    zamba2 (12 layers) and xlstm (8) in float32 at (1, 2) on 9a's
    traffic — the recurrent sublayers split by heads over model
    (:func:`recurrent_split_check`): the streams of their one-device
    engines (8a, 9a), exact launches, one dispatch a step, a clean
    dispatch audit of the mesh engine."""
    from repro_torch.core.costmodel import assert_no_drift, audit_engine
    from repro_torch.models import model as MD
    for arch in MESH_FAMILIES:
        cfg, prompts, base, ekw = FAMILY_STREAMS[arch]
        params = MD.init_params(cfg, seed=SEED, device="cuda")
        eng, counts, wall = mesh_run(params, cfg, FAMILY_MESH, prompts, 16,
                                     **ekw)
        mesh_checks("mesh_f32", eng, counts, len(prompts),
                    partitioned=cfg.family != "ssm", arch=arch,
                    depth=cfg.n_layers, config="contiguous+blocking",
                    wall_s=f"{wall:.2f}")
        _add(total, counts)
        mesh_stream_gate("mesh_f32", {r.rid: r.output for r in eng.finished},
                         base, "its one-device engine's (8a / 9a)")
        if cfg.family in ("ssm", "hybrid"):
            recurrent_split_check(eng, params)
        report = audit_engine(eng)
        assert_no_drift(report)
        log("mesh_f32", arch=arch, audit_ok=report["ok"],
            audited_dispatches=report["dispatches"])
        eng.mesh.close()
        del eng, params
        gc_empty()


def recurrent_split_check(eng, whole) -> None:
    """13d's zamba2 and xlstm run split: rank 0's Mamba2 in-projection,
    mLSTM ``wq`` and recurrent state hold 1 / model of the whole."""
    m = eng.mesh.shape[1]
    if "mamba" in whole:
        leaf, full = (t["mamba"]["mamba"]["in_proj"]
                      for t in (eng.params[0], whole))
        state = "ssm"
    else:
        leaf, full = (t["mlstm"]["wq"] for t in (eng.params[0], whole))
        state = "mlstm"
    heads = eng.kv._shards[0][state].shape[-3]
    whole_heads = eng.kv._meta[state].shape[-3]
    split = (leaf.shape[-1] * m == full.shape[-1]
             and heads * m == whole_heads)
    log("mesh_f32", arch=eng.cfg.name, recurrent_split=split,
        rank_columns=leaf.shape[-1], whole_columns=full.shape[-1],
        rank_state_heads=heads, whole_state_heads=whole_heads)
    if not split:
        raise AssertionError(f"{eng.cfg.name}: the recurrent sublayers are "
                             f"not split over model {m}")


def mesh_forward(eng, prompt, n_steps, feed=None, capacity=None):
    """A prefill of ``prompt`` and ``n_steps`` greedy decode steps (or
    the tokens of ``feed``) through the engine's mesh: each rank runs the
    port's ``prefill`` / ``decode_step`` on its shard over a one-row
    contiguous cache of ``capacity`` positions (by default the prompt
    and the steps; a rolling window's rolls) holding its heads, or every
    head in the engine's ``"replicated"`` layout — and, where the
    engine's weights split over ``data``, each layer's gathered at use.
    Returns (every step's logits, whole vocab, from rank 0; the tokens
    fed)."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.models import model as MD
    mesh, cfg_r = eng.mesh, eng._cfg_rank
    if eng._attn == "seq":
        raise ValueError("mesh_forward holds whole positions on a rank: "
                         "not the sequence-sharded layout")
    plan = (1, eng.cfg.n_kv_heads)
    cap = capacity or len(prompt) + n_steps + 1
    caches = [None] * mesh.size
    toks = torch.as_tensor(prompt[None], dtype=torch.int32)

    def run(fn):
        def one(r):
            with H.use_mesh(mesh, attn=eng._attn, plan=plan,
                            specs=eng._gather_specs):
                return fn(r)
        return mesh.run(one)

    def prefill(r):
        logits, caches[r] = MD.prefill(
            eng.params[r], cfg_r, {"tokens": toks.to(mesh.devices[r])}, cap)
        return logits

    out = [run(prefill)[0]]
    fed = []
    for i in range(n_steps):
        tok = (feed[i] if feed is not None
               else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
        fed.append(tok)

        def step(r, tok=tok):
            logits, caches[r] = MD.decode_step(
                eng.params[r], cfg_r, tok.to(mesh.devices[r]), caches[r])
            return logits

        out.append(run(step)[0])
    return out, fed


@contextlib.contextmanager
def mesh_routes(replay=None):
    """:func:`routes` per rank: every rank routes the same
    gathered hidden, so each keeps its own list of the experts it picked
    (``replay``: per rank, the lists to replay). Yields {rank: list}."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.models import moe as M
    route = M.route
    seen: dict = {}

    def rank():
        return H.current_mesh().rank()

    def recording(router_w, x, top_k):
        w, ids = route(router_w, x, top_k)
        seen.setdefault(rank(), []).append(ids)
        return w, ids

    def replaying(router_w, x, top_k):
        r = rank()
        mine = seen.setdefault(r, [])
        _, own = route(router_w, x, top_k)
        ids = replay[r][len(mine)]
        mine.append((own.sort(-1).values != ids.sort(-1).values)
                    .any(-1).sum())
        w = torch.softmax(x.float() @ router_w, dim=-1).gather(1, ids)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids

    M.route = recording if replay is None else replaying
    try:
        yield seen
    finally:
        M.route = route


@contextlib.contextmanager
def mesh_nudged():
    """:func:`nudged_moe_inputs` per rank: each rank's own
    generator from the seed, so the ranks nudge alike."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.models import moe as M
    apply_moe = M.apply_moe
    gens: dict = {}
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}

    def nudged(p, cfg, x):
        r = H.current_mesh().rank()
        if r not in gens:
            gens[r] = torch.Generator(device=x.device).manual_seed(SEED)
        up = torch.rand(x.shape, generator=gens[r], device=x.device) < 0.5
        bits = x.contiguous().view(ints[x.dtype])
        moved = (bits + torch.where(up, 1, -1).to(bits.dtype)).view(x.dtype)
        return apply_moe(p, cfg, torch.where(x == 0, x, moved))

    M.apply_moe = nudged
    try:
        yield
    finally:
        M.apply_moe = apply_moe


def mesh_qwen_f32(base, total) -> None:
    """13a: float32 qwen at phase 3's width and depth at (2, 2) on its
    traffic — contiguous and paged blocking and paged chunked 256 equal
    to phase 3's streams — and the sequence-sharded fallback at (1, 3)
    over capacity 1152, equal to one engine of the same capacity."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = qwen_f32_cfg()
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = gate_prompts(cfg)
    for mesh, label, kw in MESH_GATES:
        eng, counts, wall = mesh_run(params, cfg, mesh, prompts, 16, **kw)
        mesh_checks("mesh_f32", eng, counts, len(prompts), config=label,
                    wall_s=f"{wall:.2f}")
        _add(total, counts)
        mesh_stream_gate("mesh_f32", {r.rid: r.output for r in eng.finished},
                         base, "phase 3's")
        eng.mesh.close()
        del eng
    single, _ = run_engine(params, cfg, prompts, 16,
                           max_seq_len=FALLBACK_CAPACITY)
    want = {r.rid: r.output for r in single.finished}
    del single
    eng, counts, wall = mesh_run(params, cfg, FALLBACK_MESH, prompts, 16,
                                 max_seq_len=FALLBACK_CAPACITY)
    if eng.kv.layout != "seq":
        raise AssertionError(f"fallback layout {eng.kv.layout} != seq")
    mesh_checks("mesh_f32", eng, counts, len(prompts),
                config="contiguous+blocking (sequence fallback)",
                capacity=FALLBACK_CAPACITY, wall_s=f"{wall:.2f}")
    _add(total, counts)
    mesh_stream_gate("mesh_f32", {r.rid: r.output for r in eng.finished},
                     want, f"one engine at capacity {FALLBACK_CAPACITY}")
    eng.mesh.close()
    del eng, params
    gc_empty()


def mesh_moe_f32(total) -> None:
    """13b: float32 deepseek-moe-16b, 4 layers at capacity factor E / k,
    at (1, 2) — 32 experts a rank — on phase 3's traffic: phase 7a's
    streams."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    arch = FAMILY_ARCHS[0]
    cfg = registry.get_config(arch).replace(dtype="float32",
                                            n_layers=GATE_LAYERS)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    eng, counts, wall = mesh_run(params, dropless(cfg), MOE_MESH,
                                 gate_prompts(cfg), 16)
    mesh_checks("mesh_f32", eng, counts, 4, arch=arch, depth=GATE_LAYERS,
                config="contiguous+blocking", wall_s=f"{wall:.2f}")
    _add(total, counts)
    mesh_stream_gate("mesh_f32", {r.rid: r.output for r in eng.finished},
                     GATED[arch], "phase 7a's")
    eng.mesh.close()
    del eng, params
    gc_empty()


MOE_DROP_MESH = (2, 1)


def mesh_moe_drops_f32(total) -> None:
    """13e: float32 deepseek-moe-16b, 4 layers, at capacity factor 1.25
    over (2, 1) — each data replica 4 of the 8 slots — speculative on the
    paged cache, on phase 3's traffic: a verify dispatch drops routed
    slots, and the mesh drops the one-device engine's (its capacity of
    every replica's rows, its slots numbered after the lower replica's).
    The streams and the dropped slots of every dispatch equal the
    one-device engine's, and some dispatch drops."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    arch = FAMILY_ARCHS[0]
    cfg = registry.get_config(arch).replace(dtype="float32",
                                            n_layers=GATE_LAYERS)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = gate_prompts(cfg)
    kw = {"kv_cache": "paged", **SPECULATIVE}
    t0 = time.perf_counter()
    with counting_dispatch_drops() as want_drops:
        single, _ = run_engine(params, cfg, prompts, 16, **kw)
    want = {r.rid: r.output for r in single.finished}
    del single
    with counting_dispatch_drops() as drops:
        eng, counts, wall = mesh_run(params, cfg, MOE_DROP_MESH, prompts,
                                     16, **kw)
    # model 1: every rank holds every head, and the pools are whole over
    # data, as the reference's pool_shardings place them
    mesh_checks("mesh_f32", eng, counts, len(prompts), partitioned=False,
                arch=arch, depth=GATE_LAYERS,
                capacity_factor=cfg.moe_capacity_factor,
                config="paged+speculative", wall_s=f"{wall:.2f}")
    _add(total, counts)
    n_drops = sum(want_drops.values())
    log("mesh_f32", arch=arch, dropped_slots=n_drops,
        dispatches_dropping=sum(v > 0 for v in want_drops.values()),
        drops_equal=drops == want_drops,
        seconds=f"{time.perf_counter() - t0:.1f}")
    mesh_stream_gate("mesh_f32", {r.rid: r.output for r in eng.finished},
                     want, "the one-device engine's")
    if not n_drops:
        raise AssertionError("13e: no dispatch dropped a routed slot")
    if drops != want_drops:
        raise AssertionError(f"13e: the mesh drops {drops}, one device "
                             f"{want_drops}")
    eng.mesh.close()
    del eng, params
    gc_empty()


def single_forward(params, cfg, prompt, feed):
    """One device's prefill of ``prompt`` and a decode step for each of
    ``feed``'s tokens (the reference for :func:`mesh_forward`): every
    step's logits."""
    import torch
    from repro_torch.models import model as MD
    toks = torch.as_tensor(prompt[None], dtype=torch.int32, device="cuda")
    logits, cache = MD.prefill(params, cfg, {"tokens": toks},
                               len(prompt) + len(feed) + 1)
    out = [logits]
    for tok in feed:
        logits, cache = MD.decode_step(params, cfg, tok.to("cuda"), cache)
        out.append(logits)
    return out


def mesh_qwen_bf16(card, total) -> None:
    """13c: bf16 qwen at full width, ``QWEN_CUT_LAYERS`` deep, at (1, 4):
    phase 4's traffic (16 requests, 64 new tokens, 8 slots, contiguous +
    blocking) with exact launches, then the first prompt's prefill and 8
    greedy steps through the mesh with every K1 / K3 / K5 call of every
    shard held to its plain version on its own inputs
    (:func:`checked_kernels`, as 9b), each step's logits held to one
    device's on the same tokens (3e-2, argmax equal or a tie at rounding
    level)."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH).replace(n_layers=QWEN_CUT_LAYERS)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    eng, counts, wall = mesh_run(params, cfg, BF16_MESH, prompts, 64)
    s = mesh_checks("mesh_bf16", eng, counts, len(prompts),
                    tokens=s_tok(eng), wall_s=f"{wall:.2f}",
                    tok_per_s=f"{s_tok(eng) / wall:.1f}", card=f"'{card}'")
    log("mesh_bf16", ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
        itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
        note="host-bound: four ranks' launches from one interpreter")
    _add(total, counts)
    errs: dict = {}
    with checked_kernels(errs):
        got, fed = mesh_forward(eng, prompts[0], MESH_STEPS)
    want = single_forward(params, cfg, prompts[0], fed)
    log("mesh_bf16", checked_calls=json.dumps(
        {k: n for k, (n, _) in errs.items()}),
        max_abs_err=json.dumps({k: f"{e:.3e}" for k, (_, e) in errs.items()}),
        tol=TOL["bfloat16"])
    for name in ("add_rmsnorm", "flash_attention", "decode_attention"):
        if not errs.get(name, (0, 0))[0]:
            raise AssertionError(f"mesh_bf16: no {name} call was checked")
    for i, (g, w) in enumerate(zip(got, want)):
        rel, ties = _tie_gate(f"mesh_bf16 step {i}", g, w)
        log("mesh_bf16", logits="prefill" if i == 0 else f"decode_{i}",
            prompt_len=len(prompts[0]), rel_err=f"{rel:.3e}",
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            tol=TOL["bfloat16"], against="one device", ties=json.dumps(ties))
    eng.mesh.close()
    del eng, params
    gc_empty()


def s_tok(eng) -> int:
    return sum(len(r.output) for r in eng.finished)


def phase_mesh(base, card: str) -> dict:
    """Phase 13: mesh serving with every shard on the card — the
    sharded K1 and K4 at the fallback's shapes, 13a, 13b, 13c, 13d and
    13e.
    Returns the launch counts of its runs."""
    t0 = time.perf_counter()
    total: dict = {}
    with step_deadline():
        sharded_decode_case()
        sharded_prefill_case()
        mesh_qwen_f32(base, total)
        mesh_moe_f32(total)
        mesh_qwen_bf16(card, total)
        mesh_families_f32(total)
        mesh_moe_drops_f32(total)
    log("mesh", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 11: the static cost model — pricing on meta tensors, the dispatch
# audit, measured against predicted
# ---------------------------------------------------------------------------

# what the audit reads of the engines of phases 3, 4 and 6: (label,
# record), and the label of the phase whose engines are kept (None: none)
AUDITED: list = []
_audit_label = None


@contextlib.contextmanager
def auditing(label):
    """Keep, for 11b, the engines ``run_engine`` and ``keep_for_audit``
    see while this is open."""
    global _audit_label
    prev, _audit_label = _audit_label, label
    try:
        yield
    finally:
        _audit_label = prev


def keep_for_audit(eng, what="") -> None:
    """What ``costmodel.audit_engine`` reads of ``eng``: its dispatch log
    (operand shapes, no tensors), its dispatch functions, configs and the
    shapes of its params as meta tensors — none of its device memory."""
    from types import SimpleNamespace
    from repro_torch.core import trace as T
    if _audit_label is None:
        return
    label = (f"{_audit_label} {eng.kv.name}+{eng.scheduler.name}"
             + (f" {what}" if what else ""))
    AUDITED.append((label, SimpleNamespace(
        dispatch_log=eng.dispatch_log, _closures=eng._closures,
        _draft_closures=getattr(eng, "_draft_closures", None),
        params=T.to_meta(eng.params), draft_cfg=eng.draft_cfg,
        draft_params=(None if eng.draft_params is None
                      else T.to_meta(eng.draft_params)),
        cfg=eng.cfg, ecfg=eng.ecfg, kv=SimpleNamespace(name=eng.kv.name),
        scheduler=eng.scheduler.name, tel_label=eng.tel_label)))


# 11a: each family the port serves at its phase's config (layers: the
# phase's cut, None for full depth)
PRICED = (("qwen1.5-0.5b", None), ("phi3-mini-3.8b", None),
          ("deepseek-moe-16b", None), ("internvl2-26b", None),
          ("dbrx-132b", DBRX_LAYERS), ("h2o-danube-1.8b", None),
          ("mistral-7b", None), ("whisper-large-v3", None),
          ("zamba2-2.7b", None), ("xlstm-350m", None))
PRICE_BATCH, PRICE_LEN, PRICE_PREFILL, PRICE_CHUNK, PRICE_GAMMA = (
    8, 2048, 1024, 256, 4)
OTHER_BYTES = 4096.0
# params leaves a decode step reads as a product's weight, by name: the
# projections, the MoE router and experts, the recurrent blocks' (not
# Mamba2's depthwise conv_w, an elementwise window), and the head
PRODUCT_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "router", "in_proj", "out_proj", "w_i", "w_f", "w_in",
                  "w_rec", "w_ff_up", "w_ff_down", "head"}


def decode_weight_bytes(cfg, params) -> int:
    """Bytes of the params leaves one decode step reads as weights,
    counted from the tree by name: every product leaf, the embedding
    table only where it is the tied head (a decode gathers its rows),
    none of whisper's encoder (prefill only) nor its cross-attention's
    wk / wv (their K/V are cached), zamba2's shared block once for each
    of its groups."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(walk(v, path) for v in tree)
        name = path[-1]
        read = name in PRODUCT_LEAVES or (
            path == ("embed", "table") and cfg.tie_embeddings)
        if path[0] in ("enc_layers", "enc_norm") or (
                "xattn" in path and name in ("wk", "wv")):
            read = False
        n = tree.numel() * tree.element_size() if read else 0
        if cfg.family == "hybrid" and path[0] == "shared":
            n *= cfg.n_layers // cfg.attn_every
        return n
    return walk(params, ())


def _priced_line(arch, kind, ops, lin=None, **extra) -> None:
    from repro_torch.core import trace as T
    t = T.totals(ops)
    fields = dict(arch=arch, kind=kind, flops=f"{t.flops:.6g}",
                  bytes=f"{t.bytes:.6g}", weight_bytes=f"{t.weight_bytes:.6g}",
                  kernel_flops=f"{t.kernel_flops:.6g}", ops=len(ops))
    if lin is not None:
        fields["kv_bytes_per_position"] = (
            f"{sum(o.in_bytes[1] + o.out_bytes[1] for o in lin):.6g}")
    log("costmodel", **fields, **extra)


def _price_gates(arch, kind, ops) -> None:
    """No heavy "other" op, no kernel priced at zero FLOPs."""
    for o in ops:
        if o.kind == "other" and o.in_bytes + o.out_bytes > OTHER_BYTES:
            raise AssertionError(f"{arch} {kind}: unpriced op {o.prim} "
                                 f"moves {o.in_bytes + o.out_bytes:.0f} B")
        if o.kind == "kernel" and o.flops <= 0:
            raise AssertionError(f"{arch} {kind}: kernel {o.kernel} "
                                 "priced at zero FLOPs")


def price_families() -> None:
    """11a: every family's dispatches priced at full width on meta
    tensors (nothing allocated): a 1024-position prefill, the ragged
    decode of 8 rows over 2048 positions on both backends, a 256-token
    chunk over a 2048-position history, the gamma-4 verify of 8 rows —
    where the family has them. The decode's weight bytes are the params
    leaves it reads, and its KV slope 8 x ``kv_bytes_per_token`` (plus
    each layer's block tables on the paged cache)."""
    from repro_torch.configs import registry
    from repro_torch.core import costmodel as CM
    from repro_torch.serving.kv_cache import kv_bytes_per_token
    B, C = PRICE_BATCH, PRICE_LEN
    for arch, layers in PRICED:
        t0 = time.perf_counter()
        cfg = registry.get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        pricer = CM.DispatchPricer(cfg)
        ops = pricer.prefill_ops(1, PRICE_PREFILL)
        _price_gates(arch, "prefill", ops)
        _priced_line(arch, "prefill", ops)
        want_w = decode_weight_bytes(cfg, pricer._params_spec())
        for kv in ("contiguous", "paged"):
            try:
                lin = pricer.decode_ops_linear(B, C, ragged=True,
                                               kv_cache=kv)
            except ValueError as e:   # the engine falls back, warning
                log("costmodel", arch=arch, kind=f"decode {kv}",
                    refused=f"'{e}'")
                continue
            ops = [o.at(C) for o in lin]
            _price_gates(arch, f"decode {kv}", ops)
            w = sum(o.weight_bytes for o in ops)
            slope = sum(o.in_bytes[1] + o.out_bytes[1] for o in lin)
            want_slope = B * kv_bytes_per_token(cfg) + (
                cfg.n_layers * B * 4 / 16 if kv == "paged" else 0)
            k1 = sum(o.in_bytes + o.out_bytes for o in ops
                     if o.kind == "kernel" and "decode" in o.kernel)
            total = sum(o.in_bytes + o.out_bytes for o in ops)
            _priced_line(arch, f"decode {kv}", ops, lin,
                         want_weight_bytes=want_w,
                         want_kv_bytes_per_position=f"{want_slope:.6g}",
                         decode_kernel_byte_share=f"{k1 / total:.4f}")
            if w != want_w or abs(slope - want_slope) > 1e-6 * want_slope:
                raise AssertionError(
                    f"{arch} decode {kv}: weight bytes {w} (want {want_w}),"
                    f" KV slope {slope} (want {want_slope})")
        for kind, price in (
                ("chunk", lambda: pricer.chunk_ops(PRICE_CHUNK, C)),
                ("verify", lambda: pricer.verify_ops_linear(B, C,
                                                            PRICE_GAMMA))):
            try:
                got = price()
            except ValueError as e:
                log("costmodel", arch=arch, kind=kind, refused=f"'{e}'")
                continue
            lin = got if kind == "verify" else None
            ops = [o.at(C) for o in got] if lin else got
            _price_gates(arch, kind, ops)
            _priced_line(arch, kind, ops, lin)
        log("costmodel", arch=arch, layers=cfg.n_layers,
            priced_seconds=f"{time.perf_counter() - t0:.2f}")


def audit_runs(memo) -> None:
    """11b: every dispatch of the engines phases 3, 4 and 6 ran, traced
    through the engine's own functions: all priced, no drift, one target
    dispatch a step."""
    from repro_torch.core import costmodel as CM
    seen = set()
    for label, rec in AUDITED:
        t0 = time.perf_counter()
        rep = CM.audit_engine(rec, memo=memo)
        CM.assert_no_drift(rep)
        steps = [e["step"] for e in rec.dispatch_log
                 if e["kind"] in CM.TARGET_STEP_KINDS]
        if rep["priced"] != rep["dispatches"] or len(steps) != len(
                set(steps)):
            raise AssertionError(f"audit {label}: {rep['priced']} of "
                                 f"{rep['dispatches']} priced")
        seen.add((rec.kv.name, rec.scheduler))
        log("costmodel", audit=f"'{label}'", dispatches=rep["dispatches"],
            priced=rep["priced"], kinds=json.dumps(dict(rep["kinds"])),
            seconds=f"{time.perf_counter() - t0:.2f}")
    want = {(kv, s) for kv in ("contiguous", "paged")
            for s in ("blocking", "chunked", "speculative", "slo")}
    if not want <= seen:
        raise AssertionError(f"audited {sorted(seen)}, not {sorted(want)}")


def h100_profile():
    """One card of ``DGX_H100`` (eight): 989.5 TFLOP/s, 3350 GB/s."""
    from dataclasses import replace
    from repro_torch.core.profiles import DGX_H100
    return replace(DGX_H100, name="h100 (dgx-h100 / 8)",
                   tops=DGX_H100.tops / 8, mem_bw_gbs=DGX_H100.mem_bw_gbs / 8,
                   vector_gops=DGX_H100.vector_gops / 8,
                   cost_usd=DGX_H100.cost_usd / 8)


# the kernels' device names, by the wrapper that launches them
KERNEL_NAMES = (("decode", ("decode_partial_kernel", "decode_combine_kernel")),
                ("add_rmsnorm", ("add_rmsnorm_kernel",)),
                ("flash_attention", ("flash_fwd_kernel", "flash_bf16_kernel")),
                ("prefill_attention", ("prefill_hist_kernel",
                                       "chunk_bf16_kernel",
                                       "verify_split_kernel",
                                       "verify_combine_kernel")),
                ("quant_gemv", ("quant_gemv_kernel", "quant_mma_kernel")))


@contextlib.contextmanager
def costed_launches(calls):
    """Each kernel module's wrapper appends (group, flops, bytes, dtype)
    of every call to ``calls``: ``ops.call_cost`` at the call's real
    lengths (read from the card: a synchronisation, outside any kernel's
    device time)."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as kpdec
    from repro_torch.kernels import prefill_attention as kpre
    from repro_torch.kernels import quant_gemv as kqg
    from repro_torch.kernels import rmsnorm as krn
    saved = {}
    for mod, name in ((kdec, "decode_attention"),
                      (kpdec, "paged_decode_attention"),
                      (krn, "add_rmsnorm"), (kfa, "flash_attention"),
                      (kpre, "prefill_attention"), (kqg, "quant_gemv")):
        fn = saved[mod, name] = getattr(mod, name)
        group = "decode" if name.endswith("decode_attention") else name

        def wrapped(*a, _fn=fn, _name=name, _group=group, **kw):
            calls.append((_group, *ops.call_cost(_name, *a, **kw),
                          str(a[0].dtype).removeprefix("torch.")))
            return _fn(*a, **kw)
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def kernel_bounds(eng, card) -> None:
    """One decode step of 8 live slots traced by ``torch.profiler``: each
    kernel's device time against the bound of its cost() at the step's
    real lengths. A kernel that beats its bound by more than 5% means
    its cost() overcounts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(DEVICE_TRIES):
        calls: list = []
        with costed_launches(calls), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        dev = {}
        step_us = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            step_us += e.self_device_time_total
            for group, names in KERNEL_NAMES:
                if any(n in e.key for n in names):
                    dev[group] = dev.get(group, 0.0) + (
                        e.self_device_time_total / 1e3)
        if dev:
            break
    else:
        raise AssertionError("the decode step's trace held no device time")
    PROFILED_STEP.update(device_ms=step_us / 1e3,
                         kernels_ms=sum(dev.values()))
    for group in sorted({c[0] for c in calls}):
        mine = [c for c in calls if c[0] == group]
        bound = sum(bound_ms(nb, fl, d)[0] for _, fl, nb, d in mine)
        ms = dev.get(group, 0.0)
        log("costmodel", kernel=group, calls=len(mine),
            device_ms=f"{ms:.5f}", bound_ms=f"{bound:.6f}",
            bound_share=f"{bound / ms:.4f}" if ms else "null",
            card=f"'{card}'")
        if not ms or bound > 1.05 * ms:
            raise AssertionError(f"{group}: device {ms} ms against the "
                                 f"bound {bound} ms of its cost()")


def calibration_runs(card, memo) -> None:
    """11c: phase 4's traffic on bf16 qwen, paged + chunked 256, with
    telemetry on — every dispatch's measured wall against the cost
    model's roofline on one card (``model_error_ratio`` >= 0.95 and
    finite for every kind) — then one decode step's kernels against
    their bounds."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import costmodel as CM
    from repro_torch.models import model as MD
    from repro_torch.serving import EngineConfig, ServingEngine, Telemetry
    from repro_torch.serving.telemetry import (dispatch_calibration,
                                               format_calibration)
    cfg = registry.get_config(ARCH)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    run_engine(params, cfg, prompts[:2], 4)  # warm-up (allocator, cuBLAS)
    tel = Telemetry()
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=64, kv_cache="paged",
        **CHUNKED), telemetry=tel)
    for p in prompts:
        eng.submit(p)
    _, counts = counted(eng.run)
    _check_engine("costmodel calibration", eng, counts, len(prompts))
    t0 = time.perf_counter()
    CM.assert_no_drift(CM.audit_engine(eng, memo=memo))
    profile = h100_profile()
    table = dispatch_calibration(eng, tel, profile, memo=memo)
    for line in format_calibration(table).splitlines():
        log("costmodel", calibration=f"'{line}'")
    log("costmodel", profile=f"'{profile.name}'",
        peak_tflops=profile.ops_per_s / 1e12,
        peak_gb_per_s=profile.mem_bw_gbs, card=f"'{card}'",
        join_seconds=f"{time.perf_counter() - t0:.2f}")
    for kind, row in table.items():
        r = row["model_error_ratio"]
        if not (math.isfinite(r) and r >= 0.95):
            raise AssertionError(f"calibration {kind}: measured / predicted "
                                 f"{r} (a wall under the roofline means "
                                 "the cost model undercounts)")
    del eng
    torch.cuda.empty_cache()
    # one decode step of 8 live slots (prompts of 256-1023 tokens)
    rng = np.random.default_rng(SEED + 22)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=10_000,
        kv_cache="paged", **CHUNKED))
    for n in rng.integers(256, 1024, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=int(n)))
    while eng.waiting or eng.prefilling:
        eng.step()
    for _ in range(3):
        eng.step()
    # the positions the profiled step attends over, as a decode step
    # reads them (each live row's cache length)
    PROFILED_STEP["positions"] = [int(eng.slot_pos[i]) for i, r in
                                  enumerate(eng.slot_req) if r is not None]
    kernel_bounds(eng, card)
    del eng, params
    torch.cuda.empty_cache()


def phase_costmodel(card: str) -> None:
    """Phase 11: 11a full-width pricing on meta, 11b the audit of phases
    3, 4 and 6's engines, 11c the calibration and the kernels' bounds."""
    import torch
    t0 = time.perf_counter()
    with step_deadline():
        price_families()
    t1 = time.perf_counter()
    memo: dict = {}
    with step_deadline():
        audit_runs(memo)
    t2 = time.perf_counter()
    with step_deadline():
        calibration_runs(card, memo)
    torch.cuda.empty_cache()
    log("costmodel", seconds=f"{time.perf_counter() - t0:.1f}",
        pricing_seconds=f"{t1 - t0:.1f}",
        audit_seconds=f"{t2 - t1:.1f}",
        calibration_seconds=f"{time.perf_counter() - t2:.1f}",
        card=f"'{card}'")


# ---------------------------------------------------------------------------
# phase 12: the simulator — its schedule mirror against the replays the
# card ran, the paper's scenarios, predicted against measured
# ---------------------------------------------------------------------------

def _ttfts(requests) -> dict:
    return {rid: req.ttft_s for rid, req in requests.items()}


def mirror_runs() -> None:
    """12a: ``LLMSimulator.serve(trace=)`` at each kept replay's engine
    settings: the schedule must equal the card's — admission order,
    preemption log, steps, decode steps, each request's virtual TTFT
    and token count, the prefix ledger; for the cluster the rescale log,
    handoffs, migrations and transferred KV bytes (also against the
    packets the card exported)."""
    from repro_torch.core.profiles import PIM_AI_SERVER
    from repro_torch.core.simulator import LLMSimulator
    if len(MIRRORED) != 7:
        raise AssertionError(f"phase 12a: {len(MIRRORED)} replays kept, "
                             "want 7 (4 overload, 2 sharedprefix, mixshift)")
    for run in MIRRORED:
        rep, clu = run["rep"], run.get("cluster")
        r = LLMSimulator(run["cfg"], PIM_AI_SERVER).serve(
            trace=run["trace"], max_batch=4, max_seq_len=96,
            step_quantum_s=QUANTUM, **run["kw"])
        want = {"steps": rep["steps"], "decode_steps": rep["decode_steps"],
                "ttfts": _ttfts(rep["requests"]),
                "tokens": {i: len(o) for i, o in rep["outputs"].items()}}
        got = {"steps": r["steps"], "decode_steps": r["decode_steps"],
               "ttfts": _ttfts(r["requests"]),
               "tokens": {i: len(q.output) for i, q in
                          r["requests"].items()}}
        if clu is None:
            for k in ("admission_order", "preemption_log"):
                want[k], got[k] = rep[k], r[k]
            for k in ("prefix_hits", "prefix_hit_tokens", "prefix_evictions"):
                want[k], got[k] = rep["summary"][k], r[k]
        else:
            for k in ("rescale_log", "handoffs", "migrations",
                      "kv_transfer_bytes"):
                want[k], got[k] = clu[k], r[k]
            want["packet_bytes"], got["packet_bytes"] = (
                clu["packet_bytes"], r["kv_transfer_bytes"])
        bad = sorted(k for k in want if got[k] != want[k])
        log("simulator", mirror=f"'{run['label']}'",
            requests=len(run["trace"].requests), steps=r["steps"],
            decode_steps=r["decode_steps"],
            preemptions=r["summary"]["preemptions"],
            prefix_hits=r["prefix_hits"],
            kv_transfer_bytes=r.get("kv_transfer_bytes", 0),
            equal=f"{len(want) - len(bad)}/{len(want)}",
            priced_energy_j=f"{r['energy_j']:.6g}")
        if bad:
            raise AssertionError(f"phase 12a {run['label']}: the simulated "
                                 f"schedule differs from the card's in "
                                 f"{bad}")


# every band of tests/test_paper_claims.py: (cell, key, low, high)
CLOUD_BANDS = (("gqa", "ttft", 2.4, 3.3), ("mha", "ttft", 1.3, 2.1),
               (None, "tokens_per_s", 2.23 * 0.75, 2.75 * 1.25),
               (None, "energy_per_token", 1.18, 1.67 * 1.25),
               (None, "qps", 1.4, float("inf")),
               (None, "energy_per_query", 0.85, 1.35),
               (None, "tco_per_qps", 6.2 * 0.9, 6.94 * 1.15))
MOBILE_BANDS = {
    "a17-pro": {"tokens_per_s": (1.40, 1.60), "energy_per_token": (17, 22),
                "qps": (1.35, 1.55), "energy_per_query": (11.5, 14.8)},
    "snapdragon-8-gen3": {"tokens_per_s": (1.18, 1.35),
                          "energy_per_token": (8.5, 11.5),
                          "qps": (1.18, 1.35),
                          "energy_per_query": (6.0, 7.6)},
    "dimensity-9300": {"tokens_per_s": (1.18, 1.35),
                       "energy_per_token": (8.5, 11.5), "qps": (1.18, 1.35),
                       "energy_per_query": (6.0, 7.6)},
}
# §4.2.1's encode-energy savings of llama2-7b, +- 7 points
ENCODE_SAVINGS = {"a17-pro": 0.285, "snapdragon-8-gen3": 0.164,
                  "dimensity-9300": 0.153}


def paper_scenarios() -> None:
    """12b: ``run_cloud`` for both models x GQA / MHA and ``run_mobile``
    for llama2-7b and mistral-7b (and the 1000 / 1000 runs of §5.1) on
    this host: every band of the reference's paper-claims test, each
    ratio printed (model outputs of ``core/profiles.py``)."""
    from repro_torch.core import profiles as HW
    from repro_torch.core.scenarios import run_cloud, run_mobile
    checks = []   # (what, value, low, high)
    for got, want in HW.check_composition().values():
        checks.append(("table1 composition", got - want, -1e-6, 1e-6))
    cloud = {(m, a): run_cloud(m, a) for m in ("llama2-70b", "mixtral-8x22b")
             for a in ("gqa", "mha")}
    for (m, a), r in cloud.items():
        ra = r["ratios"]
        log("simulator", scenario=f"'cloud {m} {a}'",
            **{k: f"{v:.4f}" for k, v in ra.items()})
        for cell, key, lo, hi in CLOUD_BANDS:
            if cell in (None, a):
                checks.append((f"cloud {m} {a} {key}", ra[key], lo, hi))
    qps = [r["ratios"]["qps"] for r in cloud.values()]
    checks.append(("cloud mean qps", sum(qps) / len(qps), 1.5, 2.2))
    long = run_cloud("llama2-70b", "gqa", 1000, 1000)["ratios"]
    short = cloud["llama2-70b", "gqa"]["ratios"]
    for key in ("qps", "energy_per_query"):
        checks.append((f"cloud 1000/1000 over 1000/100 {key}",
                       long[key] / short[key], 1.0 + 1e-12, float("inf")))
    for m in ("llama2-7b", "mistral-7b"):
        r = run_mobile(m)
        tt = [q.ttft_s for q in r["profiles"].values()]
        checks.append((f"mobile {m} ttft max/min", max(tt) / min(tt), 0.0,
                       1.4 - 1e-12))
        for hw, bands in MOBILE_BANDS.items():
            ra = r["ratios"][hw]
            log("simulator", scenario=f"'mobile {m} {hw}'",
                **{k: f"{v:.4f}" for k, v in ra.items()})
            for key, (lo, hi) in bands.items():
                checks.append((f"mobile {m} {hw} {key}", ra[key], lo, hi))
        if m == "llama2-7b":
            enc = {k: v["encode"].energy_j for k, v in r["raw"].items()}
            for hw, want in ENCODE_SAVINGS.items():
                saving = 1 - enc["pim-ai-mobile"] / enc[hw]
                checks.append((f"mobile {m} {hw} encode saving", saving,
                               want - 0.07, want + 0.07))
    ra = run_mobile("llama2-7b", 1000, 1000)["ratios"]
    checks.append(("mobile 1000/1000 a17-pro energy_per_query",
                   ra["a17-pro"]["energy_per_query"], 17.5, 20.5))
    checks.append(("mobile 1000/1000 snapdragon energy_per_query",
                   ra["snapdragon-8-gen3"]["energy_per_query"], 9.0, 10.8))
    bad = [c for c in checks if not c[2] <= c[1] <= c[3]]
    log("simulator", paper_bands=len(checks), held=len(checks) - len(bad),
        tco_per_qps=",".join(f"{r['ratios']['tco_per_qps']:.4f}"
                             for r in cloud.values()))
    if bad:
        raise AssertionError(f"phase 12b: bands missed: {bad}")


def predicted_against_measured(card: str) -> None:
    """12c (printed, no gate): the simulator on one card of DGX_H100
    against what this card measured — 11c's profiled decode step (8
    live slots, paged) by its whole device time, and phase 4's traffic
    on contiguous + blocking (16 requests, 64 tokens each, 8 slots: two
    waves of 8) by TTFT p50 and ITL p50."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.core.simulator import LLMSimulator
    cfg = registry.get_config(ARCH)
    sim = LLMSimulator(cfg, h100_profile())
    pos = PROFILED_STEP["positions"]
    step = sim.decode(len(pos), float(np.mean(pos)), 1, ragged=True,
                      kv_cache="paged", kv_block_size=BS)
    log("simulator", predicted="'11c decode step'", rows=len(pos),
        mean_positions=f"{np.mean(pos):.1f}",
        predicted_ms=f"{step.seconds * 1e3:.5f}",
        predicted_bytes=f"{step.mem_bytes:.6g}",
        measured_device_ms=f"{PROFILED_STEP['device_ms']:.5f}",
        measured_kernels_ms=f"{PROFILED_STEP['kernels_ms']:.5f}",
        measured_over_predicted=(
            f"{PROFILED_STEP['device_ms'] / (step.seconds * 1e3):.4f}"),
        profile=f"'{sim.hw.name}'", card=f"'{card}'")
    lens = [len(p) for p in serve_prompts(cfg)]
    t0, ttfts, itl = 0.0, [], []
    for wave in (lens[:8], lens[8:]):
        r = sim.serve(wave, 63, max_seq_len=2048)
        ttfts += [t0 + t for t in r["ttft_per_req_s"]]
        itl.append(r["decode"].seconds / 63)
        t0 += r["encode"].seconds + r["decode"].seconds
    got = SERVED["engine_bf16", "contiguous+blocking"]
    p_ttft, p_itl = float(np.median(ttfts)), float(np.mean(itl))
    log("simulator", predicted="'phase 4 contiguous+blocking'",
        requests=len(lens), predicted_ttft_p50_ms=f"{p_ttft * 1e3:.4f}",
        measured_ttft_p50_ms=f"{got['ttft_p50_s'] * 1e3:.4f}",
        predicted_itl_ms=f"{p_itl * 1e3:.5f}",
        measured_itl_p50_ms=f"{got['itl_p50_s'] * 1e3:.4f}",
        itl_measured_over_predicted=f"{got['itl_p50_s'] / p_itl:.4f}",
        ttft_measured_over_predicted=f"{got['ttft_p50_s'] / p_ttft:.4f}",
        profile=f"'{sim.hw.name}'", card=f"'{card}'")


def phase_simulator(card: str) -> None:
    """Phase 12: 12a the schedule mirror against phases 6 and 10's
    replays, 12b the paper's scenarios, 12c predicted against measured.
    Host work only: the simulator traces on meta tensors."""
    t0 = time.perf_counter()
    with step_deadline():
        mirror_runs()
    t1 = time.perf_counter()
    with step_deadline():
        paper_scenarios()
    t2 = time.perf_counter()
    predicted_against_measured(card)
    log("simulator", seconds=f"{time.perf_counter() - t0:.1f}",
        mirror_seconds=f"{t1 - t0:.1f}", scenario_seconds=f"{t2 - t1:.1f}",
        predicted_seconds=f"{time.perf_counter() - t2:.1f}")


# ---------------------------------------------------------------------------
# phase 14: single-device training
# ---------------------------------------------------------------------------

TRAIN_DEVICE = "cuda"
GATE_SHAPE = (2, 2048)      # 14b: B x S — two q chunks of 1024, one skipped
TRAIN_SHAPE = (4, 2048)     # 14c: B x S, 8192 rows a step
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 13
TRAIN_FAMILIES = ("deepseek-moe-16b", "internvl2-26b", "whisper-large-v3",
                  "h2o-danube-1.8b", "zamba2-2.7b", "xlstm-350m")
FAMILY_SHAPE = (2, 64)      # 14c's smoke-config steps: past danube's window
EXAMPLE_STEPS = 100         # 14d
# float32 gradients, kernel path against plain: each leaf normwise within
# GRAD_RTOL of its own norm plus GRAD_ATOL of the whole gradient's (a
# leaf whose gradient nearly cancels, zamba2's A_log, is float32 noise at
# its own scale); the loss within LOSS_RTOL
GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-5
# microbatch 2 == 1 after one AdamW step: the reference test's tolerance
MB_RTOL, MB_ATOL = 1e-4, 1e-5
LOSS_DROP = 0.3             # 14d: mean of the last 5 below the first 5


def train_cfg(arch=ARCH, **kw):
    from repro_torch.configs import registry
    return registry.get_config(arch).replace(**kw)


def family_cfg(arch):
    from repro_torch.configs import registry
    return registry.get_smoke_config(arch).replace(dtype="float32")


def _sync():
    import torch
    if TRAIN_DEVICE != "cpu":
        torch.cuda.synchronize()


def train_counted(fn):
    """(fn(), forward launches, K5b launches) of exactly this call."""
    from repro_torch.kernels import ops
    _sync()
    ops.reset_launch_counts()
    out = fn()
    _sync()
    return out, ops.launch_counts(), ops.backward_launch_counts()


def grad_gate(phase, what, got, want) -> float:
    """Every leaf of ``got`` within GRAD_RTOL of ``want``'s norm plus
    GRAD_ATOL of the whole gradient's; returns the worst leaf's error
    relative to its own norm."""
    import torch
    from repro_torch import tree as T
    gl, wl = T.paths(got), T.paths(want)
    whole = torch.sqrt(sum(w.float().square().sum() for _, w in wl)).item()
    worst, name, fails = 0.0, "", []
    for (k, g), (_, w) in zip(gl, wl):
        err = (g.float() - w.float()).norm().item()
        ref_n = w.float().norm().item()
        rel = err / max(ref_n, 1e-30)
        if rel > worst:
            worst, name = rel, k
        if err > GRAD_RTOL * ref_n + GRAD_ATOL * whole:
            fails.append(f"{k}: {err:.3e} of {ref_n:.3e}")
    log(phase, check=f"{what}_grads", leaves=len(gl),
        worst_leaf=f"'{name}'", worst_rel_err=f"{worst:.3e}",
        whole_grad_norm=f"{whole:.4e}", rtol=GRAD_RTOL,
        atol_of_whole=GRAD_ATOL)
    if fails:
        raise AssertionError(f"{phase} {what}: gradients off the plain "
                             f"path's: {fails[:4]}")
    return worst


def _loss_gate(phase, what, got, want) -> None:
    rel = abs(got - want) / abs(want)
    log(phase, check=f"{what}_loss", kernels=f"{got:.8f}",
        plain=f"{want:.8f}", rel_err=f"{rel:.3e}", tol=LOSS_RTOL)
    if rel > LOSS_RTOL:
        raise AssertionError(f"{phase} {what}: loss {got} against the "
                             f"plain path's {want}")


def _k5_gate(phase, counts, bwd, want_fwd, want_bwd) -> None:
    log(phase, k5_launches=counts["rmsnorm"], expected_k5=want_fwd,
        k5b_launches=bwd["add_rmsnorm_bwd"], expected_k5b=want_bwd,
        other_launches=sum(v for k, v in counts.items() if k != "rmsnorm"))
    if (counts["rmsnorm"] != want_fwd or bwd["add_rmsnorm_bwd"] != want_bwd
            or any(v for k, v in counts.items() if k != "rmsnorm")):
        raise AssertionError(f"{phase}: launches {counts} {bwd}, expected "
                             f"K5 {want_fwd} and K5b {want_bwd} only")


def train_gate_f32(total) -> None:
    """14b: full-width, full-depth qwen in float32 (remat "full"), one
    ``loss_fn`` and backward through K5 / K5b against the plain path on
    the card; then one train step at microbatch 2 against microbatch 1."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    cfg = train_cfg(dtype="float32")
    b, s = GATE_SHAPE
    params = MD.init_params(cfg, seed=SEED, device=TRAIN_DEVICE)
    batch = MD.make_dummy_batch(cfg, b, s, seed=SEED, device=TRAIN_DEVICE)
    t0 = time.perf_counter()
    (loss, grads), counts, bwd = train_counted(
        lambda: ST.loss_and_grads(params, cfg, batch))
    kernel_s = time.perf_counter() - t0
    _add(total, {**counts, **bwd})
    norms = 2 * cfg.n_layers + 1
    _k5_gate("train_f32", counts, bwd, 2 * norms - 1, norms)
    with plain_kernels():
        t0 = time.perf_counter()
        loss_p, grads_p = ST.loss_and_grads(params, cfg, batch)
        _sync()
        plain_s = time.perf_counter() - t0
    _loss_gate("train_f32", "qwen", loss.item(), loss_p.item())
    grad_gate("train_f32", "qwen", grads, grads_p)
    del grads, grads_p
    log("train_f32", batch=b, seq=s, remat=cfg.remat,
        kernels_s=f"{kernel_s:.2f}", plain_s=f"{plain_s:.2f}")
    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                          weight_decay=0.0))
    outs = {}
    for mb in (1, 2):
        (loss, grads), counts, bwd = train_counted(
            lambda: ST.accumulated_grads(params, cfg.replace(microbatch=mb),
                                         batch))
        _add(total, {**counts, **bwd})
        p, _, _ = opt.apply(grads, opt.init(params), params)
        outs[mb] = (loss.item(), grads, p)
    _check_microbatch("train_f32", outs)


def _check_microbatch(phase, outs) -> None:
    """Microbatch 2 against 1: the loss within LOSS_RTOL and every
    gradient element within the reference test's rtol / atol; after one
    AdamW step, every param element off by more than that tolerance
    must be one whose gradient sits at float32 noise (the two runs'
    gradients differ by over 1% of it) — Adam's first update is
    lr * g / (|g| + eps), ±lr for any |g| well above eps, so such an
    element's sign may flip."""
    from repro_torch import tree as T
    (l1, g1, p1), (l2, g2, p2) = outs[1], outs[2]
    worst_g = worst_p = 0.0
    flipped = noisy = 0
    for a, c, ga, gc in zip(T.leaves(p1), T.leaves(p2), T.leaves(g1),
                            T.leaves(g2)):
        ga, gc = ga.float(), gc.float()
        dg = (ga - gc).abs()
        worst_g = max(worst_g, dg.max().item())
        if ((dg - (MB_ATOL + MB_RTOL * gc.abs())).max().item() > 0):
            raise AssertionError(f"{phase}: microbatch 2 gradients off "
                                 "microbatch 1's past the tolerance")
        dp = (a.float() - c.float()).abs()
        worst_p = max(worst_p, dp.max().item())
        off = dp > MB_ATOL + MB_RTOL * c.float().abs()
        flipped += int(off.sum())
        noisy += int((off & (dg > 0.01 * ga.abs())).sum())
    rel = abs(l1 - l2) / abs(l1)
    log(phase, check="microbatch_2_vs_1", loss_1=f"{l1:.8f}",
        loss_2=f"{l2:.8f}", loss_rel_err=f"{rel:.3e}",
        grads_max_abs_err=f"{worst_g:.3e}",
        params_max_abs_err_after_adamw=f"{worst_p:.3e}",
        params_off_tolerance=flipped, of_them_at_gradient_noise=noisy,
        rtol=MB_RTOL, atol=MB_ATOL)
    if rel > LOSS_RTOL or noisy != flipped:
        raise AssertionError(f"{phase}: microbatch 2 against 1: loss "
                             f"{l2} / {l1}, {flipped - noisy} params off "
                             "with a gradient above its noise")


def train_argv(ckpt_dir, extra=()) -> list:
    b, s = TRAIN_SHAPE
    return ["--arch", ARCH, "--device", TRAIN_DEVICE, "--steps",
            str(TRAIN_STEPS), "--batch", str(b), "--seq", str(s),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--ckpt-dir", ckpt_dir,
            "--log-every", "10", "--seed", str(SEED), *extra]


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms on (cuBLAS's workspace set in the
    phase's environment, before CUDA started); an op with no
    deterministic form raises instead of running."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def train_bf16(card, total) -> None:
    """14c: full-width qwen in bf16 (remat "full") through
    ``launch.train``: 20 steps checkpointed every 10, then the same run
    failing once at step 13 under ``RestartPolicy`` — its final params
    and optimizer state bitwise the uninterrupted run's — then
    ``launch.serve --ckpt-dir`` serving from that checkpoint."""
    import tempfile
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import serve, train
    cfg = train_cfg()
    b, s = TRAIN_SHAPE
    norms = 2 * cfg.n_layers + 1
    lines = []
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2, deterministic():
        if TRAIN_DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run, counts, bwd = train_counted(
            lambda: train.train(train_argv(d1), log=lines.append))
        run_s = time.perf_counter() - t0
        _add(total, {**counts, **bwd})
        peak = (0 if TRAIN_DEVICE == "cpu"
                else torch.cuda.max_memory_allocated())
        _k5_gate("train_bf16", counts, bwd, TRAIN_STEPS * (2 * norms - 1),
                 TRAIN_STEPS * norms)
        t0 = time.perf_counter()
        again, counts2, bwd2 = train_counted(lambda: train.train(
            train_argv(d2, ["--inject-failure-at", str(TRAIN_FAIL_AT)]),
            log=lines.append))
        again_s = time.perf_counter() - t0
        _add(total, {**counts2, **bwd2})
        equal = all(torch.equal(x, y) for x, y in zip(
            T.leaves(run["state"]), T.leaves(again["state"])))
        log("train_bf16", check="resume_after_failure_bitwise",
            equal=equal, restarts=again["restarts"], end=again["step"],
            steps_run=len(again["losses"]), fail_at=TRAIN_FAIL_AT,
            seconds=f"{again_s:.1f}", k5=counts2["rmsnorm"],
            k5b=bwd2["add_rmsnorm_bwd"])
        if not (equal and again["restarts"] == 1
                and again["step"] == TRAIN_STEPS):
            raise AssertionError("train_bf16: the resumed run's state is "
                                 "not the uninterrupted run's")
        train_metrics(card, cfg, run, run_s, peak, norms, lines)
        del run, again
        t0 = time.perf_counter()
        (rc, served), counts3, bwd3 = train_counted(lambda: _serve_ckpt(
            serve, d2))
        _add(total, {**counts3, **bwd3})
        log("train_bf16", check="serve_from_checkpoint", rc=rc,
            seconds=f"{time.perf_counter() - t0:.1f}",
            launches=json.dumps(counts3), **served)
        if rc != 0 or served.get("from_step") != str(TRAIN_STEPS):
            raise AssertionError(f"train_bf16: serving from the checkpoint "
                                 f"failed: {served}")


def _serve_ckpt(serve, ckpt_dir):
    """``launch.serve.main`` from ``ckpt_dir`` at a small load; (rc,
    fields of what it printed)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--ckpt-dir", ckpt_dir, "--device", TRAIN_DEVICE,
                         "--requests", "4", "--prompt-len", "64",
                         "--max-new", "8", "--capacity", "128"])
    out = buf.getvalue()
    m = re.search(r"checkpoint step (\d+)", out)
    n = re.search(r"served (\d+) requests / (\d+) tokens", out)
    return rc, {"from_step": m.group(1) if m else "none",
                "requests": n.group(1) if n else "none",
                "tokens": n.group(2) if n else "none"}


def train_metrics(card, cfg, run, run_s, peak, norms, lines) -> None:
    """14c's numbers: step wall (median past the first step), device ms
    of one more step in a ``torch.profiler`` trace, the idle share,
    tokens/s, peak allocation, K5 / K5b per step, the loss curve."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    b, s = TRAIN_SHAPE
    walls = [run["step_seconds"][k] for k in sorted(run["step_seconds"])]
    wall = statistics.median(walls[1:])
    state = run["state"]
    opt = AdamW(OptConfig(lr=3e-3, total_steps=TRAIN_STEPS,
                          warmup_steps=min(50, TRAIN_STEPS // 10)))
    step = ST.build_train_step(cfg, opt)
    batch = MD.make_dummy_batch(cfg, b, s, seed=SEED, device=TRAIN_DEVICE)
    dev = (None if TRAIN_DEVICE == "cpu" else profiled_step(
        lambda: step(state["params"], state["opt"], batch)))
    losses = [run["losses"][k] for k in sorted(run["losses"])]
    log("train_bf16", arch=ARCH, dtype=cfg.dtype, remat=cfg.remat,
        batch=b, seq=s, steps=TRAIN_STEPS, run_s=f"{run_s:.1f}",
        step_wall_ms_median=f"{wall * 1e3:.1f}",
        step_wall_ms_first=f"{walls[0] * 1e3:.1f}",
        step_device_ms="null" if dev is None else f"{dev:.1f}",
        idle_share="null" if dev is None else f"{1 - dev / (wall * 1e3):.3f}",
        tokens_per_s=f"{b * s / wall:.0f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}",
        k5_per_step=2 * norms - 1, k5b_per_step=norms,
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        card=f"'{card}'")
    for ln in lines:
        log("train_bf16", launcher=f"'{ln}'")


def profiled_step(fn) -> float | None:
    """Device ms of one more (warm) call of ``fn``, from a
    ``torch.profiler`` trace that also prints the kernels taking the
    most device time (``serving.profile.report``); None when the trace
    held no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.profile import report
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        return None
    report("train_step", prof, wall, 1, 15)
    return us / 1e3


def train_families(total) -> None:
    """14c: every other family's smoke config in float32 — one loss and
    backward through the kernels against the plain path, then one train
    step — K5 / K5b launched where the family has an RMSNorm."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    b, s = FAMILY_SHAPE
    for arch in TRAIN_FAMILIES:
        cfg = family_cfg(arch)
        params = MD.init_params(cfg, seed=SEED, device=TRAIN_DEVICE)
        batch = MD.make_dummy_batch(cfg, b, s, seed=SEED,
                                    device=TRAIN_DEVICE)
        (loss, grads), counts, bwd = train_counted(
            lambda: ST.loss_and_grads(params, cfg, batch))
        _add(total, {**counts, **bwd})
        with plain_kernels():
            loss_p, grads_p = ST.loss_and_grads(params, cfg, batch)
        _loss_gate(f"train_{arch}", "smoke", loss.item(), loss_p.item())
        worst = grad_gate(f"train_{arch}", "smoke", grads, grads_p)
        opt = AdamW(OptConfig(lr=3e-3, warmup_steps=1, total_steps=10))
        (p, _, m), c2, b2 = train_counted(lambda: ST.build_train_step(
            cfg, opt)(params, opt.init(params), batch))
        _add(total, {**c2, **b2})
        rms = path_shape(cfg)[0] > 0
        log(f"train_{arch}", family=cfg.family, norm=cfg.norm, remat=cfg.remat,
            k5=counts["rmsnorm"], k5b=bwd["add_rmsnorm_bwd"],
            step_loss=f"{m['loss'].item():.4f}",
            worst_rel_err=f"{worst:.3e}")
        if rms and not (counts["rmsnorm"] and bwd["add_rmsnorm_bwd"]):
            raise AssertionError(f"train_{arch}: K5 / K5b never launched")


def train_example(total) -> None:
    """14d: ``examples/torch_train_100m.py --full-100m`` for 100 steps;
    the mean of the last 5 losses at least LOSS_DROP below the first 5."""
    sys.path.insert(0, str(REPO / "examples"))
    import torch_train_100m as ex
    t0 = time.perf_counter()
    res, counts, bwd = train_counted(lambda: ex.run(
        ["--full-100m", "--steps", str(EXAMPLE_STEPS), "--device",
         TRAIN_DEVICE], verbose=False))
    _add(total, {**counts, **bwd})
    losses = res["losses"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log("train_100m", steps=res["end"], seconds=f"{res['seconds']:.1f}",
        ms_per_step=f"{res['seconds'] / max(1, res['end']) * 1e3:.1f}",
        loss_first5=f"{first:.4f}", loss_last5=f"{last:.4f}",
        drop=f"{first - last:.4f}", gate=LOSS_DROP,
        k5=counts["rmsnorm"], k5b=bwd["add_rmsnorm_bwd"],
        wall_s=f"{time.perf_counter() - t0:.1f}")
    if not last < first - LOSS_DROP:
        raise AssertionError(f"train_100m: loss {first:.4f} -> {last:.4f}, "
                             f"not {LOSS_DROP} lower")


MESH_TRAIN_ARCHS = ("zamba2-2.7b", "xlstm-350m", "whisper-large-v3")
MESH_TRAIN_SECONDS = 60    # phase 15's own limit
MESH_TRAIN_SHAPES = ((1, 1), (1, 1, 1))


def mesh_train_one_card(total) -> None:
    """15: training over a mesh on the one card — a CUDA training mesh
    takes one device per rank, so (1, 1) and (1, 1, 1) meshes on
    ``cuda:0``. For the smoke-depth zamba2, xlstm and whisper in float32
    one step of ``build_train_step`` under ``hints.use_mesh(mesh,
    train=True)`` is the one-device step bit for bit — params, AdamW
    state, metrics — with the same K5 / K5b launches (some where the
    family has an RMSNorm); then a checkpoint of the mesh state, saved
    from its shards (``CheckpointManager.save(..., placement=)``), read
    into the one-device trainer's state the same bits."""
    import tempfile
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import hints as H
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh, PerRank
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    b, s = FAMILY_SHAPE
    for arch in MESH_TRAIN_ARCHS:
        phase = f"mesh_train_{arch}"
        cfg = family_cfg(arch)
        params = MD.init_params(cfg, seed=SEED, device=TRAIN_DEVICE)
        batch = MD.make_dummy_batch(cfg, b, s, seed=SEED,
                                    device=TRAIN_DEVICE)
        opt = AdamW(OptConfig(lr=3e-3, warmup_steps=1, total_steps=10))
        step = ST.build_train_step(cfg, opt)
        (p1, s1, m1), c1, b1 = train_counted(
            lambda: step(params, opt.init(params), batch))
        _add(total, {**c1, **b1})
        rms = path_shape(cfg)[0] > 0
        for shape in MESH_TRAIN_SHAPES:
            mesh = DeviceMesh(shape, (TRAIN_DEVICE,))
            with H.use_mesh(mesh, train=True):
                (pr, sr, mr), c2, b2 = train_counted(
                    lambda: step([params], [opt.init(params)], batch))
            _add(total, {**c2, **b2})
            same = (all(torch.equal(x, y) for x, y in zip(
                T.leaves(pr[0]), T.leaves(p1))) and all(
                torch.equal(x, y) for x, y in zip(T.leaves(sr[0]),
                                                  T.leaves(s1)))
                and all(torch.equal(m1[k], mr[k]) for k in m1))
            what = "x".join(map(str, shape))
            log(phase, mesh=what, check="step_bitwise_one_device",
                equal=same, k5=c2["rmsnorm"], k5b=b2["add_rmsnorm_bwd"],
                one_device_k5=c1["rmsnorm"],
                one_device_k5b=b1["add_rmsnorm_bwd"],
                loss=f"{mr['loss'].item():.6f}")
            if not same or (c2, b2) != (c1, b1) or (
                    rms and not (c2["rmsnorm"] and b2["add_rmsnorm_bwd"])):
                raise AssertionError(f"{phase} {what}: the mesh step is not "
                                     "the one-device step")
            mt = ST.MeshTrain(cfg, mesh)
            place = SH.Placement(mesh, {"params": mt.specs,
                                        "opt_state": mt.state_specs})
            with tempfile.TemporaryDirectory() as d:
                t0 = time.perf_counter()
                CheckpointManager(d).save(
                    1, PerRank([{"params": pr[0], "opt_state": sr[0]}]),
                    placement=place)
                save_s = time.perf_counter() - t0
                got_step, got = CheckpointManager(d).restore_latest(
                    {"params": p1, "opt_state": s1})
            same = got_step == 1 and all(
                torch.equal(x, y) for x, y in zip(
                    T.leaves(got), T.leaves({"params": p1,
                                             "opt_state": s1})))
            log(phase, mesh=what, check="mesh_checkpoint_one_device_bitwise",
                equal=same, save_s=f"{save_s:.3f}")
            if not same:
                raise AssertionError(f"{phase} {what}: the mesh checkpoint "
                                     "does not load the one-device state")
            mesh.close()


SPLIT_SECONDS = 60         # phase 15's placements check
SPLIT_SERVE_LAYERS = 2     # the serving check's full-width qwen
SPLIT_LOSS_RTOL = 1e-6     # the CPU parity tests' loss tolerance
SPLIT_TRAIN_DEVICES = ("cuda:0", "cpu")   # a training mesh: a device a rank
SPLIT_MODES = ("dmodel", "seq")


@contextlib.contextmanager
def gathered_logits():
    """Training's logits as the port computed them before the
    vocab-parallel loss: ``hints.logits`` gathers the vocab-split logits
    whole on every model rank (its backward the rank's slice), and the
    loss runs over the whole vocab — what the split path is held to."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import hints as H
    split = H.logits

    def gathered(x, vocab):
        comm = H._comm()
        if comm is not None and x.shape[-1] != vocab:
            return C.gather_from(x, x.dim() - 1, "model", comm)
        return split(x, vocab)

    H.logits = gathered
    try:
        yield
    finally:
        H.logits = split


@contextlib.contextmanager
def assembled_norm_grads(mode):
    """act_shard "none" whose norms' operands take their gradient as a
    stream split by ``mode`` assembles it: each model rank's chunk, along
    the split dim, of its own whole gradient, gathered over ``model``.
    Where the ranks' whole gradients of a norm's input differ (K5b on
    ``cuda:0`` against its plain version on the CPU), this is what the
    split stream computes: each rank keeps its own chunk of them. Where
    they agree it changes no bit."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.models import layers as L
    plain = L._add_norm

    class Assemble(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm):
            ctx.comm = comm
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            d = g.dim() - 1 if mode == "dmodel" else 1
            return ctx.comm.all_gather(ctx.comm.chunk(g, d, "model"), d,
                                       "model"), None

    def assembled(p, cfg, x, a, out_dtype):
        comm = H._comm()
        if comm is not None and comm.size("model") > 1:
            x = Assemble.apply(x, comm)
            a = None if a is None else Assemble.apply(a, comm)
        return plain(p, cfg, x, a, out_dtype)

    L._add_norm = assembled
    try:
        yield
    finally:
        L._add_norm = plain


def same_bits(out, want) -> tuple:
    """(every rank's loss, every rank's gradients) of two per-rank
    (loss, gradients) lists the same bits."""
    import torch
    from repro_torch import tree as T
    return (all(torch.equal(a[0], w[0]) for a, w in zip(out, want)),
            all(torch.equal(x, y) for a, w in zip(out, want)
                for x, y in zip(T.leaves(a[1]), T.leaves(w[1]))))


def max_leaf_diff(out, want) -> float:
    """The largest |difference| of any rank's gradient leaf."""
    from repro_torch import tree as T
    return max(float((x.double() - y.double()).abs().max())
               for a, w in zip(out, want)
               for x, y in zip(T.leaves(a[1]), T.leaves(w[1])))


def mesh_split_one_card(total) -> None:
    """15, the activation placements: the float32 smoke qwen at (1, 2).
    Training runs over ``cuda:0`` and the CPU (a training mesh takes one
    device per rank), under deterministic algorithms: the vocab-split
    logits' loss (``collectives.vocab_nll``) within SPLIT_LOSS_RTOL of
    the gathered logits' (:func:`gathered_logits`) and every gradient
    leaf within 14b's gate, the split loss the same bits on both ranks.
    act_shard "dmodel" and "seq": the loss and every rank's gradients
    the same bits as "none" with each norm's input gradient assembled
    from its ranks' chunks (:func:`assembled_norm_grads`) — the one
    place a split stream's gradient differs from "none"'s on these two
    devices, whose whole gradients of a norm's input differ by K5b's
    rounding against its plain version's (logged: "none" against the
    split, and against the assembled "none"). Serving runs both shards
    on ``cuda:0``, qwen at full width and SPLIT_SERVE_LAYERS layers (the
    kernels take its head dim): "dmodel" and "seq" streams equal to
    "none"'s on the contiguous cache (blocking) and the paged one
    (speculative). Launches go to ``total``."""
    import numpy as np
    import torch
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh_train_split"
    cfg = family_cfg(ARCH)
    b, s = FAMILY_SHAPE
    params = MD.init_params(cfg, seed=SEED, device=TRAIN_DEVICE)
    batch = MD.make_dummy_batch(cfg, b, s, seed=SEED, device="cpu")
    mesh = DeviceMesh((1, 2), SPLIT_TRAIN_DEVICES)

    def grads(c):
        mt = ST.MeshTrain(c, mesh)
        pr, parts = mt.shard(params), ST.mesh_parts(mt, batch)
        out, c1, b1 = train_counted(
            lambda: mt.run(lambda r: mt.grads(pr[r], r, parts[r])))
        _add(total, {**c1, **b1})
        return mt, out

    with deterministic():
        mt, split = grads(cfg)
        # the gathered logits' loss is each rank's own, over the whole
        # vocab on its device; the split loss is one sum, every rank's
        if not torch.equal(split[0][0].cpu(), split[1][0].cpu()):
            raise AssertionError(f"{phase}: the split loss differs by rank")
        with gathered_logits():
            _, whole = grads(cfg)
        modes = {}
        for m in SPLIT_MODES:
            with assembled_norm_grads(m):
                assembled = grads(cfg)[1]
            modes[m] = (grads(cfg.replace(act_shard=m))[1], assembled)
    got, want = split[0][0].item(), whole[0][0].item()
    rel = abs(got - want) / abs(want)
    log(phase, mesh="1x2", devices=json.dumps(SPLIT_TRAIN_DEVICES),
        check="vocab_split_loss_vs_gathered", split=f"{got:.8f}",
        gathered=f"{want:.8f}", rel_err=f"{rel:.3e}", tol=SPLIT_LOSS_RTOL)
    if rel > SPLIT_LOSS_RTOL:
        raise AssertionError(f"{phase}: the vocab-split loss {got} against "
                             f"the gathered {want}")
    grad_gate(phase, "vocab_split_vs_gathered",
              mt.gather([o[1] for o in split], TRAIN_DEVICE),
              mt.gather([o[1] for o in whole], TRAIN_DEVICE))
    for m, (out, assembled) in modes.items():
        loss_eq, grads_eq = same_bits(out, assembled)
        log(phase, act_shard=m, check="train_bitwise_assembled_none",
            loss_equal=loss_eq, grads_equal=grads_eq,
            loss_equal_none=same_bits(out, split)[0],
            max_grad_diff_none=f"{max_leaf_diff(out, split):.3e}",
            max_grad_diff_assembled=f"{max_leaf_diff(out, assembled):.3e}",
            none_vs_assembled=f"{max_leaf_diff(split, assembled):.3e}")
        if not (loss_eq and grads_eq):
            raise AssertionError(f"{phase}: act_shard {m}'s loss or "
                                 "gradients differ from the assembled "
                                 "none's")
    mesh.close()
    cfg = train_cfg(dtype="float32", n_layers=SPLIT_SERVE_LAYERS)
    params = MD.init_params(cfg, seed=SEED, device=TRAIN_DEVICE)
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (17, 40, 64)]
    for kv, sched in (("contiguous", "blocking"), ("paged", "speculative")):
        out = {}
        for m in ("none",) + SPLIT_MODES:
            eng = ServingEngine(params, cfg.replace(act_shard=m), EngineConfig(
                mesh=(1, 2), max_batch=4, max_seq_len=128, max_new_tokens=8,
                kv_cache=kv, scheduler=sched, eos_token=-1),
                devices=(TRAIN_DEVICE,) * 2)
            for p in prompts:
                eng.submit(p)
            _, c1, _ = train_counted(eng.run)
            _add(total, c1)
            out[m] = {r.rid: r.output for r in eng.finished}
            eng.mesh.close()
        same = all(out[m] == out["none"] for m in SPLIT_MODES)
        log(phase, serve=f"{kv}+{sched}", mesh="1x2",
            check="streams_equal_none", equal=same,
            tokens=sum(len(v) for v in out["none"].values()))
        if not same:
            raise AssertionError(f"{phase} {kv}+{sched}: the split "
                                 "streams differ from none's")


TRAIN_SECONDS = 600    # the phase's own process ends past this
TRAIN_COUNTS = "train_counts="


def phase_train(card: str) -> dict:
    """Phase 14 in a process of its own (``chip_smoke.py --phase-train``),
    its lines passed through: cuBLAS's deterministic workspace
    (``CUBLAS_WORKSPACE_CONFIG``, read when CUDA starts), which 14c's
    bitwise resume under ``torch.use_deterministic_algorithms`` needs,
    then holds for this phase only. Returns the launch counts of its
    runs, K5b's as ``add_rmsnorm_bwd``."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    proc = subprocess.Popen(
        [sys.executable, "-u", str(Path(__file__).resolve()),
         "--phase-train", card], env=env, stdout=subprocess.PIPE,
        text=True)
    deadline = threading.Timer(TRAIN_SECONDS, proc.kill)
    deadline.start()
    counts = None
    try:
        for line in proc.stdout:
            if line.startswith(TRAIN_COUNTS):
                counts = json.loads(line[len(TRAIN_COUNTS):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait()
    finally:
        deadline.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or counts is None:
        raise AssertionError(f"phase 14's process exited {rc}")
    return counts


def train_child(card: str) -> int:
    """``--phase-train``: phase 14's runs, then their launch counts on a
    line of their own for the parent."""
    import torch
    if not torch.cuda.is_available():
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(TRAIN_COUNTS + json.dumps(train_phases(card)), flush=True)
    return 0


def train_phases(card: str) -> dict:
    """Phase 14: single-device training — 14b the float32 gradient gate,
    14c bf16 training with a failure and a restart then serving from its
    checkpoint, and the other families' smoke steps, 14d the 100M
    example (14a, K5b's table, is in phase 2) —; then phase 15, training
    over a mesh on the one card, in the same process (its bitwise gates
    under the same deterministic cuBLAS)."""
    import torch
    t0 = time.perf_counter()
    total: dict = {}
    with step_deadline():
        train_gate_f32(total)
    torch.cuda.empty_cache()
    with step_deadline():
        train_bf16(card, total)
    torch.cuda.empty_cache()
    with step_deadline():
        train_families(total)
        train_example(total)
    log("train", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    t0 = time.perf_counter()
    with step_deadline(MESH_TRAIN_SECONDS), deterministic():
        mesh_train_one_card(total)
    with step_deadline(SPLIT_SECONDS):
        mesh_split_one_card(total)
    log("mesh_train", seconds=f"{time.perf_counter() - t0:.1f}",
        card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 16: nemotron-4-340b's attention (Dh 192, G 12) at full width
# ---------------------------------------------------------------------------

NEMOTRON = "nemotron-4-340b"
NEMOTRON_LAYERS = 2       # of 96: the embedding and head alone are 18.9 GB
NEMOTRON_NEW = 8
NEMOTRON_CAPACITY = 1024
NEMOTRON_CONFIGS = ("contiguous+blocking", "paged+blocking",
                    "contiguous+chunked", "paged+chunked",
                    "contiguous+speculative", "paged+speculative")


def nemotron_logits(phase, params, cfg, prompt) -> None:
    """A prefill of ``prompt`` (K3), the same prompt as 256-token chunks
    over a one-slot cache (K4), then ``NEMOTRON_NEW`` greedy decode steps
    (K1) and the same tokens as one verify window (K4's split shape)
    through the kernels, then through the plain versions: every logits
    normwise <= 3e-2 with the argmax equal or tied (:func:`_tie_gate`)."""
    import torch
    from repro_torch.models import model as MD
    n = len(prompt)
    toks = torch.as_tensor(prompt[None, :], dtype=torch.int32, device="cuda")

    def run(feed=None):
        logits, cache = MD.prefill(params, cfg, {"tokens": toks},
                                   NEMOTRON_CAPACITY)
        verify_cache = {k: t.clone() for k, t in cache.items()}
        _, chunked = _first_logits(params, cfg, prompt, CHUNK_TOKENS)
        out, fed = [logits, chunked], []
        for i in range(NEMOTRON_NEW):
            tok = (feed[i] if feed is not None
                   else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
            fed.append(tok)
            logits, cache = MD.decode_step(params, cfg, tok, cache)
            out.append(logits)
        window = torch.cat(fed[:5], 1)
        verify_cache["len"] = torch.tensor([n], dtype=torch.int32,
                                           device="cuda")
        ver, _ = MD.verify_tokens(params, cfg, window, verify_cache)
        out.append(ver[0])
        return out, fed

    got, fed = run()
    with plain_kernels():
        want, _ = run(feed=fed)
    names = (["prefill", "chunked_prefill"]
             + [f"decode_{i}" for i in range(NEMOTRON_NEW)] + ["verify"])
    for what, g, w in zip(names, got, want):
        rel, ties = _tie_gate(f"{phase} {what}", g, w)
        log(phase, logits=what, prompt_len=n, rel_err=f"{rel:.3e}",
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            tol=TOL["bfloat16"], argmax_flips=len(ties),
            ties="none" if not ties else ",".join(
                f"{r}:{m:.3e}<{e:.3e}" for r, m, e in ties))


def phase_nemotron(card: str) -> dict:
    """Phase 16: nemotron-4-340b in bf16 at full width, 2 of its 96
    layers (LayerNorm, squared ReLU, GQA 96/8: Dh 192, G 12): its logits
    through every K1–K4 route against the plain versions, then 8 seeded
    requests of 64–512 tokens, 8 new tokens each, on both caches under
    blocking, chunked (256) and speculative (gamma 4) scheduling, with
    every K1–K4 call held to its plain version on its own inputs and
    exact launches. Returns the launch counts of its runs."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    phase = "nemotron_bf16"
    t0 = time.perf_counter()
    cfg = registry.get_config(NEMOTRON).replace(n_layers=NEMOTRON_LAYERS)
    if (cfg.d_head, cfg.n_heads // cfg.n_kv_heads, cfg.dtype) != \
            (192, 12, "bfloat16"):
        raise AssertionError(f"{NEMOTRON}: Dh {cfg.d_head}, G "
                             f"{cfg.n_heads // cfg.n_kv_heads}, {cfg.dtype}")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(phase, arch=NEMOTRON, layers=cfg.n_layers, params=cfg.param_count(),
        d_head=cfg.d_head, g=cfg.n_heads // cfg.n_kv_heads,
        weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
        init_s=f"{time.perf_counter() - t0:.1f}")
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(64, 513, size=8)]
    prompts[0] = rng.integers(0, cfg.vocab_size, size=512).astype(np.int32)
    nemotron_logits(phase, params, cfg, prompts[0])
    total: dict = {}
    for label in NEMOTRON_CONFIGS:
        kw = GATE_CONFIGS.get(label, {})
        torch.cuda.empty_cache()
        errs: dict = {}
        with checked_kernels(errs, ATTENTION_OPS):
            eng, counts = run_engine(params, cfg, prompts, NEMOTRON_NEW,
                                     max_seq_len=NEMOTRON_CAPACITY, **kw)
        s = _check_engine(f"{phase} {label}", eng, counts, len(prompts))
        for r in eng.finished:
            if len(r.output) != NEMOTRON_NEW:
                raise AssertionError(f"{phase} {label} request {r.rid}: "
                                     f"{len(r.output)} tokens")
        log(phase, config=label, requests=s["requests"],
            tokens=s["tokens"], decode_steps=s["decode_steps"],
            prefills=s["prefills"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            verify_dispatches=s["verify_dispatches"],
            checked_calls=json.dumps({k: n for k, (n, _) in errs.items()}),
            max_abs_err=json.dumps({k: f"{e:.3e}"
                                    for k, (_, e) in errs.items()}),
            tol=TOL["bfloat16"], launches=json.dumps(counts),
            card=f"'{card}'")
        _add(total, counts)
        del eng
    for name in ATTENTION_OPS:
        if not total.get(name):
            raise AssertionError(f"{phase}: {name} never launched")
    log(phase, seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    del params
    gc_empty()
    return total


SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:84"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:134"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/flash_attention.py:148"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:230"),
    "add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:25"),
    "quant_gemv": ("src/repro_torch/kernels/csrc/quant_gemv.cu",
                   "src/repro/kernels/quant_gemv.py:56"),
    # K5b has no TPU kernel: it is the gradient XLA derives from the
    # reference's plain RMSNorm, which the training path runs
    "add_rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/models/layers.py:49"),
}


# the launch counter of each kernel of the JSON line, where it is named
# otherwise (``ops.launch_counts()``)
COUNTERS = {"add_rmsnorm": "rmsnorm"}


# ---------------------------------------------------------------------------
# phase 17: the dry-run and the roofline against the card
# ---------------------------------------------------------------------------

DRYRUN_DEVICE = "cuda:0"
DRYRUN_STEPS = (("decode", 8, 2048), ("prefill", 1, 1024),
                ("train", 4, 2048))
DRYRUN_MESH_LAYERS = 8
DRYRUN_MESH_STEPS = (("decode", 8, 2048), ("prefill", 2, 512))
ARG_RTOL, ARG_ATOL = 0.01, 2 << 20     # argument bytes: 1% + 2 MiB
PEAK_RANGE = (0.85, 1.5)               # predicted / measured peak
BOUND_FLOOR = 0.95                     # device time / roofline bound


def dryrun_expected(cfg, kind: str, ranks: int) -> tuple[dict, set]:
    """(launches per kernel, the kernels that must have run) of one
    phase-17 step on ``ranks`` ranks, each launching what one device
    would (:func:`path_shape`: R RMSNorms, L attention layers): a decode
    R K5 and L K1 (the contiguous cache), a prefill R K5 and L K3, a
    train step R K5b and R K5 — 2R - 1 under remat "full", whose
    backward runs each layer's norms again — and no attention kernel
    (training attends through the plain path)."""
    norms, n = path_shape(cfg)
    want = {"rmsnorm": norms, "flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "prefill_attention": 0,
            "quant_gemv": 0, "add_rmsnorm_bwd": 0}
    if kind == "decode":
        want["decode_attention"] = n
    elif kind == "prefill":
        want["flash_attention"] = n
    else:
        want["rmsnorm"] = 2 * norms - 1 if cfg.remat == "full" else norms
        want["add_rmsnorm_bwd"] = norms
    want = {k: ranks * v for k, v in want.items()}
    return want, {k for k, v in want.items() if v}


def dryrun_launched(phase, cfg, kind, ranks, fn, total: dict):
    """``fn()``, one step on the card, with every launch count zeroed
    just before it and read just after: held to :func:`dryrun_expected`
    and added to ``total``."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {**ops.launch_counts(), **ops.backward_launch_counts()}
    _launch_gate(phase, counts, *dryrun_expected(cfg, kind, ranks))
    _add(total, counts)
    return out


def dryrun_mesh_builders() -> None:
    """17a: the builders on the card, and the placeholder pod."""
    import torch
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    one = make_mesh((1, 1))
    got = one.run(lambda r: torch.ones(3, device=one.devices[r]).sum()
                  .item())
    if got != [3.0] or one.devices[0].type != "cuda":
        raise AssertionError(f"dryrun: make_mesh((1, 1)) gave {got} on "
                             f"{one.devices}")
    four = make_mesh((2, 2), devices=[DRYRUN_DEVICE] * 4)
    got = four.run(lambda r: four.all_gather(torch.full(
        (1,), float(r), device=four.devices[r]), 0, "model").tolist())
    if got != [[0.0, 1.0], [0.0, 1.0], [2.0, 3.0], [2.0, 3.0]]:
        raise AssertionError(f"dryrun: a (2, 2) gather over model gave "
                             f"{got}")
    one.close()
    four.close()
    n = torch.cuda.device_count()
    try:
        make_production_mesh()
    except ValueError as e:
        if "256" not in str(e) or f"only {n}" not in str(e):
            raise AssertionError(f"dryrun: the refusal {e} names neither "
                                 f"256 nor the {n} visible") from e
        refusal = str(e)
    else:
        raise AssertionError("dryrun: make_production_mesh() built on "
                             f"{n} card(s)")
    pod = make_production_mesh(devices=["meta"] * 256)
    log("dryrun", builders="ok", pod=f"{pod.shape}", refusal=f"'{refusal}'")
    pod.close()


def _device_ms(fn) -> float:
    """Device ms of one call of ``fn`` (``torch.profiler``, every
    thread's kernels); raises when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("dryrun: the profiler saw no device time")
    return us / 1e3


def dryrun_step(card: str, kind: str, batch: int, seq: int,
                total: dict) -> None:
    """17b: one step's dry-run at (1, 1) against the card; its launches
    added to ``total``."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as A
    cfg = registry.get_config(ARCH)
    t0 = time.perf_counter()
    dry = D.Cell(cfg, kind, batch, seq, (1, 1))
    rec = dry.run()
    dry.close()
    dry_s = time.perf_counter() - t0
    mem = rec["memory"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cell = D.Cell(cfg, kind, batch, seq, (1, 1), devices=[DRYRUN_DEVICE])
    args = cell.place(SEED)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    arg = mem["argument_size_in_bytes"]
    if abs(placed - arg) > ARG_RTOL * arg + ARG_ATOL:
        raise AssertionError(f"dryrun {kind}: argument bytes {arg} against "
                             f"{placed} placed")
    phase = f"dryrun {kind}"

    def step():
        return dryrun_launched(phase, cfg, kind, 1,
                               lambda: cell.step_on(args), total)

    step()                        # warm: the step's first call
    torch.cuda.reset_peak_memory_stats()
    out = step()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    ratio = mem["peak_memory_in_bytes"] / peak
    if not PEAK_RANGE[0] <= ratio <= PEAK_RANGE[1]:
        raise AssertionError(f"dryrun {kind}: predicted peak "
                             f"{mem['peak_memory_in_bytes']} is {ratio:.3f}"
                             f" x the measured {peak}")
    dev_ms = _device_ms(step)
    c = A.analyze_record({**rec, "arch": ARCH, "shape": kind, "devices": 1})
    bound_ms = max(c["compute_s"], c["memory_s"]) * 1e3
    if dev_ms < BOUND_FLOOR * bound_ms:
        raise AssertionError(f"dryrun {kind}: {dev_ms:.3f} ms of device "
                             f"time under the {bound_ms:.3f} ms bound")
    log("dryrun", step=kind, batch=batch, seq=seq, arg_bytes=arg,
        placed_bytes=placed, arg_rel=f"{(placed - arg) / arg:+.5f}",
        peak_pred=mem["peak_memory_in_bytes"], peak_meas=peak,
        peak_ratio=f"{ratio:.4f}", compute_ms=f"{c['compute_s'] * 1e3:.4f}",
        memory_ms=f"{c['memory_s'] * 1e3:.4f}", bound_ms=f"{bound_ms:.4f}",
        device_ms=f"{dev_ms:.4f}", bound_over_device=f"{bound_ms / dev_ms:.4f}",
        bound_by=c["bottleneck"], dry_s=f"{dry_s:.1f}", card=f"'{card}'")
    del args
    cell.close()
    gc_empty()
    torch.cuda.empty_cache()


def dryrun_collectives(card: str, total: dict) -> None:
    """17c: the card's collectives at (2, 2) against the meta rank
    run's, rank by rank, kind and shape; its launches added to
    ``total``."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import collective_bytes as CB
    cfg = registry.get_config(ARCH).replace(n_layers=DRYRUN_MESH_LAYERS)
    for kind, batch, seq in DRYRUN_MESH_STEPS:
        meta = D.Cell(cfg, kind, batch, seq, (2, 2), every_rank=True)
        rec = meta.run(trace=False)
        meta.close()
        cell = D.Cell(cfg, kind, batch, seq, (2, 2),
                      devices=[DRYRUN_DEVICE] * 4)
        args = cell.place(SEED)
        with CB.recording(cell.mesh) as got:
            dryrun_launched(f"dryrun {kind} 2x2", cfg, kind, cell.mesh.size,
                            lambda: cell.step_on(args), total)
        if got.per_rank != meta.collectives.per_rank \
                or got.report() != rec["collectives"]:
            raise AssertionError(f"dryrun {kind} (2, 2): the card's "
                                 f"collectives {got.report()} against the "
                                 f"dry-run's {rec['collectives']}")
        log("dryrun", collectives=kind, mesh="2x2",
            layers=DRYRUN_MESH_LAYERS, bytes=json.dumps(got.report()["bytes"]),
            counts=json.dumps(got.report()["counts"]), equal=True,
            card=f"'{card}'")
        del args
        cell.close()
    gc_empty()
    torch.cuda.empty_cache()


def phase_dryrun(card: str) -> dict:
    """Phase 17. Returns the launch counts of its steps on the card, K5b's
    as ``add_rmsnorm_bwd``."""
    t0 = time.perf_counter()
    total: dict = {}
    dryrun_mesh_builders()
    for kind, batch, seq in DRYRUN_STEPS:
        dryrun_step(card, kind, batch, seq, total)
    dryrun_collectives(card, total)
    log("dryrun", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    # float32 products in full float32 (no TF32) for every gate below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_device()
    rows = phase_kernels()
    base = phase_engine_f32()
    torch.cuda.empty_cache()
    counts = phase_engine_bf16(card)
    torch.cuda.empty_cache()
    for name, c in phase_w4(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_request_surface(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_families(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_window(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_recurrent(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_cluster(base, card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_mesh(base, card).items():
        counts[name] += c
    phase_costmodel(card)
    phase_simulator(card)
    torch.cuda.empty_cache()
    for name, c in phase_train(card).items():
        counts[name] = counts.get(name, 0) + c
    with step_deadline():
        for name, c in phase_nemotron(card).items():
            counts[name] += c
    torch.cuda.empty_cache()
    with step_deadline():
        for name, c in phase_dryrun(card).items():
            counts[name] = counts.get(name, 0) + c
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        cases, err = r["cases"], r["max_abs_err"]
        if name == "add_rmsnorm":   # K5 also runs without the add, and
            cases = cases + rows["rmsnorm"]["cases"]   # counts both
            err = max(err, rows["rmsnorm"]["max_abs_err"])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": counts[COUNTERS.get(name, name)],
            "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "cases": cases})
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-train"]:
        sys.exit(train_child(sys.argv[2]))
    sys.exit(main())
