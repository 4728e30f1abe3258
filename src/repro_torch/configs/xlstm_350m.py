"""xLSTM-350M — sLSTM + mLSTM blocks (attention-free).

[arXiv:2405.04517; unverified]. 24L d_model=1024 4H (kv=4) d_ff=0
vocab=50304, xLSTM[7:1] ratio -> one sLSTM per 8 layers. Recurrent-state
decode -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    slstm_every=8,
    chunk_len=256,
    microbatch=1,
    source="arXiv:2405.04517",
)
