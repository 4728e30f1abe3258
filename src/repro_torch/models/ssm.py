"""Mamba2 (SSD — state-space duality) block, chunkwise-parallel, on
tensors.

Counterpart of ``repro/models/ssm.py``: the minimal SSD form of Mamba2
[arXiv:2405.21060],

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * B_t x_t        (per head h)
    y_t = C_t^T h_t + D_h x_t

computed chunk by chunk: an intra-chunk quadratic term, each chunk's
end state, the fp32 recurrence over chunks and the carried state's term.
The chunk engine (:func:`ssd_chunked`) is shared with the mLSTM
(:mod:`repro_torch.models.xlstm`). Every chunk runs the same fixed-shape
contractions, so a chunk's result does not depend on how many chunks the
prompt has: a right-padded prompt whose pads are neutral (decay 1, zero
input) gives the exact-length prompt's state bit for bit.

Decode is O(1) a token through the recurrent state (B, H, P, N) and a
rolling conv state (B, k - 1, C). The gated norm runs K5 without the add.

On a serving mesh (:func:`~repro_torch.distributed.hints.model_split`
ranks over ``model``) the in-projection's columns, split by the serve
rule in the reference's order, are gathered whole; the conv runs on the
rank's channels where its weight splits them (the conv state holds
those channels) and its output is gathered; the scan runs over the
rank's heads where they divide, with their state, and y is gathered for
the gated norm over the whole width; ``out_proj`` computes the rank's
output columns, gathered.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as H
from repro_torch.models import layers as L


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a (..., l) -> (..., l, l): sum_{k=j+1..i} log_a_k for i >= j,
    -inf above the diagonal."""
    l = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]   # (..., i, j) = sum (j, i]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, log_a, b, c, chunk: int, h0=None):
    """Chunkwise SSD scan.

    x (B, S, H, P) inputs (dt-scaled for Mamba2, i-gated for the mLSTM);
    log_a (B, S, H) per-step log decay (<= 0); b, c (B, S, H, N) input
    and output maps; h0 (B, H, P, N) or None. The sequence is zero-padded
    to whole chunks; every contraction is in fp32, one chunk at a time.
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    fp32."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    nchunks = math.ceil(s / chunk)
    pad = nchunks * chunk - s
    if pad:
        x, log_a, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (x, log_a, b, c))
    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for z in range(nchunks):
        # each chunk's operands dense and fp32, whatever the caller's
        # layout (a broadcast B or C, a padded copy): the same layout
        # gives the same contraction path, chunk for chunk
        at = slice(z * chunk, (z + 1) * chunk)
        xc, bc, cc = (t[:, at].float().contiguous() for t in (x, b, c))
        la = log_a[:, at].float().transpose(1, 2).contiguous()  # (B, H, l)
        a_cum = torch.cumsum(la, dim=-1)
        # intra-chunk (diagonal block) term
        scores = torch.einsum("blhn,bshn->bhls", cc, bc)
        y = torch.einsum("bhls,bshp->blhp", scores * torch.exp(segsum(la)),
                         xc)
        # the carried state's contribution, then this chunk's end state
        y = y + torch.einsum("blhn,bhl,bhpn->blhp", cc, torch.exp(a_cum), h)
        decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
        st = torch.einsum("bshn,bhs,bshp->bhpn", bc, decay_to_end, xc)
        h = torch.exp(a_cum[..., -1])[..., None, None] * h + st
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba2(gen, cfg, lead=(), device="cuda") -> dict:
    """One Mamba2 block's params with leading axes ``lead``; shapes,
    dtypes and keys of ``repro.models.ssm.init_mamba2``."""
    d, dt = cfg.d_model, L.dtype_of(cfg)
    d_in = cfg.ssm_expand * d
    n, k = cfg.ssm_state, cfg.ssm_conv
    h = d_in // cfg.ssm_head_dim
    zdim = 2 * d_in + 2 * n + h   # z, x, B, C, dt
    conv_dim = d_in + 2 * n

    def dense(*shape, fan_in):
        return L.dense_init(gen, (*lead, *shape), dt, device, fan_in=fan_in)

    def per_head(v):
        return v.to(device).expand(*lead, h).contiguous()

    return {
        "in_proj": dense(d, zdim, fan_in=d),
        "conv_w": dense(k, conv_dim, fan_in=k),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, h,
                                                   dtype=torch.float32))),
        "D": per_head(torch.ones(h, dtype=torch.float32)),
        "dt_bias": per_head(torch.zeros(h, dtype=torch.float32)),
        "norm": {"w": torch.ones((*lead, d_in), dtype=dt, device=device)},
        "out_proj": dense(d_in, d, fan_in=d_in),
    }


def _split_proj(cfg, zxbcdt):
    """The in-projection's (z, x, B, C, dt) along its last axis."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, n, n,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * n], dim=-1)


def _causal_conv(x, w, state=None, n_valid=None):
    """Depthwise causal conv: x (B, S, C), w (k, C). Returns (y, the new
    rolling state (B, k - 1, C)). With ``n_valid`` (a right-padded input)
    the state is the last ``k - 1`` *valid* positions, ``xp[:, n_valid :
    n_valid + k - 1]``, not the pad tail."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, :s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    if k <= 1:
        return y, state
    at = xp.shape[1] - (k - 1) if n_valid is None else int(n_valid)
    return y, xp[:, at:at + k - 1]


def _rank_heads(cfg) -> int:
    """Heads the calling rank scans: its share where they divide the
    serving mesh's ``model`` ranks, else all of them."""
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    m = H.model_split()
    return nh // m if nh % m == 0 else nh


def _scan_inputs(p, cfg, u, conv_state, n_valid, mm):
    """The in-projection and the conv of u (B, S, d) as the calling rank
    computes them: (x (B, S, Hr, P) and dt (B, S, Hr) of its ``Hr`` heads,
    B and C (B, S, N) whole, z (B, S, d_in) whole, its new conv
    state)."""
    bsz, s, d = u.shape
    d_in, hp, n = cfg.ssm_expand * d, cfg.ssm_head_dim, cfg.ssm_state
    nh, hr = d_in // hp, _rank_heads(cfg)
    zx = H.cols(mm(u, p["in_proj"]), 2 * d_in + 2 * n + nh)
    z, x, b, c, dt = _split_proj(cfg, zx)
    xbc = torch.cat([x, b, c], dim=-1)
    cw = p["conv_w"].shape[-1]
    if cw != xbc.shape[-1]:
        # the conv's channels split over model in the reference's order
        i = H.model_index()
        xbc, conv = _causal_conv(xbc[..., i * cw:(i + 1) * cw], p["conv_w"],
                                 conv_state, n_valid=n_valid)
        xbc = H.cols(F.silu(xbc), d_in + 2 * n)
    else:
        xbc, conv = _causal_conv(xbc, p["conv_w"], conv_state,
                                 n_valid=n_valid)
        xbc = F.silu(xbc)
    lo = H.model_index() * hr if hr != nh else 0
    x = xbc[..., :d_in].reshape(bsz, s, nh, hp)[:, :, lo:lo + hr]
    return (x, xbc[..., d_in:d_in + n], xbc[..., d_in + n:],
            dt[..., lo:lo + hr], z, conv)


def _gated_out(p, cfg, y, z, u_dtype, mm):
    """y (B, S, the rank's heads' columns) fp32, gathered to d_in, gated
    by silu(z), RMSNorm'd at d_in (K5 without the add) in the model's
    dtype, then projected out and gathered to d_model."""
    d_in = cfg.ssm_expand * cfg.d_model
    y = H.cols(y, d_in) * F.silu(z.float())
    return H.cols(mm(L.rmsnorm(y.to(u_dtype), p["norm"]["w"]),
                     p["out_proj"]), cfg.d_model)


def _head_params(p, hr):
    """The rank's ``hr`` heads of ``A_log``, ``D`` and ``dt_bias``."""
    return (H.local_cols(p["A_log"], hr), H.local_cols(p["D"], hr),
            H.local_cols(p["dt_bias"], hr))


def apply_mamba2(p, cfg, u, state=None, conv_state=None, n_valid=None,
                 mm=torch.matmul):
    """u (B, S, d); state (B, H, P, N) or None. Returns (y, (state,
    conv)).

    ``n_valid`` (an int): the prompt's true length in a right-padded
    input. Pad steps get decay 1 (``log_a = 0``) and zero input — the
    values :func:`ssd_chunked` pads its own chunks with — so the states
    coming out are bitwise the exact-length prompt's; pad outputs are
    garbage nobody reads. ``mm`` computes the projections. On a serving
    mesh the state and conv state are the rank's (the module's
    docstring)."""
    bsz, s, d = u.shape
    hp, n = cfg.ssm_head_dim, cfg.ssm_state
    hr = _rank_heads(cfg)
    x, bvec, cvec, dt, z, new_conv = _scan_inputs(p, cfg, u, conv_state,
                                                  n_valid, mm)
    a_log, dd, dt_bias = _head_params(p, hr)
    bmat = bvec[..., None, :].expand(bsz, s, hr, n)
    cmat = cvec[..., None, :].expand(bsz, s, hr, n)
    dt = F.softplus(dt.float() + dt_bias)                # (B, S, Hr)
    log_a = dt * -torch.exp(a_log)                       # <= 0
    x_bar = x.float() * dt[..., None]
    if n_valid is not None:
        keep = torch.arange(s, device=u.device) < int(n_valid)
        log_a = torch.where(keep[None, :, None], log_a, 0.0)
        x_bar = torch.where(keep[None, :, None, None], x_bar, 0.0)
    y, h = ssd_chunked(x_bar, log_a, bmat, cmat, cfg.chunk_len, h0=state)
    y = y + x.float() * dd[:, None]
    return _gated_out(p, cfg, y.reshape(bsz, s, hr * hp), z, u.dtype, mm), \
        (h, new_conv)


def mamba2_decode_step(p, cfg, u, state, conv_state):
    """u (B, 1, d): one token's O(1) recurrent update. Returns (y,
    (state, conv))."""
    bsz = u.shape[0]
    hp = cfg.ssm_head_dim
    hr = _rank_heads(cfg)
    x, bvec, cvec, dt, z, new_conv = _scan_inputs(p, cfg, u, conv_state,
                                                  None, torch.matmul)
    a_log, dd, dt_bias = _head_params(p, hr)
    x = x[:, 0]                                          # (B, Hr, P)
    bvec, cvec = bvec[:, 0].float(), cvec[:, 0].float()
    dt = F.softplus(dt[:, 0].float() + dt_bias)         # (B, Hr)
    decay = torch.exp(dt * -torch.exp(a_log))
    x_bar = x.float() * dt[..., None]                    # (B, Hr, P)
    upd = torch.einsum("bhp,bn->bhpn", x_bar, bvec)
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, cvec)
    y = y + x.float() * dd[:, None]
    return _gated_out(p, cfg, y.reshape(bsz, 1, hr * hp), z, u.dtype,
                      torch.matmul), (state, new_conv)
