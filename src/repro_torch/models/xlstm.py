"""xLSTM blocks on tensors: the mLSTM (matrix memory) and the sLSTM
(scalar memory).

Counterpart of ``repro/models/xlstm.py`` [arXiv:2405.04517]. The mLSTM

    C_t = f_t * C_{t-1} + i_t * v_t k_t^T        (matrix memory, per head)
    n_t = f_t * n_{t-1} + i_t * k_t              (normalizer)
    y_t = (C_t q_t) / max(|n_t^T q_t|, 1)

runs chunkwise through the SSD engine (:func:`repro_torch.models.ssm.
ssd_chunked`), the value vector augmented with a constant-one channel
that carries the normalizer; sigmoid input and forget gates, as the
reference's. The sLSTM has block-diagonal recurrent weights and runs
step by step over time. Both decode in O(1) a token.

The blocks normalise by RMSNorm whatever the config's norm (K5). As the
decoder blocks of :mod:`repro_torch.models.model` do, a block takes the
residual ``x`` and the previous block's output ``delta`` (None before
the first) and adds them in its first norm (K5 with the add), and it
returns (residual, its output) un-added: the reference's adds, in its
order, each fused into the norm after it.

On a serving mesh every product computes the output columns the serve
rule gives the rank (:func:`~repro_torch.distributed.hints.cols` gathers
them to what it computes on next). The mLSTM, where its heads divide the
:func:`~repro_torch.distributed.hints.model_split` ranks, gathers u
whole (``wq``, ``wk`` and ``wv`` contract all of it), runs the scan over
its own heads with its state, and gathers y and z for ``out_norm``; the
sLSTM, and an mLSTM whose heads do not divide, runs its recurrence whole
on every model rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints as H
from repro_torch.models import layers as L
from repro_torch.models.ssm import ssd_chunked


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg, lead=(), device="cuda") -> dict:
    """One mLSTM block's params with leading axes ``lead``; shapes, dtypes
    and keys of ``repro.models.xlstm.init_mlstm``."""
    d, dt = cfg.d_model, L.dtype_of(cfg)
    d_in, h = 2 * d, cfg.n_heads

    def dense(*shape):
        return L.dense_init(gen, (*lead, *shape), dt, device,
                            fan_in=shape[0])

    def ones(width):
        return {"w": torch.ones((*lead, width), dtype=dt, device=device)}

    return {
        "norm": ones(d),
        "w_up": dense(d, d_in), "w_gate": dense(d, d_in),
        "wq": dense(d_in, d_in), "wk": dense(d_in, d_in),
        "wv": dense(d_in, d_in),
        "w_i": dense(d_in, h), "w_f": dense(d_in, h),
        "f_bias": torch.full((*lead, h), 3.0, dtype=torch.float32,
                             device=device),
        "out_norm": ones(d_in),
        "w_down": dense(d_in, d),
    }


def _key_scale(pdim: int, dtype: torch.dtype) -> float:
    """sqrt(P) rounded to the keys' dtype, as the reference divides by
    it (a float32 root cast to that dtype)."""
    return float(torch.tensor(math.sqrt(pdim), dtype=torch.float32)
                 .to(dtype))


def _rank_heads(cfg) -> int:
    """mLSTM heads the calling rank scans: its share where they divide
    the serving mesh's ``model`` ranks, else all of them."""
    m = H.model_split()
    return cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads


def _mlstm_heads(p, cfg, u, mm):
    """u (B, S, d_in) whole -> the rank's heads' q, k, v (B, S, Hr, P),
    log_f (B, S, Hr), i (B, S, Hr)."""
    b, s, d_in = u.shape
    hr = _rank_heads(cfg)
    pdim = d_in // cfg.n_heads
    q, k, v = (H.cols(mm(u, p[w]), hr * pdim).reshape(b, s, hr, pdim)
               for w in ("wq", "wk", "wv"))
    k = k / _key_scale(pdim, k.dtype)
    i_pre = H.cols(mm(u, p["w_i"]), hr).float()
    f_pre = H.cols(mm(u, p["w_f"]), hr).float()
    return q, k, v, F.logsigmoid(f_pre + H.local_cols(p["f_bias"], hr)), \
        torch.sigmoid(i_pre)


def _mlstm_out(p, x, y, z, mm):
    """y (B, S, the rank's heads' columns) gathered to d_in and
    normalised (K5), gated by silu(z) (z gathered too), projected down
    and gathered to d_model."""
    d_in = p["out_norm"]["w"].shape[-1]
    y = L.rmsnorm(H.cols(y, d_in).to(x.dtype), p["out_norm"]["w"])
    z = H.cols(z, d_in)
    return H.cols(mm(y * F.silu(z.to(y.dtype)), p["w_down"]), x.shape[-1])


def apply_mlstm(p, cfg, x, delta=None, state=None, n_valid=None,
                mm=torch.matmul):
    """x (B, S, d) and ``delta`` (the previous block's output, or None);
    state (B, H, P + 1, N) or None. Returns ((residual, output),
    new_state).

    ``n_valid`` (an int): the prompt's true length in a right-padded
    input. Pad steps get ``log_f = 0`` (forget gate 1) and a zero
    augmented value, the values :func:`ssd_chunked` pads its own chunks
    with, so the final state is bitwise the exact-length prompt's."""
    b, s, d = x.shape
    x, xin = L.add_rmsnorm(x, delta, p["norm"]["w"])
    u, z = H.cols(mm(xin, p["w_up"]), 2 * d), mm(xin, p["w_gate"])
    q, k, v, log_f, i_gate = _mlstm_heads(p, cfg, u, mm)
    # the normalizer channel rides in the SSD state
    ones = v.new_ones(v.shape[:-1] + (1,))
    v_aug = torch.cat([v, ones], dim=-1) * i_gate[..., None].to(v.dtype)
    if n_valid is not None:
        keep = torch.arange(s, device=x.device) < int(n_valid)
        log_f = torch.where(keep[None, :, None], log_f, 0.0)
        v_aug = torch.where(keep[None, :, None, None], v_aug,
                            v_aug.new_zeros(()))
    y_aug, h = ssd_chunked(v_aug, log_f, k, q, cfg.chunk_len, h0=state)
    y = y_aug[..., :-1] / torch.clamp(y_aug[..., -1:].abs(), min=1.0)
    return (x, _mlstm_out(p, x, y.reshape(b, s, -1), z, mm)), h


def mlstm_decode_step(p, cfg, x, delta, state):
    """x (B, 1, d), ``delta`` as in :func:`apply_mlstm`; state (B, H,
    P + 1, N). Returns ((residual, output), state): the O(1) update."""
    b, _, d = x.shape
    x, xin = L.add_rmsnorm(x, delta, p["norm"]["w"])
    u, z = H.cols(xin @ p["w_up"], 2 * d), xin @ p["w_gate"]
    q, k, v, log_f, i_gate = _mlstm_heads(p, cfg, u, torch.matmul)
    q1, k1, v1 = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ones = v1.new_ones(v1.shape[:-1] + (1,))
    v_aug = torch.cat([v1, ones], dim=-1) * i_gate[:, 0, :, None]
    upd = torch.einsum("bhp,bhn->bhpn", v_aug, k1)
    state = torch.exp(log_f[:, 0])[..., None, None] * state + upd
    y_aug = torch.einsum("bhpn,bhn->bhp", state, q1)
    y = y_aug[..., :-1] / torch.clamp(y_aug[..., -1:].abs(), min=1.0)
    return (x, _mlstm_out(p, x, y.reshape(b, 1, -1), z, torch.matmul)), \
        state


def mlstm_state_shape(cfg, batch: int) -> tuple:
    d_in = 2 * cfg.d_model
    pdim = d_in // cfg.n_heads
    return (batch, cfg.n_heads, pdim + 1, pdim)


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_ff(d_model: int) -> int:
    """Width of the sLSTM's small GeLU feed-forward."""
    return int(d_model * 4 / 3)


def init_slstm(gen, cfg, lead=(), device="cuda") -> dict:
    """One sLSTM block's params with leading axes ``lead``; shapes, dtypes
    and keys of ``repro.models.xlstm.init_slstm``."""
    d, dt = cfg.d_model, L.dtype_of(cfg)
    h = cfg.n_heads
    ph = d // h
    d_ff = slstm_ff(d)

    def dense(*shape, fan_in):
        return L.dense_init(gen, (*lead, *shape), dt, device, fan_in=fan_in)

    def ones(width):
        return {"w": torch.ones((*lead, width), dtype=dt, device=device)}

    return {
        "norm": ones(d),
        "w_in": dense(d, 4 * d, fan_in=d),           # gates i, f, z, o
        "w_rec": dense(h, ph, 4 * ph, fan_in=ph),    # block-diagonal
        "bias": torch.zeros((*lead, 4 * d), dtype=torch.float32,
                            device=device),
        "ff_norm": ones(d),
        "w_ff_up": dense(d, d_ff, fan_in=d),
        "w_ff_down": dense(d_ff, d, fan_in=d_ff),
    }


def _slstm_cell(p, cfg, xt, carry):
    """One step: xt (B, 4d), the step's pre-projected input; carry (c, n,
    h) each (B, H, ph) fp32. Returns (y (B, d) fp32, the new carry)."""
    c, n, hp = carry
    nh = cfg.n_heads
    ph = cfg.d_model // nh
    rec = torch.einsum("bhp,hpq->bhq", hp.to(p["w_rec"].dtype), p["w_rec"])
    gates = xt.reshape(xt.shape[0], nh, 4 * ph) + rec
    gates = gates.float() + p["bias"].reshape(nh, 4 * ph)
    gi, gf, gz, go = torch.split(gates, ph, dim=-1)
    i, f = torch.sigmoid(gi), torch.sigmoid(gf + 1.0)
    c = f * c + i * torch.tanh(gz)
    n = f * n + i
    hnew = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return hnew.reshape(xt.shape[0], -1), (c, n, hnew)


def apply_slstm(p, cfg, x, delta=None, state=None, n_valid=None,
                mm=torch.matmul):
    """x (B, S, d), ``delta`` as in :func:`apply_mlstm`; state (c, n, h)
    each (B, H, ph) fp32, or None. A Python loop over time. Returns
    ((residual, output), state).

    ``n_valid`` (an int): the prompt's true length in a right-padded
    input. The carry is frozen at pad steps — they are not run at all;
    their outputs, which nobody reads, are zeros — so the final state is
    the exact-length prompt's."""
    b, s, d = x.shape
    x, xin = L.add_rmsnorm(x, delta, p["norm"]["w"])
    xproj = H.cols(mm(xin, p["w_in"]), 4 * d)            # (B, S, 4d)
    if state is None:
        zero = torch.zeros((b, cfg.n_heads, d // cfg.n_heads),
                           dtype=torch.float32, device=x.device)
        state = (zero, zero, zero)
    steps = s if n_valid is None else min(int(n_valid), s)
    ys = []
    for t in range(steps):
        y, state = _slstm_cell(p, cfg, xproj[:, t], state)
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, d))
    if steps < s:
        y = torch.cat([y, y.new_zeros((b, s - steps, d))], dim=1)
    # the small GeLU feed-forward, its residual add fused into ff_norm
    x, xf = L.add_rmsnorm(x, y.to(x.dtype), p["ff_norm"]["w"])
    f = L.gelu(H.cols(mm(xf, p["w_ff_up"]), slstm_ff(d)))
    return (x, H.cols(mm(f, p["w_ff_down"]), d)), state


def slstm_decode_step(p, cfg, x, delta, state):
    """One token through :func:`apply_slstm`."""
    return apply_slstm(p, cfg, x, delta, state)


def slstm_state_shape(cfg, batch: int) -> tuple:
    return (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
