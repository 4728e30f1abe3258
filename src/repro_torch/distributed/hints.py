"""Where the model code meets the mesh: the reference's sharding-hint
sites (``hidden``, ``logits``, ``row_input``, ``moe_buf``), made into
explicit gathers between the ranks of a :class:`DeviceMesh`.

Counterpart of ``repro/distributed/hints.py`` under
``use_mesh(..., gather_rows=True)``, the bitwise serving layout. There
the hints pin shardings for XLA to lower; here each rank runs the model
functions on its own shard (:mod:`repro_torch.distributed.sharding`)
and the hints move the data:

- :func:`row_input` all-gathers an activation's last dim over ``model``
  before a row-parallel product (``wo``, ``w_down``), so the product
  contracts the whole dim locally;
- :func:`hidden` all-gathers a sublayer's output columns over ``model``
  before the residual add;
- :func:`logits` all-gathers the vocab over ``model`` before sampling;
- :func:`moe_buf` / :func:`moe_gather` select the rank's experts of the
  (E, capacity, d) dispatch buffer and gather their outputs in expert
  order;
- :func:`embed` looks a token up in a vocab-sharded table.

Each is a no-op outside :func:`use_mesh` — every path that runs on one
device is untouched — and a no-op on a tensor that is already whole (a
weight the rules left whole). The context is per thread: each rank's
worker enters it around its own call.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, attn: str = "heads", plan=None):
    """Arm the hints for the calling rank's model code. ``attn``: how
    this dispatch's KV cache is laid out over ``model`` — ``"heads"``
    (each rank its KV heads), ``"seq"`` (each rank a range of positions;
    q, k and v gathered to every head) or ``"replicated"`` (every head
    and position on every rank). ``plan``: the (batch, KV heads) of the
    whole decode, from which the split-KV kernels take their launch
    plan on every shard."""
    if attn not in ("heads", "seq", "replicated"):
        raise ValueError(f"unknown attention layout {attn!r}")
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, attn, plan)
    try:
        yield mesh
    finally:
        _STATE.ctx = prev


def _ctx():
    return getattr(_STATE, "ctx", None)


def current_mesh():
    ctx = _ctx()
    return None if ctx is None else ctx[0]


def attn_layout() -> str | None:
    """The armed attention layout (None outside a mesh)."""
    ctx = _ctx()
    return None if ctx is None else ctx[1]


def model_index() -> int:
    """The calling rank's coordinate on ``model`` (0 outside a mesh)."""
    mesh = current_mesh()
    return 0 if mesh is None else mesh.coords(mesh.rank())[1]


def _gather_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last dim all-gathered over ``model`` to ``width``;
    ``x`` itself when it is whole already or no mesh is armed."""
    mesh = current_mesh()
    if mesh is None or x.shape[-1] == width:
        return x
    out = mesh.all_gather(x.contiguous(), -1, "model")
    if out.shape[-1] != width:
        raise ValueError(f"gathered width {out.shape[-1]} != {width}")
    return out


def row_input(x: torch.Tensor, width: int) -> torch.Tensor:
    """The activation feeding a row-parallel product whose contraction
    dim is ``width``: gathered whole, so the product contracts every
    column locally, in one order."""
    return _gather_last(x, width)


def hidden(x: torch.Tensor, width: int) -> torch.Tensor:
    """A sublayer's output (..., d_model / model) gathered to
    ``width`` = d_model on every rank, ahead of the residual add."""
    return _gather_last(x, width)


def logits(x: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., V / model) logits of a vocab-sharded head gathered to the
    whole vocab."""
    return _gather_last(x, vocab)


def heads(x: torch.Tensor, width: int) -> torch.Tensor:
    """A q, k or v projection's columns gathered to ``width`` (its
    config's heads x d_head): in the "seq" and "replicated" layouts the
    shard config keeps every head, and attention needs them all; in
    "heads" the width is the rank's own and nothing moves."""
    return _gather_last(x, width)


def local_cols(b: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` columns of a whole bias ``b`` (..., n * model)
    that is added to a column-sharded product; ``b`` itself when it
    already has ``n`` columns."""
    if b.shape[-1] == n:
        return b
    i = model_index()
    return b[..., i * n:(i + 1) * n]


def moe_buf(buf: torch.Tensor, n_local: int) -> torch.Tensor:
    """The rank's ``n_local`` experts of the (E, capacity, d) dispatch
    buffer: experts are split over ``model`` in order."""
    if buf.shape[0] == n_local:
        return buf
    i = model_index()
    return buf[i * n_local:(i + 1) * n_local]


def moe_gather(y: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The experts' outputs (E / model, capacity, d) gathered to all E,
    in expert order."""
    mesh = current_mesh()
    if mesh is None or y.shape[0] == n_experts:
        return y
    return mesh.all_gather(y.contiguous(), 0, "model")


def embed(table: torch.Tensor, ids: torch.Tensor, vocab: int
          ) -> torch.Tensor:
    """Rows of ``ids`` from a vocab-sharded ``table`` (V / model, d):
    each rank looks up its own id range, zero elsewhere, and the ranks'
    rows are summed in rank order — every token's row is one rank's,
    exactly, plus zeros."""
    rows = table.shape[0]
    mesh = current_mesh()
    if mesh is None or rows == vocab:
        return table[ids.long()]
    lo = model_index() * rows
    local = ids.long() - lo
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    parts = mesh.all_gather(x.unsqueeze(0), 0, "model")
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def kv_offset(c_local: int) -> int:
    """First cache position a rank holds: ``model index x c_local`` in
    the "seq" layout, 0 otherwise."""
    return model_index() * c_local if attn_layout() == "seq" else 0


def gather_positions(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The shards' split-KV partials of one decode (or any tensor split
    by position over ``model``) gathered along ``dim`` in shard order."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return mesh.all_gather(x.contiguous(), dim, "model")


def decode_plan():
    """The (batch, KV heads) of the whole decode, or None: the split-KV
    kernels cut a shard's cache where the single device would."""
    ctx = _ctx()
    return None if ctx is None else ctx[2]
