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
- :func:`residual` holds a call's residual stream split over ``model``
  as ``cfg.act_shard`` says (the reference's ``hints.hidden(x,
  act_shard)``): d_model (``"dmodel"``) or the positions (``"seq"``)
  where they divide. :func:`hidden` then leaves each rank its part of
  the sublayer's output, :func:`embed` its part of the lookups, and a
  norm gathers the rank's parts of its input whole (:func:`stream_whole`;
  :func:`stream_part` cuts a whole tensor to the rank's part);
- :func:`logits` all-gathers the vocab over ``model`` before sampling;
- :func:`cols` gathers a recurrent sublayer's product columns to what
  the rank computes on — every column, or its own heads'
  (:func:`model_split` ranks split them);
- :func:`moe_buf` / :func:`moe_gather` select the rank's experts of the
  (E, capacity, d) dispatch buffer and gather their outputs in expert
  order;
- :func:`embed` looks a token up in a vocab-sharded table;
- :func:`weights` gathers a layer's leaves split over ``data`` (a model
  over the serve budget) at use, with no autograd;
- :func:`kv_offset`, :func:`kv_shards` and :func:`gather_positions` place
  and gather a cache split by position over ``model``, or over ``data``
  and ``model`` where the batch does not divide over ``data``.

Each is a no-op outside :func:`use_mesh` — every path that runs on one
device is untouched — and a no-op on a tensor that is already whole (a
weight the rules left whole). The context is per thread: each rank's
worker enters it around its own call.

Under ``use_mesh(..., train=True)`` the same sites apply the reference's
train placements instead (the rules of
:func:`~repro_torch.distributed.sharding.train_specs`), each through an
autograd function of :mod:`repro_torch.distributed.collectives`:

- :func:`weights` gathers a layer's weights split over the FSDP axes
  whole at use, and reduce-scatters their gradients; a sublayer that
  runs whole on every model rank (``sharding.whole_sublayers``, or an
  MLP its placement keeps whole) comes back as a :class:`Whole` dict,
  its weights split over ``model`` gathered too — their gradient the
  rank's slice of the whole one every model rank computes alike, never
  a sum;
- :func:`col_input` is Megatron's *f* ahead of a product whose columns
  (heads, FFN units, vocab) are split over ``model``; :func:`row_input`
  passes the rank's columns on, and :func:`hidden` is Megatron's *g*,
  the rank-ordered all-reduce of the row-parallel product's partial
  sums (``wo`` / ``w_down`` split their contraction over ``model``);
  both are identities for a :class:`Whole` sublayer. Where the call's
  residual stream is split (:func:`residual`), :func:`hidden`
  reduce-scatters the partial sums instead — each rank's part bitwise
  the all-reduce's — and cuts a whole sublayer's output;
- :func:`logits` leaves the vocab-split logits split, and
  :func:`vocab_nll` takes the loss from them (Megatron's vocab-parallel
  cross-entropy): no rank forms the whole vocab; :func:`embed` sums the
  vocab-split lookups by *g* (reduce-scattered where the stream is
  split);
- :func:`local_cols` and :func:`moe_buf` cut a replicated tensor to the
  rank's columns or experts (backward: the chunks' gradients gathered),
  :func:`moe_gather` gathers the experts' outputs;
- :func:`data_ranks` and :func:`slot_offsets` size an MoE's capacity
  and number its slots over the whole microbatch of every FSDP rank
  (``("pod", "data")``, pod-major, as the batch's rows) — in serving,
  over every data replica's rows of a dispatch split over ``data``
  (``use_mesh(..., data_rows=True)``) —, and
  :func:`sum_over_data` / :func:`sum_over_mesh` make the loss's mean and
  the gradient's norm global.

The train context carries its rank, so autograd's worker thread — which
runs a rank's backward and recompute on the card — can restore it
(:func:`snapshot`, :func:`restored`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from repro_torch.distributed import collectives as C

_STATE = threading.local()


class _Ctx(NamedTuple):
    mesh: object
    attn: str
    plan: object
    train: bool
    comm: object       # collectives.Comm of a train context's rank
    specs: object      # the params' spec tree: the train placements, or a
                       # serve placement that splits weights over data
    whole: frozenset   # sublayer keys run whole over model in training
    pos_axes: tuple    # the axes a "seq" cache splits its positions over
    data_rows: bool    # serving: the dispatch's rows split over data
    resid: int | None = None   # the dim of the call's (B, S, d) residual
                               # stream split over model (residual)


class Whole(dict):
    """A sublayer's weights gathered whole over ``model`` as well as
    FSDP (:func:`weights`): every model rank runs it whole on the same
    input, so no Megatron collective applies inside it."""


def whole(p) -> bool:
    """Whether the sublayer ``p`` runs whole on every model rank."""
    return isinstance(p, Whole)


@contextlib.contextmanager
def use_mesh(mesh, *, attn: str = "heads", plan=None, train: bool = False,
             specs=None, whole=frozenset(), pos_axes=("model",),
             data_rows: bool = False):
    """Arm the hints for the calling rank's model code. ``attn``: how
    this dispatch's KV cache is laid out over ``model`` — ``"heads"``
    (each rank its KV heads), ``"seq"`` (each rank a range of positions;
    q, k and v gathered to every head) or ``"replicated"`` (every head
    and position on every rank). ``plan``: the (batch, KV heads) of the
    whole decode, from which the split-KV kernels take their launch
    plan on every shard. ``pos_axes``: the axes the "seq" layout splits
    positions over, flattened in order (``("model",)``, or ``("data",
    "model")`` where the batch does not divide over ``data``). ``specs``
    in serving: the params' serve placement where it splits weights over
    ``data`` (:func:`weights` gathers them), else None.

    ``train``: the train placements, over the params' ``specs`` (the
    spec tree of the whole params); ``whole``: the sublayer keys that
    run whole over ``model`` (``sharding.whole_sublayers``). Around a
    train step's call, on the controller, it names the mesh
    :func:`~repro_torch.launch.steps.build_train_step` runs over; inside
    a rank's worker it also takes the rank and its call from the
    thread."""
    if attn not in ("heads", "seq", "replicated"):
        raise ValueError(f"unknown attention layout {attn!r}")
    comm = None
    if train and mesh.rank() is not None:
        comm = C.Comm(mesh, mesh.rank(), mesh.current_call())
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = _Ctx(mesh, attn, plan, train, comm, specs,
                      frozenset(whole), tuple(pos_axes), bool(data_rows))
    try:
        yield mesh
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def residual(mode: str, shape):
    """Within the block, the armed rank's model call holds its residual
    stream — the (B, S, d) activation that runs between the sublayers,
    ``shape`` whole — split over ``model`` as ``mode`` (a config's
    ``act_shard``) says, as the
    reference's ``hints.hidden(x, act_shard)`` pins it: ``"dmodel"``
    splits d where it divides ``model``, ``"seq"`` the positions where
    they divide, ``"none"`` (or a dim that does not divide, or no mesh)
    nothing. In training and in serving alike: the bits do not change,
    only where they are held. A nested call (whisper's encoder) arms its
    own stream."""
    ctx = _ctx()
    if ctx is None:
        yield
        return
    if mode not in ("none", "dmodel", "seq"):
        raise ValueError(f"unknown act_shard {mode!r}: none, dmodel or seq")
    n = ctx.mesh.axis_size("model")
    dim = {"dmodel": 2, "seq": 1}.get(mode)
    split = dim is not None and n > 1 and shape[dim] % n == 0
    _STATE.ctx = ctx._replace(resid=dim if split else None)
    try:
        yield
    finally:
        _STATE.ctx = ctx


def stream_dim(x: torch.Tensor) -> int | None:
    """The dim of ``x`` — a tensor of the residual stream's layout: (B,
    S, d), or (N, d) rows under a d split — that the armed call's
    residual split cuts (:func:`residual`); None where nothing is cut."""
    ctx = _ctx()
    if ctx is None or ctx.resid is None:
        return None
    if ctx.resid == 2:
        return x.dim() - 1
    return 1 if x.dim() == 3 else None


def stream_part(x: torch.Tensor) -> torch.Tensor:
    """The rank's part of ``x``, a whole tensor of the residual stream's
    layout, the same on every model rank: its chunk along
    :func:`stream_dim` (in training its gradient the chunks' gathered);
    ``x`` itself where the stream is not split."""
    dim = stream_dim(x)
    if dim is None:
        return x
    comm = _comm()
    if comm is not None:
        return C.split_to(x, dim, "model", comm)
    n = current_mesh().axis_size("model")
    w = x.shape[dim] // n
    return x.narrow(dim, model_index() * w, w).contiguous()


def stream_whole(x: torch.Tensor) -> torch.Tensor:
    """The ranks' parts ``x`` of a split residual stream gathered whole
    (in training its gradient the rank's chunk: every model rank
    computes the same whole gradient); ``x`` itself where the stream is
    not split."""
    dim = stream_dim(x)
    if dim is None:
        return x
    comm = _comm()
    if comm is not None:
        return C.gather_from(x, dim, "model", comm)
    return current_mesh().all_gather(x.contiguous(), dim, "model")


class StreamPart(NamedTuple):
    """A rank's part of the residual stream held split over ``model`` in
    training (:func:`residual`): its chunk along ``dim``, of ``comm``'s
    model group. Its moves are untracked by autograd, for a function
    that makes its own backward (``ops.add_rmsnorm(..., part=)``)."""
    dim: int
    comm: object

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The group's parts ``x`` gathered whole."""
        return self.comm.all_gather(x, self.dim, "model")

    def cut(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's part of the whole ``x``."""
        return self.comm.chunk(x, self.dim, "model").contiguous()

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """A whole tensor that holds the part ``x`` at the rank's place
        and zeros elsewhere."""
        shape = list(x.shape)
        shape[self.dim] *= self.comm.size("model")
        out = x.new_zeros(shape)
        self.comm.chunk(out, self.dim, "model").copy_(x)
        return out


def stream_layout(x: torch.Tensor) -> StreamPart | None:
    """In training, where the armed call holds its stream split
    (:func:`residual`), the layout of ``x``, a rank's part of it; None
    elsewhere."""
    dim, comm = stream_dim(x), _comm()
    return None if dim is None or comm is None else StreamPart(dim, comm)


def snapshot():
    """The calling thread's context, for :func:`restored`."""
    return _ctx()


@contextlib.contextmanager
def restored(ctx):
    """``ctx`` (a :func:`snapshot`) armed on the calling thread: a layer's
    recompute, which autograd runs on its own worker thread on the card,
    runs the rank's mesh path."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def _ctx():
    return getattr(_STATE, "ctx", None)


def current_mesh():
    ctx = _ctx()
    return None if ctx is None else ctx.mesh


def training() -> bool:
    """Whether the train placements are armed."""
    ctx = _ctx()
    return ctx is not None and ctx.train


def _comm():
    """The train context's :class:`~repro_torch.distributed.collectives.
    Comm`, or None (serving, one device, or the controller)."""
    ctx = _ctx()
    return None if ctx is None else ctx.comm


def train_rank() -> int | None:
    """The calling rank in a train context (None otherwise)."""
    comm = _comm()
    return None if comm is None else comm.rank


def train_placement():
    """(the rank's :class:`~repro_torch.distributed.collectives.Comm`,
    the params' spec tree) in a rank's train context, else None."""
    ctx = _ctx()
    if ctx is None or ctx.comm is None:
        return None
    return ctx.comm, ctx.specs


def attn_layout() -> str | None:
    """The armed attention layout (None outside a mesh)."""
    ctx = _ctx()
    return None if ctx is None else ctx.attn


def model_index() -> int:
    """The calling rank's coordinate on ``model`` (0 outside a mesh)."""
    comm = _comm()
    if comm is not None:
        return comm.index("model")
    mesh = current_mesh()
    return 0 if mesh is None else mesh.coords(mesh.rank())[-1]


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
    column locally, in one order. Training passes the rank's columns on:
    its weight holds the matching rows."""
    if _comm() is not None:
        if x.shape[-1] != width:
            raise ValueError(f"row-parallel input of {x.shape[-1]} columns "
                             f"against {width} weight rows")
        return x
    return _gather_last(x, width)


def hidden(x: torch.Tensor, width: int, split: bool = True
           ) -> torch.Tensor:
    """A sublayer's output (..., d_model / model) gathered to
    ``width`` = d_model on every rank, ahead of the residual add.
    Training: the row-parallel product's partial sums (..., d_model)
    summed over ``model`` in rank order (Megatron's *g*) — where the
    product's contraction is ``split``; a whole sublayer's output is
    already the sum. Where the call's residual stream is split
    (:func:`residual`), each rank keeps its part of the output: in
    training the partial sums reduce-scattered (the rank's part of the
    same sum, bitwise), in serving the rank's own output columns (d
    split) or its positions of the gathered output."""
    comm = _comm()
    dim = stream_dim(x)
    if comm is not None:
        if dim is None:
            return C.reduce_from(x, "model", comm) if split else x
        return (C.scatter_from(x, dim, "model", comm) if split
                else stream_part(x))
    if dim == x.dim() - 1 and x.shape[-1] != width:
        return x     # the rank's own columns: its part of a d split
    return stream_part(_gather_last(x, width))


def col_input(x: torch.Tensor, split: bool = True) -> torch.Tensor:
    """The replicated activation feeding products whose output columns
    are split over ``model`` (``split``): in training, Megatron's *f* —
    its gradient, each rank's partial, summed over ``model``. A no-op
    outside training or for a product the rules left whole."""
    comm = _comm()
    if comm is None or not split:
        return x
    return C.copy_to(x, "model", comm)


def logits(x: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., V / model) logits of a vocab-sharded head gathered to the
    whole vocab for sampling. Training keeps them split, as the
    reference's ``hints.logits`` pins them: the loss is vocab-parallel
    (:func:`vocab_nll`)."""
    if _comm() is not None:
        return x
    return _gather_last(x, vocab)


def vocab_nll(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """In training, the per-position negative log likelihood of
    ``labels`` under logits split over ``model`` by vocabulary, ``z``
    the rank's columns: Megatron's vocab-parallel cross-entropy
    (:func:`~repro_torch.distributed.collectives.vocab_nll`), the same
    bits on every model rank."""
    comm = _comm()
    if comm is None:
        raise RuntimeError("vocab-split logits outside a train context")
    return C.vocab_nll(z, labels, "model", comm)


def heads(x: torch.Tensor, width: int) -> torch.Tensor:
    """A q, k or v projection's columns gathered to ``width`` (its
    config's heads x d_head): in the "seq" and "replicated" layouts the
    shard config keeps every head, and attention needs them all; in
    "heads" — training's only layout — the width is the rank's own and
    nothing moves."""
    if _comm() is not None:
        if x.shape[-1] != width:
            raise ValueError(f"{x.shape[-1]} projection columns on a rank "
                             f"of {width}")
        return x
    return _gather_last(x, width)


def model_split() -> int:
    """The ``model`` ranks a serving dispatch splits the recurrent
    sublayers' heads and columns over (1 outside a serving mesh; in
    training they run whole on every model rank)."""
    mesh = current_mesh()
    if mesh is None or _comm() is not None:
        return 1
    return mesh.axis_size("model")


def cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """A product's output columns, split over ``model`` by the serve
    rule, gathered to ``width`` — the columns the rank computes on next
    (every column, or its heads'); ``x`` itself when it has them, and in
    training, where the recurrent sublayers run whole."""
    if _comm() is not None:
        return x
    return _gather_last(x, width)


def local_cols(b: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` columns of a whole bias ``b`` (..., n * model)
    that is added to a column-sharded product; ``b`` itself when it
    already has ``n`` columns."""
    if b.shape[-1] == n:
        return b
    comm = _comm()
    if comm is not None:
        return C.split_to(b, b.dim() - 1, "model", comm)
    i = model_index()
    return b[..., i * n:(i + 1) * n]


def moe_buf(buf: torch.Tensor, n_local: int) -> torch.Tensor:
    """The rank's ``n_local`` experts of the (E, capacity, d) dispatch
    buffer: experts are split over ``model`` in order."""
    if buf.shape[0] == n_local:
        return buf
    comm = _comm()
    if comm is not None:
        return C.split_to(buf, 0, "model", comm)
    i = model_index()
    return buf[i * n_local:(i + 1) * n_local]


def moe_gather(y: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The experts' outputs (E / model, capacity, d) gathered to all E,
    in expert order."""
    mesh = current_mesh()
    if mesh is None or y.shape[0] == n_experts:
        return y
    comm = _comm()
    if comm is not None:
        return C.gather_from(y, 0, "model", comm)
    return mesh.all_gather(y.contiguous(), 0, "model")


def embed(table: torch.Tensor, ids: torch.Tensor, vocab: int
          ) -> torch.Tensor:
    """Rows of ``ids`` from a vocab-sharded ``table`` (V / model, d):
    each rank looks up its own id range, zero elsewhere, and the ranks'
    rows are summed in rank order — every token's row is one rank's,
    exactly, plus zeros (in training by Megatron's *g*, so each rank's
    table rows take the gradient of the tokens in its range). Where the
    call's residual stream is split (:func:`residual`), each rank gets
    its part of the rows (in training the sum reduce-scattered)."""
    rows = table.shape[0]
    mesh = current_mesh()
    if mesh is None or rows == vocab:
        return stream_part(table[ids.long()])
    lo = model_index() * rows
    local = ids.long() - lo
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    comm = _comm()
    dim = stream_dim(x)
    if comm is not None:
        if dim is not None:
            return C.scatter_from(x, dim, "model", comm)
        return C.reduce_from(x, "model", comm)
    parts = mesh.all_gather(x.unsqueeze(0), 0, "model")
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return stream_part(out)


def weights(tree, *path):
    """In training, ``tree`` — the params' subtree at ``path``, or one
    layer of a stacked subtree — with every leaf the placements split
    over the FSDP axes gathered whole (FSDP at use; its gradient
    reduce-scattered back to the shards), and each sublayer that runs
    whole over ``model`` a :class:`Whole` dict with its leaves split
    over ``model`` gathered too (their gradient the rank's slice). In
    serving under a placement that splits weights over
    ``data``, ``tree`` with those leaves all-gathered over ``data`` in
    shard order (no autograd; a leaf split over ``model`` stays the
    rank's). ``tree`` itself otherwise."""
    ctx = _ctx()
    if ctx is None or ctx.specs is None:
        return tree
    specs = ctx.specs
    for k in path:
        specs = specs[k]
    if ctx.comm is None:
        return tree if ctx.train else _gather_data(tree, specs, ctx.mesh)
    if ctx.comm.size(C.FSDP) == 1 and ctx.comm.size("model") == 1:
        return tree
    top = bool(path) and path[0] in ctx.whole
    return _gather(tree, specs, ctx, top, path[-1] if path else "")


def _whole_here(key, parent, specs, ctx) -> bool:
    """Whether the subtree at ``key`` (under ``parent``, placed by
    ``specs``) is a sublayer that runs whole over ``model``: a key of
    ``ctx.whole``, or an MLP (``mlp``, an MoE's ``shared``) whose
    placement keeps ``w_down``'s contraction whole — its width does not
    divide."""
    if key in ctx.whole:
        return True
    if key == "mlp" or (key == "shared" and parent == "moe"):
        entry = specs["w_down"][-2]
        return entry is None or "model" not in entry
    return False


def _gather(tree, specs, ctx, whole_, key=""):
    if isinstance(tree, dict):
        out = {k: _gather(v, specs[k], ctx,
                          whole_ or _whole_here(k, key, specs[k], ctx), k)
               for k, v in tree.items()}
        return Whole(out) if whole_ else out
    if isinstance(tree, list):
        return [_gather(v, s, ctx, whole_) for v, s in zip(tree, specs)]
    # a stacked leaf's layer drops the spec's leading (whole) entries
    for dim, entry in enumerate(specs[len(specs) - tree.dim():]):
        if entry is None:
            continue
        if "model" in entry:
            if whole_:
                tree = C.gather_from(tree, dim, "model", ctx.comm)
        else:
            tree = C.fsdp_gather(tree, dim, ctx.comm, entry)
    return tree


@torch.no_grad()
def _gather_data(tree, specs, mesh):
    """Serving's gather at use: ``tree`` with every leaf's dims split
    over ``data`` all-gathered whole (a stacked leaf's layer drops the
    spec's leading entries)."""
    if isinstance(tree, dict):
        return {k: _gather_data(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gather_data(v, s, mesh) for v, s in zip(tree, specs)]
    for dim, entry in enumerate(specs[len(specs) - tree.dim():]):
        if entry is not None and "data" in entry:
            tree = mesh.all_gather(tree.contiguous(), dim, "data")
    return tree


def _serve_data_rows() -> bool:
    """Whether a serving dispatch's rows are split over ``data`` (of
    size > 1)."""
    ctx = _ctx()
    return (ctx is not None and ctx.comm is None and ctx.data_rows
            and ctx.mesh.axis_size("data") > 1)


def data_ranks() -> int:
    """Ranks a dispatch's rows are split over: in training the FSDP
    group, in serving over a data-split batch ``data`` (1 otherwise)."""
    comm = _comm()
    if comm is not None:
        return comm.size(C.FSDP)
    return current_mesh().axis_size("data") if _serve_data_rows() else 1


def slot_offsets(ids: torch.Tensor, n_experts: int):
    """Per routed slot of ``ids`` (N, k), the slots the lower data ranks
    route to its expert — over a split batch the dispatch numbers slots
    over every rank's rows, rank by rank in the rows' order (in training
    the FSDP group's, pod-major), as the reference's one program does; 0
    otherwise."""
    comm = _comm()
    if comm is not None and comm.size(C.FSDP) > 1:
        def gather(t):
            return comm.all_gather(t, 0, C.FSDP)
        index = comm.index(C.FSDP)
    elif comm is None and _serve_data_rows():
        mesh, rank = current_mesh(), current_mesh().rank()

        def gather(t):
            return mesh.all_gather(t, 0, "data")
        index = mesh.group(rank, "data").index(rank)
    else:
        return 0
    counts = torch.bincount(ids.reshape(-1), minlength=n_experts)
    below = gather(counts[None])[:index].sum(0)
    return below[ids.reshape(-1)]


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """In training, the FSDP ranks' ``x`` summed in rank order (its
    gradient passed to each as it is); ``x`` itself otherwise."""
    comm = _comm()
    return x if comm is None else C.reduce_from(x, C.FSDP, comm)


@torch.no_grad()
def sum_over_mesh(x: torch.Tensor) -> torch.Tensor:
    """In training, the sum of every rank's ``x`` — over ``model``, then
    over the FSDP group, each in rank order, so every rank gets the same
    bits; ``x`` itself otherwise."""
    comm = _comm()
    if comm is None:
        return x
    return comm.all_reduce(comm.all_reduce(x, "model"), C.FSDP)


def _pos_axes() -> tuple:
    ctx = _ctx()
    return ("model",) if ctx is None else ctx.pos_axes


def kv_shards() -> int:
    """Position shards of a "seq" cache (1 otherwise): the size of the
    axes it splits positions over."""
    mesh = current_mesh()
    if mesh is None or attn_layout() != "seq":
        return 1
    n = 1
    for a in _pos_axes():
        n *= mesh.axis_size(a)
    return n


def kv_offset(c_local: int) -> int:
    """First cache position a rank holds: its index over the position
    axes (row-major) x ``c_local`` in the "seq" layout, 0 otherwise."""
    if attn_layout() != "seq":
        return 0
    mesh = current_mesh()
    rank = mesh.rank()
    grp = mesh.group(rank, _pos_axes())
    return grp.index(rank) * c_local


def gather_positions(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The shards' split-KV partials of one decode (or any tensor split
    by position) gathered along ``dim`` in shard order, over the "seq"
    layout's position axes."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return mesh.all_gather(x.contiguous(), dim, _pos_axes())


def decode_plan():
    """The (batch, KV heads) of the whole decode, or None: the split-KV
    kernels cut a shard's cache where the single device would."""
    ctx = _ctx()
    return None if ctx is None else ctx.plan
