"""Sharding rules over the (data, model) or (pod, data, model) mesh —
serve mode and train mode — and the shards they give each rank.

Counterpart of ``repro/distributed/sharding.py`` (``fsdp_axes``,
``axis_size``, ``_div``, ``_param_spec``, ``param_shardings`` with its
serve budget switch, ``opt_state_shardings``, ``batch_shardings``,
``cache_shardings``' ``kv_spec``, ``pool_shardings``, ``replicated``).
The rules work on shapes: a spec is a tuple with one entry per dim,
None (whole) or the tuple of mesh axes the dim is split over, leading
stack dims whole; an entry of several axes splits the dim row-major
over them (``("pod", "data")``: pod-major). An axis of size 1 splits
nothing. A mesh is a :class:`~repro_torch.distributed.mesh.DeviceMesh`
or its shape: two sizes name (data, model), three (pod, data, model).
Serving takes (data, model) meshes only.

Weights follow the reference's "gather-rows" tensor parallelism: every
product splits its output columns over ``model`` and keeps its
contraction dim whole — row-parallel ``wo`` / ``w_down`` too — experts
split over ``model``, the embedding and head split their vocab over
``model``. A model that fits ``serve_budget_bytes`` a device on the
model axis alone keeps its weights whole over ``data`` (each data
replica then reads local weights); a larger one keeps the FSDP rules,
which split contraction dims over ``data``, and serving gathers each
layer's ``data`` shards at use (:func:`~repro_torch.distributed.hints.
weights`). The recurrent sublayers take the serve rules too: Mamba2's
and the mLSTM's products split their output columns over ``model``
where they divide, in the reference's column order, and each rank
runs the scan over its own heads where the heads divide; the sLSTM, and
a recurrence whose heads do not divide, runs whole on every model rank
on its products' gathered columns.

Training keeps the reference's rules (``param_specs(serve=False)``):
FSDP splits contraction dims over ``("pod", "data")``, the row-parallel
``wo`` / ``w_down`` split their contraction (IN) dim over ``model``
(Megatron's partial sums), experts split their FFN dim over FSDP; a
dim that does not divide falls back to whole, leaf by leaf; the
optimizer moments follow the params, the batch splits its rows over
FSDP. :func:`train_specs` is the placement the train step realizes (the
rules of one layer's shapes, every layer stack whole), and
:func:`check_train_mesh` what it takes. A sublayer whose split the port
does not compute locally — Mamba2, mLSTM, sLSTM, and attention or an MLP
whose heads or width do not divide ``model`` — runs whole on every
model rank (:func:`whole_sublayers`).

Caches put the slot batch over ``data`` and the heads over ``model``
— KV heads, and the ``ssm`` and ``mlstm`` state's heads and the
``conv`` state's channels where they divide (:func:`cache_specs`);
when the KV heads do not divide ``model`` a contiguous cache
splits its positions over ``model`` instead (the sequence-sharded
decode of :mod:`repro_torch.models.attention`), and a paged pool stays
whole; when the batch does not divide over ``data`` a contiguous cache
splits its positions over every axis (:func:`kv_spec`).

:func:`shard_params` cuts a whole tree into per-rank trees (and
:func:`shard_tree` any tree by a spec tree: the optimizer state);
:func:`init_params_sharded` makes each rank's leaves directly on its
device, so the whole tree of a model that fits no single device never
exists; :func:`gather_tree` reassembles per-rank trees whole.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed.mesh import PerRank
from repro_torch.models import layers as L
from repro_torch.models import model as MD

POD, DATA, MODEL = "pod", "data", "model"
MOE_EXPERT_SHARD = "dff"   # the reference's default: experts' FFN dim
                           # over FSDP, contraction dims whole
SERVE_BUDGET_BYTES = 8e9


def _sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh or its shape."""
    shape = tuple(int(x) for x in getattr(mesh, "shape", mesh))
    return dict(zip(axis_names(shape), shape))


def axis_names(mesh) -> tuple:
    """``("data", "model")`` or ``("pod", "data", "model")``."""
    n = len(getattr(mesh, "shape", mesh))
    if n not in (2, 3):
        raise ValueError(f"a mesh has 2 or 3 axes, not {n}")
    return (POD, DATA, MODEL)[-n:]


def fsdp_axes(mesh) -> tuple:
    """Axes used for batch / FSDP sharding: ``("pod", "data")`` when
    the mesh has ``pod``, else ``("data",)``."""
    return tuple(a for a in (POD, DATA) if a in axis_names(mesh))


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _div(dim: int, mesh, axes) -> bool:
    if not axes:   # serve mode under the budget: never split over FSDP
        return False
    return dim % axis_size(mesh, axes) == 0


def _ax(axes):
    """A spec entry: None, or the tuple of axes."""
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _spec(*entries) -> tuple:
    return tuple(_ax(e) for e in entries)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_ff_up", "in_proj",
        "w_i", "w_f"}
_ROW = {"wo", "w_down", "w_ff_down", "out_proj"}
_EMBED = {"table", "head"}


def param_spec(path_names, shape, mesh, fsdp, serve=False) -> tuple:
    """The reference's ``_param_spec`` for a leaf of ``shape`` at
    ``path_names``, as a full-length spec."""
    name = path_names[-1] if path_names else ""
    in_moe = "moe" in path_names
    nd = len(shape)

    def lead(n_trailing):
        return (None,) * (nd - n_trailing)

    if nd <= 1:
        return (None,) * nd

    if in_moe and name in ("w_gate", "w_up", "w_down") and nd >= 3:
        e, a, b = shape[-3], shape[-2], shape[-1]
        e_ax = MODEL if _div(e, mesh, MODEL) else None
        if MOE_EXPERT_SHARD == "dff":
            if name == "w_down":
                f_ax = fsdp if _div(a, mesh, fsdp) else None
                return _spec(*lead(3), e_ax, f_ax, None)
            f_ax = fsdp if _div(b, mesh, fsdp) else None
            return _spec(*lead(3), e_ax, None, f_ax)
        d_ax = fsdp if _div((a if name != "w_down" else b), mesh,
                            fsdp) else None
        if name == "w_down":
            return _spec(*lead(3), e_ax, None, d_ax)
        return _spec(*lead(3), e_ax, d_ax, None)

    if name in _EMBED or path_names[-2:] == ["embed", "table"]:
        v, d = shape[-2], shape[-1]
        v_ax = MODEL if _div(v, mesh, MODEL) else None
        d_ax = fsdp if _div(d, mesh, fsdp) else None
        return _spec(*lead(2), v_ax, d_ax)

    if name in _COL:
        i, o = shape[-2], shape[-1]
        o_ax = MODEL if _div(o, mesh, MODEL) else None
        i_ax = fsdp if _div(i, mesh, fsdp) else None
        return _spec(*lead(2), i_ax, o_ax)

    if name in _ROW:
        i, o = shape[-2], shape[-1]
        if serve:
            # gather-rows TP: the contraction dim stays whole, OUT splits
            o_ax = MODEL if _div(o, mesh, MODEL) else None
            return _spec(*lead(2), None, o_ax)
        i_ax = MODEL if _div(i, mesh, MODEL) else None
        o_ax = fsdp if _div(o, mesh, fsdp) else None
        return _spec(*lead(2), i_ax, o_ax)

    if name == "router":
        d = shape[-2]
        return _spec(*lead(2), fsdp if _div(d, mesh, fsdp) else None, None)

    if name == "conv_w":
        c = shape[-1]
        return _spec(*lead(2), None, MODEL if _div(c, mesh, MODEL) else None)

    if name == "w_rec":
        return (None,) * nd

    d0 = shape[-2]
    return _spec(*lead(2), fsdp if _div(d0, mesh, fsdp) else None, None)


def _walk(tree, path=()):
    """(path names, leaf) of every tensor leaf: dict keys, list indices
    as strings, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield list(path), tree


def _map(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(path names, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def tree_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.element_size()
               for _, leaf in _walk(tree))


def param_specs(params, mesh, *, serve: bool = False,
                serve_budget_bytes: float = SERVE_BUDGET_BYTES):
    """A spec per leaf of ``params`` (tensors, meta ones included): the
    reference's ``param_shardings``. With ``serve``, a model that fits
    ``serve_budget_bytes`` a device over ``model`` alone keeps its
    weights whole over ``data``."""
    fsdp = fsdp_axes(mesh)
    if serve and (tree_bytes(params) / axis_size(mesh, MODEL)
                  <= serve_budget_bytes):
        fsdp = ()
    return _map(params, lambda names, leaf: param_spec(
        names, tuple(leaf.shape), mesh, fsdp, serve=serve))


def serve_specs(params, mesh, *,
                serve_budget_bytes: float = SERVE_BUDGET_BYTES):
    """The placement the engine realizes: the serve rules of
    :func:`param_specs` (``serve=True``, the budget switch over the
    whole tree) applied to each layer's leaf, as :func:`train_specs`
    applies the train rules — a stacked subtree (:data:`STACKS`) keeps
    its stack axes whole, since the engine runs a layer at a time and
    gathers its ``data`` shards at use (:func:`~repro_torch.distributed.
    hints.weights`). Where the reference's rule reads a stack as a
    matrix they differ: a stacked norm or bias (L, d) stays whole, and an
    MoE's stacked shared MLP (L, d, f) takes the dense MLP's rule, not
    an expert stack's."""
    fsdp = fsdp_axes(mesh)
    if tree_bytes(params) / axis_size(mesh, MODEL) <= serve_budget_bytes:
        fsdp = ()

    def one(names, leaf):
        shape = tuple(leaf.shape)
        lead = next((STACKS[n] for n in names if n in STACKS), 0)
        return (None,) * lead + param_spec(names, shape[lead:], mesh, fsdp,
                                           serve=True)

    return _map(params, one)


def splits_over_data(specs, mesh) -> bool:
    """Whether a placement splits any leaf over ``data`` (of size > 1):
    then serving gathers those leaves at use."""
    if _sizes(mesh)[DATA] == 1:
        return False
    return any(e is not None and DATA in e
               for _, spec in _walk_specs(specs) for e in spec)


def infer_serve_specs(rank_tree, cfg, mesh):
    """The serve placement a rank's param tree (one of
    :func:`init_params_sharded`'s or :func:`shard_tree`'s) was made
    under: :func:`serve_specs` at the default budget, or with every
    weight over the FSDP rules (a budget of 0, the reference's placement
    of a model over its budget) — whichever its local shapes match."""
    meta = MD.init_params(cfg, device="meta")
    for budget in (SERVE_BUDGET_BYTES, 0):
        specs = serve_specs(meta, mesh, serve_budget_bytes=budget)
        if all(tuple(leaf.shape) == local_shape(
                tuple(_lookup(meta, names).shape), _lookup(specs, names),
                mesh) for names, leaf in _walk(rank_tree)):
            return specs
    raise ValueError(f"{cfg.name}: a rank's param tree matches neither "
                     "serve placement (within the budget, or FSDP over "
                     "'data')")


# the stacked subtrees of the params and their leading stack axes: the
# decoder layers, whisper's encoder, zamba2's (groups, attn_every) Mamba2
# stack, xLSTM's (n_super, n_inner) mLSTMs and (n_super,) sLSTMs
STACKS = {"layers": 1, "enc_layers": 1, "mamba": 2, "mlstm": 2, "slstm": 1}


def train_specs(params, mesh):
    """The placement the train step realizes: the train rules applied to
    each layer's leaf — a leaf of a stacked subtree (:data:`STACKS`,
    named anywhere on its path: an optimizer state's ``mu`` / ``nu`` or
    a whole train state place as the params do) keeps its stack axes
    whole and takes the rule of one layer's shape, since the step
    gathers and runs a layer at a time. :func:`param_specs`
    applies the rules to the stacked shapes as the reference does, and
    there they differ: it reads a stacked vector (L, d) or (G, 6, H) — a
    norm's scale, a bias, Mamba2's ``A_log`` — as a matrix and splits a
    stack axis over FSDP, and an MoE's stacked shared experts (L, d, f)
    as an expert stack; here the vector is whole and the shared experts
    take the dense MLP's rule."""
    fsdp = fsdp_axes(mesh)

    def one(names, leaf):
        shape = tuple(leaf.shape)
        lead = next((STACKS[n] for n in names if n in STACKS), 0)
        return (None,) * lead + param_spec(names, shape[lead:], mesh, fsdp)

    return _map(params, one)


# the sublayers that train whole on every model rank whatever the
# widths (their gathers under autograd are the next slice's): Mamba2's
# in-projection concatenates z, x, B, C and dt, and the xLSTM cells'
# heads mix every column. Serving splits them by the serve rules.
WHOLE_STACKS = ("mamba", "mlstm", "slstm")


def attention_whole(cfg, mesh) -> bool:
    """Whether attention runs whole on every model rank: its query or
    KV heads do not divide ``model`` (each rank would hold part of a
    head)."""
    m = axis_size(mesh, MODEL)
    return cfg.n_heads % m != 0 or cfg.n_kv_heads % m != 0


def whole_sublayers(cfg, mesh) -> frozenset:
    """The sublayer keys that run whole over ``model`` in training:
    :data:`WHOLE_STACKS`, and ``"attn"`` / ``"xattn"`` where
    :func:`attention_whole`. An MLP runs whole where its width does not
    divide ``model`` — its placement then keeps it whole, which the
    hints read from the spec."""
    keys = set(WHOLE_STACKS)
    if attention_whole(cfg, mesh):
        keys |= {"attn", "xattn"}
    return frozenset(keys)


def train_rank_cfg(cfg, mesh):
    """The config each rank's model code runs in training: its own query
    and KV heads where attention splits them over ``model`` (Megatron),
    the whole config where attention runs whole or the family has none
    (xLSTM's cells read ``n_heads`` as their own heads)."""
    m = axis_size(mesh, MODEL)
    if m == 1 or cfg.family == "ssm" or attention_whole(cfg, mesh):
        return cfg
    return cfg.replace(n_heads=cfg.n_heads // m,
                       n_kv_heads=cfg.n_kv_heads // m)


def opt_state_specs(opt_state, mesh):
    """The reference's ``opt_state_shardings``: each moment leaf by the
    param rules (train mode) at its path — the leading ``mu`` / ``nu``
    changes no rule —, a scalar (the step) whole."""
    fsdp = fsdp_axes(mesh)

    def one(names, leaf):
        if leaf.dim() == 0:
            return ()
        return param_spec(names, tuple(leaf.shape), mesh, fsdp)

    return _map(opt_state, one)


def train_state_specs(param_spec_tree) -> dict:
    """The realized placement of an AdamW state over params placed by
    ``param_spec_tree`` (:func:`train_specs`): each moment as its param,
    the step whole — so the update stays elementwise on a rank's
    shard."""
    return {"mu": param_spec_tree, "nu": param_spec_tree, "step": ()}


def batch_spec(shape, mesh) -> tuple:
    """The reference's ``batch_shardings`` for one leaf: the batch dim
    over the FSDP axes, else over ``data``, else whole."""
    if not shape:
        return ()
    b = shape[0]
    fsdp = fsdp_axes(mesh)
    b_ax = fsdp if _div(b, mesh, fsdp) else (
        DATA if _div(b, mesh, DATA) else None)
    return _spec(b_ax, *(None,) * (len(shape) - 1))


def batch_specs(batch, mesh):
    """:func:`batch_spec` of every leaf of ``batch``."""
    return _map(batch, lambda names, leaf: batch_spec(tuple(leaf.shape),
                                                      mesh))


def replicated(tree):
    """The reference's ``replicated``: every leaf whole on every rank."""
    return _map(tree, lambda names, leaf: (None,) * leaf.dim())


def check_train_mesh(cfg, mesh) -> None:
    """What training over ``mesh`` takes: a family of the registry, any
    axis sizes (widths that do not divide ``model`` run whole on every
    model rank), and on the card one device per rank — autograd runs a
    device's backward on one worker thread, where two ranks' backward
    collectives would wait for each other."""
    MD.check_supported(cfg)
    devs = list(getattr(mesh, "devices", ()))
    cuda = [x for x in devs if x.type == "cuda"]
    if len(set(cuda)) != len(cuda):
        shape = "x".join(str(v) for v in _sizes(mesh).values())
        raise ValueError(
            f"a training mesh of {shape} on {[str(x) for x in devs]} names "
            "a CUDA device twice: autograd runs each device's backward on "
            "one worker thread, so two ranks sharing a card would wait for "
            "each other at their first backward collective")


def counted_leaves(specs, mesh, coords) -> list:
    """Per leaf of ``specs`` (a param or gradient spec tree), in pytree
    order, whether the rank at ``coords`` counts it in a sum over the
    mesh: a leaf whole over an axis is counted by the axis's first rank
    only, so every distinct shard counts once."""
    axes = axis_names(mesh)
    pos = dict(zip(axes, coords))
    out = []
    for _, spec in spec_leaves(specs):
        split = {a for e in spec if e is not None for a in e}
        out.append(all(pos[a] == 0 for a in axes if a not in split))
    return out


def spec_leaves(tree, path=""):
    """(path, spec) in pytree order (a dict's keys sorted, as
    :func:`repro_torch.tree.paths` walks)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in spec_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in spec_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _walk_specs(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_specs(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk_specs(v, path + (str(i),))
    else:
        yield list(path), tree


# ---------------------------------------------------------------------------
# cache rules
# ---------------------------------------------------------------------------

def kv_spec(shape, mesh) -> tuple:
    """``cache_shardings``' rule for a K/V leaf (.., B, C, H, Dh)."""
    fsdp = fsdp_axes(mesh)
    nd = len(shape)
    b, c, h = shape[-4], shape[-3], shape[-2]
    lead = (None,) * (nd - 4)
    if _div(h, mesh, MODEL):
        h_ax, c_model = MODEL, None
    else:
        h_ax, c_model = None, MODEL if _div(c, mesh, MODEL) else None
    if _div(b, mesh, fsdp):
        return _spec(*lead, fsdp, c_model, h_ax, None)
    if _div(b, mesh, DATA):
        return _spec(*lead, DATA, c_model, h_ax, None)
    all_axes = axis_names(mesh)
    if _div(c, mesh, all_axes):
        return _spec(*lead, None, all_axes, None, None)
    c_ax = c_model if c_model else (fsdp if _div(c, mesh, fsdp) else None)
    return _spec(*lead, None, c_ax, h_ax, None)


def cache_specs(cache, mesh) -> dict:
    """The reference's ``cache_shardings`` for a decode cache dict (its
    leaves' shapes): K/V by :func:`kv_spec`, recurrent state batch over
    FSDP and heads or channels over ``model``, the position counter
    whole."""
    fsdp = fsdp_axes(mesh)
    out = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name == "len" or nd == 0:
            out[name] = (None,) * nd
        elif name in ("k", "v", "cross_k", "cross_v"):
            out[name] = kv_spec(shape, mesh)
        elif name in ("ssm", "mlstm"):
            b, h = shape[-4], shape[-3]
            out[name] = _spec(*(None,) * (nd - 4),
                              fsdp if _div(b, mesh, fsdp) else None,
                              MODEL if _div(h, mesh, MODEL) else None,
                              None, None)
        elif name == "conv":
            b, c = shape[-3], shape[-1]
            out[name] = _spec(*(None,) * (nd - 3),
                              fsdp if _div(b, mesh, fsdp) else None, None,
                              MODEL if _div(c, mesh, MODEL) else None)
        elif name.startswith("slstm"):
            b = shape[-3]
            out[name] = _spec(*(None,) * (nd - 3),
                              fsdp if _div(b, mesh, fsdp) else None,
                              None, None)
        else:
            out[name] = (None,) * nd
    return out


def pool_spec(shape, mesh) -> tuple:
    """``pool_shardings``' rule for a paged pool (.., NB, bs, H, Dh):
    heads over ``model`` when they divide, everything else whole."""
    nd = len(shape)
    if nd < 2:
        return (None,) * nd
    h_ax = MODEL if _div(shape[-2], mesh, MODEL) else None
    return _spec(*(None,) * (nd - 2), h_ax, None)


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def split_count(entry, mesh) -> int:
    """Shards a dim with spec ``entry`` is cut into."""
    return 1 if entry is None else axis_size(mesh, entry)


def shard_index(entry, mesh, coords) -> int:
    """Which shard of a dim with spec ``entry`` the rank at ``coords``
    (one per mesh axis) holds: row-major over the entry's axes."""
    if entry is None:
        return 0
    pos = dict(zip(axis_names(mesh), coords))
    sizes = _sizes(mesh)
    i = 0
    for a in entry:
        i = i * sizes[a] + pos[a]
    return i


def local_shape(shape, spec, mesh) -> tuple:
    out = []
    for n, e in zip(shape, spec):
        k = split_count(e, mesh)
        if n % k:
            raise ValueError(f"dim {n} does not split into {k} shards")
        out.append(n // k)
    return tuple(out)


def shard_slices(shape, spec, mesh, coords) -> tuple:
    """The index of the rank at ``coords``'s shard of a ``shape`` leaf."""
    out = []
    for n, e in zip(shape, spec):
        w = n // split_count(e, mesh)
        i = shard_index(e, mesh, coords)
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def shard_key(spec, mesh, coords) -> tuple:
    """The shard's identity: its index along every split dim (ranks
    with equal keys hold equal values)."""
    return tuple(shard_index(e, mesh, coords) for e in spec)


def shard_tree(tree, specs, mesh) -> list:
    """Per-rank trees of ``tree`` (a whole tree, any device) under
    ``specs``, each on its rank's device. A leaf a rank holds whole is
    the same tensor on every rank of one device; a split leaf is a
    contiguous copy of the rank's shard."""
    out = []
    for r in range(mesh.size):
        coords, dev = mesh.coords(r), mesh.devices[r]

        def one(names, leaf):
            spec = _lookup(specs, names)
            if all(split_count(e, mesh) == 1 for e in spec):
                return leaf.to(dev)
            sl = shard_slices(tuple(leaf.shape), spec, mesh, coords)
            return leaf[sl].to(dev).contiguous()

        out.append(_map(tree, one))
    return out


def shard_params(params, cfg, mesh, specs=None) -> list:
    """Per-rank trees of ``params`` under ``specs`` (by default
    :func:`serve_specs`)."""
    if specs is None:
        specs = serve_specs(params, mesh)
    return shard_tree(params, specs, mesh)


def gather_tree(per_rank, specs, mesh, device="cpu"):
    """The whole tree of ``per_rank`` trees placed by ``specs``, on
    ``device``: each shard copied from the first rank holding it."""
    dev = torch.device(device)

    def one(names, leaf):
        spec = _lookup(specs, names)
        shape = tuple(n * split_count(e, mesh)
                      for n, e in zip(leaf.shape, spec))
        out = torch.empty(shape, dtype=leaf.dtype, device=dev)
        seen = set()
        for r in range(mesh.size):
            key = shard_key(spec, mesh, mesh.coords(r))
            if key not in seen:
                seen.add(key)
                sl = shard_slices(shape, spec, mesh, mesh.coords(r))
                out[sl] = _lookup(per_rank[r], names).to(dev)
        return out

    return _map(per_rank[0], one)


class Placement(NamedTuple):
    """How per-rank trees sit on a mesh: the mesh and the spec tree of
    one rank's tree structure (a train state: ``{"params": MeshTrain.
    specs, "opt_state": MeshTrain.state_specs}``, or
    :func:`train_specs` of the whole state)."""
    mesh: object
    specs: object

    def shard(self, whole) -> PerRank:
        """Per-rank trees of the whole tree ``whole``."""
        return PerRank(shard_tree(whole, self.specs, self.mesh))

    def gather(self, per_rank, device="cpu"):
        """The whole tree of ``per_rank``, each shard copied from the
        first rank holding it onto ``device``: a device holds no whole
        leaf unless ``device`` is one."""
        return gather_tree(per_rank, self.specs, self.mesh, device)

    def whole_like(self, rank_tree):
        """A host tree of the whole leaves one rank's ``rank_tree``
        holds shards of: their shapes and dtypes, no storage."""
        def one(names, leaf):
            shape = tuple(n * split_count(e, self.mesh) for n, e in
                          zip(leaf.shape, _lookup(self.specs, names)))
            return torch.empty((), dtype=leaf.dtype).expand(shape)
        return _map(rank_tree, one)


def _lookup(tree, names):
    for n in names:
        tree = tree[int(n)] if isinstance(tree, list) else tree[n]
    return tree


def _init_kind(names) -> str:
    """How :func:`repro_torch.models.model.init_params` fills the leaf
    at ``names``: a norm's weight (ones) or bias (zeros), a projection
    or gate bias (zeros), Mamba2's ``D`` (ones), ``A_log`` (the log of
    1..16 over the heads) and xLSTM's ``f_bias`` (3), an embedding or
    head (N(0, 0.02)), or a dense weight (N(0, 1 / fan_in), fan_in its
    second-last dim)."""
    name = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    if parent.startswith("ln") or parent.endswith("norm"):
        return "ones" if name == "w" else "zeros"
    if name in ("bq", "bk", "bv", "dt_bias", "bias"):
        return "zeros"
    if name == "D":
        return "ones"
    if name in ("A_log", "f_bias"):
        return name
    if name in _EMBED:
        return "embed"
    return "dense"


def init_params_sharded(cfg, mesh, *, seed: int = 0, specs=None) -> list:
    """Per-rank trees of random params, each leaf made on its rank's
    device at its shard's shape from a generator seeded per (leaf,
    shard) — ranks holding the same shard hold the same values, and a
    rank holding a whole leaf shares it with the other ranks of its
    device. The values are :func:`~repro_torch.models.model.init_params`'
    distributions, not its draws; the whole tree is never made. The
    placement is ``specs`` (a spec tree of the whole params: to train,
    :func:`train_specs`' — the optimizer state then comes from
    ``AdamW.init`` of each rank's tree, zeros of its shards), by default
    :func:`serve_specs`'."""
    meta = MD.init_params(cfg, device="meta")
    if specs is None:
        specs = serve_specs(meta, mesh)
    made: dict = {}

    def one_rank(r):
        coords, dev = mesh.coords(r), mesh.devices[r]

        def one(names, leaf):
            spec = _lookup(specs, names)
            shape = local_shape(tuple(leaf.shape), spec, mesh)
            key = (str(dev), "/".join(names), shard_key(spec, mesh, coords))
            if key in made:
                return made[key]
            kind = _init_kind(names)
            if kind in ("ones", "zeros"):
                t = (torch.ones if kind == "ones" else torch.zeros)(
                    shape, dtype=leaf.dtype, device=dev)
            elif kind == "f_bias":
                t = torch.full(shape, 3.0, dtype=leaf.dtype, device=dev)
            elif kind == "A_log":   # whole: a vector of one layer's heads
                t = torch.log(torch.linspace(
                    1.0, 16.0, shape[-1], dtype=torch.float32)).to(
                        dev, leaf.dtype).expand(shape).contiguous()
            else:
                h = zlib.crc32(f"{seed}/{key[1]}/{key[2]}".encode())
                gen = torch.Generator(device=dev).manual_seed(h)
                scale = (0.02 if kind == "embed"
                         else 1.0 / max(1, leaf.shape[-2]) ** 0.5)
                t = L._fill_normal(gen, shape, leaf.dtype, dev, scale)
            made[key] = t
            return t

        return _map(meta, one)

    return [one_rank(r) for r in range(mesh.size)]
