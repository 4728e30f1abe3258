"""Op-stream tracer over ``meta`` tensors — the measurement substrate of
the cost model.

Counterpart of ``repro/core/trace.py``, which walks the jaxpr of a
closure traced on ``ShapeDtypeStruct``s. Here the closure runs on
``meta`` tensors (shape and dtype, no storage, no arithmetic) under a
``TorchDispatchMode`` that sees every aten op the model issues:

- ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` become a GEMM record, or a
  GEMV one where a product has one row (2 x MACs FLOPs; the weight
  operand found by identity: a params leaf, a view whose ``_base`` is
  one, or a copy or cast of one — ``einsum`` and ``linear`` reach aten
  as reshaped, transposed views, so rank tells nothing);
- pointwise ops (``torch.Tag.pointwise``) one op per output element,
  reductions one per input element;
- gathers (``index``, ``gather``, ``embedding``, ...) charge only the
  gathered rows, scatters (``index_put_``, ...) only the update slice,
  ``cat`` and the other data movers every operand;
- views, ``_to_copy``, ``copy_``, comparisons and tensor creation are
  cheap, as ``convert_element_type`` / ``copy`` / ``broadcast_in_dim``
  are in the reference;
- a hand-written kernel (:mod:`repro_torch.kernels.ops`) runs nothing
  on meta operands and records one ``kind="kernel"`` record of its own
  ``cost()``: what the kernel must move and compute;
- anything else becomes ``"other"``, carrying its bytes (the lint
  script, ``scripts/torch_lint_prims.py``, fails on a heavy one).

torch computes most ops' meta outputs in Python, so a functional op
met again with the same input metadata takes its outputs' shapes,
strides and dtypes from a memo (``_run_meta``): a model repeats its
layers, and a trace costs a third of running every op.

The model's loops are Python loops, recorded once per iteration, so no
cost is ever a guess: ``approx_ops`` stays 0 and
:class:`TraceUndercountWarning` is never raised here; both are kept for
the reference's interface. ``trace_linear`` traces a closure at two
cache lengths and fits per-op linear models ``cost(L) = a + b*L``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops as K

# aten op classification (by overload packet name) ------------------------

MATMUL_OPS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot"}
CONV_OPS = {"convolution"}
# not tagged pointwise, but one op per output element all the same
ELEMENTWISE_OPS = {"tril", "triu", "log_sigmoid_forward"}
REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
              "argmin", "prod", "cumsum", "cumprod", "cummax", "logsumexp",
              "_softmax", "_log_softmax", "var", "var_mean", "std", "norm",
              "linalg_vector_norm", "all", "any", "native_layer_norm"}
# read only the gathered rows, not the whole table
GATHER_OPS = {"index", "index_select", "gather", "embedding", "take",
              "sort", "topk"}
# write only the update slice, not the whole base buffer
SCATTER_OPS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
               "index_add", "index_add_", "index_copy", "index_copy_",
               "slice_scatter", "select_scatter"}
DATA_OPS = GATHER_OPS | SCATTER_OPS | {
    "cat", "stack", "constant_pad_nd", "roll", "flip", "repeat",
    "repeat_interleave"}
# comparisons, casts, copies, views and tensor creation: no charge
CHEAP_OPS = {
    "eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isinf", "isnan",
    "_to_copy", "clone", "copy_", "copy", "_unsafe_view", "expand",
    "contiguous", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "empty", "empty_like", "new_empty", "empty_strided",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill_",
    "zero_", "arange", "linspace", "scalar_tensor", "resolve_conj",
    "resolve_neg", "bitwise_left_shift", "bitwise_right_shift",
    "__lshift__", "__rshift__"}
# cheap ops whose output carries its input's data: a weight stays a
# weight through them
_CARRY_OPS = {"_to_copy", "clone", "_unsafe_view", "expand", "contiguous",
              "detach", "alias"}


class TraceUndercountWarning(UserWarning):
    """A traced graph holds a construct whose cost is not statically
    known. The reference raises it for a ``while`` loop; the port's
    loops run in Python and are recorded iteration by iteration, so it
    is never raised here."""


@dataclass
class OpRecord:
    """One traced operation."""
    kind: str          # gemm|gemv|conv|elementwise|reduce|data|kernel|other
    prim: str          # the aten op, or the kernel wrapper's name
    flops: float = 0.0       # multiply-accumulate*2 for matmuls
    in_bytes: float = 0.0    # operand bytes
    out_bytes: float = 0.0
    weight_bytes: float = 0.0  # bytes of the weight operand
    rows: int = 0            # GEMM row count (tokens) — GEMV when <= 1
    count: float = 1.0       # multiplier applied (always 1: no trip
                             # counts, every iteration is its own record)
    batch_dims: int = 0      # bmm batch dims
    kernel: str = ""         # kernel name (kind == "kernel")
    approx: str = ""         # non-empty: cost is a declared guess (never)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree) -> list:
    """Every tensor of a tree of lists, tuples and dicts: an aten op's
    arguments or results, or the params."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if not isinstance(tree, (list, tuple, dict)):
        return []
    out = []
    for x in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _rows_of(name: str, outs) -> int:
    """A kernel record's query rows: S of an attention's (B, S, Hq, Dh)
    out, B of K6's (B, N), 0 for a norm."""
    out = outs[-1]
    if name.endswith("attention"):
        return int(out.shape[1])
    return int(out.shape[0]) if name == "quant_gemv" else 0


# Output metadata of functional aten ops on meta tensors, by the ops'
# input metadata and arguments. torch computes most meta outputs in
# Python (a pointwise op takes ≈ 0.2 ms); a model repeats the same op
# on the same shapes in every layer, so a repeat is a lookup and a fresh
# empty tensor. Only pure functions of the metadata are kept: no
# in-place op, no view or alias, no host tensor, tensor results only.
_META_OUTS: dict = {}
_META_OUTS_MAX = 200_000
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _meta_key(x):
    """The metadata of an argument tree, hashable; None when an argument
    is not a meta tensor or a plain value."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            return None
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        parts = tuple(_meta_key(v) for v in x)
        return None if any(p is None and v is not None
                           for p, v in zip(parts, x)) else (type(x), parts)
    if isinstance(x, dict):
        return _meta_key(tuple(sorted(x.items())))
    return (type(x), x) if isinstance(x, _HASHABLE) else None


@functools.lru_cache(maxsize=None)
def _memoizable(func) -> bool:
    schema = func._schema
    return (not schema.is_mutable and not getattr(func, "is_view", False)
            and bool(schema.returns)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns))


def _bincount(ids, weights=None, minlength=0):
    """``bincount``'s meta output, which torch does not define (its
    length depends on the values): a count over ids below
    ``minlength`` — an MoE's per-expert slot counts."""
    dt = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dt, device="meta")


def _run_meta(func, args, kwargs):
    """``func(*args, **kwargs)``, its meta outputs from the memo where
    the same op met the same metadata before."""
    if func is torch.ops.aten.bincount.default and args[0].is_meta:
        return _bincount(*args, **kwargs)
    if not _memoizable(func):
        return func(*args, **kwargs)
    key = _meta_key((args, kwargs))
    if key is None:
        return func(*args, **kwargs)
    key = (func, key)
    specs = _META_OUTS.get(key)
    if specs is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        if all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
            if len(_META_OUTS) >= _META_OUTS_MAX:
                _META_OUTS.clear()
            _META_OUTS[key] = (isinstance(out, tuple), tuple(
                (tuple(t.shape), t.stride(), t.dtype) for t in outs))
        return out
    many, specs = specs
    outs = tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                 for sh, st, dt in specs)
    return outs if many else outs[0]


class _Recorder(TorchDispatchMode):
    """Records every aten op on meta tensors into ``out``; ``weights``
    maps id -> (tensor, origin itemsize) of the params leaves and of the
    casts, copies and views derived from them during the trace."""

    def __init__(self, out: list, weights: dict):
        super().__init__()
        self.out = out
        self.weights = weights

    # -- weights -------------------------------------------------------
    def _weight_itemsize(self, t) -> int:
        if not isinstance(t, torch.Tensor):
            return 0
        hit = self.weights.get(id(t))
        if hit is None and t._base is not None:
            hit = self.weights.get(id(t._base))
        return hit[1] if hit is not None and (hit[0] is t or hit[0] is
                                              t._base) else 0

    def _carry(self, args, out) -> None:
        src = next((a for a in args if isinstance(a, torch.Tensor)), None)
        size = self._weight_itemsize(src)
        if size:
            for t in _tensors(out):
                self.weights[id(t)] = (t, size)

    # -- records -------------------------------------------------------
    def _matmul(self, name, args, out) -> OpRecord:
        if name in ("addmm", "baddbmm"):
            a, b = args[1], args[2]
        else:
            a, b = args[0], args[1]
        if name == "dot":
            batch, m, k, n = 1, 1, a.shape[0], 1
        elif name == "mv":
            batch, (m, k), n = 1, a.shape, 1
        elif name in ("bmm", "baddbmm"):
            (batch, m, k), n = a.shape, b.shape[2]
        else:
            batch, (m, k), n = 1, a.shape, b.shape[1]
        weight = 0.0
        in_b = 0.0
        for t in (a, b):
            size = self._weight_itemsize(t)
            nb = float(t.numel() * size) if size else _nbytes(t)
            if size:
                weight = max(weight, nb)
            in_b += nb
        if name in ("addmm", "baddbmm"):
            in_b += _nbytes(args[0])
        return OpRecord("gemv" if m == 1 else "gemm", name,
                        2.0 * batch * m * n * k, in_b,
                        sum(_nbytes(t) for t in _tensors(out)), weight,
                        rows=m * batch,
                        batch_dims=1 if name in ("bmm", "baddbmm") else 0)

    def _classify(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if not any(t.is_meta for t in ins + outs):
            return None        # host scalar arithmetic, not device work
        if name in MATMUL_OPS:
            return self._matmul(name, args, out)
        if name in CHEAP_OPS or getattr(func, "is_view", False):
            if name in _CARRY_OPS or getattr(func, "is_view", False):
                self._carry(args, out)
            return None
        in_sizes = [_nbytes(t) for t in ins]
        out_b = sum(_nbytes(t) for t in outs)
        if name in CONV_OPS:
            w = args[1]
            cout = w.shape[0]
            return OpRecord("conv", name,
                            2.0 * outs[0].numel() * max(1, w.numel() // cout),
                            sum(in_sizes), out_b, _nbytes(w))
        if torch.Tag.pointwise in func.tags or name in ELEMENTWISE_OPS:
            return OpRecord("elementwise", name,
                            float(sum(t.numel() for t in outs)),
                            sum(in_sizes), out_b)
        if name in REDUCE_OPS:
            return OpRecord("reduce", name,
                            float(sum(t.numel() for t in ins)),
                            sum(in_sizes), out_b)
        if name in DATA_OPS:
            in_b = sum(in_sizes)
            if name in GATHER_OPS:
                in_b -= max(in_sizes, default=0.0)
            elif name in SCATTER_OPS:
                in_b -= max(in_sizes, default=0.0)
                out_b = in_b
            return OpRecord("data", name, 0.0, in_b, out_b)
        # unknown op: bytes, no flops — the lint gate fails when one of
        # these carries real traffic
        return OpRecord("other", name, 0.0, sum(in_sizes), out_b)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _run_meta(func, args, kwargs)
        rec = self._classify(func, args, kwargs, out)
        if rec is not None:
            self.out.append(rec)
        return out

    def kernel(self, name, flops, nbytes, outs) -> None:
        """The meta sink of :mod:`repro_torch.kernels.ops`."""
        out_b = sum(_nbytes(t) for t in outs)
        self.out.append(OpRecord("kernel", name, float(flops),
                                 float(nbytes) - out_b, out_b,
                                 rows=_rows_of(name, outs), kernel=name))


def to_meta(tree, memo: dict | None = None):
    """``tree`` with every tensor, and every shape-and-dtype spec (the
    engine's ``TensorSpec``), as a meta tensor of its shape and dtype;
    other leaves as they are. ``memo`` (id -> meta tensor) maps one
    object to one meta tensor throughout."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: to_meta(v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v, memo) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_meta:
        return tree
    if isinstance(tree, torch.Tensor) or (hasattr(tree, "shape")
                                          and hasattr(tree, "dtype")):
        if id(tree) not in memo:
            memo[id(tree)] = (torch.empty(tuple(tree.shape),
                                          dtype=tree.dtype, device="meta"),
                              tree)
        return memo[id(tree)][0]
    return tree


def trace_ops(fn, *operands, weights=None, grad: bool = False) -> list:
    """Run ``fn(*operands)`` on meta tensors and return its op stream.

    Tensors and shape specs in ``operands`` become meta tensors (nothing
    is allocated, nothing computed); ``weights`` — a tree of the same
    objects, typically the params — names the tensors whose bytes a
    product counts as ``weight_bytes``. ``grad``: run with grad mode on
    (a train step's backward: autograd on meta runs in the calling
    thread, so the recorder sees its ops too); off by default."""
    memo: dict = {}
    metas = to_meta(operands, memo)
    wmap = {}
    for w in _tensors(to_meta(weights, memo)):
        wmap[id(w)] = (w, w.element_size())
    out: list = []
    rec = _Recorder(out, wmap)
    prev = K._meta_sink
    K.set_meta_sink(rec.kernel)
    try:
        with torch.set_grad_enabled(grad), rec:
            fn(*metas)
    finally:
        K.set_meta_sink(prev)
    return out


@dataclass
class Totals:
    flops: float = 0.0
    matmul_flops: float = 0.0
    vector_ops: float = 0.0
    bytes: float = 0.0
    weight_bytes: float = 0.0
    gemm_flops: float = 0.0
    gemv_flops: float = 0.0
    kernel_flops: float = 0.0  # share of matmul_flops inside kernels
    approx_ops: int = 0        # records carrying a declared approximation
                               # (always 0: every loop is traced)


def totals(ops) -> Totals:
    t = Totals()
    for o in ops:
        t.flops += o.flops
        t.bytes += o.in_bytes + o.out_bytes
        t.weight_bytes += o.weight_bytes
        if o.approx:
            t.approx_ops += 1
        if o.kind in ("gemm", "gemv", "conv"):
            t.matmul_flops += o.flops
            if o.kind == "gemv":
                t.gemv_flops += o.flops
            else:
                t.gemm_flops += o.flops
        elif o.kind == "kernel":
            # hand-written kernels are matmul-class compute; the
            # GEMM/GEMV split by their query rows (decode kernels have
            # one a row and stay GEMV-like)
            t.matmul_flops += o.flops
            t.kernel_flops += o.flops
            if o.rows > 1:
                t.gemm_flops += o.flops
            else:
                t.gemv_flops += o.flops
        else:
            t.vector_ops += o.flops
    return t


# ---------------------------------------------------------------------------
# two-point linear tracing (KV growth)
# ---------------------------------------------------------------------------

@dataclass
class LinearOp:
    """cost(L) = const + slope * L, per field."""
    kind: str
    prim: str
    flops: tuple = (0.0, 0.0)
    in_bytes: tuple = (0.0, 0.0)
    out_bytes: tuple = (0.0, 0.0)
    weight_bytes: tuple = (0.0, 0.0)
    batch_dims: int = 0
    rows: int = 0
    kernel: str = ""
    approx: str = ""

    def at(self, L: float) -> OpRecord:
        ev = lambda c: c[0] + c[1] * L  # noqa: E731
        return OpRecord(self.kind, self.prim, ev(self.flops),
                        ev(self.in_bytes), ev(self.out_bytes),
                        ev(self.weight_bytes), batch_dims=self.batch_dims,
                        rows=self.rows, kernel=self.kernel,
                        approx=self.approx)


def trace_linear(fn_of_len, L1: int, L2: int) -> list:
    """``fn_of_len(L)`` must return (fn, operands) or (fn, operands,
    weights) for cache length L with an identical code path; ops are
    matched positionally and fit linearly."""
    f1, s1, *w1 = fn_of_len(L1)
    f2, s2, *w2 = fn_of_len(L2)
    ops1 = trace_ops(f1, *s1, weights=w1[0] if w1 else None)
    ops2 = trace_ops(f2, *s2, weights=w2[0] if w2 else None)
    if len(ops1) != len(ops2):
        raise ValueError(
            f"op streams differ ({len(ops1)} vs {len(ops2)}); cache length "
            "must not change the traced code path")
    out = []
    dL = float(L2 - L1)
    for a, b in zip(ops1, ops2):
        if a.prim != b.prim or a.kernel != b.kernel:
            raise ValueError(
                f"op mismatch: {a.prim}{a.kernel and f'[{a.kernel}]'} vs "
                f"{b.prim}{b.kernel and f'[{b.kernel}]'}")

        def fit(x, y):
            slope = (y - x) / dL
            return (x - slope * L1, slope)

        out.append(LinearOp(a.kind, a.prim,
                            fit(a.flops, b.flops),
                            fit(a.in_bytes, b.in_bytes),
                            fit(a.out_bytes, b.out_bytes),
                            fit(a.weight_bytes, b.weight_bytes),
                            batch_dims=a.batch_dims, rows=a.rows,
                            kernel=a.kernel, approx=a.approx))
    return out
