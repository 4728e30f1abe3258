"""Multi-pod dry-run: every (arch x shape x mesh) cell placed and run on
``meta`` tensors over a mesh of placeholder devices.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell's step on 256 or 512 placeholder host devices and reads XLA's
``memory_analysis`` (bytes per device), ``cost_analysis`` and the HLO's
collectives. The port has no compiler; each cell runs its step as the
card would, on tensors that carry a shape and a dtype and no storage:

- **operands**: the port's builders at the cell's shapes — the params
  (``MD.init_params(cfg, device="meta")``), the batch
  (``MD.batch_spec``), the decode cache (``MD.cache_spec``, or the
  engine's paged pools), the AdamW state (``AdamW.init`` of meta
  params);
- **placements**: the port's rules — serving the engine's
  (``sharding.serve_specs``, the mesh caches of
  :mod:`repro_torch.serving.kv_cache`), training :class:`~repro_torch.
  launch.steps.MeshTrain`'s (``train_specs``, the moments as their
  params), the batch ``batch_specs``;
- **argument bytes per device**: each rank's local shapes summed, the
  fullest rank reported; the donated operands (params and optimizer
  state in training, the cache in decode) count as alias too;
- **the global trace** (``rec["trace"]``): the cell's step
  (:func:`~repro_torch.launch.steps.build_train_step`,
  ``build_prefill_step``, ``build_serve_step``) through
  :func:`repro_torch.core.trace.trace_ops` — a train step with grad
  mode on, so its backward is counted, a kernel priced by its
  ``cost()``;
- **the rank run**, the counterpart of ``compile()``: every rank's step
  on its own shards over the production mesh's shape on placeholder
  devices (``make_production_mesh(devices=["meta"] * n)``) — training
  through ``MeshTrain``, serving in the engine's dispatch context (its
  cache layout, decode plan and gathers over ``data``). It
  proves the placement runs, and it yields the per-device ``flops`` and
  ``bytes_accessed`` (the rank's op stream), ``temp_size_in_bytes``
  (the peak of the storage the rank's ops make and hold, each block
  rounded to the caching allocator's 512 bytes) and the collectives
  (:mod:`repro_torch.roofline.collective_bytes`).

The ranks of a placement hold shards of equal shapes, so one
representative rank runs and every collective hands it its own tensor
as each peer's part. ``Cell(every_rank=True)`` runs every rank, one
thread each, meeting at every collective (≈ 0.24 s a gather round at
256 ranks): the tests hold the two equal, record for record, on small
meshes, and a comparison of each rank's collectives takes it.

Serving takes (data, model) meshes: on the multi-pod mesh a serving
cell runs over (pod x data, model), the same ranks in the same order —
``("pod", "data")`` flattened pod-major is how the reference's rules
split a dim over both.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-done]

``--all`` drives one subprocess per cell and appends JSONL records to
``results/torch_dryrun.jsonl``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import threading
import time
import weakref

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core import trace as T
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh, PerRank
from repro_torch.kernels import ops as K
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_mesh
from repro_torch.models import model as MD
from repro_torch.optim import AdamW, OptConfig
from repro_torch.roofline import collective_bytes as CB

DEFAULT_OUT = os.path.join("results", "torch_dryrun.jsonl")
ALLOC_QUANTUM = 512   # the CUDA caching allocator rounds every block up


def peak_memory_bytes(mem) -> int:
    """Version-tolerant peak-memory read of a record's ``memory`` dict
    (or an object with those attributes): ``peak_memory_in_bytes``, or
    the older ``peak_memory_bytes``, else argument + output + temp — the
    reference's reader, kept where its analysis imports it."""
    def get(k):
        v = mem.get(k) if isinstance(mem, dict) else getattr(mem, k, None)
        return None if v is None else int(v)

    for k in ("peak_memory_in_bytes", "peak_memory_bytes"):
        v = get(k)
        if v is not None and v > 0:
            return v
    return sum(get(k) or 0 for k in ("argument_size_in_bytes",
                                     "output_size_in_bytes",
                                     "temp_size_in_bytes"))


def _block(n: int) -> int:
    return -(-int(n) // ALLOC_QUANTUM) * ALLOC_QUANTUM


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors, each rounded
    up to the allocator's quantum: what holding the tree costs a
    device."""
    seen, n = set(), 0
    for t in T._tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += _block(st.nbytes())
    return n


# ---------------------------------------------------------------------------
# a rank's meter: its op stream and the storage its ops hold
# ---------------------------------------------------------------------------

class Meter(T._Recorder):
    """:mod:`repro_torch.core.trace`'s recorder, which also keeps the
    bytes of every storage the ops make while a tensor holds it — each
    storage counted once, freed by a finalizer when its last tensor
    goes (autograd's saved tensors included) — and their peak. The
    storages of ``held`` (the arguments) are not counted."""

    def __init__(self, weights: dict, held=()):
        super().__init__([], weights)
        self._held = list(held)               # keeps their ids stable
        self._held_ids = {id(s) for s in self._held}
        self._live: dict[int, int] = {}
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in T._tensors(out):
            if t.is_meta:
                self._track(t.untyped_storage())
        return out

    def _track(self, st) -> None:
        key = id(st)
        if key in self._live or key in self._held_ids:
            return
        n = _block(st.nbytes())
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)


_TLS = threading.local()


def _thread_sink(name, flops, nbytes, outs) -> None:
    """The kernels' meta sink during a rank run: the calling rank's
    meter (each rank runs on its own thread)."""
    _TLS.meter.kernel(name, flops, nbytes, outs)


@contextlib.contextmanager
def metering(meter: Meter):
    """``meter`` armed on the calling thread: its dispatch mode and its
    kernel records."""
    prev = getattr(_TLS, "meter", None)
    _TLS.meter = meter
    try:
        with meter:
            yield meter
    finally:
        _TLS.meter = prev


class RankMesh(DeviceMesh):
    """A :class:`DeviceMesh` whose :meth:`run` meters each rank that
    runs (:attr:`meters`, kept across runs) with the argument storages
    :attr:`held` names for it. ``every_rank=False``: only one
    representative rank runs — the first of those asked for — and each
    collective hands it its own tensor as every peer's part (the ranks'
    shards have equal shapes); the call's results are that rank's, for
    every rank."""

    def __init__(self, shape, devices, *, every_rank: bool = True,
                 metered: bool = True):
        super().__init__(shape, devices)
        self.every_rank = every_rank
        self.metered = metered
        self.meters: dict[int, Meter] = {}
        self.held: dict[int, list] = {}
        self.weights: dict[int, dict] = {}

    def meter(self, rank: int) -> Meter:
        if rank not in self.meters:
            self.meters[rank] = Meter(self.weights.get(rank, {}),
                                      self.held.get(rank, ()))
        return self.meters[rank]

    def run(self, fn, ranks=None) -> list:
        if not self.metered:
            return super().run(fn, ranks)
        ranks = tuple(range(self.size)) if ranks is None else tuple(ranks)

        def one(r):
            with metering(self.meter(r)):
                return fn(r)

        if self.every_rank:
            return super().run(one, ranks)
        rep = ranks[0]
        out = super().run(one, (rep,))[rep]
        return [out if r in ranks else None for r in range(self.size)]

    def _meet(self, x, axis, what, rank, call):
        if self.every_rank:
            return super()._meet(x, axis, what, rank, call)
        rank = self.rank() if rank is None else rank
        call = self.current_call() if call is None else call
        grp = self.group(rank, axis)
        if len(grp) > 1:   # posted as with every rank running
            self._post(x, grp, rank, call)
        return grp, [x] * len(grp), self.devices[rank]


# ---------------------------------------------------------------------------
# operands and placements
# ---------------------------------------------------------------------------

def _local(tree, specs, mesh):
    """A meta tree of ``tree``'s leaves at their local shapes under
    ``specs`` (a rank's shards; every rank's have these shapes)."""
    return SH._map(tree, lambda names, leaf: torch.empty(
        SH.local_shape(tuple(leaf.shape), SH._lookup(specs, names), mesh),
        dtype=leaf.dtype, device="meta"))


def serve_mesh_shape(shape) -> tuple:
    """The (data, model) mesh a serving cell runs on: a (pod, data,
    model) mesh's pod and data flattened pod-major."""
    shape = tuple(int(x) for x in shape)
    return shape if len(shape) == 2 else (shape[0] * shape[1], shape[2])


def optimizer(cfg) -> AdamW:
    return AdamW(OptConfig(moment_dtype=cfg.optimizer_state_dtype))


class Cell:
    """One dry-run cell: ``cfg``'s step of ``kind`` ("train", "prefill"
    or "decode") at ``batch`` x ``seq_len`` over a mesh of ``shape`` on
    ``devices`` (placeholder ``meta`` devices by default). ``kv_cache``:
    a decode cell's cache — ``"contiguous"`` (the reference's
    ``init_cache``) or the engine's ``"paged"`` pools (the engine's
    default blocks, ``max_batch * seq_len / block_size`` of them).
    ``devices`` other than placeholders (cards, the CPU) make a cell
    whose step runs for real: :meth:`place` its operands, then
    :meth:`step_on` them — every rank, unmetered."""

    def __init__(self, cfg, kind, batch, seq_len, shape, *, devices=None,
                 every_rank=False, kv_cache="contiguous"):
        if kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown cell kind {kind!r}")
        self.cfg, self.kind = cfg, kind
        self.batch, self.seq_len = int(batch), int(seq_len)
        self.shape = tuple(int(x) for x in shape)
        run_shape = self.shape if kind == "train" else serve_mesh_shape(
            self.shape)
        n = math.prod(run_shape)
        devices = ["meta"] * n if devices is None else list(devices)
        real = any(torch.device(d).type != "meta" for d in devices)
        self.mesh = RankMesh(run_shape, devices,
                             every_rank=every_rank or real, metered=not real)
        self.kv_cache = kv_cache
        self._args: dict = {}
        self.params = MD.init_params(cfg, device="meta")
        if kind == "train":
            self.opt = optimizer(cfg)
            self.mt = ST.MeshTrain(cfg, self.mesh)
            self.mesh.__dict__.setdefault("_train_placements", {})[cfg] = \
                self.mt
            self.param_specs = self.mt.specs
            self.data = MD.batch_spec(cfg, self.batch, self.seq_len, "train")
        else:
            self.param_specs = SH.serve_specs(self.params, self.mesh)
            self.data = MD.batch_spec(
                cfg, self.batch, self.seq_len if kind == "prefill" else 1,
                kind)
            if kind == "decode":
                self._make_cache()
        self.batch_specs = SH.batch_specs(self.data, self.mesh)

    def _make_cache(self) -> None:
        """The engine's mesh cache of ``batch`` slots at ``seq_len``
        positions, made on the mesh's (meta) devices."""
        from repro_torch.serving.engine import EngineConfig
        from repro_torch.serving.kv_cache import make_kv_cache
        ecfg = EngineConfig(max_batch=self.batch, max_seq_len=self.seq_len,
                            kv_cache=self.kv_cache, mesh=self.mesh.shape)
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the paged fallback's
            self.kv = make_kv_cache(self.cfg, ecfg, self.mesh.devices[0],
                                    mesh=self.mesh)

    # -- what each rank holds ----------------------------------------------
    def rank_cache(self, r: int) -> dict:
        """Rank ``r``'s decode cache dict (its shards, and the position
        counter: the cache full up to its last position)."""
        kv = self.kv
        if hasattr(kv, "_shards"):
            return dict(kv._shards[r])
        n = kv._rows_per_group
        w = kv.table.shape[1]
        dev = self.mesh.devices[r]
        return {"k": kv._pools_k[r], "v": kv._pools_v[r],
                "block_tab": torch.zeros((n, w), dtype=torch.int32,
                                         device=dev),
                "len": torch.zeros((), dtype=torch.int32, device=dev)}

    def rank_batch(self, r: int) -> dict:
        """Rank ``r``'s rows of the batch (its data replica's; every row
        where the batch does not divide)."""
        if self.kind == "decode" and not self.kv.split_rows:
            return dict(self.data)
        return _local(self.data, self.batch_specs, self.mesh)

    def rank_arguments(self, r: int) -> dict:
        """Rank ``r``'s operands: {"params", "opt_state" | "batch",
        "cache"} as the step takes them."""
        p = _local(self.params, self.param_specs, self.mesh)
        if self.kind == "train":
            return {"params": p, "opt_state": self.opt.init(p),
                    "batch": self.rank_batch(r)}
        out = {"params": p, "batch": self.rank_batch(r)}
        if self.kind == "decode":
            out["cache"] = self.rank_cache(r)
        return out

    def place(self, seed: int = 0) -> dict:
        """Per rank, its operands on its device, as the card holds them:
        random params (``init_params_sharded`` under the cell's
        placement), zero AdamW moments, random token ids and the
        engine's zero cache with every position up to the last written
        (decode attends the whole capacity)."""
        mesh = self.mesh
        per_rank = SH.init_params_sharded(self.cfg, mesh, seed=seed,
                                          specs=self.param_specs)
        gen = torch.Generator().manual_seed(seed)

        def fill(t):
            if t.dtype.is_floating_point:
                return torch.randn(t.shape, generator=gen).to(t.dtype)
            return torch.randint(0, self.cfg.vocab_size, t.shape,
                                 generator=gen, dtype=t.dtype)

        if self.kind == "train":
            self.host_batch = {k: fill(t) for k, t in self.data.items()}
            mb = ST.microbatches(self.cfg, self.batch, self.mt.fsdp)
            rows = ST.mesh_microbatches(self.host_batch, mb, self.mt.fsdp)
        out = {}
        for r in range(mesh.size):
            dev = mesh.devices[r]
            if self.kind == "train":
                parts = rows[self.mt.fsdp_index(r)]
                batch = {k: torch.cat([p[k] for p in parts]).to(dev)
                         for k in self.data}
            else:
                batch = {k: fill(t).to(dev)
                         for k, t in self.rank_batch(r).items()}
            a = {"params": per_rank[r], "batch": batch}
            if self.kind == "train":
                a["opt_state"] = self.opt.init(per_rank[r])
            if self.kind == "decode":
                cache = self.rank_cache(r)
                cache["len"] = torch.full((), self.seq_len - 1,
                                          dtype=torch.int32, device=dev)
                a["cache"] = cache
            out[r] = a
        return out

    def step_on(self, args) -> list:
        """The cell's step on placed operands (:meth:`place`), every
        rank: per rank, its outputs."""
        if self.kind == "train":
            return self._train_run(args)
        return self._serve_run(args)

    def donated(self) -> tuple:
        return {"train": ("params", "opt_state"), "decode": ("cache",),
                "prefill": ()}[self.kind]

    def argument_bytes(self) -> tuple:
        """(argument bytes, donated bytes) of a rank's operands. A rank's
        local shapes do not depend on which rank it is — a spec says how
        many shards a dim has, and every shard is alike — so one rank's
        are every rank's, the fullest's included."""
        args = self._arg_shapes(0)
        return (sum(storage_bytes(v) for v in args.values()),
                sum(storage_bytes(args[k]) for k in self.donated()))

    def _arg_shapes(self, r: int) -> dict:
        if r not in self._args:
            self._args[r] = self.rank_arguments(r)
        return self._args[r]

    # -- the steps -----------------------------------------------------------
    def step(self):
        """The cell's step of the whole model (one device)."""
        if self.kind == "train":
            return ST.build_train_step(self.cfg, optimizer(self.cfg))
        if self.kind == "prefill":
            return ST.build_prefill_step(self.cfg, capacity=self.seq_len)
        return ST.build_serve_step(self.cfg)

    def global_operands(self) -> tuple:
        if self.kind == "train":
            return (self.params, optimizer(self.cfg).init(self.params),
                    self.data)
        if self.kind == "prefill":
            return (self.params, self.data)
        return (self.params, self.data["tokens"],
                MD.cache_spec(self.cfg, self.batch, self.seq_len))

    def global_trace(self) -> T.Totals:
        ops = T.trace_ops(self.step(), *self.global_operands(),
                          weights=self.params, grad=self.kind == "train")
        return T.totals(ops)

    def rank_run(self):
        """Every rank's step (or the representative rank's) on its
        shards: per rank, the step's outputs."""
        mesh = self.mesh
        ranks = range(mesh.size) if mesh.every_rank else (0,)
        args = {r: self._arg_shapes(r) for r in ranks}
        for r in ranks:
            mesh.held[r] = [t.untyped_storage()
                            for t in T._tensors(args[r])]
            mesh.weights[r] = {id(w): (w, w.element_size())
                               for w in T._tensors(args[r]["params"])}
        prev = K._meta_sink
        K.set_meta_sink(_thread_sink)
        try:
            if self.kind == "train":
                return self._train_run(args)
            return self._serve_run(args)
        finally:
            K.set_meta_sink(prev)

    def _train_run(self, args) -> list:
        mesh = self.mesh
        full = [args.get(r, args[0]) for r in range(mesh.size)]
        step = ST.build_train_step(self.cfg, self.opt)
        # the global batch (placed: the host batch whose rows the ranks
        # hold); the step cuts each rank's rows from it
        data = getattr(self, "host_batch", self.data)
        with H.use_mesh(mesh, train=True):
            p, s, metrics = step(PerRank(a["params"] for a in full),
                                 PerRank(a["opt_state"] for a in full),
                                 data)
        return [(p[r], s[r], metrics) for r in range(mesh.size)]

    def _serve_run(self, args) -> list:
        from repro_torch.serving.engine import shard_cfg
        mesh, cfg = self.mesh, self.cfg
        gather = (self.param_specs if SH.splits_over_data(self.param_specs,
                                                          mesh) else None)
        if self.kind == "decode":
            layout = self.kv.layout
            pos_axes = self.kv.pos_axes or ("model",)
            fn = ST.build_serve_step(shard_cfg(cfg, layout, mesh.shape[1]))
        else:
            layout, pos_axes = "heads", ("model",)
            if SH.attention_whole(cfg, mesh):
                layout = "replicated"
            fn = ST.build_prefill_step(shard_cfg(cfg, layout, mesh.shape[1]),
                                       capacity=self.seq_len)
        plan = (self.batch, cfg.n_kv_heads)

        def one(r):
            a = args[r] if r in args else args[0]
            with H.use_mesh(mesh, attn=layout, plan=plan, specs=gather,
                            pos_axes=pos_axes):
                if self.kind == "decode":
                    return fn(a["params"], a["batch"]["tokens"], a["cache"])
                return fn(a["params"], a["batch"])

        return mesh.run(one)

    def run(self, *, trace: bool = True) -> dict:
        """The record's measurements: memory, per-device flops and bytes,
        collectives, and (``trace``) the global trace."""
        rec = {}
        t0 = time.time()
        arg, alias = self.argument_bytes()
        with CB.recording(self.mesh) as coll:
            outs = self.rank_run()
        ranks = sorted(self.mesh.meters)
        temp = {r: self.mesh.meters[r].peak for r in ranks}
        out_b = {r: storage_bytes(outs[r]) for r in ranks}
        rep = max(ranks, key=lambda r: temp[r])
        mem = {"argument_size_in_bytes": arg,
               "output_size_in_bytes": max(out_b.values()),
               "temp_size_in_bytes": temp[rep],
               "alias_size_in_bytes": alias}
        mem["peak_memory_in_bytes"] = (mem["argument_size_in_bytes"]
                                       + mem["temp_size_in_bytes"])
        rec["memory"] = mem
        busiest = max(ranks, key=lambda r: T.totals(
            self.mesh.meters[r].out).flops)
        tt = T.totals(self.mesh.meters[busiest].out)
        rec["flops"] = tt.flops
        rec["bytes_accessed"] = tt.bytes
        rec["collectives"] = coll.report()
        rec["rank_s"] = round(time.time() - t0, 2)
        self.collectives = coll
        if trace:
            t1 = time.time()
            g = self.global_trace()
            rec["trace"] = {"flops": g.flops, "matmul_flops": g.matmul_flops,
                            "vector_ops": g.vector_ops, "bytes": g.bytes,
                            "weight_bytes": g.weight_bytes}
            rec["trace_s"] = round(time.time() - t1, 2)
        return rec

    def close(self) -> None:
        self.mesh.close()


def production_shape(mesh_kind: str) -> tuple:
    if mesh_kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh {mesh_kind!r}: single or multi")
    return MULTI_POD if mesh_kind == "multi" else SINGLE_POD


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             collect_hlo: bool = True, overrides: dict | None = None,
             shard_flags: dict | None = None) -> dict:
    """The reference's ``run_cell``: one (arch, shape, mesh) record.
    ``collect_hlo=False`` skips the global trace (the collectives come
    from the rank run either way)."""
    cfg = registry.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    saved = {k: getattr(SH, k) for k in ("MOE_EXPERT_SHARD",
                                         *(shard_flags or {}))}
    if cfg.moe_expert_shard:
        SH.MOE_EXPERT_SHARD = cfg.moe_expert_shard
    for k, v in (shard_flags or {}).items():
        setattr(SH, k, v)
    try:
        spec = SHAPES[shape_name]
        shape = production_shape(mesh_kind)
        # the production mesh's builder proves the placeholder pod builds
        make_mesh(shape, devices=["meta"] * math.prod(shape)).close()
        cell = Cell(cfg, spec.kind, spec.global_batch, spec.seq_len, shape)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "devices": int(math.prod(shape))}
        rec.update(cell.run(trace=collect_hlo))
        cell.close()
    finally:
        for k, v in saved.items():
            setattr(SH, k, v)
    rec["params"] = int(cfg.param_count())
    rec["active_params"] = int(cfg.active_param_count())
    if overrides:
        rec["overrides"] = overrides
    if shard_flags:
        rec["shard_flags"] = shard_flags
    rec["ok"] = True
    return rec


def _parse_kv(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def _append(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the global trace (rec['trace'])")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (hillclimb variants)")
    ap.add_argument("--shard", action="append", default=[],
                    help="sharding-module flag key=value")
    ap.add_argument("--tag", default=None,
                    help="variant tag recorded in the output record")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        rec = run_cell(args.arch, args.shape, meshes[0],
                       collect_hlo=not args.no_hlo,
                       overrides=_parse_kv(args.set),
                       shard_flags=_parse_kv(args.shard))
        if args.tag:
            rec["tag"] = args.tag
        print(json.dumps(rec, indent=2))
        if args.out:
            _append(args.out, rec)
        return 0

    # --all: one subprocess per cell
    import subprocess

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    cells = registry.cells()
    total = len(cells) * len(meshes)
    i = 0
    failures = []
    for mesh_kind in meshes:
        for arch, shape in cells:
            i += 1
            if (arch, shape, mesh_kind) in done:
                print(f"[{i}/{total}] skip {arch} {shape} {mesh_kind}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out", args.out]
            if args.no_hlo:
                cmd.append("--no-hlo")
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                ok = r.returncode == 0
                err = r.stderr[-2000:] if not ok else ""
            except subprocess.TimeoutExpired:
                ok, err = False, f"timeout after {args.timeout}s"
            dt = time.time() - t0
            print(f"[{i}/{total}] {'ok  ' if ok else 'FAIL'} {arch} "
                  f"{shape} {mesh_kind} ({dt:.0f}s)", flush=True)
            if not ok:
                failures.append((arch, shape, mesh_kind))
                _append(args.out, {"arch": arch, "shape": shape,
                                   "mesh": mesh_kind, "ok": False,
                                   "error": err})
    if failures:
        print(f"{len(failures)} failures: {failures}")
        return 1
    print("all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
