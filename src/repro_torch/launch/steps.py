"""Step builders: the units the launchers drive.

Counterpart of ``repro/launch/steps.py``:

- :func:`build_train_step` — loss and gradients (with fp32 gradient
  accumulation over ``cfg.microbatch`` slices of the batch), the
  optional gradient-compression hook, then the AdamW update. Functional
  as the reference's: it takes params and optimizer state and returns
  new ones; the params passed in need not require grad. Under
  ``hints.use_mesh(mesh, train=True)`` it trains over a (data, model)
  or (pod, data, model) mesh: FSDP over ``("pod", "data")``, Megatron
  tensor parallelism over ``model`` where a sublayer's widths divide it,
  the sublayer whole on every model rank where they do not
  (:class:`MeshTrain`).
- :func:`build_prefill_step` — the prompt's last-token logits and a
  filled cache.
- :func:`build_serve_step` — one decode token against a cache and its
  greedy pick.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.distributed import collectives as C
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import PerRank
from repro_torch.models import model as MD
from repro_torch.optim import AdamW


def microbatches(cfg, batch_size: int, fsdp: int = 1) -> int:
    """Slices of a batch of ``batch_size`` rows: the largest count up to
    ``cfg.microbatch`` that divides it into slices whose rows divide
    ``fsdp`` (the mesh's FSDP extent, ``pod x data``) — the
    reference's ``_clamp_mb``."""
    mb = max(1, min(cfg.microbatch, batch_size))
    while mb > 1 and (batch_size % mb or (batch_size // mb) % fsdp):
        mb -= 1
    return mb


def loss_and_grads(params, cfg, batch, *, attn_impl="chunked"):
    """(loss, gradients in the params' dtypes) of one batch: the leaves
    are differentiated as they stand (detached copies that require
    grad), so the params themselves are left as they were."""
    leaves = [t.detach().requires_grad_() for t in T.leaves(params)]
    loss, _ = MD.loss_fn(T.unflatten(params, leaves), cfg, batch,
                         attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), T.unflatten(params, grads)


def _accumulate(params, cfg, parts, *, attn_impl="chunked"):
    """(loss, gradients) over the microbatches ``parts``: one is
    :func:`loss_and_grads` of it; more are differentiated in turn, their
    gradients added in fp32 (the sum, and the loss, then divided by
    their count after ``reduce``, as the reference's scan)."""
    if len(parts) == 1:
        loss, grads = loss_and_grads(params, cfg, parts[0],
                                     attn_impl=attn_impl)
        return loss, grads, 1
    acc = [torch.zeros_like(p, dtype=torch.float32)
           for p in T.leaves(params)]
    loss = 0.0
    for part in parts:
        li, g = loss_and_grads(params, cfg, part, attn_impl=attn_impl)
        acc = [a + gi.float() for a, gi in zip(acc, T.leaves(g))]
        loss = loss + li
    return loss, T.unflatten(params, acc), len(parts)


def _microbatch(batch, mb: int, i: int) -> dict:
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            for k, v in batch.items()}


def accumulated_grads(params, cfg, batch, *, attn_impl="chunked"):
    """(loss, gradients) of a batch over ``m = microbatches(cfg, B)``
    slices: with m > 1 each slice of B / m rows is differentiated in
    turn, the gradients added in fp32 and the sum and the loss divided
    by m, as the reference's scan does (the gradients are then fp32);
    with m == 1, :func:`loss_and_grads` of the whole batch."""
    mb = microbatches(cfg, batch["tokens"].shape[0])
    loss, grads, n = _accumulate(
        params, cfg, [_microbatch(batch, mb, i) for i in range(mb)],
        attn_impl=attn_impl)
    if n == 1:
        return loss, grads
    return loss / n, T.tree_map(lambda a: a / n, grads)


# ---------------------------------------------------------------------------
# over a (data, model) or (pod, data, model) mesh
# ---------------------------------------------------------------------------

def mesh_microbatches(batch, mb: int, data: int) -> list:
    """``[FSDP rank][microbatch]`` row slices of a global ``batch``, the
    reference's order: the batch cut into ``mb`` microbatches of
    consecutive rows first, then each microbatch's rows into ``data``
    (the FSDP extent) consecutive blocks, one per FSDP rank in pod-major
    order. (The other orders would give an MoE dispatch other tokens,
    and so other drops.)"""
    b = batch["tokens"].shape[0]
    if b % (mb * data):
        raise ValueError(f"a batch of {b} rows does not split into {mb} "
                         f"microbatches over data={data}")
    w = b // (mb * data)
    return [[{k: v[i * data * w + j * w:i * data * w + (j + 1) * w]
              for k, v in batch.items()} for i in range(mb)]
            for j in range(data)]


class MeshTrain:
    """The train placements of ``cfg`` over ``mesh``: the spec trees of
    the params (:func:`~repro_torch.distributed.sharding.train_specs`)
    and of the AdamW state, the sublayers that run whole over ``model``
    (:func:`~repro_torch.distributed.sharding.whole_sublayers`), and the
    config each rank runs (its own query and KV heads where attention
    splits them, else the whole config)."""

    def __init__(self, cfg, mesh):
        SH.check_train_mesh(cfg, mesh)
        self.mesh, self.cfg = mesh, cfg
        self.specs = SH.train_specs(MD.init_params(cfg, device="meta"),
                                    mesh)
        self.state_specs = SH.train_state_specs(self.specs)
        self.whole = SH.whole_sublayers(cfg, mesh)
        self.rank_cfg = SH.train_rank_cfg(cfg, mesh)
        self.fsdp = mesh.axis_size("pod") * mesh.axis_size("data")

    def shard(self, params, opt_state=None):
        """Per-rank trees of whole ``params`` (and ``opt_state``)."""
        p = SH.shard_tree(params, self.specs, self.mesh)
        if opt_state is None:
            return p
        return p, SH.shard_tree(opt_state, self.state_specs, self.mesh)

    def gather(self, per_rank, device="cpu"):
        """The whole params (or gradients) of per-rank trees."""
        return SH.gather_tree(per_rank, self.specs, self.mesh, device)

    def grads(self, params, rank, parts, *, attn_impl="chunked"):
        """On ``rank``'s worker, in its train context: (loss, gradients)
        of its shard ``params`` over its microbatches ``parts``. Leaves
        the placements split over FSDP arrive reduce-scattered from
        their gathers' backward; the others — whole over FSDP — are
        summed over the FSDP group here, once, after the accumulation.
        Over ``model`` nothing is summed: a leaf whole over it has the
        same gradient on every model rank."""
        loss, grads, n = _accumulate(params, self.rank_cfg, parts,
                                     attn_impl=attn_impl)
        comm = C.Comm(self.mesh, rank, self.mesh.current_call())
        sp = SH.spec_leaves(self.specs)
        out = []
        for (_, spec), g in zip(sp, T.leaves(grads)):
            if not any(e is not None and SH.DATA in e for e in spec):
                g = comm.all_reduce(g, C.FSDP)
            out.append(g / n if n > 1 else g)
        return (loss / n if n > 1 else loss), T.unflatten(grads, out)

    def step(self, opt, params, opt_state, parts, rank, *,
             attn_impl="chunked", grad_compression=None):
        """On ``rank``'s worker: :meth:`grads`, then ``grad_compression
        (grads, opt_state)`` on the rank's shards where given
        (:func:`repro_torch.distributed.compression.apply` holds them to
        the whole leaves' blocks), then AdamW on the rank's shard with
        the global norm. Returns (params, opt_state, metrics, gradients),
        the metrics the same bits on every rank."""
        loss, grads = self.grads(params, rank, parts, attn_impl=attn_impl)
        if grad_compression is not None:
            grads, opt_state = grad_compression(grads, opt_state)
        counted = SH.counted_leaves(self.specs, self.mesh,
                                    self.mesh.coords(rank))
        p, s, stats = opt.apply(grads, opt_state, params, counted=counted)
        return p, s, {"loss": loss, **stats}, grads

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank's worker, in its train context."""
        def one(r):
            with H.use_mesh(self.mesh, train=True, specs=self.specs,
                            whole=self.whole):
                return fn(r)
        return self.mesh.run(one)

    def fsdp_index(self, rank: int) -> int:
        """``rank``'s place in its FSDP group (pod-major): which block
        of every microbatch's rows it takes."""
        return self.mesh.group(rank, C.FSDP).index(rank)


def mesh_train(cfg) -> MeshTrain:
    """The :class:`MeshTrain` of ``cfg`` over the mesh armed on the
    calling thread (``hints.use_mesh(mesh, train=True)``), made once a
    mesh (kept on it)."""
    mesh = H.current_mesh()
    made = mesh.__dict__.setdefault("_train_placements", {})
    if cfg not in made:
        made[cfg] = MeshTrain(cfg, mesh)
    return made[cfg]


def mesh_parts(mt: MeshTrain, batch) -> list:
    """Each rank's microbatches of the global ``batch``
    (``microbatches(cfg, B, pod x data)`` of them,
    :func:`mesh_microbatches`' rows), on its device."""
    mb = microbatches(mt.cfg, batch["tokens"].shape[0], mt.fsdp)
    rows = mesh_microbatches(batch, mb, mt.fsdp)
    return [[{k: v.to(mt.mesh.devices[r]) for k, v in part.items()}
             for part in rows[mt.fsdp_index(r)]]
            for r in range(mt.mesh.size)]


def build_train_step(cfg, opt: AdamW, *, attn_impl="chunked",
                     grad_compression=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`accumulated_grads`, then
    ``grad_compression(grads, opt_state) -> (grads, opt_state)`` where
    given (on the mesh, on each rank's shards), then the AdamW update.

    Under ``hints.use_mesh(mesh, train=True)`` the step runs over the
    mesh: ``params`` and ``opt_state`` are per-rank trees placed by
    :class:`MeshTrain` (``shard`` them, or make them with
    ``sharding.init_params_sharded(..., specs=MeshTrain(...).specs)``
    and ``opt.init`` of each), ``batch`` the global batch. Each rank
    accumulates its rows of every microbatch (:func:`mesh_microbatches`)
    in fp32, its gradients are reduced over the FSDP group once, and
    AdamW runs on its shard with the global norm (:meth:`MeshTrain.step`); the
    step returns per-rank trees and the metrics, the same bits on every
    rank (rank 0's)."""
    def train_step(params, opt_state, batch):
        if H.training():
            mt = mesh_train(cfg)
            parts = mesh_parts(mt, batch)
            outs = mt.run(lambda r: mt.step(
                opt, params[r], opt_state[r], parts[r], r,
                attn_impl=attn_impl, grad_compression=grad_compression))
            return (PerRank(o[0] for o in outs),
                    PerRank(o[1] for o in outs), outs[0][2])
        loss, grads = accumulated_grads(params, cfg, batch,
                                        attn_impl=attn_impl)
        if grad_compression is not None:
            grads, opt_state = grad_compression(grads, opt_state)
        params, opt_state, stats = opt.apply(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def build_prefill_step(cfg, *, capacity=None):
    """``prefill_step(params, batch) -> (logits (B, V), cache)`` of a
    cache holding ``capacity`` positions (the prompt's length when
    None)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        cap = capacity or batch["tokens"].shape[1]
        return MD.prefill(params, cfg, batch, cap)

    return prefill_step


def build_serve_step(cfg, *, sample="greedy"):
    """``serve_step(params, tokens, cache) -> (next tokens (B, 1) int32,
    logits (B, V), cache)``: one greedy decode step."""
    if sample != "greedy":
        raise ValueError(f"unknown sampling {sample!r}: the step builder "
                         "samples greedily (the engine samples otherwise)")

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        logits, cache = MD.decode_step(params, cfg, tokens, cache)
        return logits.argmax(-1)[:, None].to(torch.int32), logits, cache

    return serve_step
