"""The (pod, data, model) mesh, gradient compression over a mesh and
elastic restart, on the float32 (and bf16) smoke models over
``("cpu",) * n`` ranks:

- a three-axis mesh's coordinates, its flattened ``("pod", "data")``
  group (pod-major) and its collectives, summed in group order;
- ``compression.apply`` on each rank's shards of a gradient and an
  error state — shards that are runs of whole blocks round-tripped
  alone, the others gathered — bitwise the JAX reference's
  ``compression.apply`` on the whole leaves; a mesh step with
  ``ErrorFeedback`` at (1, 3) bitwise the one-device step with it;
- ``remesh`` of a train state (2, 2) -> (4, 1) -> (2, 1, 2) -> one
  device, bit for bit;
- ``RestartPolicy`` over a (2, 2) mesh, a failure injected, replaying to
  the uninterrupted run's bits;
- a mesh checkpoint (bf16 params and fp32 moments) read by the JAX
  package's ``load_pytree``, bit for bit, and restored onto (1, 2),
  (2, 1, 2) and one device — the same bits — from which training goes
  on within LOSS_RTOL of the (2, 2) run's loss."""
from __future__ import annotations

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.distributed import compression as JGC
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import make_train_stream
from repro_torch.distributed import compression as GC
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault_tolerance import RestartPolicy, remesh
from repro_torch.distributed.mesh import PerRank
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.optim import AdamW, OptConfig
from _mesh_parity import OPT, cpu_mesh
from _torch_threads import one_thread  # noqa: F401
from _train_parity import LOSS_RTOL

B, S = 4, 32


def _cfg(arch="qwen1.5-0.5b", dtype="float32"):
    return registry.get_smoke_config(arch).replace(dtype=dtype)


def _meta(tree):
    """``tree``'s shapes and dtypes, no values: the ``like`` of a restore
    onto another mesh."""
    return T.tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                            device="meta"), tree)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def _batch(cfg, step, b=B):
    st = make_train_stream(cfg, b, S, seed=0)
    return {k: torch.from_numpy(v) for k, v in st.batch_at(step).items()}


def test_three_axis_mesh_groups_and_collectives():
    """Rank r at (pod, data, model) row-major; the FSDP group
    ``("pod", "data")`` pod-major; ``all_reduce`` over it the group's
    tensors added left to right in float32, ``reduce_scatter`` its
    chunks, ``all_gather`` in group order — every rank the same bits."""
    mesh = cpu_mesh((2, 2, 2))
    assert [mesh.coords(r) for r in (0, 1, 2, 5, 7)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 1)]
    assert mesh.group(5, ("pod", "data")) == (1, 3, 5, 7)
    assert mesh.group(5, ("data", "pod")) == (1, 5, 3, 7)
    assert mesh.group(5, "model") == (4, 5)
    assert mesh.group(5, "pod") == (1, 5)
    assert cpu_mesh((2, 2)).group(3, ("pod", "data")) == (1, 3)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(8, 3, generator=gen).to(torch.bfloat16)
          for _ in range(8)]
    fsdp = ("pod", "data")

    def one(r):
        return (mesh.all_reduce(xs[r], fsdp),
                mesh.reduce_scatter(xs[r], 0, fsdp),
                mesh.all_gather(xs[r], 1, fsdp))

    outs = mesh.run(one)
    for r in range(8):
        grp = mesh.group(r, fsdp)
        total = xs[grp[0]].float()
        for j in grp[1:]:
            total = total + xs[j].float()
        assert torch.equal(outs[r][0], total.to(torch.bfloat16))
        i = grp.index(r)
        assert torch.equal(outs[r][1],
                           total[2 * i:2 * i + 2].to(torch.bfloat16))
        assert torch.equal(outs[r][2], torch.cat([xs[j] for j in grp], 1))
    mesh.close()


def _whole_tree(params, seed):
    """A random fp32 tree of the params' shapes (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    return T.tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), params)


@pytest.mark.parametrize("arch,shape", (("zamba2-2.7b", (2, 2, 2)),
                                        ("qwen1.5-0.5b", (2, 2))),
                         ids=("zamba2-2x2x2", "qwen-2x2"))
def test_compression_over_a_mesh_is_the_reference_on_whole_leaves(
        arch, shape):
    cfg = _cfg(arch)
    meta = MD.init_params(cfg, device="meta")
    grads, err = _whole_tree(meta, 1), _whole_tree(meta, 2)
    err = T.tree_map(lambda e: e * 1e-3, err)
    mesh = cpu_mesh(shape)
    mt = ST.MeshTrain(cfg, mesh)
    gr, er = mt.shard(grads), mt.shard(err)
    kinds = set()
    for (_, spec), leaf in zip(SH.spec_leaves(mt.specs), T.leaves(gr[0])):
        kinds.add(GC._whole_blocks(leaf.shape, spec,
                                   _comm_sizes(mesh), 256))
    assert kinds == {True, False}   # both paths run
    outs = mt.run(lambda r: GC.apply(gr[r], er[r]))
    got_g = mt.gather([o[0] for o in outs])
    got_e = mt.gather([o[1] for o in outs])
    want_g, want_e = JGC.apply(   # eager: jit fuses to other bits
        T.tree_map(lambda t: t.numpy(), grads),
        T.tree_map(lambda t: t.numpy(), err))
    for got, want in ((got_g, want_g), (got_e, want_e)):
        for (k, a), (_, b) in zip(T.paths(got), T.paths(jax.device_get(
                want))):
            assert np.array_equal(a.numpy(), np.asarray(b)), k
    mesh.close()


class _comm_sizes:
    """What ``_whole_blocks`` asks of a rank's Comm: a group's size."""

    def __init__(self, mesh):
        self.mesh = mesh

    def size(self, axes):
        return len(self.mesh.group(0, axes))


def test_error_feedback_step_over_a_mesh_is_the_one_device_step():
    """At (1, 3) qwen's step is the one-device step bit for bit; with
    ``ErrorFeedback`` as its ``grad_compression`` two steps stay so —
    the error state carried per rank."""
    cfg = _cfg()
    params = MD.init_params(cfg, seed=3, device="cpu")
    opt = AdamW(OptConfig(**OPT))
    batches = [_batch(cfg, i) for i in range(2)]
    one = ST.build_train_step(cfg, opt, grad_compression=GC.ErrorFeedback())
    p, s = params, opt.init(params)
    for b in batches:
        p, s, m = one(p, s, b)
    mesh = cpu_mesh((1, 3))
    hook = GC.ErrorFeedback()
    step = ST.build_train_step(cfg, opt, grad_compression=hook)
    mt = ST.MeshTrain(cfg, mesh)
    pr = mt.shard(params)
    sr = [opt.init(x) for x in pr]
    from repro_torch.distributed import hints as H
    with H.use_mesh(mesh, train=True):
        for b in batches:
            pr, sr, mr = step(pr, sr, b)
    assert sorted(hook.err) == [0, 1, 2]
    assert all(torch.equal(m[k], mr[k]) for k in m)
    assert _same(mt.gather(pr), p)
    mesh.close()


def _state(cfg, seed=3):
    """A train state after one AdamW step: (params, opt state)."""
    params = MD.init_params(cfg, seed=seed, device="cpu")
    opt = AdamW(OptConfig(**OPT))
    p, s, _ = ST.build_train_step(cfg, opt)(params, opt.init(params),
                                            _batch(cfg, 0))
    return {"params": p, "opt_state": s}


def test_remesh_across_meshes_and_back_to_one_device_bitwise():
    cfg = _cfg("zamba2-2.7b")
    whole = _state(cfg)
    state, place = remesh(whole, cpu_mesh((2, 2)))
    assert place.specs["params"]["mamba"]["mamba"]["in_proj"] == (
        None, None, ("data",), ("model",))
    assert place.specs["opt_state"]["mu"] == SH.train_specs(
        whole["params"], place.mesh)
    for shape in ((4, 1), (2, 1, 2)):
        state, place = remesh(state, cpu_mesh(shape), placement=place)
        assert len(state) == place.mesh.size
        lead = state[0]["params"]["mamba"]["mamba"]["in_proj"]
        assert lead.shape[-2] == 64 // (4 if shape == (4, 1) else 2)
    assert _same(place.gather(state), whole)


def _mesh_run(cfg, shape, tmp, n_steps, inject=None, every=2):
    """``n_steps`` of a mesh train step under RestartPolicy, checkpoints
    every ``every`` steps in ``tmp``: (final per-rank state, policy,
    placement, per-step losses)."""
    from repro_torch.distributed import hints as H
    mesh = cpu_mesh(shape)
    opt = AdamW(OptConfig(**OPT))
    mt = ST.MeshTrain(cfg, mesh)
    place = SH.Placement(mesh, {"params": mt.specs,
                                "opt_state": mt.state_specs})
    params = MD.init_params(cfg, seed=3, device="cpu")
    state = place.shard({"params": params, "opt_state": opt.init(params)})
    step = ST.build_train_step(cfg, opt)
    losses = {}

    def step_fn(st, batch):
        with H.use_mesh(mesh, train=True):
            p, s, m = step([x["params"] for x in st],
                           [x["opt_state"] for x in st], batch)
        losses[int(s[0]["step"])] = m["loss"].item()
        return PerRank({"params": a, "opt_state": b} for a, b in zip(p, s))

    pol = RestartPolicy(CheckpointManager(str(tmp), keep=3),
                        checkpoint_every=every, placement=place)
    state, done = pol.run(state=state, step_fn=step_fn,
                          data_at=lambda i: _batch(cfg, i),
                          n_steps=n_steps, inject_failure=inject)
    assert done == n_steps
    return state, pol, place, losses


def test_restart_policy_over_a_mesh_replays_bitwise(tmp_path):
    cfg = _cfg()
    want, _, place, _ = _mesh_run(cfg, (2, 2), tmp_path / "a", 6)
    failed = []

    def inject(step):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("node lost at step 3")

    got, pol, _, _ = _mesh_run(cfg, (2, 2), tmp_path / "b", 6, inject)
    assert pol.restarts == 1 and pol.log[0]["step"] == 3
    assert all(_same(a, b) for a, b in zip(got, want))
    place.mesh.close()


def test_mesh_checkpoint_reads_in_the_reference_and_on_other_meshes(
        tmp_path):
    """A bf16 state saved from (2, 2): the JAX package's ``load_pytree``
    reads the same bits; ``restore_latest(shardings=)`` puts them onto
    (1, 2) and (2, 1, 2), one device reads them whole; a step from each
    gives the (2, 2) run's next loss within LOSS_RTOL (float32 copy of
    the run)."""
    cfg = _cfg(dtype="bfloat16")
    state, pol, place, _ = _mesh_run(cfg, (2, 2), tmp_path, 2)
    whole = place.gather(state)
    path = pol.manager._path(2)
    like = T.tree_map(lambda t: np.zeros(
        tuple(t.shape), ml_dtypes.bfloat16 if t.dtype == torch.bfloat16
        else t.numpy().dtype), whole)
    got = jax_load_pytree(path, like)
    for (k, a), (_, b) in zip(T.paths(whole), T.paths(got)):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16).numpy(), b.view(np.int16)
        else:
            a = a.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    one_step, one = CheckpointManager(str(tmp_path)).restore_latest(whole)
    assert one_step == 2 and _same(one, whole)
    for shape in ((1, 2), (2, 1, 2)):
        mesh = cpu_mesh(shape)
        specs = SH.train_specs(whole, mesh)
        step, got = CheckpointManager(str(tmp_path)).restore_latest(
            _meta(whole), shardings=SH.Placement(mesh, specs))
        assert step == 2 and len(got) == mesh.size
        assert _same(SH.gather_tree(got, specs, mesh), whole)
        mesh.close()
    place.mesh.close()


def test_training_goes_on_after_restoring_onto_fewer_devices(tmp_path):
    """float32 qwen: 2 steps at (2, 2) checkpointed; restored onto
    (1, 2) and onto one device, the third step's loss is the (2, 2)
    run's third within LOSS_RTOL (the reductions sum in other orders)."""
    from repro_torch.distributed import hints as H
    cfg = _cfg()
    _, _, place, losses = _mesh_run(cfg, (2, 2), tmp_path / "a", 3)
    state, _, _, _ = _mesh_run(cfg, (2, 2), tmp_path / "b", 2)
    opt = AdamW(OptConfig(**OPT))
    step = ST.build_train_step(cfg, opt)
    whole = place.gather(state)
    mgr = CheckpointManager(str(tmp_path / "b"))
    _, one = mgr.restore_latest(whole)
    _, _, m = step(one["params"], one["opt_state"], _batch(cfg, 2))
    assert abs(m["loss"].item() - losses[3]) <= LOSS_RTOL * losses[3]
    mesh = cpu_mesh((1, 2))
    mt = ST.MeshTrain(cfg, mesh)
    _, got = mgr.restore_latest(_meta(whole), shardings=SH.Placement(
        mesh, {"params": mt.specs, "opt_state": mt.state_specs}))
    with H.use_mesh(mesh, train=True):
        _, _, m = step([x["params"] for x in got],
                       [x["opt_state"] for x in got], _batch(cfg, 2))
    assert abs(m["loss"].item() - losses[3]) <= LOSS_RTOL * losses[3]
    mesh.close()
    place.mesh.close()
