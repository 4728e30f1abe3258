"""The port's train-mode sharding rules against the JAX package's, on
shapes only (the port's meta tensors, the reference's ``jax.eval_shape``
on an ``AbstractMesh``, no device): for all 14 registry architectures
at (data, model) = (2, 4), (4, 2), (2, 2), (1, 4), (8, 1) and (1, 3),
and at (pod, data, model) = (2, 2, 2), the per-leaf placement of the
params (``param_shardings``), of the AdamW state
(``opt_state_shardings``), of the train batch (``batch_shardings``) and
``replicated``; the placement the step realizes (``train_specs``) and
where it departs from the rules; which rank counts a leaf in the global
norm; ``microbatches`` against the reference's ``_clamp_mb``, ``pod``
included; the microbatch-then-data row order; the one mesh training
refuses (a CUDA device named twice)."""
from __future__ import annotations

import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import hints as JH
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.models import model as JMD
from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.optim import AdamW, OptConfig
from _torch_threads import one_thread  # noqa: F401

MESHES = ((2, 4), (4, 2), (2, 2), (1, 4), (8, 1), (1, 3), (2, 2, 2))
ARCHS = registry.list_archs(False)
mesh_ids = pytest.mark.parametrize("mesh", MESHES,
                                   ids=lambda m: "x".join(map(str, m)))


def _abstract(mesh):
    return AbstractMesh(mesh, ("pod", "data", "model")[-len(mesh):])


def _norm(spec, nd):
    """A PartitionSpec as the port writes a spec: one entry per dim,
    None or a tuple of axis names."""
    out = []
    for e in tuple(spec) + (None,) * (nd - len(tuple(spec))):
        out.append(None if e is None else
                   ((e,) if isinstance(e, str) else tuple(e)))
    return tuple(out)


def _names(path):
    return [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]


def _lookup(tree, names):
    for n in names:
        tree = tree[int(n)] if isinstance(tree, list) else tree[n]
    return tree


def _same(ref, ours, shapes, what):
    """Every leaf of the reference's NamedSharding tree ``ref`` equal to
    the port's spec at its path; returns the leaves compared."""
    n = 0
    for path, sh in jax.tree_util.tree_leaves_with_path(ref):
        names = _names(path)
        want = _norm(sh.spec, _lookup(shapes, names).dim())
        assert _lookup(ours, names) == want, (what, names)
        n += 1
    return n


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference param and AdamW state shapes, port meta params
    and meta AdamW state)."""
    out = {}
    for arch in ARCHS:
        jcfg = jreg.get_config(arch)
        jp = jax.eval_shape(lambda c=jcfg: JMD.init_params(
            jax.random.PRNGKey(0), c))
        js = jax.eval_shape(JAdamW(JOpt()).init, jp)
        meta = MD.init_params(registry.get_config(arch), device="meta")
        out[arch] = (jp, js, meta, AdamW(OptConfig()).init(meta))
    return out


@mesh_ids
def test_param_and_opt_state_placement_equals_reference(shapes, mesh):
    amesh = _abstract(mesh)
    for arch in ARCHS:
        jp, js, meta, state = shapes[arch]
        n = _same(JSH.param_shardings(amesh, jp), SH.param_specs(meta, mesh),
                  meta, arch)
        assert n == len(T.leaves(meta)), arch
        m = _same(JSH.opt_state_shardings(amesh, js),
                  SH.opt_state_specs(state, mesh), state, arch)
        assert m == 2 * n + 1, arch
        assert SH.opt_state_specs(state, mesh)["step"] == ()


@mesh_ids
def test_batch_placement_and_replicated_equal_reference(mesh):
    amesh = _abstract(mesh)
    for arch in ARCHS:
        jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
        for b in (16, 8, 6, 3):
            jb = JMD.batch_spec(jcfg, b, 512, "train")
            tb = MD.batch_spec(cfg, b, 512, "train")
            assert set(jb) == set(tb), arch
            _same(JSH.batch_shardings(amesh, jb), SH.batch_specs(tb, mesh),
                  tb, (arch, b))
            _same(JSH.replicated(amesh, jb), SH.replicated(tb), tb,
                  (arch, b))


@mesh_ids
def test_realized_placement_departs_only_for_stacked_vectors_and_shared(
        shapes, mesh):
    """``train_specs`` is the rules applied to one layer's shapes: equal
    to the reference's rules except in a stacked subtree (the decoder
    and encoder layers, zamba2's (G, 6) Mamba2 stack, xLSTM's
    (n_super, n_inner) mLSTMs and (n_super,) sLSTMs) a stacked vector —
    a norm's scale, a bias, ``A_log`` — whole, not split along a stack
    axis, and an MoE's stacked shared experts (the dense MLP's rule)."""
    fsdp = SH.fsdp_axes(mesh)
    departed = set()
    for arch in ARCHS:
        meta = shapes[arch][2]
        rules = SH.param_specs(meta, mesh)
        real = SH.train_specs(meta, mesh)
        for names, leaf in SH._walk(meta):
            got, want = _lookup(real, names), _lookup(rules, names)
            assert len(got) == leaf.dim()
            lead = SH.STACKS.get(names[0], 0)
            if not lead:
                assert got == want, (arch, names)
                continue
            assert got[:lead] == (None,) * lead, (arch, names)
            if leaf.dim() == lead + 1:
                assert got == (None,) * leaf.dim(), (arch, names)
                if got != want:
                    departed.add(names[0])
            elif "shared" in names:
                dense = [n for n in names if n != "moe"]
                assert got == (None,) + SH.param_spec(
                    dense, tuple(leaf.shape[1:]), mesh, fsdp), (arch, names)
            else:
                assert got == want, (arch, names)
    if SH.axis_size(mesh, fsdp) == 2:   # zamba2's (9, 6, H) A_log splits
        assert {"layers", "enc_layers", "mamba"} <= departed, departed


@pytest.mark.parametrize("mesh", ((2, 4), (4, 2), (1, 4), (1, 3),
                                  (2, 2, 2)),
                         ids=lambda m: "x".join(map(str, m)))
def test_every_shard_counts_once_in_the_global_norm(shapes, mesh):
    """Summed over the ranks that count it, a leaf's shards hold each of
    its elements once — every family, two or three axes."""
    dev = DeviceMesh(mesh, ("cpu",) * math.prod(mesh))
    for arch in ARCHS:
        meta = shapes[arch][2]
        specs = SH.train_specs(meta, mesh)
        counted = [SH.counted_leaves(specs, mesh, dev.coords(r))
                   for r in range(dev.size)]
        for i, ((_, spec), leaf) in enumerate(zip(SH.spec_leaves(specs),
                                                  T.leaves(meta))):
            local = SH.local_shape(tuple(leaf.shape), spec, mesh)
            n = sum(c[i] for c in counted)
            assert n * torch.Size(local).numel() == leaf.numel(), (arch, i)


def _clamp_mb(cfg):
    """The reference's ``_clamp_mb``, a closure of its train step."""
    step = JST.build_train_step(cfg, JAdamW(JOpt()))
    cells = dict(zip(step.__code__.co_freevars,
                     (c.cell_contents for c in step.__closure__)))
    return cells["_clamp_mb"]


@pytest.mark.parametrize("mb", (1, 2, 3, 4, 8))
def test_microbatches_equal_the_reference_clamp(mb):
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(microbatch=mb)
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(microbatch=mb)
    clamp = _clamp_mb(jcfg)
    for shape in ((1, 2), (2, 2), (4, 2), (8, 2), (2, 2, 2), (2, 4, 1)):
        mt = ST.MeshTrain(cfg, DeviceMesh(shape, ("cpu",) * math.prod(
            shape)))
        with JH.use_mesh(_abstract(shape)):
            for b in (1, 2, 3, 4, 6, 8, 12, 16, 24):
                assert ST.microbatches(cfg, b, mt.fsdp) == clamp(b), (
                    b, shape)
    for b in (1, 5, 8):
        assert ST.microbatches(cfg, b) == ST.microbatches(cfg, b, 1)


def test_microbatch_then_data_row_order():
    """Rows of a batch of 8 at 2 microbatches over data 2: microbatch i
    is rows 4i..4i+3 (the reference's reshape), its data rank j the
    block of 2 rows at 4i + 2j."""
    batch = {"tokens": torch.arange(8)[:, None].repeat(1, 3),
             "labels": torch.arange(8)[:, None] + 100}
    parts = ST.mesh_microbatches(batch, 2, 2)
    rows = [[p["tokens"][:, 0].tolist() for p in rank] for rank in parts]
    assert rows == [[[0, 1], [4, 5]], [[2, 3], [6, 7]]]
    assert parts[1][1]["labels"][:, 0].tolist() == [106, 107]
    assert [[p["tokens"][:, 0].tolist() for p in r]
            for r in ST.mesh_microbatches(batch, 1, 4)] == [
        [[0, 1]], [[2, 3]], [[4, 5]], [[6, 7]]]
    with pytest.raises(ValueError, match="does not split"):
        ST.mesh_microbatches(batch, 3, 2)


class _Stub:
    """A mesh as ``check_train_mesh`` reads one: shape and devices."""

    def __init__(self, shape, devices):
        self.shape, self.devices = shape, tuple(devices)


def test_a_cuda_training_mesh_with_a_repeated_device_refuses():
    """Two ranks on one card would share autograd's one worker thread
    for that device: their backward collectives would wait for each
    other. Checked on device names alone — no card needed."""
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    cuda = [torch.device("cuda", i) for i in (0, 1, 1, 2)]
    with pytest.raises(ValueError, match="names a CUDA device twice"):
        SH.check_train_mesh(cfg, _Stub((2, 2), cuda))
    SH.check_train_mesh(cfg, _Stub(
        (2, 2), [torch.device("cuda", i) for i in range(4)]))
    SH.check_train_mesh(cfg, _Stub((2, 2), [torch.device("cpu")] * 4))
    cuda = [torch.device("cuda", i) for i in (0, 1, 2, 3, 4, 5, 6, 0)]
    with pytest.raises(ValueError, match="names a CUDA device twice"):
        SH.check_train_mesh(cfg, _Stub((2, 2, 2), cuda))
