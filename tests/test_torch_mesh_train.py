"""Training over a (data, model) mesh of ``("cpu",) * n`` ranks against
the JAX reference, on the float32 smoke models: ``build_train_step``'s
mesh path (FSDP over ``data``, Megatron over ``model``, the rank-ordered
reductions) gives the loss, the AdamW norm and, reassembled, every
gradient leaf of ``jax.value_and_grad`` of the reference's ``loss_fn``
on the bridged weights — qwen (dense, tied embeddings, QKV bias) at
(2, 2), (4, 1) and (1, 4), deepseek-moe-16b at capacity factor 1.25
with routed slots dropping, internvl2-26b (vlm) at (2, 2); a
``loss_mask`` that keeps other counts on the data ranks gives the
reference's loss; the same mesh twice, every replica of a shard, every
rank's metrics and a (1, 1) mesh against the one-device step are the
same bits; the collectives themselves. Tolerance: ``tests/
_train_parity.py``'s (GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-6,
1e-6); the norm within LOSS_RTOL."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro_torch import tree as T
from repro_torch.distributed import hints as H
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.models import moe as M
from repro_torch.optim import AdamW, OptConfig
from _torch_threads import one_thread  # noqa: F401
from _train_parity import (LOSS_RTOL, assert_grads_close, family,
                           jax_loss_and_grads)

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=1.0)
B = 4


def _mesh(shape):
    return DeviceMesh(shape, ("cpu",) * (shape[0] * shape[1]))


def mesh_step(cfg, params, batch, shape, mesh=None):
    """One mesh train step of the whole ``params`` on ``batch``: (the
    step's placements, per rank (params, opt state, metrics, grads))."""
    mesh = mesh or _mesh(shape)
    opt = AdamW(OptConfig(**OPT))
    with H.use_mesh(mesh, train=True):
        mt = ST.mesh_train(cfg)
    pr = mt.shard(params)
    sr = [opt.init(p) for p in pr]
    parts = ST.mesh_parts(mt, batch)
    return mt, mt.run(lambda r: mt.step(opt, pr[r], sr[r], parts[r], r))


def reference(jcfg, jp, jb):
    """The reference's (loss, gradients, AdamW's grad_norm)."""
    loss, g = jax_loss_and_grads(jcfg, jp, jb)
    opt = JAdamW(JOpt(**OPT))
    _, _, stats = opt.apply(g, opt.init(jp), jp)
    return loss, g, float(stats["grad_norm"])


def check(mt, outs, want):
    """Loss and norm within LOSS_RTOL on every rank (the same bits on
    each), every reassembled gradient leaf within the stated tolerance."""
    loss, g, norm = want
    for key in ("loss", "grad_norm", "lr"):
        vals = [o[2][key] for o in outs]
        assert all(torch.equal(v, vals[0]) for v in vals), key
    m = outs[0][2]
    assert abs(m["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    assert abs(m["grad_norm"].item() - norm) <= LOSS_RTOL * norm
    return assert_grads_close(mt.gather([o[3] for o in outs]), g)


@pytest.fixture(scope="module")
def qwen():
    cfg, params, batch, jcfg, jp, jb = family("qwen1.5-0.5b", batch=B)
    return cfg, params, batch, reference(jcfg, jp, jb)


@pytest.mark.parametrize("shape", ((2, 2), (4, 1), (1, 4)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_qwen_mesh_step_matches_reference(qwen, shape):
    cfg, params, batch, want = qwen
    mt, outs = mesh_step(cfg, params, batch, shape)
    check(mt, outs, want)


def test_qwen_loss_mask_differing_across_data_ranks(qwen):
    """Data rank 0 keeps 10 + 48 positions, rank 1 48 + 0: the mean is
    the whole batch's, not the mean of the ranks' means."""
    cfg, params, batch, _ = qwen
    jcfg, jp, jb = family("qwen1.5-0.5b", batch=B)[3:]
    mask = np.ones(batch["labels"].shape, np.float32)
    mask[0, 10:] = 0
    mask[3] = 0
    jb = {**jb, "loss_mask": mask}
    mt, outs = mesh_step(cfg, params,
                         {**batch, "loss_mask": torch.from_numpy(mask)},
                         (2, 2))
    check(mt, outs, reference(jcfg, jp, jb))


def test_moe_mesh_step_matches_reference_with_drops(monkeypatch):
    """deepseek-moe-16b at capacity factor 1.25: the reference's one
    program drops routed slots over the whole batch; the mesh, each data
    rank dispatching its own rows, must drop the same ones (its
    capacity of the whole batch's tokens, its slots after the lower
    ranks')."""
    cfg, params, batch, jcfg, jp, jb = family("deepseek-moe-16b", batch=B)
    assert cfg.moe_capacity_factor == 1.25
    drops = []
    apply_moe = M.apply_moe

    def counted(p, c, x):
        xf = x.reshape(-1, x.shape[-1])
        _, ids = M.route(p["router"], xf, c.moe_top_k)
        pos = M.slot_positions(ids, c.n_experts)
        drops.append(int((pos >= M._capacity(xf.shape[0], c)).sum()))
        return apply_moe(p, c, x)

    monkeypatch.setattr(M, "apply_moe", counted)
    MD.loss_fn(params, cfg, batch)
    monkeypatch.setattr(M, "apply_moe", apply_moe)
    assert drops and min(drops) > 0, drops
    mt, outs = mesh_step(cfg, params, batch, (2, 2))
    check(mt, outs, reference(jcfg, jp, jb))


def test_vlm_mesh_step_matches_reference():
    cfg, params, batch, jcfg, jp, jb = family("internvl2-26b", batch=B)
    assert "images" in batch
    mt, outs = mesh_step(cfg, params, batch, (2, 2))
    check(mt, outs, reference(jcfg, jp, jb))


def test_same_mesh_twice_and_replicas_bitwise(qwen):
    cfg, params, batch, _ = qwen
    mesh = _mesh((2, 2))
    mt, a = mesh_step(cfg, params, batch, (2, 2), mesh)
    _, b = mesh_step(cfg, params, batch, (2, 2), mesh)
    for x, y in zip(a, b):
        for i in (0, 1, 3):
            assert all(torch.equal(u, v) for u, v in zip(T.leaves(x[i]),
                                                         T.leaves(y[i])))
    copies = 0
    for which in (0, 3):   # new params, gradients
        leaves = [T.leaves(o[which]) for o in a]
        for i, (_, spec) in enumerate(SH.spec_leaves(mt.specs)):
            first = {}
            for r in range(mesh.size):
                key = SH.shard_key(spec, mesh, mesh.coords(r))
                if key in first:
                    copies += 1
                    assert torch.equal(leaves[r][i], first[key])
                else:
                    first[key] = leaves[r][i]
    assert copies > 0


def test_one_by_one_mesh_is_the_one_device_step_bitwise(qwen):
    cfg, params, batch, _ = qwen
    for mb in (1, 2):
        c = cfg.replace(microbatch=mb)
        opt = AdamW(OptConfig(**OPT))
        step = ST.build_train_step(c, opt)
        p1, s1, m1 = step(params, opt.init(params), batch)
        mesh = _mesh((1, 1))
        with H.use_mesh(mesh, train=True):
            pr, sr, mr = step([params], [opt.init(params)], batch)
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(p1),
                                                     T.leaves(pr[0])))
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(s1),
                                                     T.leaves(sr[0])))
        assert all(torch.equal(m1[k], mr[k]) for k in m1)
        mesh.close()


def test_microbatch_2_on_the_mesh_matches_the_one_device_step(qwen):
    cfg, params, batch, _ = qwen
    c = cfg.replace(microbatch=2)
    want_loss, want = ST.accumulated_grads(params, c, batch)
    mt, outs = mesh_step(c, params, batch, (2, 2))
    got = mt.gather([o[3] for o in outs])
    assert abs(outs[0][2]["loss"].item() - want_loss.item()) <= (
        LOSS_RTOL * abs(want_loss.item()))
    assert_grads_close(got, T.tree_map(lambda t: t.numpy(), want))


def test_mesh_collectives_sum_in_rank_order_and_agree():
    """``all_reduce`` and ``reduce_scatter`` over each axis: every rank
    of a group the same bits, the group's tensors added left to right in
    float32; ``all_gather`` in group order."""
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(4, 6, generator=gen).to(torch.bfloat16)
          for _ in range(4)]

    def one(r):
        return (mesh.all_reduce(xs[r], "model"),
                mesh.reduce_scatter(xs[r], 0, "data"),
                mesh.all_gather(xs[r], 1, "model"))

    outs = mesh.run(one)
    for r in range(4):
        mg, dg = mesh.group(r, "model"), mesh.group(r, "data")
        want = (xs[mg[0]].float() + xs[mg[1]].float()).to(torch.bfloat16)
        assert torch.equal(outs[r][0], want)
        i = dg.index(r)
        chunk = (xs[dg[0]][2 * i:2 * i + 2].float()
                 + xs[dg[1]][2 * i:2 * i + 2].float()).to(torch.bfloat16)
        assert torch.equal(outs[r][1], chunk)
        assert torch.equal(outs[r][2], torch.cat([xs[j] for j in mg], 1))
    mesh.close()


def test_a_whole_state_shards_onto_the_mesh_and_gathers_back(qwen):
    """A one-device run's params and AdamW state cut onto a (2, 2) mesh
    (the moments as their params, the step whole) reassemble bit for
    bit, and the mesh's next step takes up the count: its learning rate
    is the one-device second step's."""
    cfg, params, batch, _ = qwen
    opt = AdamW(OptConfig(**OPT))
    step = ST.build_train_step(cfg, opt)
    p1, s1, _ = step(params, opt.init(params), batch)
    _, _, m2 = step(p1, s1, batch)
    mesh = _mesh((2, 2))
    with H.use_mesh(mesh, train=True):
        mt = ST.mesh_train(cfg)
        pr, sr = mt.shard(p1, s1)
        whole = SH.gather_tree(sr, mt.state_specs, mesh)
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(whole),
                                                     T.leaves(s1)))
        assert all(torch.equal(a, b) for a, b in zip(
            T.leaves(mt.gather(pr)), T.leaves(p1)))
        _, sr2, mr = step(pr, sr, batch)
    assert all(int(s["step"]) == 2 for s in sr2)
    assert torch.equal(mr["lr"], m2["lr"])
    mesh.close()
