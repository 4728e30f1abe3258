"""Shared by the mesh-training parity tests: one train step of a float32
smoke model over a ``("cpu",) * n`` mesh, the reference it is held to,
and the check. The reference is the JAX package's ``jax.value_and_grad``
of ``loss_fn`` and its AdamW's norm on the bridged weights
(``_train_parity.family``), beside the port's one-device norm."""
from __future__ import annotations

import math

import jax
import torch

from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.launch import steps as ST
from repro_torch.optim import AdamW, OptConfig
from _train_parity import (GRAD_RTOL, LOSS_RTOL, assert_grads_close,
                           family, jax_loss_and_grads)

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=1.0)
B = 4


def cpu_mesh(shape) -> DeviceMesh:
    return DeviceMesh(shape, ("cpu",) * math.prod(shape))


def mesh_step(cfg, params, batch, shape):
    """One mesh train step of the whole ``params`` on ``batch``: (the
    step's placements, per rank (params, opt state, metrics, grads))."""
    mesh = cpu_mesh(shape)
    opt = AdamW(OptConfig(**OPT))
    mt = ST.MeshTrain(cfg, mesh)
    pr = mt.shard(params)
    sr = [opt.init(p) for p in pr]
    parts = ST.mesh_parts(mt, batch)
    outs = mt.run(lambda r: mt.step(opt, pr[r], sr[r], parts[r], r))
    mesh.close()
    return mt, outs


def reference(cfg, params, batch, jcfg, jp, jb):
    """The reference's (loss, gradients, AdamW's grad_norm), and the
    port's one-device AdamW norm."""
    loss, g = jax_loss_and_grads(jcfg, jp, jb)
    opt = JAdamW(JOpt(**OPT))
    _, _, stats = jax.jit(opt.apply)(g, opt.init(jp), jp)
    popt = AdamW(OptConfig(**OPT))
    _, grads = ST.loss_and_grads(params, cfg, batch)
    _, _, one = popt.apply(grads, popt.init(params), params)
    return loss, g, float(stats["grad_norm"]), one["grad_norm"].item()


def check(mt, outs, want):
    """The metrics the same bits on every rank; the loss within
    LOSS_RTOL of the reference's; every reassembled gradient leaf within
    the stated tolerance; the AdamW norm within LOSS_RTOL of the port's
    one-device norm (the mesh's reductions add float32 noise only) and
    within GRAD_RTOL of the reference's (the bound the gradient
    tolerance puts on it: zamba2's one-device port is 2e-5 off there,
    its embedding gradient 7e-5 of its norm)."""
    loss, g, norm, one = want
    for key in ("loss", "grad_norm", "lr"):
        vals = [o[2][key] for o in outs]
        assert all(torch.equal(v, vals[0]) for v in vals), key
    m = outs[0][2]
    assert abs(m["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    got = m["grad_norm"].item()
    assert abs(got - one) <= LOSS_RTOL * one, (got, one)
    assert abs(got - norm) <= GRAD_RTOL * norm, (got, norm)
    return assert_grads_close(mt.gather([o[3] for o in outs]), g)


_CASES: dict = {}


def case(arch):
    """(port cfg, params, batch, reference) of ``arch`` at B rows, made
    once a process."""
    if arch not in _CASES:
        cfg, params, batch, jcfg, jp, jb = family(arch, batch=B,
                                                  jit_init=True)
        _CASES[arch] = (cfg, params, batch,
                        reference(cfg, params, batch, jcfg, jp, jb))
    return _CASES[arch]


def shape_id(v):
    return v if isinstance(v, str) else "x".join(map(str, v))
