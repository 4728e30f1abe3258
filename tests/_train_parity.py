"""Shared by the training-path parity tests: one family's smoke model in
float32, weights from ``jax.random.PRNGKey(3)`` bridged into the port,
one seeded train batch; the JAX reference's loss and ``jax.grad`` of
every leaf (jitted), and the gradient comparison.

Tolerance, stated once: each gradient leaf normwise within GRAD_RTOL of
its own norm plus GRAD_ATOL of the whole gradient's norm. The second
term holds a leaf whose gradient nearly cancels to the whole gradient's
scale: zamba2's ``A_log`` — a sum over every position of terms that
cancel — comes out of float32 only to ~1e-5 of a float64 evaluation in
one layer, in either package."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import tree as T
from repro_torch.bridge import params_from_jax
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as ST

GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-6
BATCH, SEQ = 2, 48


def family(arch, seq=SEQ, **kw):
    """(port cfg, port params requiring grad, port batch, JAX cfg, JAX
    params, JAX batch) of ``arch``'s float32 smoke model."""
    jcfg = jreg.get_smoke_config(arch).replace(dtype="float32", **kw)
    cfg = treg.get_smoke_config(arch).replace(dtype="float32", **kw)
    jp = JMD.init_params(jax.random.PRNGKey(3), jcfg)
    jb = JMD.make_dummy_batch(jax.random.PRNGKey(5), jcfg, BATCH, seq,
                              "train")
    params = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return cfg, params, batch, jcfg, jp, jb


def jax_loss_and_grads(jcfg, jp, jb):
    """(loss, gradient tree as numpy) of the reference's ``loss_fn``."""
    f = jax.jit(jax.value_and_grad(
        lambda p, b: JMD.loss_fn(p, jcfg, b)[0]))
    loss, g = f(jp, jb)
    return float(loss), jax.device_get(g)


def port_loss_and_grads(params, cfg, batch, **kw):
    """(loss, gradient tree) of the port's ``loss_fn`` through autograd
    (``launch.steps.loss_and_grads``)."""
    loss, grads = ST.loss_and_grads(params, cfg, batch, **kw)
    return loss.item(), grads


def assert_grads_close(got, want_np):
    """Every leaf of ``got`` (tensors) against ``want_np`` (numpy, the
    same pytree order) within the stated tolerance; returns the worst
    leaf's error relative to its own norm."""
    gl = T.paths(got)
    wl = T.paths(want_np)
    assert [k for k, _ in gl] == [k for k, _ in wl]
    whole = np.sqrt(sum(float(np.sum(np.square(np.asarray(w, np.float64))))
                        for _, w in wl))
    worst = 0.0
    for (k, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(g.detach().double().numpy() - w)
        ref = np.linalg.norm(w)
        assert err <= GRAD_RTOL * ref + GRAD_ATOL * whole, (k, err, ref)
        worst = max(worst, err / max(ref, 1e-30))
    return worst
