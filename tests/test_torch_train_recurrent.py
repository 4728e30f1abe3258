"""The training path against the JAX reference (``loss_fn`` and every
leaf's ``jax.grad``, bridged weights, float32 smoke models; tolerance in
``tests/_train_parity.py``) for the rolling-window decoder
(h2o-danube-1.8b: the 48-token sequence crosses its 32-token window),
the hybrid (zamba2-2.7b: Mamba2 and the shared block) and the xLSTM
(xlstm-350m: mLSTM and sLSTM) — and their remat policies bitwise inside
the port."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from _train_parity import (LOSS_RTOL, assert_grads_close, family,
                           jax_loss_and_grads, port_loss_and_grads)
from repro.models import model as JMD
from repro_torch import tree as T
from repro_torch.models import model as MD

ARCHS = ["h2o-danube-1.8b", "zamba2-2.7b", "xlstm-350m"]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    cfg, params, batch, jcfg, jp, jb = family(request.param, remat="none")
    return cfg, params, batch, jax_loss_and_grads(jcfg, jp, jb), (jcfg, jp,
                                                                  jb)


def test_loss_and_every_gradient_leaf_match_jax(fam):
    cfg, params, batch, (jloss, jgrads), _ = fam
    loss, grads = port_loss_and_grads(params, cfg, batch)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert assert_grads_close(grads, jgrads) < 1e-3


def test_forward_logits_match_jax(fam):
    cfg, params, batch, _, (jcfg, jp, jb) = fam
    with torch.no_grad():
        got = MD.forward(params, cfg, batch)
    want = np.asarray(jax.jit(lambda p, b: JMD.forward(p, jcfg, b))(jp, jb))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradients_bitwise(arch):
    cfg, params, batch, *_ = family(arch)
    runs = [port_loss_and_grads(params, cfg.replace(remat=r), batch)
            for r in ("none", "dots", "full")]
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(
            T.leaves(grads), T.leaves(runs[0][1])))


def test_unknown_remat_policy_raises():
    cfg, params, batch, *_ = family("xlstm-350m")
    with pytest.raises(ValueError, match="remat policy"):
        port_loss_and_grads(params, cfg.replace(remat="some"), batch)
