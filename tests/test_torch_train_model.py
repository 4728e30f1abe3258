"""The training path — ``model.forward`` / ``loss_fn`` and autograd
through K5 with its backward K5b (plain versions on the CPU) — against
the JAX reference's ``loss_fn`` and ``jax.grad`` on bridged weights, for
the dense, MoE, vlm and audio families at smoke size in float32 (the
tolerance is stated in ``tests/_train_parity.py``); the remat policies
bitwise inside the port; the train batch; the attention kinds."""
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

ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "internvl2-26b",
         "whisper-large-v3"]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    cfg, params, batch, jcfg, jp, jb = family(request.param, remat="none")
    return cfg, params, batch, jax_loss_and_grads(jcfg, jp, jb), (jcfg, jp,
                                                                  jb)


def test_loss_and_every_gradient_leaf_match_jax(fam):
    cfg, params, batch, (jloss, jgrads), _ = fam
    loss, grads = port_loss_and_grads(params, cfg, batch)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    assert assert_grads_close(grads, jgrads) < 1e-4


def test_forward_logits_match_jax(fam):
    cfg, params, batch, _, (jcfg, jp, jb) = fam
    with torch.no_grad():
        got = MD.forward(params, cfg, batch)
    want = np.asarray(jax.jit(lambda p, b: JMD.forward(p, jcfg, b))(jp, jb))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-large-v3"])
def test_remat_policies_give_the_same_gradients_bitwise(arch):
    """none, dots (the matmul outputs kept) and full recompute: the same
    loss and gradients, bit for bit."""
    cfg, params, batch, *_ = family(arch)
    runs = [port_loss_and_grads(params, cfg.replace(remat=r), batch)
            for r in ("none", "dots", "full")]
    for loss, grads in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(
            T.leaves(grads), T.leaves(runs[0][1])))


def test_vlm_loss_skips_the_image_prefix_and_honours_a_mask():
    """internvl2: the loss reads the token positions only; a
    ``loss_mask`` keeps the positions it marks (the reference's
    masked mean)."""
    cfg, params, batch, jcfg, jp, jb = family("internvl2-26b")
    assert batch["images"].shape[1] == cfg.n_image_tokens
    assert batch["labels"].shape == batch["tokens"].shape
    mask = (np.arange(batch["tokens"].shape[1]) % 3 > 0)[None].repeat(2, 0)
    with torch.no_grad():
        got = MD.loss_fn(params, cfg, {**batch,
                                       "loss_mask": torch.from_numpy(mask)})
    want = JMD.loss_fn(jp, jcfg, {**jb, "loss_mask": mask})
    assert abs(got[0].item() - float(want[0])) < 1e-5
    assert got[1]["loss"] is got[0]


def test_train_batch_struct_and_dummy_batch():
    cfg, *_ = family("internvl2-26b")
    st = MD.batch_struct(cfg, 2, 48)
    assert list(st) == ["images", "tokens", "labels"]
    assert st["labels"] == ((2, 48 - cfg.n_image_tokens), torch.int32)
    spec = MD.batch_spec(cfg, 2, 48, "train")
    assert spec["labels"].is_meta
    a = MD.make_dummy_batch(cfg, 2, 48, seed=4, device="cpu")
    b = MD.make_dummy_batch(cfg, 2, 48, seed=4, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in st)
    assert int(a["tokens"].max()) < cfg.vocab_size
    assert a["images"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown batch kind"):
        MD.batch_struct(cfg, 2, 48, "score")


def test_attention_kinds_of_forward():
    """``attn_impl="pallas"`` runs K3 (its plain version here): without
    grad it gives the chunked path's logits; with an operand requiring
    grad it refuses, as K3 has no backward."""
    cfg, params, batch, *_ = family("qwen1.5-0.5b", seq=300)
    with torch.no_grad():
        a = MD.forward(params, cfg, batch, attn_impl="pallas")
        b = MD.forward(params, cfg, batch, attn_impl="chunked")
        c = MD.forward(params, cfg, batch, attn_impl="reference")
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(c, b, atol=2e-5, rtol=2e-5)
    grad_params = T.tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="no backward"):
        MD.loss_fn(grad_params, cfg, batch, attn_impl="pallas")
