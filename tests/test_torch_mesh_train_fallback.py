"""Training over a mesh whose ``model`` axis the widths do not divide,
and over the ``pod`` axis, against the JAX reference on the float32
smoke models (weights bridged from ``PRNGKey(3)``):

- whisper and qwen at (1, 3), where 4 heads, FFN width 128 and vocab
  256 all fail to divide 3: every sublayer, the embedding and the head
  run whole on each model rank;
- the model-whole fallback sums nothing over ``model``: qwen at (1, 3)
  is the one-device step bit for bit, and zamba2's Mamba2 leaves split
  over ``model`` at (1, 4) take their slice of the whole gradient;
- deepseek-moe-16b at (pod, data, model) = (2, 2, 1), routed slots
  dropping over the whole microbatch, its rows split over
  ``("pod", "data")`` pod-major — a data-major split drops other slots
  and misses the reference.

Tolerance (``tests/_mesh_parity.py``): ``_train_parity.py``'s
GRAD_RTOL, GRAD_ATOL and LOSS_RTOL; the norm within LOSS_RTOL of the
one-device port's and GRAD_RTOL of the reference's."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.models import moe as M
from repro_torch.optim import AdamW, OptConfig
from _mesh_parity import (B, OPT, case, check, mesh_step, reference,
                          shape_id)
from _torch_threads import one_thread  # noqa: F401
from _train_parity import family


@pytest.mark.parametrize("arch,shape", (
    ("whisper-large-v3", (1, 3)), ("qwen1.5-0.5b", (1, 3))), ids=shape_id)
def test_widths_that_do_not_divide_model_match_reference(arch, shape):
    cfg, params, batch, want = case(arch)
    mt, outs = mesh_step(cfg, params, batch, shape)
    assert {"attn", "xattn"} <= mt.whole and mt.rank_cfg == cfg
    head = "table" if cfg.tie_embeddings else "head"
    spec = (mt.specs["embed"]["table"] if cfg.tie_embeddings
            else mt.specs[head])
    assert spec[0] is None          # the vocab whole over model
    check(mt, outs, want)


def test_model_whole_fallback_sums_nothing_over_model():
    """At (1, 3) every sublayer of qwen runs whole on each model rank:
    the step is the one-device step bit for bit — loss, norm, gradients
    and params. A fallback that summed the ranks' identical gradients
    (Megatron's *f* or *g* left in, a gather whose backward sums) would
    scale them by 3. At (1, 4), zamba2's Mamba2 leaves split over
    ``model`` (in_proj, conv_w, out_proj) take their slice of the whole
    gradient: the one-device gradient's, to float32 noise."""
    cfg, params, batch, _ = case("qwen1.5-0.5b")
    opt = AdamW(OptConfig(**OPT))
    p1, _, m1 = ST.build_train_step(cfg, opt)(params, opt.init(params),
                                              batch)
    _, g1 = ST.loss_and_grads(params, cfg, batch)
    mt, outs = mesh_step(cfg, params, batch, (1, 3))
    assert all(torch.equal(m1[k], outs[0][2][k]) for k in m1)
    for got, want in ((mt.gather([o[3] for o in outs]), g1),
                      (mt.gather([o[0] for o in outs]), p1)):
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(got),
                                                     T.leaves(want)))
    zcfg, zp, zb, _ = case("zamba2-2.7b")
    _, want = ST.loss_and_grads(zp, zcfg, zb)
    mt, outs = mesh_step(zcfg, zp, zb, (1, 4))
    got = mt.gather([o[3] for o in outs])
    for name in ("in_proj", "conv_w", "out_proj"):
        assert any(e is not None and "model" in e
                   for e in mt.specs["mamba"]["mamba"][name]), name
        a, b = got["mamba"]["mamba"][name], want["mamba"]["mamba"][name]
        assert (a - b).norm() <= 1e-5 * b.norm(), name


@pytest.fixture(scope="module")
def moe_case():
    """deepseek-moe-16b with row 1 one repeated token: its 48 tokens
    route to the same experts, which overflow within row 2 — so the
    rows' order in the dispatch decides which slots drop."""
    cfg, params, batch, jcfg, jp, jb = family("deepseek-moe-16b", batch=B,
                                              jit_init=True)
    tokens = np.array(jb["tokens"])
    tokens[1] = 5
    jb = {**jb, "tokens": jnp.asarray(tokens)}
    batch = {**batch, "tokens": torch.from_numpy(tokens)}
    return cfg, params, batch, reference(cfg, params, batch, jcfg, jp, jb)


def _drops(monkeypatch, cfg, params, batch):
    """Routed slots dropped by each one-device MoE dispatch."""
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
    return drops


def test_moe_on_the_pod_axis_drops_pod_major(monkeypatch, moe_case):
    """deepseek-moe-16b at (pod, data, model) = (2, 2, 1): rank r takes
    block ``pod * 2 + data`` of every microbatch's rows, and the
    dispatch numbers its slots after the lower blocks' — the
    reference's ``P(("pod", "data"))``. With routed slots dropping, the
    step matches the reference; the same step with the rows dealt
    data-major (block ``data * 2 + pod``) puts rows 1 and 2 the other
    way round in the dispatch, drops other slots and does not."""
    cfg, params, batch, want = moe_case
    assert cfg.moe_capacity_factor == 1.25
    drops = _drops(monkeypatch, cfg, params, batch)
    assert drops and min(drops) > 0, drops
    mt, outs = mesh_step(cfg, params, batch, (2, 2, 1))
    assert [mt.fsdp_index(r) for r in range(4)] == [0, 1, 2, 3]
    assert [mt.mesh.coords(r) for r in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    check(mt, outs, want)

    def data_major(self, rank):
        p, d, _ = self.mesh.coords(rank)
        return d * self.mesh.shape[0] + p

    monkeypatch.setattr(ST.MeshTrain, "fsdp_index", data_major)
    mt, outs = mesh_step(cfg, params, batch, (2, 2, 1))
    with pytest.raises(AssertionError):
        check(mt, outs, want)
