"""Port W4A16 mobile decode (``repro_torch.models.w4`` and
``examples/torch_w4_mobile_decode.py``) against the JAX example
``examples/w4_mobile_decode.py`` on bridged weights, at the example's
``run()`` config (phi3-mini smoke, d_model 128, 4 heads of 32, d_ff 256,
float32, group 64) on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_w4_mobile_decode as tw4
import w4_mobile_decode as jw4
from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.models import w4

GROUP = 64
# log-softmax of the float32 logits: each GEMV output is rounded to bf16
# on both sides, but the two sum in different orders, so an output that
# sits near a bf16 rounding boundary may round one ulp (2^-8 relative)
# apart; that moves a log-prob by far less than this
LOGPROB_ATOL = 1e-3


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def setup():
    cfg = tw4.run_config()
    jcfg = jreg.get_smoke_config("phi3-mini-3.8b").replace(
        dtype="float32", d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256)
    jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    jqp = dict(jp, layers=jw4.quantize_layer_stack(jp["layers"], GROUP))
    tp = bridge.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    tqp = bridge.params_from_jax(jax.device_get(jqp), cfg, device="cpu")
    return jcfg, jp, jqp, cfg, tp, tqp


@pytest.fixture(scope="module")
def decoded(setup):
    """One JAX prefill shared by both sides, then 2 teacher-forced W4
    steps on each (the JAX one through Pallas interpret): per step the
    (JAX, port) logits, and both caches at the end."""
    jcfg, jp, jqp, cfg, tp, tqp = setup
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 12)).astype(np.int32)
    logits, jcache = JMD.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                 32)
    cache = {k: torch.from_numpy(np.array(v))
             for k, v in jax.device_get(jcache).items()}
    tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
    steps = []
    for _ in range(2):
        want, jcache = jw4.w4_decode_step(jqp, jcfg, jnp.asarray(tok),
                                          jcache, GROUP)
        got, cache = w4.w4_decode_step(tqp, cfg, torch.from_numpy(tok),
                                       cache, GROUP)
        steps.append((np.asarray(want), got.numpy()))
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    return steps, jax.device_get(jcache), cache


def test_bridge_carries_the_quantized_tree_both_ways(setup):
    jcfg, jp, jqp, cfg, tp, tqp = setup
    wq = tqp["layers"]["attn"]["wq"]
    assert wq["__w4__"] is True
    assert wq["packed"].dtype == torch.uint8
    assert tuple(wq["packed"].shape) == (cfg.n_layers, cfg.d_model // 2,
                                         cfg.n_heads * cfg.d_head)
    assert tuple(wq["scales"].shape) == (cfg.n_layers, cfg.d_model // GROUP,
                                         cfg.n_heads * cfg.d_head)
    want = dict(_leaves(jax.device_get(jqp)))
    got = dict(_leaves(bridge.params_to_numpy(tqp)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        if isinstance(leaf, bool):
            assert got[path] is leaf, path
        else:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), path)


def test_quantize_layer_stack_is_the_examples_byte_for_byte(setup):
    jcfg, jp, jqp, cfg, tp, tqp = setup
    got = dict(_leaves(w4.quantize_layer_stack(tp["layers"], GROUP)))
    want = dict(_leaves(tqp["layers"]))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        if isinstance(leaf, bool):
            assert got[path] is leaf, path
        else:
            assert got[path].dtype == leaf.dtype, path
            assert torch.equal(got[path], leaf), path
    assert {p.split("/")[2] for p in got if p.endswith("__w4__")} \
        == w4.PROJ_NAMES


def test_w4_decode_step_matches_the_example(decoded):
    steps, jcache, cache = decoded
    for want, got in steps:
        np.testing.assert_allclose(
            torch.log_softmax(torch.from_numpy(got), -1).numpy(),
            np.asarray(jax.nn.log_softmax(want)), atol=LOGPROB_ATOL, rtol=0)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
    assert int(cache["len"]) == int(jcache["len"]) == 14
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), jcache[name],
                                   atol=1e-4, rtol=0)


def test_run_on_cpu_reports_per_step_fidelity():
    corr, mad = tw4.run(n_steps=2, device="cpu", verbose=False)
    assert len(corr) == len(mad) == 2
    assert all(np.isfinite(corr)) and all(0.5 < c <= 1.0 for c in corr)
    assert all(np.isfinite(mad)) and all(m >= 0 for m in mad)


def test_bf16_params_quantize_to_a_float32_rest_and_decode_on_cpu():
    """A bf16 model: the quantized tree keeps only packed int4 and fp32
    leaves, the W4 step runs on it with the plain versions, launches no
    kernel, and writes the token's KV in the cache's dtype."""
    cfg = registry.get_smoke_config("phi3-mini-3.8b")
    assert cfg.dtype == "bfloat16"
    params = MD.init_params(cfg, seed=1, device="cpu")
    qp = w4.quantize_params(params, GROUP)
    for path, leaf in _leaves(qp):
        if isinstance(leaf, torch.Tensor):
            assert leaf.dtype in (torch.float32, torch.uint8), path
    toks = torch.tensor([[3, 7, 11, 5]], dtype=torch.int32)
    logits, cache = MD.prefill(params, cfg, {"tokens": toks}, 16)
    ops.reset_launch_counts()
    res = tw4.teacher_forced(params, qp, cfg, logits, cache, 2, GROUP)
    assert all(not any(c.values()) for c in res["w4_launches"])
    assert all(torch.isfinite(lb).all() for lb in res["w4"])
    assert int(cache["len"]) == 4     # teacher_forced works on copies
    _, c2 = w4.w4_decode_step(qp, cfg, res["tokens"][0], cache, GROUP)
    assert c2["k"].dtype == torch.bfloat16 and int(c2["len"]) == 5
    assert c2["k"][:, :, 4].abs().sum() > 0
