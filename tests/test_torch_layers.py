"""The port's norms and MLPs against ``repro.models.layers`` (float32 and
bf16, CPU): LayerNorm and the LayerNorm arm of the fused add + norm, and
the swiglu / geglu / gelu (tanh) / squared_relu MLPs with their
two- or three-matrix params."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers as L

ATOL = 1e-4      # float32, elementwise
BF16_REL = 1e-2  # bf16, normwise: a few bf16 roundings (2^-8 each)
ACTIVATIONS = ("swiglu", "geglu", "gelu", "squared_relu")


def _cfgs(arch, **kw):
    return (jreg.get_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    got, want = got.float().numpy(), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL, rel


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = JL.layernorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                        jnp.asarray(b, jdt))
    got = L.layernorm(_t(x, dtype), _t(w, dtype), _t(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_norm_layernorm_sum_is_torchs_and_h_matches(dtype):
    """dbrx's norm: ``s`` is bitwise torch's ``x + a``, ``h`` the
    reference's ``apply_norm`` of that sum; no ``a`` gives ``s = x``."""
    jcfg, cfg = _cfgs("dbrx-132b", dtype=dtype)
    assert cfg.norm == "layernorm"
    rng = np.random.default_rng(1)
    x, a = (_t(rng.standard_normal((2, 7, cfg.d_model)), dtype)
            for _ in range(2))
    p = {"w": _t(rng.standard_normal(cfg.d_model), dtype),
         "b": _t(rng.standard_normal(cfg.d_model), dtype)}
    s, h = L.add_norm(p, cfg, x, a)
    assert torch.equal(s, x + a) and h.dtype == x.dtype
    jp = {k: jnp.asarray(v.float().numpy(), jnp.dtype(dtype))
          for k, v in p.items()}
    want = JL.apply_norm(jp, jcfg, jnp.asarray(s.float().numpy(),
                                               jnp.dtype(dtype)))
    _close(h, want, dtype)
    s0, h0 = L.add_norm(p, cfg, x)
    assert s0 is x
    assert torch.equal(h0, L.add_norm(p, cfg, x, torch.zeros_like(x))[1])
    # a float32 residual normalised into a bf16 operand
    _, hb = L.add_norm(p, cfg, x.float(), out_dtype=torch.bfloat16)
    assert hb.dtype == torch.bfloat16


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_init_norm_leaves_match_reference(norm):
    jcfg, cfg = _cfgs("qwen1.5-0.5b", norm=norm)
    want = JL.init_norm(jax.random.PRNGKey(0), jcfg)
    got = L.init_norm(cfg, (3,), "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == (3, *want[k].shape)
        np.testing.assert_array_equal(got[k][1].float().numpy(), _np(want[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_mlp_matches_reference(act, dtype):
    """Each activation on bridged weights (the reference's own init: two
    matrices for gelu and squared_relu, three for the gated ones)."""
    jcfg, cfg = _cfgs("qwen1.5-0.5b", activation=act, dtype=dtype)
    jp = jax.device_get(JL.init_mlp(jax.random.PRNGKey(2), jcfg))
    own = L.init_mlp(torch.Generator().manual_seed(0), cfg, cfg.d_ff,
                     device="cpu")
    assert own.keys() == jp.keys()
    assert all(tuple(own[k].shape) == jp[k].shape
               and own[k].dtype == getattr(torch, dtype) for k in jp)
    tp = bridge.params_from_jax(jp, cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                        jnp.asarray(x, jnp.dtype(dtype)))
    got = L.apply_mlp(tp, cfg, _t(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(L.gelu(x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
                               atol=1e-6, rtol=0)
    assert not torch.allclose(L.gelu(x), torch.nn.functional.gelu(x),
                              atol=1e-5, rtol=0)
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(
        activation="relu6")
    with pytest.raises(ValueError, match="unknown activation"):
        L.apply_mlp({"w_up": torch.zeros(cfg.d_model, 4),
                     "w_down": torch.zeros(4, cfg.d_model)}, cfg,
                    torch.zeros(1, cfg.d_model))
