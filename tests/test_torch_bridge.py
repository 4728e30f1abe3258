"""Params bridge between the JAX reference and the port."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JMD
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import model as MD


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b").replace(dtype=dtype)
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype=dtype)
    jp = jax.device_get(JMD.init_params(jax.random.PRNGKey(7), jcfg))
    tp = bridge.params_from_jax(jp, cfg, device="cpu")
    back = bridge.params_to_numpy(tp)
    want = dict(_leaves(jp))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    # the port's own init has the same keys, shapes and dtypes
    own = dict(_leaves(MD.init_params(cfg, seed=0, device="cpu")))
    assert own.keys() == want.keys()
    for path, t in _leaves(tp):
        assert tuple(t.shape) == want[path].shape, path
        assert t.dtype == own[path].dtype == getattr(torch, dtype), path
        assert tuple(own[path].shape) == want[path].shape, path
        # bit-exact both ways (bf16 comes back widened to float32)
        np.testing.assert_array_equal(
            got[path], np.asarray(want[path]).astype(np.float32), path)
    assert tp["layers"]["attn"]["wq"].shape[0] == cfg.n_layers


def test_bridge_rejects_wrong_layer_axis():
    cfg = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")
    jp = jax.device_get(JMD.init_params(jax.random.PRNGKey(0), jreg.get_smoke_config(
        "qwen1.5-0.5b").replace(dtype="float32")))
    with pytest.raises(ValueError, match="n_layers"):
        bridge.params_from_jax(jp, cfg.replace(n_layers=3), device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_moe_params_round_trip_bf16(arch):
    """An MoE tree — deepseek's leading dense ``first_layers`` (a list)
    and its stack of n_layers - 1 — both ways, bf16 bit for bit."""
    jcfg = jreg.get_smoke_config(arch).replace(dtype="bfloat16")
    cfg = registry.get_smoke_config(arch).replace(dtype="bfloat16")
    jp = jax.device_get(JMD.init_params(jax.random.PRNGKey(7), jcfg))
    tp = bridge.params_from_jax(jp, cfg, device="cpu")
    assert isinstance(tp.get("first_layers", []), list)
    n_first = len(jp.get("first_layers", []))
    assert n_first == cfg.first_dense_layers
    assert tp["layers"]["moe"]["w_gate"].shape[0] == cfg.n_layers - n_first
    want = dict(_leaves(jp))
    got = dict(_leaves(bridge.params_to_numpy(tp)))
    assert got.keys() == want.keys()
    for path, t in _leaves(tp):
        # the router stays float32, every other leaf is bf16
        assert t.dtype == (torch.float32 if path.endswith("/router")
                           else torch.bfloat16), path
        np.testing.assert_array_equal(
            got[path], np.asarray(want[path]).astype(np.float32), path)
    with pytest.raises(ValueError, match="first dense layers"):
        bridge.params_from_jax(jp, cfg.replace(n_layers=cfg.n_layers + 1),
                               device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_params_round_trip(dtype):
    """Whisper's tree — the stacked encoder ``enc_layers``, ``enc_norm``
    and each decoder layer's ``ln_x`` / ``xattn`` — both ways, bit for
    bit, with the keys, shapes and dtypes of the port's own init; a
    wrong encoder depth is refused."""
    jcfg = jreg.get_smoke_config("whisper-large-v3").replace(dtype=dtype)
    cfg = registry.get_smoke_config("whisper-large-v3").replace(dtype=dtype)
    jp = jax.device_get(JMD.init_params(jax.random.PRNGKey(7), jcfg))
    tp = bridge.params_from_jax(jp, cfg, device="cpu")
    want = dict(_leaves(jp))
    got = dict(_leaves(bridge.params_to_numpy(tp)))
    own = dict(_leaves(MD.init_params(cfg, seed=0, device="cpu")))
    assert got.keys() == want.keys() == own.keys()
    assert {"/enc_norm/w", "/enc_norm/b", "/layers/ln_x/w",
            "/layers/xattn/wq"} <= want.keys()
    for path, t in _leaves(tp):
        assert tuple(t.shape) == tuple(own[path].shape) == want[path].shape
        assert t.dtype == own[path].dtype == getattr(torch, dtype), path
        np.testing.assert_array_equal(
            got[path], np.asarray(want[path]).astype(np.float32), path)
    assert tp["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_encoder_layers
    with pytest.raises(ValueError, match="n_encoder_layers"):
        bridge.params_from_jax(
            jp, cfg.replace(n_encoder_layers=cfg.n_encoder_layers + 1),
            device="cpu")
