"""The training substrate against the JAX reference on the CPU: the
cosine schedule, AdamW over three steps (float32 and bf16 moments,
bf16 params, weight decay on matrices only, the global-norm clip),
int8 gradient compression with error feedback (codes bit for bit), and
the synthetic data stream (batches bit for bit: the port's copy of the
numpy-only pipeline). Float32 results within 1e-6 relative; a bf16
moment or param may sit one rounding apart."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import make_train_stream as jstream
from repro.distributed import compression as JC
from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro.optim import cosine_schedule as jcos
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.data import host_shard_slice, make_train_stream
from repro_torch.distributed import compression as C
from repro_torch.optim import AdamW, OptConfig, cosine_schedule


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    steps = np.arange(0, total + 20, 3)
    want = np.asarray([float(jcos(s, base_lr=3e-3, warmup_steps=warmup,
                                  total_steps=total)) for s in steps])
    got = cosine_schedule(torch.from_numpy(steps), base_lr=3e-3,
                          warmup_steps=warmup, total_steps=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _tree(rng, dt):
    """A params-like tree: matrices (decayed), vectors and a list."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"w": arr(8, 16), "b": arr(16),
            "layers": [{"k": arr(3, 4, 5)}, {"k": arr(3, 4, 5)}],
            "n": {"w": arr(16)}}


@pytest.mark.parametrize("moments,pdt", [("float32", "float32"),
                                         ("bfloat16", "float32"),
                                         ("float32", "bfloat16")])
def test_adamw_three_steps_match_jax(moments, pdt):
    rng = np.random.default_rng(0)
    p0 = _tree(rng, pdt)
    grads = [jax.tree.map(lambda a, i=i: a * (i + 1), _tree(rng, pdt))
             for i in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=0.5, moment_dtype=moments)
    jopt, opt = JAdamW(JOpt(**kw)), AdamW(OptConfig(**kw))
    jdt, tdt = jnp.dtype(pdt), getattr(torch, pdt)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = T.tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    js, ts = jopt.init(jp), opt.init(tp)
    assert ts["mu"]["w"].dtype == getattr(torch, moments)
    assert ts["step"].dtype == torch.int32
    for g in grads:
        jp, js, jstats = jopt.apply(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g), js, jp)
        tp, ts, tstats = opt.apply(
            T.tree_map(lambda a: torch.from_numpy(a).to(tdt), g), ts, tp)
    tol = (dict(rtol=1e-6, atol=1e-7) if "bfloat16" not in (moments, pdt)
           else dict(rtol=1e-2, atol=1e-3))
    for (k, a), (_, b) in zip(T.paths(tp), T.paths(jax.device_get(jp))):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol,
                                   err_msg=k)
    for name in ("mu", "nu"):
        for a, b in zip(T.leaves(ts[name]),
                        T.leaves(jax.device_get(js[name]))):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert abs(tstats["grad_norm"].item() - float(jstats["grad_norm"])) \
        <= 1e-6 * float(jstats["grad_norm"])
    assert abs(tstats["lr"].item() - float(jstats["lr"])) <= 1e-9


def test_adamw_decays_matrices_only_and_leaves_inputs_alone():
    opt = AdamW(OptConfig(lr=1.0, warmup_steps=0, total_steps=1,
                          weight_decay=0.5, grad_clip=1e9))
    p = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    zero = T.tree_map(torch.zeros_like, p)
    new, _, _ = opt.apply(zero, opt.init(p), p)
    assert torch.equal(p["m"], torch.ones(2, 2))       # not in place
    # step 1 of 1: the schedule's floor, lr 0.1; a zero gradient moves
    # nothing but the decay
    assert torch.allclose(new["m"], torch.full((2, 2), 1 - 0.1 * 0.5))
    assert torch.equal(new["v"], torch.ones(2))         # no decay


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 130), 128),
                                         ((3, 4, 5), 256), ((512,), 256)])
def test_compress_codes_are_the_references_bit_for_bit(shape, block):
    rng = np.random.default_rng(1)
    g = rng.standard_normal(shape).astype(np.float32) * 1e-3
    g.reshape(-1)[:3] = 0.0
    codes, scale, shp = C.compress(torch.from_numpy(g), block)
    jcodes, jscale, jshp = JC.compress(jnp.asarray(g), block)
    assert codes.dtype == torch.int8 and shp == tuple(jshp)
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    got = C.decompress(codes, scale, shp)
    assert np.array_equal(got.numpy(),
                          np.asarray(JC.decompress(jcodes, jscale, jshp)))
    assert C.compress(torch.zeros(300), 256)[1].min().item() == np.float32(1e-12)


def test_error_feedback_over_steps_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((40, 9)).astype(np.float32),
            "b": [rng.standard_normal(300).astype(np.float32)]}
    terr = C.init_error_state(T.tree_map(torch.from_numpy, tree))
    jerr = JC.init_error_state(jax.tree.map(jnp.asarray, tree))
    for i in range(3):
        g = jax.tree.map(lambda a, i=i: a * (i + 1), tree)
        tg, terr = C.apply(T.tree_map(torch.from_numpy, g), terr, block=128)
        jg, jerr = JC.apply(jax.tree.map(jnp.asarray, g), jerr, block=128)
        for a, b in zip(T.leaves(tg), T.leaves(jax.device_get(jg))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(T.leaves(terr), T.leaves(jax.device_get(jerr))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("seed,step,host,hosts", [(0, 0, 0, 1), (0, 7, 0, 1),
                                                  (3, 2, 1, 2), (5, 11, 3, 4)])
def test_data_batches_are_the_references_bit_for_bit(seed, step, host,
                                                     hosts):
    jcfg = jreg.get_smoke_config("qwen1.5-0.5b")
    cfg = treg.get_smoke_config("qwen1.5-0.5b")
    want = jstream(jcfg, 8, 33, seed=seed, host_index=host,
                   host_count=hosts).batch_at(step)
    got = make_train_stream(cfg, 8, 33, seed=seed, host_index=host,
                            host_count=hosts).batch_at(step)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == np.int32 and got[k].shape == (8 // hosts, 33)
        assert np.array_equal(got[k], want[k])
    assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    with pytest.raises(ValueError, match="not divisible"):
        host_shard_slice(8, 0, 3)
