"""nemotron-4-340b's attention geometry — head dim 192, 12 query heads a
KV head — in K1–K4's plain versions (the CPU path of
``repro_torch.kernels.ops``) against the JAX Pallas kernels in interpret
mode and the JAX model functions; the kernels' contract and launch plans
at that geometry (pure Python); and the position-split entries of K1
(rolling, shards of no whole split) and K4 over ``("cpu",) * n`` mesh
ranks against the whole cache's Pallas results."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as kpre

TOL = dict(atol=2e-5, rtol=2e-5)   # float32, as tests/test_torch_kernels.py
DH = 192


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hq,hkv", [(12, 1), (24, 2)])
def test_decode_dh192_g12_plain_matches_pallas_and_model(hq, hkv):
    b, cap = 3, 48
    q, kc, vc, ek, ev = _inputs(1, (b, 1, hq, DH), (b, cap, hkv, DH),
                                (b, cap, hkv, DH), (b, 1, hkv, DH),
                                (b, 1, hkv, DH))
    lens = np.array([cap, 19, 1], np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, ek, ev, lens)]
    j = [jnp.asarray(a) for a in (q, kc, vc, ek, ev, lens)]
    _close(ops.decode_attention(t[0], t[1], t[2], t[5]),
           jops.decode_attention(j[0], j[1], j[2], j[5], block_s=16))
    _close(ops.decode_attention(t[0], t[1], t[2], t[5], extra_k=t[3],
                                extra_v=t[4]),
           jattn.decode_attention(j[0], j[1], j[2], j[5], extra_k=j[3],
                                  extra_v=j[4]))
    # the rolling cache of a window equal to the capacity, full rows
    roll = np.array([cap + 5, 2 * cap, 30], np.int32)
    _close(ops.decode_attention(t[0], t[1], t[2], torch.from_numpy(roll),
                                extra_k=t[3], extra_v=t[4], window=cap),
           jattn.decode_attention(j[0], j[1], j[2], jnp.asarray(roll),
                                  extra_k=j[3], extra_v=j[4], window=cap))


def test_paged_decode_dh192_g12_plain_matches_pallas():
    b, nb, bs, w, hq, hkv = 3, 10, 8, 4, 12, 1
    q, kp, vp = _inputs(2, (b, 1, hq, DH), (nb, bs, hkv, DH),
                        (nb, bs, hkv, DH))
    lens = np.array([w * bs, 13, 1], np.int32)
    tab = np.full((b, w), nb, np.int32)
    tab[0], tab[1, :2], tab[2, :1] = [3, 9, 0, 6], [1, 8], [4]
    t = [torch.from_numpy(a) for a in (q, kp, vp, tab, lens)]
    j = [jnp.asarray(a) for a in (q, kp, vp, tab, lens)]
    _close(ops.paged_decode_attention(*t), jops.paged_decode_attention(*j))


@pytest.mark.parametrize("sq,sk,causal,window", [
    (40, 40, True, None), (48, 48, True, 16), (16, 40, False, None)])
def test_flash_dh192_plain_matches_pallas(sq, sk, causal, window):
    q, k, v = _inputs(3, (1, sq, 12, DH), (1, sk, 1, DH), (1, sk, 1, DH))
    off = sk - sq if causal else 0
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, q_offset=off)
    _close(got, jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, q_offset=off,
                                     block_q=16, block_k=16))


@pytest.mark.parametrize("s", [16, 3])
def test_prefill_dh192_plain_matches_pallas_and_model(s):
    b, c, hq, hkv = 3, 40, 12, 1
    q, kh, vh, ks, vs = _inputs(4, (b, s, hq, DH), (b, c, hkv, DH),
                                (b, c, hkv, DH), (b, s, hkv, DH),
                                (b, s, hkv, DH))
    hist = np.array([0, 17, c], np.int32)
    t = [torch.from_numpy(a) for a in (q, kh, vh, hist, ks, vs)]
    j = [jnp.asarray(a) for a in (q, kh, vh, hist, ks, vs)]
    got = ops.prefill_attention(*t)
    _close(got, jops.prefill_attention(*j))
    _close(got, jattn.prefill_over_cache(*j))


def test_contract_and_plans_at_dh192_g12():
    """Every K1–K4 takes Dh 192 and K1 / K2 G up to 12 there (8 at the
    other head dims, where no registry model has more); a Dh or G past
    them is refused, never run. K1 / K2's split and K4's launch shape do
    not depend on the head geometry."""
    assert DH in kdec.HEAD_DIMS and DH in kfa.HEAD_DIMS
    assert DH in kpre.HEAD_DIMS and kdec.WIDE[DH] >= 12
    q = torch.empty(2, 1, 96, DH, device="meta")
    assert kdec.check_operands("k1", q, (2, 64, 8, DH), None, None) == ()
    with pytest.raises(ValueError, match="G <= 12"):
        kdec.check_operands("k1", torch.empty(2, 1, 104, DH, device="meta"),
                            (2, 64, 8, DH), None, None)
    with pytest.raises(ValueError, match="G <= 8"):
        kdec.check_operands("k1", torch.empty(2, 1, 96, 128, device="meta"),
                            (2, 64, 8, 128), None, None)
    with pytest.raises(ValueError, match="Dh=160"):
        kdec.check_operands("k1", torch.empty(2, 1, 96, 160, device="meta"),
                            (2, 64, 8, 160), None, None)
    # nemotron's decode: 8 KV heads; 8 rows stay in the one-tile splits
    for b, split in ((1, 32), (8, 32), (9, 128)):
        assert kdec.launch_plan(b, 8, 4096).split == split
    plan = kpre.launch_plan(8, 5, 1024, 96, DH, torch.bfloat16)
    assert plan.splits and plan.ns == 8
    assert plan.o_shape == (8, 96, 5, 9, DH)
    assert not kpre.launch_plan(1, 256, 1024, 96, DH, torch.bfloat16).splits
    assert not kpre.launch_plan(8, 5, 1024, 96, DH, torch.float32).splits


def _sharded(n, fn):
    mesh = DeviceMesh((1, n), ("cpu",) * n)
    try:
        return mesh.run(lambda r: fn(
            r, lambda t, d: mesh.all_gather(t.contiguous(), d, "model")))
    finally:
        mesh.close()


@pytest.mark.parametrize("n", [3, 4])
def test_shard_entries_match_pallas(n):
    """K1's and K4's position-split entries, each shard a rank of a
    (1, n) mesh, against the whole cache's Pallas and model results:
    K1 rolling or not, K4 at a verify and a chunk width."""
    b, c, hq, hkv = 3, 48, 12, 1
    w = c // n
    q, kc, vc, ek, ev = _inputs(5, (b, 1, hq, DH), (b, c, hkv, DH),
                                (b, c, hkv, DH), (b, 1, hkv, DH),
                                (b, 1, hkv, DH))
    t = [torch.from_numpy(a) for a in (q, kc, vc, ek, ev)]
    j = [jnp.asarray(a) for a in (q, kc, vc, ek, ev)]
    for window, lens in ((None, [48, 20, 1]), (c, [60, 96, 47])):
        lens = np.array(lens, np.int32)
        outs = _sharded(n, lambda r, g: ops.decode_attention_shard(
            t[0], t[1][:, r * w:(r + 1) * w], t[2][:, r * w:(r + 1) * w],
            torch.from_numpy(lens), offset=r * w, capacity=c, gather=g,
            extra_k=t[3], extra_v=t[4], window=window))
        assert all(torch.equal(o, outs[0]) for o in outs)
        _close(outs[0], jattn.decode_attention(
            j[0], j[1], j[2], jnp.asarray(lens), extra_k=j[3],
            extra_v=j[4], window=window))
    for s in (4, 16):
        qs, ks, vs = _inputs(6, (b, s, hq, DH), (b, s, hkv, DH),
                             (b, s, hkv, DH))
        hist = np.array([0, 29, c], np.int32)
        ts = [torch.from_numpy(a) for a in (qs, ks, vs)]
        outs = _sharded(n, lambda r, g: ops.prefill_attention_shard(
            ts[0], t[1][:, r * w:(r + 1) * w], t[2][:, r * w:(r + 1) * w],
            torch.from_numpy(hist), ts[1], ts[2], offset=r * w, gather=g))
        assert all(torch.equal(o, outs[0]) for o in outs)
        _close(outs[0], jops.prefill_attention(
            jnp.asarray(qs), j[1], j[2], jnp.asarray(hist), jnp.asarray(ks),
            jnp.asarray(vs)))
