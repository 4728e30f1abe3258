"""K1–K4 at nemotron-4-340b's head geometry (Dh 192, G 12) and the
position-split entries of K1 and K4 against their plain versions on the
card. Marked ``cuda``; skips itself without CUDA. Imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_dh192_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.kernels import ops, ref

TOLS = [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return torch.device("cuda")


def _rnd(card, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)
    return rnd


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("hq,hkv", [(96, 8), (12, 1), (16, 16)])
def test_decode_dh192_matches_plain_and_paged_is_bitwise(card, dtype, tol,
                                                         hq, hkv):
    rnd = _rnd(card, dtype, 1)
    b, cap, dh = 3, 320, 192
    q, kc, vc = rnd(b, 1, hq, dh), rnd(b, cap, hkv, dh), rnd(b, cap, hkv, dh)
    ek, ev = rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    lens = torch.tensor([320, 129, 1], dtype=torch.int32, device=card)
    got = ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    _close(got, ref.decode_attention(q, kc, vc, lens, extra_k=ek,
                                     extra_v=ev), tol)
    # the same rows through a block table: bitwise K1
    bs, w = 16, cap // 16
    tab = torch.arange(b * w, dtype=torch.int32, device=card).reshape(b, w)
    pool_k = kc.reshape(b * w, bs, hkv, dh)
    pool_v = vc.reshape(b * w, bs, hkv, dh)
    paged = ops.paged_decode_attention(q, pool_k, pool_v, tab, lens,
                                       extra_k=ek, extra_v=ev)
    assert torch.equal(paged, got)
    # a rolling cache, full and not
    for lens in ([320, 700], [319, 320]):
        lens = torch.tensor(lens[:1] * 2 + lens[1:], dtype=torch.int32,
                            device=card)
        _close(ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev,
                                    window=cap),
               ref.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev,
                                    window=cap), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("sq,skv,causal,window", [
    (200, 200, True, None), (512, 512, True, 64), (64, 300, False, None),
    (1, 257, True, None)])
def test_flash_dh192_matches_plain(card, dtype, tol, sq, skv, causal,
                                   window):
    rnd = _rnd(card, dtype, 2)
    q, k, v = rnd(2, sq, 12, 192), rnd(2, skv, 1, 192), rnd(2, skv, 1, 192)
    off = skv - sq if causal else 0
    _close(ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=off),
           ref.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=off), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("s", [1, 5, 16, 17, 64, 256])
def test_prefill_dh192_matches_plain(card, dtype, tol, s):
    rnd = _rnd(card, dtype, 3)
    b, c, hq, hkv, dh = 2, 384, 12, 1, 192
    q, kh, vh = rnd(b, s, hq, dh), rnd(b, c, hkv, dh), rnd(b, c, hkv, dh)
    ks, vs = rnd(b, s, hkv, dh), rnd(b, s, hkv, dh)
    hl = torch.tensor([300, 17], dtype=torch.int32, device=card)
    _close(ops.prefill_attention(q, kh, vh, hl, ks, vs),
           ref.prefill_attention(q, kh, vh, hl, ks, vs), tol)


def _sharded(card, n, fn):
    """``fn(rank, gather)`` on ``n`` position shards of one card, each
    rank on its own thread of a (1, n) mesh; every rank's result."""
    mesh = DeviceMesh((1, n), (card,) * n)
    try:
        return mesh.run(lambda r: fn(
            r, lambda t, d: mesh.all_gather(t.contiguous(), d, "model")))
    finally:
        mesh.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("dh,n", [(64, 3), (192, 4), (128, 8)])
def test_shard_entries_match_plain(card, dtype, tol, dh, n):
    """K1 over shards that hold no whole splits, rolling or not, and K4's
    partials and merge, against the whole cache's plain version; every
    shard returns the same bits."""
    rnd = _rnd(card, dtype, 4)
    b, hq, hkv, c = 3, 8, 2, 96
    q, kc, vc = rnd(b, 1, hq, dh), rnd(b, c, hkv, dh), rnd(b, c, hkv, dh)
    ek, ev = rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    w = c // n
    for window, lens in ((None, [96, 40, 1]), (c, [96, 200, 50])):
        lens = torch.tensor(lens, dtype=torch.int32, device=card)
        outs = _sharded(card, n, lambda r, g: ops.decode_attention_shard(
            q, kc[:, r * w:(r + 1) * w].contiguous(),
            vc[:, r * w:(r + 1) * w].contiguous(), lens, offset=r * w,
            capacity=c, gather=g, extra_k=ek, extra_v=ev, window=window))
        assert all(torch.equal(o, outs[0]) for o in outs)
        _close(outs[0], ref.decode_attention(q, kc, vc, lens, extra_k=ek,
                                             extra_v=ev, window=window), tol)
    s = 5
    qs, ks, vs = rnd(b, s, hq, dh), rnd(b, s, hkv, dh), rnd(b, s, hkv, dh)
    hl = torch.tensor([90, 13, 0], dtype=torch.int32, device=card)
    outs = _sharded(card, n, lambda r, g: ops.prefill_attention_shard(
        qs, kc[:, r * w:(r + 1) * w].contiguous(),
        vc[:, r * w:(r + 1) * w].contiguous(), hl, ks, vs, offset=r * w,
        gather=g))
    assert all(torch.equal(o, outs[0]) for o in outs)
    _close(outs[0], ref.prefill_attention(qs, kc, vc, hl, ks, vs), tol)
