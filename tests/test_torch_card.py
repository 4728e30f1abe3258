"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. Marked ``cuda``; skips itself without CUDA. Imports no JAX, so
it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_on_card(card, dtype, tol):
    g = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    x, w = rnd(8, 1024), rnd(1024)
    cases = [(ops.rmsnorm(x, w), ref.rmsnorm(x, w))]
    q, k, v = rnd(1, 200, 8, 64), rnd(1, 200, 2, 64), rnd(1, 200, 2, 64)
    cases.append((ops.flash_attention(q, k, v, window=64),
                  ref.flash_attention(q, k, v, window=64)))
    q, kc, vc = rnd(4, 1, 8, 64), rnd(4, 300, 2, 64), rnd(4, 300, 2, 64)
    ek, ev = rnd(4, 1, 2, 64), rnd(4, 1, 2, 64)
    lens = torch.tensor([300, 129, 1, 0], dtype=torch.int32, device=card)
    cases.append((
        ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev),
        ref.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)))
    for got, want in cases:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _scatter_to_pool(dense, bs, nb, lens, gen):
    """A pool of ``nb`` blocks holding ``dense``'s (B, W*bs, H, Dh) rows
    at seeded, scattered block ids; table entries past each row's length
    are the sentinel ``nb``."""
    b, cap = dense.shape[:2]
    w = cap // bs
    perm = torch.randperm(nb, generator=gen, device="cpu")[:b * w]
    tab = perm.reshape(b, w).to(torch.int32)
    pool = torch.zeros((nb, bs, *dense.shape[2:]), dtype=dense.dtype,
                       device=dense.device)
    pool[tab.reshape(-1).long().to(dense.device)] = dense.reshape(
        b * w, bs, *dense.shape[2:])
    for i, n in enumerate(lens):
        tab[i, -(-int(n) // bs):] = nb
    return pool, tab.to(dense.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_paged_decode_is_bitwise_contiguous_decode(card, dtype, tol):
    """K2 on scattered pool blocks == K1 on the dense copy of the same
    rows, bit for bit; and within tolerance of its plain version."""
    g = torch.Generator(device=card).manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    b, cap, bs, hkv, hq, dh = 4, 304, 16, 2, 8, 64
    q, kc, vc = rnd(b, 1, hq, dh), rnd(b, cap, hkv, dh), rnd(b, cap, hkv, dh)
    ek, ev = rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    lens = torch.tensor([304, 129, 1, 0], dtype=torch.int32, device=card)
    kp, tab = _scatter_to_pool(kc, bs, 80, lens.tolist(), cpu_gen)
    vp, _ = _scatter_to_pool(vc, bs, 80, lens.tolist(),
                             torch.Generator().manual_seed(1))
    got = ops.paged_decode_attention(q, kp, vp, tab, lens, extra_k=ek,
                                     extra_v=ev)
    assert torch.equal(got, ops.decode_attention(q, kc, vc, lens,
                                                 extra_k=ek, extra_v=ev))
    want = ref.paged_decode_attention(q, kp, vp, tab, lens, extra_k=ek,
                                      extra_v=ev)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("s", [5, 40, 200])
def test_prefill_attention_matches_plain_on_card(card, dtype, tol, s):
    g = torch.Generator(device=card).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    b, c, hkv, hq, dh = 3, 300, 2, 8, 64
    q, ks, vs = rnd(b, s, hq, dh), rnd(b, s, hkv, dh), rnd(b, s, hkv, dh)
    kh, vh = rnd(b, c, hkv, dh), rnd(b, c, hkv, dh)
    for hist_len in (torch.tensor([0, 129, 300], dtype=torch.int32,
                                  device=card), 77):
        got = ops.prefill_attention(q, kh, vh, hist_len, ks, vs)
        want = ref.prefill_attention(q, kh, vh, hist_len, ks, vs)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,k,n,group", [(1, 3072, 8192, 128),
                                         (8, 3072, 8192, 128),
                                         (3, 512, 320, 64),
                                         (1, 1024, 200, 256)])
def test_quant_gemv_matches_plain_on_card(card, dtype, tol, b, k, n, group):
    """K6 against its plain version; N = 320 and 200 leave a ragged
    column tile."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((b, k), generator=g, device=card).to(dtype)
    w = torch.randn((k, n), generator=g, device=card) / k ** 0.5
    packed, scales = ref.quantize_int4(w, group=group)
    got = ops.quant_gemv(x, packed, scales, group=group)
    want = ref.quant_gemv(x, packed, scales, group=group)
    assert got.dtype == dtype and tuple(got.shape) == (b, n)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_head_dim_96_kernels_match_plain_on_card(card, dtype, tol):
    """K3 and K1 at phi3-mini's head dim, and K2 bitwise K1 there."""
    g = torch.Generator(device=card).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    q, k, v = rnd(1, 200, 4, 96), rnd(1, 200, 4, 96), rnd(1, 200, 4, 96)
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               ref.flash_attention(q, k, v).float(),
                               atol=tol, rtol=tol)
    b, cap, bs, h = 4, 304, 16, 4
    q, kc, vc = rnd(b, 1, h, 96), rnd(b, cap, h, 96), rnd(b, cap, h, 96)
    ek, ev = rnd(b, 1, h, 96), rnd(b, 1, h, 96)
    lens = torch.tensor([304, 129, 1, 0], dtype=torch.int32, device=card)
    got = ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    want = ref.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    kp, tab = _scatter_to_pool(kc, bs, 80, lens.tolist(),
                               torch.Generator().manual_seed(4))
    vp, _ = _scatter_to_pool(vc, bs, 80, lens.tolist(),
                             torch.Generator().manual_seed(4))
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, tab, lens,
                                                  extra_k=ek, extra_v=ev),
                       got)
