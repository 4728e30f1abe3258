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


# per-row history lengths of K4's card tests: empty, one position, both
# sides of the 128-position split edge, and the whole capacity
K4_C = 300
K4_HIST = [0, 1, 127, 128, 129, K4_C]


def _k4_inputs(card, dtype, s, dh, seed, c=K4_C, hq=8, hkv=2):
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    b = len(K4_HIST)
    hl = torch.tensor(K4_HIST, dtype=torch.int32, device=card).clamp(max=c)
    return (rnd(b, s, hq, dh), rnd(b, c, hkv, dh), rnd(b, c, hkv, dh), hl,
            rnd(b, s, hkv, dh), rnd(b, s, hkv, dh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dh", [64, 96, 128])
@pytest.mark.parametrize("s", [1, 5, 16, 17, 40, 64, 200, 256])
def test_prefill_attention_matches_plain_on_card(card, dtype, tol, dh, s):
    """K4 against its plain version at every head dim, on both launch
    shapes (S <= 16: history splits; S > 16: query tiles) and the tile
    edges between them, GQA 8/2, with ragged per-row history lengths
    and one scalar length."""
    q, kh, vh, hl, ks, vs = _k4_inputs(card, dtype, s, dh, seed=2)
    for hist_len in (hl, 77):
        got = ops.prefill_attention(q, kh, vh, hist_len, ks, vs)
        want = ref.prefill_attention(q, kh, vh, hist_len, ks, vs)
        torch.testing.assert_close(
            got.float(), want.float(), atol=tol, rtol=tol,
            msg=lambda m: f"hist_len={hist_len}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,k,n,group", [(1, 3072, 8192, 128),
                                         (8, 3072, 8192, 128),
                                         (3, 512, 320, 64),
                                         (1, 1024, 200, 256),
                                         (1, 3072, 8192, 32),
                                         (2, 3072, 1000, 24),
                                         (8, 3072, 512, 96),
                                         (3, 3072, 512, 3072)])
def test_quant_gemv_matches_plain_on_card(card, dtype, tol, b, k, n, group):
    """K6 against its plain version; N = 320, 200 and 1000 leave a ragged
    column tile; groups 32 and 96 take the tensor cores in bf16 (in
    batches of 2 and of 2 16-K tiles), 24 the CUDA cores, and one group
    over the whole K (per-column scales) is cut into units."""
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


def _k3_cases():
    """(sq, skv, hq, hkv, causal, window, q_offset) for K3: S at the
    64-row tile edges (self-attention, causal), GQA 8/2, a continuation
    at q_offset > 0, a window, and a non-causal call whose keys end
    mid-tile."""
    cases = [(s, s, 4, 4, True, None, 0)
             for s in (1, 15, 16, 17, 63, 64, 65, 1024)]
    cases += [(200, 200, 8, 2, True, None, 0),
              (65, 200, 8, 2, True, None, 135),
              (300, 300, 4, 4, True, 64, 0),
              (17, 130, 4, 4, False, None, 0)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dh", [64, 80, 96, 128])
def test_flash_attention_tiles_match_plain_on_card(card, dtype, tol, dh):
    """K3 against its plain version at every head dim it takes, over
    tile-edge lengths and every mask it applies."""
    g = torch.Generator(device=card).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    for sq, skv, hq, hkv, causal, window, q_off in _k3_cases():
        q = rnd(1, sq, hq, dh)
        k, v = rnd(1, skv, hkv, dh), rnd(1, skv, hkv, dh)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            got.float(), want.float(), atol=tol, rtol=tol,
            msg=lambda m: f"S={sq} Skv={skv} {hq}/{hkv} {kw}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [5, 64])
def test_prefill_attention_is_deterministic_and_layout_free(card, dtype, s):
    """K4 twice on the same inputs is bit-for-bit the same, and K4 over a
    block-table gather of the history rows from a larger pool (a longer
    view whose tail is other blocks' data) is bit-for-bit K4 over the
    contiguous rows: splits and tiles start at fixed positions."""
    q, kh, vh, hl, ks, vs = _k4_inputs(card, dtype, s, 96, seed=8, c=304,
                                       hq=32, hkv=32)
    first = ops.prefill_attention(q, kh, vh, hl, ks, vs)
    assert torch.equal(first, ops.prefill_attention(q, kh, vh, hl, ks, vs))
    # the rows in a pool twice the size they need, read back through
    # tables 3 blocks wider than the capacity: the view a paged dispatch
    # gathers, whose tail past each row's length is other blocks' data
    b, c = kh.shape[:2]
    nb = 2 * b * (c // 16 + 3)
    kg, vg = (ref.gather_kv_blocks(*_scatter_to_pool(
        torch.cat([x, x[:, :48]], 1), 16, nb, hl.tolist(),
        torch.Generator().manual_seed(7))) for x in (kh, vh))
    assert kg.shape[1] == c + 48
    assert torch.equal(first, ops.prefill_attention(q, kg, vg, hl, ks, vs))


def _all_bytes_weight(card, k, n, group):
    """Packed rows holding every byte value (column c of packed row i is
    (c + 7 i) mod 256), seeded positive scales, and the dequantised
    float32 weight (K, N)."""
    i = torch.arange(k // 2)[:, None]
    c = torch.arange(n)[None, :]
    packed = ((c + 7 * i) % 256).to(torch.uint8).to(card)
    g = torch.Generator(device=card).manual_seed(9)
    scales = torch.rand((k // group, n), generator=g, device=card) + 0.01
    w = ref.unpack_int4(packed).float() * scales.repeat_interleave(group, 0)
    return packed, scales, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [64, 128, 256, 32, 24, 1024])
@pytest.mark.parametrize("b", [1, 2, 5, 8])
def test_quant_gemv_every_byte_value_exact_on_card(card, group, b, dtype):
    """One-hot x rows pick weight rows: the output is the dequantised
    weight (rounded once to bf16 for bf16 x), bit for bit, for every byte
    value of a packed row and every K row (each split's partial of the
    other groups is an exact zero) — on the tensor cores at groups that
    are multiples of 16 in bf16, on the CUDA cores at group 24, with
    group 1024 cut into units; K = 1008 at group 24."""
    k, n = group * (1024 // group), 256
    packed, scales, w = _all_bytes_weight(card, k, n, group)
    for k0 in range(0, k, b):
        ks = [min(k0 + r, k - 1) for r in range(b)]
        x = torch.zeros((b, k), device=card, dtype=dtype)
        x[torch.arange(b), torch.tensor(ks)] = 1.0
        got = ops.quant_gemv(x, packed, scales, group=group)
        assert torch.equal(got, w[ks].to(dtype)), f"K rows {ks}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("b", [1, 2, 5, 8])
@pytest.mark.parametrize("n", [3000, 1000, 77, 4096, 1008])
def test_quant_gemv_ragged_and_deterministic_on_card(card, dtype, tol,
                                                     group, b, n):
    """K6 against its plain version at N = 3000, 1000 and 77 (1-byte
    loads in 8-column strips, 77 ending mid-strip), 4096 (16-byte loads;
    the tensor cores in bf16) and 1008 (16-byte loads, the last
    128-column strip half past N), K = 2048 (several K splits at B = 1),
    every group and row tile; two runs are the same bits."""
    from repro_torch.kernels import quant_gemv as kqg
    k = 2048
    gen = torch.Generator(device=card).manual_seed(10)
    x = torch.randn((b, k), generator=gen, device=card).to(dtype)
    w = torch.randn((k, n), generator=gen, device=card) / k ** 0.5
    packed, scales = ref.quantize_int4(w, group=group)
    got = ops.quant_gemv(x, packed, scales, group=group)
    torch.testing.assert_close(
        got.float(), ref.quant_gemv(x, packed, scales, group=group).float(),
        atol=tol, rtol=tol)
    assert torch.equal(got, ops.quant_gemv(x, packed, scales, group=group))
    plan = kqg.launch_plan(b, k, n, group, dtype)
    assert plan.strips * plan.strip_cols >= n


def _k1_lens(split, cap):
    """Per-row lengths around the split edge: 1, split - 1, split,
    split + 1 and the capacity."""
    return [1, split - 1, split, split + 1, cap]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dh", [64, 80, 96, 128])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("hkv", [2, 8, 16])
@pytest.mark.parametrize("self_kv", [True, False])
def test_decode_attention_split_edges_on_card(card, dtype, tol, dh, g, hkv,
                                              self_kv):
    """K1 against its plain version with lengths on both sides of the
    split edge (B = 5 with Hkv 2 or 8, the largest pair count that takes
    them: 32-position splits of one tile; Hkv 16: 128-position splits of
    four double-buffered tiles), every head dim
    and group size, with and without the self partial; two runs are the
    same bits."""
    from repro_torch.kernels import decode_attention as kdec
    cap = 300
    gen = torch.Generator(device=card).manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    split = kdec.split_size(5, hkv)
    lens = torch.tensor(_k1_lens(split, cap), dtype=torch.int32,
                        device=card)
    b = len(lens)
    q, kc, vc = rnd(b, 1, hkv * g, dh), rnd(b, cap, hkv, dh), \
        rnd(b, cap, hkv, dh)
    kw = dict(extra_k=rnd(b, 1, hkv, dh), extra_v=rnd(b, 1, hkv, dh)) \
        if self_kv else {}
    got = ops.decode_attention(q, kc, vc, lens, **kw)
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, kc, vc, lens, **kw).float(),
        atol=tol, rtol=tol)
    assert torch.equal(got, ops.decode_attention(q, kc, vc, lens, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv", [(1, 32), (2, 32), (8, 16)])
def test_paged_decode_wider_table_is_bitwise_contiguous_on_card(card, dtype,
                                                                b, hkv):
    """K2 through tables 3 blocks wider than K1's capacity (a larger
    split count, the same split size) == K1 on the same rows, bit for
    bit, at B = 1 and B = 2 (32-position splits) and B = 8 (128)."""
    cap, bs, dh = 512, 16, 96
    gen = torch.Generator(device=card).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, kc, vc = rnd(b, 1, hkv, dh), rnd(b, cap, hkv, dh), rnd(b, cap, hkv, dh)
    ek, ev = rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    lens = torch.randint(1, cap + 1, (b,), generator=gen, device=card,
                         dtype=torch.int32)
    lens[0] = cap
    want = ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    nb = 2 * b * (cap // bs + 3)
    kp, tab = _scatter_to_pool(torch.cat([kc, kc[:, :3 * bs]], 1), bs, nb,
                               lens.tolist(), torch.Generator().manual_seed(2))
    vp, _ = _scatter_to_pool(torch.cat([vc, vc[:, :3 * bs]], 1), bs, nb,
                             lens.tolist(), torch.Generator().manual_seed(2))
    assert tab.shape[1] * bs == cap + 3 * bs
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, tab, lens,
                                                  extra_k=ek, extra_v=ev),
                       want)


# (M, d) of K5's card tests: the W4 step's row, the qwen decode rows,
# phi3's, the qwen prefill bucket, the widest row it takes, and the
# narrowest float32 row of two vectors a thread (a ragged second slot)
K5_SHAPES = [(1, 3072), (8, 1024), (8, 3072), (1024, 1024), (5, 8192),
             (2, 4104)]
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,adt,hdt", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,d", K5_SHAPES)
def test_add_rmsnorm_matches_plain_on_card(card, xdt, adt, hdt, m, d):
    """K5 with the add: s is ``torch.equal`` to torch's x + a; h is
    within tolerance of the plain version and ``torch.equal`` to the
    kernel without the add run on s (the same reduction order)."""
    g = torch.Generator(device=card).manual_seed(13)
    x = torch.randn((m, d), generator=g, device=card).to(xdt)
    a = torch.randn((m, d), generator=g, device=card).to(adt)
    w = (1.0 + 0.1 * torch.randn(d, generator=g, device=card)).to(xdt)
    s, h = ops.add_rmsnorm(x, a, w, out_dtype=hdt)
    assert s.dtype == xdt and h.dtype == hdt
    assert torch.equal(s, x + a)
    want = ref.add_rmsnorm(x, a, w, out_dtype=hdt)[1]
    torch.testing.assert_close(h.float(), want.float(), atol=K5_TOL[hdt],
                               rtol=K5_TOL[hdt])
    assert torch.equal(h, ops.add_rmsnorm(s, None, w, out_dtype=hdt)[1])
    if hdt == xdt:
        assert torch.equal(h, ops.rmsnorm(s, w))


# ---------------------------------------------------------------------------
# the MoE and vlm families' shapes: internvl2 / dbrx (GQA 48/8, G 6, Dh
# 128) and deepseek-moe (MHA, 16 heads of 128)
# ---------------------------------------------------------------------------

FAMILY_HEADS = [(48, 8), (16, 16)]   # (Hq, Hkv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hq,hkv", FAMILY_HEADS)
def test_decode_attention_family_shapes_on_card(card, dtype, tol, hq, hkv):
    """K1 at G 6 and at MHA 16 x 128 against its plain version over 8
    ragged rows (as the engine's 8 slots), and K2 on scattered pool
    blocks bitwise K1 on the same rows."""
    gen = torch.Generator(device=card).manual_seed(21)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    b, cap, bs, dh = 8, 512, 16, 128
    lens = torch.tensor([512, 300, 257, 129, 128, 17, 1, 0],
                        dtype=torch.int32, device=card)
    q, kc, vc = rnd(b, 1, hq, dh), rnd(b, cap, hkv, dh), rnd(b, cap, hkv, dh)
    ek, ev = rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    got = ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    want = ref.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    kp, tab = _scatter_to_pool(kc, bs, 300, lens.tolist(),
                               torch.Generator().manual_seed(21))
    vp, _ = _scatter_to_pool(vc, bs, 300, lens.tolist(),
                             torch.Generator().manual_seed(21))
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, tab, lens,
                                                  extra_k=ek, extra_v=ev),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hq,hkv", FAMILY_HEADS)
@pytest.mark.parametrize("s", [256 + 16, 256 + 32, 256 + 1024])
def test_flash_attention_image_prefix_on_card(card, dtype, tol, hq, hkv, s):
    """K3 over a vlm prompt: the 256-position image prefix before a
    bucket, so S is no power of two."""
    gen = torch.Generator(device=card).manual_seed(22)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, k, v = rnd(1, s, hq, 128), rnd(1, s, hkv, 128), rnd(1, s, hkv, 128)
    torch.testing.assert_close(ops.flash_attention(q, k, v).float(),
                               ref.flash_attention(q, k, v).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hq,hkv", FAMILY_HEADS)
@pytest.mark.parametrize("s", [5, 256 + 256, 256])
def test_prefill_attention_family_shapes_on_card(card, dtype, tol, hq, hkv,
                                                 s):
    """K4 at the families' shapes: the verify window of gamma 4 (S 5, so
    G * S = 30 rows of one KV head at G 6), a vlm's first chunk (its
    256-row image prefix plus a 256-token chunk, over an empty history)
    and a later chunk over ragged histories; two runs are the same
    bits."""
    q, kh, vh, hl, ks, vs = _k4_inputs(card, dtype, s, 128, seed=23,
                                       c=2048, hq=hq, hkv=hkv)
    for hist_len in (hl, 0 if s == 512 else 300):
        got = ops.prefill_attention(q, kh, vh, hist_len, ks, vs)
        want = ref.prefill_attention(q, kh, vh, hist_len, ks, vs)
        torch.testing.assert_close(
            got.float(), want.float(), atol=tol, rtol=tol,
            msg=lambda m: f"hist_len={hist_len}: {m}")
        assert torch.equal(got, ops.prefill_attention(q, kh, vh, hist_len,
                                                      ks, vs))


# the rolling sliding-window cache (h2o-danube-1.8b, mistral-7b: GQA
# 32/8 at Dh 80 and 128) and whisper's cross-attention and encoder
# (MHA 20 x 64)
SWA_HEADS = [(80, 32, 8), (128, 32, 8)]   # (Dh, Hq, Hkv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("dh,hq,hkv", SWA_HEADS)
@pytest.mark.parametrize("cap_is_window", [True, False])
def test_decode_attention_rolling_window_on_card(card, dtype, tol, dh, hq,
                                                 hkv, cap_is_window):
    """K1's rolling mask against its plain version: 8 rows with lengths
    on both sides of the window (a full row masks slot len % C, the
    position one window back), the cache as wide as the window or
    narrower (no slot masked then); two runs are the same bits, and a
    window no row fills gives K1's bits without one."""
    gen = torch.Generator(device=card).manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    cap = 256
    window = cap if cap_is_window else 4 * cap
    b = 8
    lens = torch.tensor([1, 100, 255, 256, 257, 300, 511, 1000],
                        dtype=torch.int32, device=card)
    q, kc, vc = rnd(b, 1, hq, dh), rnd(b, cap, hkv, dh), rnd(b, cap, hkv, dh)
    kw = dict(extra_k=rnd(b, 1, hkv, dh), extra_v=rnd(b, 1, hkv, dh))
    got = ops.decode_attention(q, kc, vc, lens, window=window, **kw)
    want = ref.decode_attention(q, kc, vc, lens, window=window, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, ops.decode_attention(q, kc, vc, lens,
                                                 window=window, **kw))
    short = lens.clamp(max=cap - 1)
    assert torch.equal(
        ops.decode_attention(q, kc, vc, short, window=window, **kw),
        ops.decode_attention(q, kc, vc, short, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_decode_attention_cross_cache_on_card(card, dtype, tol):
    """K1 as whisper's cross-attention decode: 8 rows over the fixed
    1500-row encoder cache, 20 heads of 64, no self partial (12 splits
    of 128, the last partial); two runs are the same bits."""
    gen = torch.Generator(device=card).manual_seed(32)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    b, t, h, dh = 8, 1500, 20, 64
    q, kc, vc = rnd(b, 1, h, dh), rnd(b, t, h, dh), rnd(b, t, h, dh)
    got = ops.decode_attention(q, kc, vc, t)
    torch.testing.assert_close(
        got.float(), ref.decode_attention(q, kc, vc, t).float(), atol=tol,
        rtol=tol)
    assert torch.equal(got, ops.decode_attention(q, kc, vc, t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("sq", [1500, 256, 17])
def test_flash_attention_non_causal_encoder_on_card(card, dtype, tol, sq):
    """K3 non-causal over whisper's 1500 encoder positions (23 tiles of
    64 and 28 keys): the encoder (Sq = 1500) and the decoder's cross-
    attention (Sq = a bucket). The keys score far below zero, so keys
    past 1500 — the zero-filled rows of the last tile, which would score
    0 — would take nearly all the weight if they were not masked."""
    gen = torch.Generator(device=card).manual_seed(33)
    skv, h, dh = 1500, 20, 64
    q = torch.rand((1, sq, h, dh), generator=gen, device=card).to(dtype)
    k = (-1.0 - torch.rand((1, skv, h, dh), generator=gen, device=card)
         ).to(dtype)
    v = torch.randn((1, skv, h, dh), generator=gen, device=card).to(dtype)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_flash_attention_window_past_it_on_card(card, dtype, tol):
    """K3 at h2o-danube's head dim 80, GQA 32/8, windowed over a prompt
    past the window (S = 600 > window 256, so tiles wholly before a
    query block's window are skipped)."""
    gen = torch.Generator(device=card).manual_seed(34)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, k, v = rnd(1, 600, 32, 80), rnd(1, 600, 8, 80), rnd(1, 600, 8, 80)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, window=256).float(),
        ref.flash_attention(q, k, v, window=256).float(), atol=tol,
        rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_bits_at_the_kernel_phase_shape_on_card(card, dtype):
    """K2 at the kernel phase's first decode shape (B 8, C 2048, MHA 16 x
    64, ragged lengths, self partial) on scattered pool blocks is K1's
    bits on the same rows, and K1 with a window no row fills is K1
    without one: the rolling mask moves no bit of a row it spares."""
    gen = torch.Generator(device=card).manual_seed(35)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    b, cap, bs, h, dh = 8, 2048, 16, 16, 64
    q, kc, vc = rnd(b, 1, h, dh), rnd(b, cap, h, dh), rnd(b, cap, h, dh)
    ek, ev = rnd(b, 1, h, dh), rnd(b, 1, h, dh)
    lens = torch.randint(1, cap + 1, (b,), generator=gen, device=card,
                         dtype=torch.int32)
    lens[0] = cap - 1
    kp, tab = _scatter_to_pool(kc, bs, b * cap // bs, lens.tolist(),
                               torch.Generator().manual_seed(35))
    vp, _ = _scatter_to_pool(vc, bs, b * cap // bs, lens.tolist(),
                             torch.Generator().manual_seed(35))
    k1 = ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, tab, lens,
                                                  extra_k=ek, extra_v=ev),
                       k1)
    assert torch.equal(ops.decode_attention(q, kc, vc, lens, extra_k=ek,
                                            extra_v=ev, window=cap), k1)
