"""Port int4 quantization and the plain W4A16 GEMV (K6's CPU path)
against the JAX reference: ``repro.kernels.ref`` and the Pallas
``quant_gemv`` in interpret mode, at small shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref


def _weights(seed, k, n, group):
    """Seeded (K, N) float32 weights; the first column holds, in every
    group, values exactly half a step between two int4 levels (scale
    0.25: amax 1.75, entries (m + 0.5) * 0.25), so round-half-to-even
    decides them."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.5).astype(np.float32)
    half = (np.arange(group) % 14 - 7 + 0.5) * 0.25    # -1.625 .. 1.625
    half[0] = 1.75                                      # amax = 7 * 0.25
    w[:, 0] = np.tile(half, k // group).astype(np.float32)
    return w


@pytest.mark.parametrize("group", [64, 128, 256])
def test_quantize_int4_bytes_identical_to_reference(group):
    k, n = 512, 96
    w = _weights(group, k, n, group)
    packed, scales = ref.quantize_int4(torch.from_numpy(w), group=group)
    jp, js = jref.quantize_int4(jnp.asarray(w), group=group)
    assert packed.dtype == torch.uint8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    # the half-step column really sits on ties: w / scale is k + 0.5
    ratio = w[1:group, 0] / np.asarray(js)[0, 0]
    assert np.all(ratio - np.floor(ratio) == 0.5)


def test_pack_and_unpack_int4_round_trip_against_reference():
    rng = np.random.default_rng(5)
    w_int = rng.integers(-8, 8, size=(64, 24)).astype(np.int8)
    packed = ref.pack_int4(torch.from_numpy(w_int))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jref.pack_int4(
                                      jnp.asarray(w_int))))
    np.testing.assert_array_equal(ref.unpack_int4(packed).numpy(), w_int)


# tests/test_kernels.py's (b, k, n, group), plus an N that is not a
# multiple of the Pallas column block, group 64 and group 32 (which K6
# takes on the tensor cores in bf16)
SHAPES = [(1, 256, 512, 128), (4, 512, 256, 128), (2, 1024, 1024, 256),
          (3, 256, 320, 64), (2, 512, 256, 32)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,k,n,group", SHAPES)
def test_plain_quant_gemv_matches_pallas_and_reference(b, k, n, group,
                                                       dtype):
    """bf16: within the JAX test's own 5e-2 (one bf16 rounding of the
    output); float32: the two differ only in summation order, so within
    1e-5 of the output's magnitude."""
    rng = np.random.default_rng(b * k + n)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.5).astype(np.float32)
    jp, js = jref.quantize_int4(jnp.asarray(w), group=group)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.quant_gemv(tx, torch.from_numpy(np.array(jp)),
                         torch.from_numpy(np.array(js)), group=group)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, n)
    got = got.float().numpy()
    for want in (jops.quant_gemv(jx, jp, js, group=group, block_n=128),
                 jref.quant_gemv_ref(jx, jp, js, group=group)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_quant_gemv_wrapper_refuses_cpu_operands_before_building():
    from repro_torch.kernels import quant_gemv as kqg
    x = torch.zeros((1, 128), dtype=torch.bfloat16)
    packed = torch.zeros((64, 256), dtype=torch.uint8)
    scales = torch.ones((1, 256))
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        kqg.quant_gemv(x, packed, scales, group=128)
    with pytest.raises(ValueError, match="group=96"):
        kqg.quant_gemv(x, packed, torch.ones((1, 256)), group=96)
    with pytest.raises(ValueError, match="group=1 must be even"):
        kqg.quant_gemv(x, packed, torch.ones((128, 256)), group=1)
    with pytest.raises(ValueError, match="shapes"):
        kqg.quant_gemv(x, packed[:32], scales, group=128)


@pytest.mark.parametrize("b,k,n,group", [(1, 3072, 8192, 128),
                                         (1, 8192, 3072, 128),
                                         (8, 3072, 8192, 128),
                                         (1, 3072, 3000, 64),
                                         (3, 256, 320, 64),
                                         (1, 3072, 8192, 32),
                                         (2, 3072, 512, 24),
                                         (8, 3072, 512, 96),
                                         (8, 3072, 512, 3072)])
def test_k_splits_cover_every_group_once(b, k, n, group):
    """K6's launch plan: K is cut into units that each lie in one group
    (the whole group where it fits), the K splits of whole units (WARPS
    x units_per_warp each) cover every unit once, none empty, and x for
    a block's K range fits the staged maximum — at every even group,
    the whole K (per-column scales) included."""
    from repro_torch.kernels import quant_gemv as kqg
    p = kqg.launch_plan(b, k, n, group, torch.bfloat16)
    assert group % p.unit == 0 and p.unit % 2 == 0
    assert p.unit == group or p.rows * kqg.WARPS * group > kqg.MAX_X_FLOATS
    ups, ns = kqg.WARPS * p.units_per_warp, p.splits
    nu = k // p.unit
    assert ups >= 1 and (ns - 1) * ups < nu <= ns * ups
    assert p.rows * ups * p.unit <= kqg.MAX_X_FLOATS


PLAN_SHAPES = [(1, 3072, 8192, 128), (1, 8192, 3072, 128),
               (1, 3072, 3072, 128), (8, 3072, 8192, 128),
               (1, 3072, 8192, 64), (1, 3072, 3000, 128),
               (5, 256, 320, 64), (2, 1024, 200, 256), (8, 8192, 3072, 256),
               (3, 512, 77, 64), (1, 64, 16, 64), (1, 1024, 1008, 128),
               (1, 1024, 256, 32), (5, 1008, 256, 24), (2, 960, 320, 96),
               (8, 1024, 256, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,k,n,group", PLAN_SHAPES)
def test_launch_plan_covers_every_column_group_and_row_once(b, k, n, group,
                                                            dtype):
    """Walk K6's grid as the source does: every (x row, column, K unit)
    falls to exactly one (block, warp, lane) — strips of 8 lanes x vec
    columns masked at N, row tiles masked at B, warps of whole units,
    each inside one group — and every weight load is a whole vec-byte
    vector inside the row; bf16 with 16-byte loads and a group that is a
    multiple of 16 takes the tensor cores, 8 x rows a tile, in units of
    whole 16-row tiles."""
    from repro_torch.kernels import quant_gemv as kqg
    p = kqg.launch_plan(b, k, n, group, dtype)
    assert p.vec == (16 if n % 16 == 0 else 1)
    assert p.strip_cols == kqg.COL_LANES * p.vec
    assert p.mma == (dtype == torch.bfloat16 and p.vec == 16
                     and group % 16 == 0)
    assert p.rows == (kqg.MMA_ROWS if p.mma else 1 if b == 1
                      else 2 if b == 2 else 4)
    assert p.row_tiles == -(-b // p.rows)
    assert group % p.unit == 0 and p.unit % (16 if p.mma else 2) == 0
    ng = k // p.unit
    hits = np.zeros((b, n, ng), np.int64)
    for strip in range(p.strips):
        cols = [strip * p.strip_cols + cl * p.vec + c
                for cl in range(kqg.COL_LANES) for c in range(p.vec)
                if strip * p.strip_cols + cl * p.vec < n]
        assert all(c < n for c in cols)   # whole vectors only
        for split in range(p.splits):
            for warp in range(kqg.WARPS):
                g0 = (split * kqg.WARPS + warp) * p.units_per_warp
                g1 = min(g0 + p.units_per_warp,
                         (split + 1) * kqg.WARPS * p.units_per_warp, ng)
                for rt in range(p.row_tiles):
                    rows = range(rt * p.rows, min(rt * p.rows + p.rows, b))
                    for g in range(g0, g1):
                        hits[np.ix_(list(rows), cols, [g])] += 1
    assert (hits == 1).all()


def test_launch_plan_fills_the_card_at_the_w4_shapes():
    """At phi3-mini's B = 1 projections the grid holds at least 4 warps
    per SM's worth of (strip, group) work, one warp each."""
    from repro_torch.kernels import quant_gemv as kqg
    for k, n in ((3072, 3072), (3072, 8192), (8192, 3072)):
        p = kqg.launch_plan(1, k, n, 128, torch.bfloat16)
        assert p.units_per_warp == 1 and p.unit == 128
        assert p.vec == 16 and p.mma
        assert p.strips * p.splits * kqg.WARPS >= 132 * 4
