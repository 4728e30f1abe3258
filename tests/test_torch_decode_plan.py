"""The launch plan of the split-KV decode kernels K1 and K2 (pure Python,
no card): the split size comes from what the two share, never from the
capacity, the splits cover every valid position once, and a block-table
view wider than a contiguous cache is cut at the same positions."""
from __future__ import annotations

import pytest

from repro_torch.kernels import decode_attention as kdec

# (B, Hkv) pairs the plan sees; G, Dh and the dtype do not enter it
SHAPES = [(1, 32),    # the W4 step (phi3-mini)
          (8, 16),    # qwen decode, 8 slots
          (1, 16),    # qwen decode, one slot
          (4, 2),     # GQA 8/2
          (8, 32),    # phi3-mini served, 8 slots
          (3, 16),
          (2, 24),
          (5, 8),     # 40 pairs: the one-tile splits' upper range
          (2, 32)]    # 64 pairs: their largest


@pytest.mark.parametrize("b,hkv", SHAPES)
def test_split_size_does_not_change_with_capacity(b, hkv):
    split = kdec.split_size(b, hkv)
    assert split in kdec.SPLITS and split % kdec.TILE == 0
    for cap in (1, 31, 32, 33, 300, 512, 1024, 2048, 2080, 4096):
        p = kdec.launch_plan(b, hkv, cap)
        assert p.split == split
        assert p.splits == -(-cap // split)
        assert p.grid == (p.splits, hkv, b)


@pytest.mark.parametrize("b,hkv", SHAPES)
def test_splits_cover_each_valid_position_once(b, hkv):
    """Walk pass 1 as the source does for every row length up to the
    capacity: each block covers [start, start + split) clipped to the
    length, blocks past the length exit, and pass 2 reads the
    ceil(len / split) valid ones."""
    cap = 300
    p = kdec.launch_plan(b, hkv, cap)
    for length in range(cap + 1):
        seen = [0] * length
        live = 0
        for split in range(p.splits):
            start = split * p.split
            if start >= length:
                continue
            live += 1
            n_here = min(p.split, length - start)
            tiles = -(-n_here // kdec.TILE)
            assert tiles <= p.split // kdec.TILE
            for pos in range(start, start + n_here):
                seen[pos] += 1
        assert seen == [1] * length
        assert live == -(-length // p.split)


@pytest.mark.parametrize("b,hkv", SHAPES)
def test_k1_and_k2_get_the_same_split_boundaries(b, hkv):
    """A contiguous capacity C and a block-table view of W x bs >= C
    positions share their split boundaries below C: K2 over the wider
    view reads the same positions, in the same blocks, as K1."""
    cap, bs = 512, 16
    k1 = kdec.launch_plan(b, hkv, cap)
    for extra in (0, 1, 3, 40):
        k2 = kdec.launch_plan(b, hkv, cap + extra * bs)
        assert k2.split == k1.split and k2.splits >= k1.splits
        assert [s * k2.split for s in range(k1.splits)] == \
            [s * k1.split for s in range(k1.splits)]


def test_one_row_fills_the_card():
    """The W4 step's call (B = 1, 32 heads, 512 cached positions) gives
    several blocks per SM, where 128-position splits gave 128 blocks."""
    p = kdec.launch_plan(1, 32, 1024)
    live = -(-512 // p.split) * 32
    assert live >= 3 * 132
