"""KV-cache managers for the serving engine.

Counterpart of ``repro/serving/kv_cache.py``. :class:`KVCacheManager` is
the protocol the engine consumes, with two backends:

- :class:`ContiguousCache` — every slot owns ``max_seq_len`` positions
  of a ``(L, B, C, Hkv, Dh)`` cache on the device;
- :class:`PagedCache` — one shared pool of fixed-size KV blocks
  ``(L, NB + 1, bs, Hkv, Dh)`` (the last block is a never-allocated
  scratch block that takes dropped writes), a host-side per-slot block
  table and free-list :class:`BlockAllocator`. Blocks allocate lazily
  and free at retirement, so resident KV tracks what requests use.
  Admission reserves each request's worst-case block count, so an
  admitted request can never deadlock mid-decode.

Prefix caching and slot export/import are a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models import model as MD


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()


def kv_bytes_per_token(cfg) -> int:
    """Bytes of KV state one cached position occupies across all layers."""
    st = MD.cache_struct(cfg, 1, 1)
    return sum(_nbytes(*st[name]) for name in ("k", "v"))


def contiguous_kv_bytes(cfg, batch: int, capacity: int) -> int:
    """Total footprint of the dense layout (every leaf but the position
    counter) — the ``max_batch x max_seq_len`` charge."""
    return sum(_nbytes(sh, dt) for name, (sh, dt)
               in MD.cache_struct(cfg, batch, capacity).items()
               if name != "len")


def paged_resident_kv_bytes(cfg, lens, block_size: int) -> int:
    """Resident bytes of a paged cache holding ``lens[i]`` positions per
    request: allocated blocks only, each rounded up to ``block_size``."""
    blocks = sum(math.ceil(n / block_size) for n in lens)
    return blocks * block_size * kv_bytes_per_token(cfg)


@runtime_checkable
class KVCacheManager(Protocol):
    """What the serving engine needs from a cache backend."""

    name: str

    def can_admit(self, n_prompt: int, budget: int) -> bool:
        """True if capacity exists for a request of this prompt length
        and generation budget (worst case, no mid-decode failure)."""
        ...

    def splice(self, rows: dict, slot: int, n_prompt: int,
               budget: int) -> None:
        """Write a batch-1 prefill's KV rows into ``slot``."""
        ...

    def reserve(self, slot: int, n_prompt: int, budget: int) -> None:
        """Hold the worst-case capacity of a request admitted for
        chunked prefill before any of its KV lands."""
        ...

    def splice_partial(self, k_rows, v_rows, slot: int, offset: int,
                       n_valid: int) -> None:
        """Write one chunk's KV rows (L, 1, S, H, Dh) at positions
        ``offset .. offset + n_valid - 1`` of ``slot``; the pad tail past
        ``n_valid`` is not written."""
        ...

    def chunk_view(self, slot: int) -> dict:
        """Device operands of one chunk dispatch over the slot's
        history: ``{"kind": "contiguous", "k", "v", "slot"}`` or
        ``{"kind": "paged", "k", "v", "table"}``."""
        ...

    def decode_view(self, pos: np.ndarray, live: np.ndarray) -> dict:
        """Device cache dict for one ragged decode dispatch (allocates
        any block the step is about to write, for paged backends)."""
        ...

    def verify_view(self, pos: np.ndarray, live: np.ndarray,
                    n_tokens: np.ndarray) -> dict:
        """Device cache dict for one verify dispatch writing up to
        ``n_tokens[i]`` candidate KVs at ``pos[i]..`` per live row."""
        ...

    def commit_n(self, slot: int, n_valid: int) -> None:
        """After speculative acceptance the slot is valid to ``n_valid
        - 1``; paged backends free every block wholly past it."""
        ...

    def commit(self, new_cache: dict) -> None:
        """Store the cache dict returned by the decode dispatch."""
        ...

    def free(self, slot: int) -> None:
        """Release slot state at retirement."""
        ...

    def resident_kv_bytes(self) -> int:
        """Bytes of KV state currently resident."""
        ...

    @property
    def peak_resident_kv_bytes(self) -> int:
        """High-water mark of :meth:`resident_kv_bytes` over the run."""
        ...


class ContiguousCache:
    """Dense per-slot cache: every slot owns ``max_seq_len`` positions,
    spliced and overwritten in place on the device."""

    name = "contiguous"

    def __init__(self, cfg, ecfg, device):
        B, C = ecfg.max_batch, ecfg.max_seq_len
        self._cache = MD.init_cache(cfg, B, C, device=device)
        self._footprint = contiguous_kv_bytes(cfg, B, C)

    def can_admit(self, n_prompt: int, budget: int) -> bool:
        return True  # every slot already owns full capacity

    def splice(self, rows: dict, slot: int, n_prompt: int,
               budget: int) -> None:
        """``rows["k"]``/``rows["v"]`` (L, 1, S, Hkv, Dh) land at
        positions ``0..S-1`` of ``slot``; the rest of the row is zeroed,
        so the slot holds exactly what the reference's full-capacity
        prefill cache would."""
        s = rows["k"].shape[2]
        for name in ("k", "v"):
            dst = self._cache[name][:, slot]
            dst[:, :s] = rows[name][:, 0]
            dst[:, s:].zero_()

    def reserve(self, slot: int, n_prompt: int, budget: int) -> None:
        pass  # capacity is pre-provisioned per slot

    def splice_partial(self, k_rows, v_rows, slot: int, offset: int,
                       n_valid: int) -> None:
        for name, rows in (("k", k_rows), ("v", v_rows)):
            self._cache[name][:, slot, offset:offset + n_valid] = \
                rows[:, 0, :n_valid]

    def chunk_view(self, slot: int) -> dict:
        return {"kind": "contiguous", "k": self._cache["k"],
                "v": self._cache["v"], "slot": slot}

    def decode_view(self, pos, live) -> dict:
        return self._cache

    def verify_view(self, pos, live, n_tokens) -> dict:
        return self._cache  # every slot already owns full capacity

    def commit_n(self, slot: int, n_valid: int) -> None:
        pass  # rejected-candidate KV is masked by the per-row length
        # and overwritten in place by the next dispatch

    def commit(self, new_cache: dict) -> None:
        self._cache = new_cache

    def free(self, slot: int) -> None:
        pass  # the rows are overwritten by the next admission

    def resident_kv_bytes(self) -> int:
        return self._footprint

    @property
    def peak_resident_kv_bytes(self) -> int:
        return self._footprint


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size KV blocks.
    Double frees and foreign blocks raise; accounting is exact
    (``free_blocks + allocated_blocks == num_blocks``)."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"need at least one block, got {num_blocks}")
        self.num_blocks = num_blocks
        # pop from the end -> block 0 handed out first (deterministic)
        self._free = list(range(num_blocks - 1, -1, -1))
        self._allocated: set[int] = set()
        self.peak_allocated = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return len(self._allocated)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted (reservation "
                               "accounting should have prevented this)")
        blk = self._free.pop()
        self._allocated.add(blk)
        self.peak_allocated = max(self.peak_allocated, len(self._allocated))
        return blk

    def free(self, blk: int) -> None:
        if blk not in self._allocated:
            raise ValueError(f"double free or foreign block: {blk}")
        self._allocated.remove(blk)
        self._free.append(blk)


class PagedCache:
    """Block-table cache: a shared ``(L, NB + 1, bs, H, Dh)`` pool on the
    device, a host-side per-slot block table (sentinel ``NB`` — the
    scratch block's id — for "no block"), lazy allocation and
    retirement-time free."""

    name = "paged"

    def __init__(self, cfg, ecfg, device):
        bs, C = ecfg.kv_block_size, ecfg.max_seq_len
        if bs <= 0 or C % bs:
            raise ValueError(
                f"kv_block_size={bs} must be positive and divide "
                f"max_seq_len={C} (the paged decode must see the "
                "contiguous capacity exactly)")
        self.block_size = bs
        self.table_width = W = C // bs
        self.num_blocks = NB = ecfg.kv_blocks or ecfg.max_batch * W
        self.device = device
        self._bytes_per_token = kv_bytes_per_token(cfg)
        self._pool_k, self._pool_v = MD.init_paged_pools(cfg, NB, bs,
                                                         device=device)
        self.table = np.full((ecfg.max_batch, W), NB, np.int32)
        self.allocator = BlockAllocator(NB)
        self._reserved = np.zeros(ecfg.max_batch, np.int64)
        self._max_seq_len = C

    # -- accounting -------------------------------------------------------
    def _need_blocks(self, n_prompt: int, budget: int) -> int:
        """Worst-case blocks a request ever touches: positions
        ``0 .. n_prompt + budget - 2`` (the last generated token's KV is
        never written), capped by the retirement bound ``C - 1``."""
        n_pos = min(n_prompt + max(budget, 1) - 1, self._max_seq_len - 1)
        return math.ceil(max(n_pos, 1) / self.block_size)

    def can_admit(self, n_prompt: int, budget: int) -> bool:
        need = self._need_blocks(n_prompt, budget)
        if need > self.allocator.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool only has "
                f"{self.allocator.num_blocks}; raise kv_blocks or lower "
                "max_new_tokens")
        avail = self.allocator.free_blocks - int(self._reserved.sum())
        return avail >= need

    def _alloc_into(self, slot: int, b: int) -> None:
        """Give table entry ``b`` of ``slot`` a block if it has none,
        paying the slot's reservation down."""
        if self.table[slot, b] == self.num_blocks:
            self.table[slot, b] = self.allocator.alloc()
            self._reserved[slot] = max(0, int(self._reserved[slot]) - 1)

    def _write(self, k_rows, v_rows, slot: int, pos: np.ndarray) -> None:
        """Rows ``k_rows[:, 0, :len(pos)]`` land at the slot's logical
        positions ``pos`` (all backed by allocated blocks)."""
        bs = self.block_size
        blk = torch.from_numpy(self.table[slot, pos // bs].astype(np.int64))
        off = torch.from_numpy(pos % bs)
        blk, off = blk.to(self.device), off.to(self.device)
        n = len(pos)
        self._pool_k[:, blk, off] = k_rows[:, 0, :n].to(self._pool_k.dtype)
        self._pool_v[:, blk, off] = v_rows[:, 0, :n].to(self._pool_v.dtype)

    # -- protocol ---------------------------------------------------------
    def splice(self, rows: dict, slot: int, n_prompt: int,
               budget: int) -> None:
        """A blocking prefill's rows (L, 1, S, H, Dh): allocate exactly the
        prompt's blocks and store the rows they cover (pad rows past the
        prompt that share its last block come along, masked by length)."""
        now = math.ceil(n_prompt / self.block_size)
        for b in range(now):
            self.table[slot, b] = self.allocator.alloc()
        self._reserved[slot] = self._need_blocks(n_prompt, budget) - now
        n = min(int(rows["k"].shape[2]), now * self.block_size)
        self._write(rows["k"], rows["v"], slot, np.arange(n))

    def reserve(self, slot: int, n_prompt: int, budget: int) -> None:
        self._reserved[slot] = self._need_blocks(n_prompt, budget)

    def splice_partial(self, k_rows, v_rows, slot: int, offset: int,
                       n_valid: int) -> None:
        bs = self.block_size
        for b in range(offset // bs, math.ceil((offset + n_valid) / bs)):
            self._alloc_into(slot, b)
        self._write(k_rows, v_rows, slot, offset + np.arange(n_valid))

    def chunk_view(self, slot: int) -> dict:
        return {"kind": "paged", "k": self._pool_k, "v": self._pool_v,
                "table": torch.from_numpy(self.table[slot:slot + 1].copy()
                                          ).to(self.device)}

    def decode_view(self, pos, live) -> dict:
        return self.verify_view(pos, live, np.ones(len(self.table),
                                                   np.int32))

    def verify_view(self, pos, live, n_tokens) -> dict:
        """Allocate every block the window ``pos[i] .. pos[i] +
        n_tokens[i] - 1`` of each live row touches (``n_tokens`` is the
        row's commit cap, covered by its admission reservation);
        candidate writes past it find the sentinel and are dropped."""
        bs = self.block_size
        for i in np.nonzero(live)[0]:
            last = min(int(pos[i]) + max(int(n_tokens[i]), 1) - 1,
                       self._max_seq_len - 2)
            for b in range(int(pos[i]) // bs, last // bs + 1):
                self._alloc_into(i, b)
        return {"k": self._pool_k, "v": self._pool_v,
                "block_tab": torch.from_numpy(self.table.copy()
                                              ).to(self.device),
                "len": torch.zeros((), dtype=torch.int32)}

    def commit_n(self, slot: int, n_valid: int) -> None:
        """Speculative rollback: free every block wholly past position
        ``n_valid - 1`` and put it back on the reservation (a later
        verify may write those positions again)."""
        keep = max(1, math.ceil(n_valid / self.block_size))
        for b in range(keep, self.table_width):
            blk = int(self.table[slot, b])
            if blk == self.num_blocks:
                break  # tables fill as a prefix: the first sentinel ends
            self.allocator.free(blk)
            self.table[slot, b] = self.num_blocks
            self._reserved[slot] += 1

    def commit(self, new_cache: dict) -> None:
        self._pool_k = new_cache["k"]
        self._pool_v = new_cache["v"]

    def free(self, slot: int) -> None:
        for blk in self.table[slot]:
            if blk != self.num_blocks:
                self.allocator.free(int(blk))
        self.table[slot] = self.num_blocks
        self._reserved[slot] = 0

    def resident_kv_bytes(self) -> int:
        return (self.allocator.allocated_blocks * self.block_size
                * self._bytes_per_token)

    @property
    def peak_resident_kv_bytes(self) -> int:
        return (self.allocator.peak_allocated * self.block_size
                * self._bytes_per_token)


def make_kv_cache(cfg, ecfg, device) -> KVCacheManager:
    kind = ecfg.kv_cache
    if kind == "contiguous":
        return ContiguousCache(cfg, ecfg, device)
    if kind == "paged":
        return PagedCache(cfg, ecfg, device)
    raise ValueError(f"unknown kv_cache {kind!r}")
