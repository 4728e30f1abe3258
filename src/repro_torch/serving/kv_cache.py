"""KV-cache managers for the serving engine.

Counterpart of ``repro/serving/kv_cache.py``. :class:`KVCacheManager` is
the protocol the engine consumes, with two backends:

- :class:`ContiguousCache` — every slot owns ``max_seq_len`` positions
  of a ``(L, B, C, Hkv, Dh)`` cache on the device (``C`` the window for a
  rolling sliding-window cache), whisper's slots also their fixed
  cross-attention K/V (``cross_k``/``cross_v``), and a recurrent
  family's slots their O(1) state (``ssm``/``conv``/``mlstm`` on batch
  axis 2, ``slstm_c/n/h`` on axis 1; Zamba2 also its shared block's
  ``k``/``v``);
- :class:`PagedCache` — one shared pool of fixed-size KV blocks
  ``(L, NB + 1, bs, Hkv, Dh)`` (the last block is a never-allocated
  scratch block that takes dropped writes), a host-side per-slot block
  table and free-list :class:`BlockAllocator`. Blocks allocate lazily
  and free at retirement, so resident KV tracks what requests use.
  Admission reserves each request's worst-case block count, so an
  admitted request can never deadlock mid-decode.

Prefix caching (``EngineConfig.prefix_cache``, paged only): full
``block_size``-token prompt blocks are content-hashed (chained, so a
block's identity covers everything before it) into a :class:`PrefixIndex`
of immutable shared blocks with refcounts. Admission splices the longest
cached block-aligned prefix into the slot's table and prefills only the
suffix; the reservation charges only the uncached suffix. Only blocks
wholly inside a prompt are shared, and every later write lands at a
position ``>= n_prompt`` — a private block — so a shared block is never
written. Refcount-zero shared blocks stay resident and are evicted
LRU-first under pool pressure. The scratch block is never allocated, so
it is never registered or shared.

``export_slot`` / ``import_slot`` move one live slot's KV through the
host (SLO preemption): the packet holds CPU tensors in the cache's own
dtype (a bf16 round trip is bitwise) and is portable between backends.

:func:`make_kv_cache` falls back to contiguous, with the reference's
warning, for what the paged layout cannot express: families other than
the attention decoders, and rolling sliding-window caches.
"""
from __future__ import annotations

import hashlib
import math
import warnings
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import PerRank
from repro_torch.models import model as MD


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()


def kv_bytes_per_token(cfg) -> int:
    """Bytes of self-attention KV state one cached position occupies
    across all layers (0 for an xLSTM; a whisper slot's cross K/V and a
    recurrent slot's state are per slot, not per position:
    :func:`contiguous_kv_bytes` counts them)."""
    st = MD.cache_struct(cfg, 1, 1)
    return sum(_nbytes(*st[name]) for name in ("k", "v") if name in st)


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

    def can_admit(self, n_prompt: int, budget: int, prompt=None) -> bool:
        """True if capacity exists for a request of this prompt length
        and generation budget (worst case, no mid-decode failure).
        ``prompt`` lets a prefix-caching backend charge only the
        uncached suffix; other backends ignore it."""
        ...

    def splice(self, rows: dict, slot: int, n_prompt: int,
               budget: int, prompt=None) -> None:
        """Write a batch-1 prefill's KV rows into ``slot`` (``prompt``:
        cold-miss accounting for a prefix-caching backend)."""
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

    def export_slot(self, slot: int, n_valid: int, prompt=None,
                    n_prompt=None) -> dict:
        """Pack positions ``0 .. n_valid - 1`` of ``slot`` into a host
        packet: ``{"n_valid", "k", "v", "kv_bytes"}`` (k/v (L, 1, span,
        Hkv, Dh) CPU tensors, span padded to the export quantum or the
        block size), plus ``"prefix"`` provenance when a prefix-caching
        backend is given the prompt."""
        ...

    def import_slot(self, packet: dict, slot: int, n_prompt: int,
                    budget: int) -> None:
        """Land an :meth:`export_slot` packet in free slot ``slot``,
        re-running the admission reservation for (``n_prompt``,
        ``budget``); callers gate on :meth:`can_admit` first. Raises on
        an occupied slot."""
        ...

    def resident_kv_bytes(self) -> int:
        """Bytes of KV state currently resident."""
        ...

    @property
    def peak_resident_kv_bytes(self) -> int:
        """High-water mark of :meth:`resident_kv_bytes` over the run."""
        ...


def _chain_hash(prev: bytes, tokens: np.ndarray) -> bytes:
    """One link of the block hash chain: the digest covers the previous
    link, so equal hashes imply equal *prefixes*, not just equal blocks."""
    data = prev + np.ascontiguousarray(tokens, np.int64).tobytes()
    return hashlib.blake2b(data, digest_size=16).digest()


class PrefixIndex:
    """Content-hash registry of immutable shared KV blocks.

    Each entry maps the chained hash of one full ``block_size``-token
    prompt block to a pool block id plus a refcount — the number of slot
    tables aliasing the block. Refcount-zero entries stay resident and
    form an LRU queue; :meth:`evict_lru` unregisters the coldest one
    when the pool needs its block back."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_hash: dict[bytes, int] = {}
        self._hash_of: dict[int, bytes] = {}
        self._refs: dict[int, int] = {}
        self._lru: dict[int, None] = {}   # insertion-ordered: oldest first
        self.evictions = 0

    # -- queries ----------------------------------------------------------
    def keys_for(self, prompt, n_blocks: int) -> list[bytes]:
        """Chained hash keys of the first ``n_blocks`` full blocks."""
        bs = self.block_size
        arr = np.asarray(prompt, np.int64)[:n_blocks * bs]
        keys, key = [], b""
        for k in range(n_blocks):
            key = _chain_hash(key, arr[k * bs:(k + 1) * bs])
            keys.append(key)
        return keys

    def match(self, prompt, n_prompt: int) -> list[int]:
        """Block ids of the longest cached block-aligned prefix, capped
        at ``(n_prompt - 1) // block_size`` blocks: at least one suffix
        token must still run through prefill for the admission logits."""
        bs = self.block_size
        limit = max(0, (int(n_prompt) - 1) // bs)
        ids: list[int] = []
        if not limit:
            return ids
        arr = np.asarray(prompt, np.int64)[:limit * bs]
        key = b""
        for k in range(limit):
            key = _chain_hash(key, arr[k * bs:(k + 1) * bs])
            bid = self._by_hash.get(key)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def holds(self, bid: int) -> bool:
        return bid in self._hash_of

    def refcount(self, bid: int) -> int:
        return self._refs.get(bid, 0)

    @property
    def resident_blocks(self) -> int:
        return len(self._hash_of)

    def evictable(self, excluding=()) -> int:
        """Refcount-zero resident blocks the pool could reclaim, minus
        any the caller is about to acquire."""
        if not excluding:
            return len(self._lru)
        return len(self._lru) - len(set(excluding) & self._lru.keys())

    # -- mutation ---------------------------------------------------------
    def acquire(self, ids) -> None:
        """Alias shared blocks into one more slot table (revives any
        refcount-zero entry out of the LRU queue)."""
        for bid in ids:
            self._refs[bid] = self._refs.get(bid, 0) + 1
            self._lru.pop(bid, None)

    def release(self, bid: int) -> None:
        """Drop one table's alias; at refcount zero the block joins the
        LRU queue (still resident — that is the cache)."""
        n = self._refs.get(bid, 0) - 1
        if n < 0:
            raise RuntimeError(f"refcount underflow on shared block {bid}")
        self._refs[bid] = n
        if n == 0:
            self._lru[bid] = None

    def register(self, key: bytes, bid: int) -> bool:
        """Publish ``bid`` as the canonical block for ``key`` with one
        reference (the registering slot's own table). False if the key
        already has a canonical block — the caller keeps its copy."""
        if key in self._by_hash:
            return False
        self._by_hash[key] = bid
        self._hash_of[bid] = key
        self._refs[bid] = 1
        return True

    def evict_lru(self):
        """Unregister and return the coldest refcount-zero block id (the
        caller returns it to the allocator), or None."""
        if not self._lru:
            return None
        bid = next(iter(self._lru))
        del self._lru[bid]
        key = self._hash_of.pop(bid)
        del self._by_hash[key]
        del self._refs[bid]
        self.evictions += 1
        return bid


EXPORT_QUANTUM = 16   # exported KV spans round up to this many positions


def _export_span(n_valid: int) -> int:
    """Positions an exported KV row carries for ``n_valid`` valid ones."""
    n = max(int(n_valid), 1)
    return math.ceil(n / EXPORT_QUANTUM) * EXPORT_QUANTUM


def _host_packet(n_valid: int, **rows: torch.Tensor) -> dict:
    """A packet of host copies of ``rows`` (``k``, ``v`` and any other
    batched cache leaf) in their own dtype, and the bytes that crossed
    the device boundary."""
    host = {name: t.to("cpu", copy=True) for name, t in rows.items()}
    return {"n_valid": int(n_valid), **host,
            "kv_bytes": sum(t.numel() * t.element_size()
                            for t in host.values())}


class ContiguousCache:
    """Dense per-slot cache: every slot owns ``max_seq_len`` positions
    (at most the window, for a rolling cache), spliced and overwritten
    in place on the device. Every batched leaf is a slot's, each on its
    own batch axis (:func:`~repro_torch.models.model.cache_batch_axes`):
    ``k``/``v``, whisper's ``cross_k``/``cross_v`` and a recurrent
    family's state leaves."""

    name = "contiguous"

    def __init__(self, cfg, ecfg, device):
        B, C = ecfg.max_batch, ecfg.max_seq_len
        self._cache = MD.init_cache(cfg, B, C, device=device)
        self._axes = {name: ax for name, ax in
                      MD.cache_batch_axes(self._cache).items()
                      if ax is not None}
        self._rolling = cfg.sliding_window is not None
        self._footprint = contiguous_kv_bytes(cfg, B, C)
        self.device = device
        # slots holding a live stream (spliced, reserved or imported and
        # not yet freed): the dense layout has no allocator to notice a
        # double import, so track occupancy explicitly
        self._occupied: set[int] = set()

    def can_admit(self, n_prompt: int, budget: int, prompt=None) -> bool:
        return True  # every slot already owns full capacity

    def splice(self, rows: dict, slot: int, n_prompt: int,
               budget: int, prompt=None) -> None:
        """``rows["k"]``/``rows["v"]`` (L, 1, S, Hkv, Dh) land at
        positions ``0..S-1`` of ``slot`` and the rest of the row is
        zeroed — or, on a rolling cache that ``S`` fills, the window
        tail lands rolled (:func:`~repro_torch.models.model.roll_window`)
        — so the slot holds exactly what the reference's full-capacity
        prefill cache would; the other leaves (whisper's cross K/V, a
        recurrent slot's state) land whole on their batch axis."""
        self._occupied.add(slot)
        for name, ax in self._axes.items():
            dst = self._cache[name].select(ax, slot)
            src = rows[name].select(ax, 0)
            if name not in ("k", "v"):
                dst.copy_(src)
                continue
            s, c = src.shape[1], dst.shape[1]
            if self._rolling and s >= c:
                dst.copy_(MD.roll_window(rows[name], c)[:, 0])
            else:
                dst[:, :s] = src
                dst[:, s:].zero_()

    def reserve(self, slot: int, n_prompt: int, budget: int) -> None:
        self._occupied.add(slot)  # capacity is pre-provisioned per slot

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
        self._occupied.discard(slot)  # rows are overwritten by the next
        # admission; only the occupancy mark is released

    def export_slot(self, slot: int, n_valid: int, prompt=None,
                    n_prompt=None) -> dict:
        """The slot's row of every batched leaf, on its batch axis:
        ``k``/``v`` up to ``n_valid`` rounded up to the export quantum
        (capped at the capacity — a rolling cache past its window exports
        every slot), whisper's cross K/V and a recurrent slot's state
        whole. Prefix provenance is accepted for signature parity and
        ignored: the dense layout shares nothing."""
        rows = {}
        for name, ax in self._axes.items():
            row = self._cache[name].narrow(ax, slot, 1)
            if name in ("k", "v"):
                row = row[:, :, :min(_export_span(n_valid), row.shape[2])]
            rows[name] = row
        return _host_packet(n_valid, **rows)

    def import_slot(self, packet: dict, slot: int, n_prompt: int,
                    budget: int) -> None:
        if slot in self._occupied:
            raise RuntimeError(
                f"import_slot into occupied slot {slot}: a live stream's "
                "KV would be silently clobbered — free the slot first "
                "(preemption/requeue must never double-import)")
        rows = {name: packet[name].to(self.device) for name in self._axes}
        self.splice(rows, slot, n_prompt, budget)

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
        if cfg.family not in MD.TRANSFORMER_FAMILIES:
            raise ValueError(f"paged cache does not support family "
                             f"{cfg.family!r}")
        if cfg.sliding_window is not None:
            raise ValueError("paged cache does not support rolling SWA "
                             "caches (already capacity-bounded)")
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
        self._pool_k, self._pool_v = self._make_pools(cfg, NB, bs, device)
        B = ecfg.max_batch
        self.table = np.full((B, W), NB, np.int32)
        self.allocator = BlockAllocator(NB)
        self._reserved = np.zeros(B, np.int64)
        self._max_seq_len = C
        # opt-in prefix caching: hash-chained shared blocks + refcounts
        self.prefix = (PrefixIndex(bs)
                       if getattr(ecfg, "prefix_cache", False) else None)
        self._shared: list[set[int]] = [set() for _ in range(B)]
        self.prefix_lookups = 0        # admissions that consulted the index
        self.prefix_hits = 0           # admissions with a nonzero match
        self.prefix_hit_tokens = 0     # prompt tokens served from cache
        self.prefix_lookup_tokens = 0  # prompt tokens across lookups

    def _make_pools(self, cfg, num_blocks, block_size, device):
        return MD.init_paged_pools(cfg, num_blocks, block_size,
                                   device=device)

    # -- accounting -------------------------------------------------------
    def _need_blocks(self, n_prompt: int, budget: int) -> int:
        """Worst-case blocks a request ever touches: positions
        ``0 .. n_prompt + budget - 2`` (the last generated token's KV is
        never written), capped by the retirement bound ``C - 1``."""
        n_pos = min(n_prompt + max(budget, 1) - 1, self._max_seq_len - 1)
        return math.ceil(max(n_pos, 1) / self.block_size)

    def can_admit(self, n_prompt: int, budget: int, prompt=None) -> bool:
        need = self._need_blocks(n_prompt, budget)
        if need > self.allocator.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks but the pool only has "
                f"{self.allocator.num_blocks}; raise kv_blocks or lower "
                "max_new_tokens")
        avail = self.allocator.free_blocks - int(self._reserved.sum())
        if self.prefix is not None:
            # a cached prefix charges nothing; refcount-zero resident
            # blocks (minus the ones this match revives) are evictable on
            # demand, so they count as available — also without a prompt
            # (the resume gate), or a pool parked in the LRU queue would
            # refuse a resume forever
            ids = (self.prefix.match(prompt, n_prompt)
                   if prompt is not None else [])
            need -= len(ids)
            avail += self.prefix.evictable(excluding=ids)
        return avail >= need

    def prefix_match_tokens(self, prompt, n_prompt: int) -> int:
        """Tokens of the longest cached block-aligned prefix (a pure
        query: no counters, no refcounts)."""
        if self.prefix is None:
            return 0
        return len(self.prefix.match(prompt, n_prompt)) * self.block_size

    def _alloc_block(self) -> int:
        """Allocate one pool block, evicting the LRU refcount-zero shared
        block under pressure (the freed id is handed right back out)."""
        if self.prefix is not None and self.allocator.free_blocks == 0:
            bid = self.prefix.evict_lru()
            if bid is not None:
                self.allocator.free(bid)
        return self.allocator.alloc()

    def _free_block(self, blk: int) -> None:
        """Return a privately held block to the allocator. Freeing a
        block the prefix index still refcounts or holds would let another
        table alias a recycled block — raise instead."""
        if self.prefix is not None:
            if self.prefix.refcount(blk) > 0:
                raise RuntimeError(
                    f"freeing shared block {blk} with refcount "
                    f"{self.prefix.refcount(blk)}: another slot's table "
                    "still aliases it — release via the prefix index, "
                    "never the raw allocator")
            if self.prefix.holds(blk):
                raise RuntimeError(
                    f"freeing registered shared block {blk} outside the "
                    "eviction path: the index would map its hash to a "
                    "recycled id")
        self.allocator.free(blk)

    def _alloc_into(self, slot: int, b: int) -> None:
        """Give table entry ``b`` of ``slot`` a block if it has none,
        paying the slot's reservation down."""
        if self.table[slot, b] == self.num_blocks:
            self.table[slot, b] = self._alloc_block()
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
               budget: int, prompt=None) -> None:
        """A blocking prefill's rows (L, 1, S, H, Dh): allocate exactly the
        prompt's blocks and store the rows they cover (pad rows past the
        prompt that share its last block come along, masked by length)."""
        now = math.ceil(n_prompt / self.block_size)
        for b in range(now):
            self.table[slot, b] = self._alloc_block()
        self._reserved[slot] = self._need_blocks(n_prompt, budget) - now
        n = min(int(rows["k"].shape[2]), now * self.block_size)
        self._write(rows["k"], rows["v"], slot, np.arange(n))
        if self.prefix is not None and prompt is not None:
            # a cold full prefill under prefix mode: count the miss
            self.prefix_lookups += 1
            self.prefix_lookup_tokens += int(n_prompt)

    def splice_prefix(self, slot: int, prompt, n_prompt: int,
                      budget: int) -> int:
        """Install the longest cached block-aligned prefix into the
        slot's table (aliasing shared blocks, refcounts bumped) and set
        the reservation to charge only the uncached suffix. Returns the
        matched prefix length in tokens: the caller prefills only
        ``prompt[h:]`` at history offset ``h``. With no match this is
        :meth:`reserve` plus miss accounting."""
        assert self.prefix is not None, "prefix caching is not enabled"
        ids = self.prefix.match(prompt, n_prompt)
        h = len(ids)
        self.prefix.acquire(ids)
        self._shared[slot] = set(ids)
        if h:
            self.table[slot, :h] = ids
        self._reserved[slot] = self._need_blocks(n_prompt, budget) - h
        self.prefix_lookups += 1
        self.prefix_lookup_tokens += int(n_prompt)
        if h:
            self.prefix_hits += 1
            self.prefix_hit_tokens += h * self.block_size
        return h * self.block_size

    def register_prefix(self, slot: int, prompt, n_prompt: int) -> None:
        """Publish the slot's full prompt blocks as shared, once the
        prompt's KV is resident. Only blocks wholly inside the prompt are
        shareable — every later write lands at a position ``>=
        n_prompt``, in a later private block — so published blocks are
        immutable. A hash already mapped to another block is skipped:
        the slot keeps its private copy."""
        if self.prefix is None:
            return
        full = int(n_prompt) // self.block_size
        if not full:
            return
        keys = self.prefix.keys_for(prompt, full)
        for k in range(full):
            blk = int(self.table[slot, k])
            if blk in self._shared[slot]:
                continue  # already aliased shared (a match hit)
            if self.prefix.register(keys[k], blk):
                self._shared[slot].add(blk)

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
        return self._view()

    def _view(self) -> dict:
        """The device cache dict of a decode or verify dispatch."""
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
            self._free_block(blk)
            self.table[slot, b] = self.num_blocks
            self._reserved[slot] += 1

    def commit(self, new_cache: dict) -> None:
        self._pool_k = new_cache["k"]
        self._pool_v = new_cache["v"]

    def free(self, slot: int) -> None:
        shared = self._shared[slot]
        for blk in self.table[slot]:
            if blk == self.num_blocks:
                continue
            blk = int(blk)
            if blk in shared:
                # shared blocks are released, never raw-freed: at
                # refcount zero they stay resident on the LRU queue
                self.prefix.release(blk)
            else:
                self._free_block(blk)
        self.table[slot] = self.num_blocks
        self._reserved[slot] = 0
        self._shared[slot] = set()

    def export_slot(self, slot: int, n_valid: int, prompt=None,
                    n_prompt=None) -> dict:
        """Gather the slot's first ``ceil(n_valid / bs)`` blocks (lazy
        allocation fills the table as a prefix) into dense rows — the
        backend-portable format. With prefix caching on and the prompt
        given, the packet carries its provenance, so a prefix-caching
        importer re-matches it and aliases what it already holds."""
        bs = self.block_size
        nblk = max(1, math.ceil(max(int(n_valid), 1) / bs))
        k, v = self._slot_rows(slot, nblk)
        packet = _host_packet(n_valid, k=k, v=v)
        if (self.prefix is not None and prompt is not None
                and n_prompt is not None):
            packet["prefix"] = {
                "tokens": np.asarray(prompt, np.int32).copy(),
                "n_prompt": int(n_prompt),
                "shared_blocks": len(self._shared[slot]),
            }
        return packet

    def _slot_rows(self, slot: int, nblk: int) -> tuple:
        """The slot's first ``nblk`` blocks as dense rows (L, 1, nblk *
        bs, H, Dh), K and V."""
        idx = torch.from_numpy(self.table[slot, :nblk].astype(np.int64))
        idx = idx.to(self.device)
        l, tail = self._pool_k.shape[0], self._pool_k.shape[3:]
        span = nblk * self.block_size
        return (self._pool_k[:, idx].reshape(l, 1, span, *tail),
                self._pool_v[:, idx].reshape(l, 1, span, *tail))

    def import_slot(self, packet: dict, slot: int, n_prompt: int,
                    budget: int) -> None:
        """Unpack into freshly allocated blocks (aliasing whatever prefix
        this pool's index already holds) and re-run the reservation: the
        request's worst case less the blocks held now stays reserved, so
        an imported stream keeps the no-deadlock guarantee."""
        if (self.table[slot] != self.num_blocks).any() or self._reserved[slot]:
            raise RuntimeError(
                f"import_slot into occupied slot {slot}: its block-table "
                "row still holds allocated blocks (or a live "
                "reservation) that would leak from the pool — free the "
                "slot first (preemption/requeue must never double-import)")
        bs = self.block_size
        n_valid = int(packet["n_valid"])
        now = max(1, math.ceil(max(n_valid, 1) / bs))
        need = self._need_blocks(n_prompt, budget)
        # h < now always: matches stop at (n_prompt - 1) // bs blocks and
        # n_valid >= n_prompt
        ids: list[int] = []
        prov = packet.get("prefix")
        if self.prefix is not None and prov is not None:
            ids = self.prefix.match(prov["tokens"], int(prov["n_prompt"]))
        h = len(ids)
        if ids:
            self.prefix.acquire(ids)
        self._shared[slot] = set(ids)
        if h:
            self.table[slot, :h] = ids
        for b in range(h, now):
            self.table[slot, b] = self._alloc_block()
        self._reserved[slot] = max(0, need - now)
        span = now * bs
        rows = []
        for name in ("k", "v"):
            r = packet[name][:, :, h * bs:span].to(self.device)
            if r.shape[2] < span - h * bs:  # cross-backend: pad the span
                r = torch.nn.functional.pad(
                    r, (0, 0, 0, 0, 0, span - h * bs - r.shape[2]))
            rows.append(r)
        self._write(rows[0], rows[1], slot, np.arange(h * bs, span))

    def resident_kv_bytes(self) -> int:
        return (self.allocator.allocated_blocks * self.block_size
                * self._bytes_per_token)

    @property
    def peak_resident_kv_bytes(self) -> int:
        return (self.allocator.peak_allocated * self.block_size
                * self._bytes_per_token)

    @property
    def resident_shared_kv_bytes(self) -> int:
        """Bytes held by blocks the prefix index has published (any
        refcount, the refcount-zero LRU tail included)."""
        if self.prefix is None:
            return 0
        return (self.prefix.resident_blocks * self.block_size
                * self._bytes_per_token)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the cache."""
        if not self.prefix_lookup_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_lookup_tokens


# ---------------------------------------------------------------------------
# caches over a device mesh
# ---------------------------------------------------------------------------

_KV = ("k", "v")
_CROSS = ("cross_k", "cross_v")


def kv_placement(spec) -> tuple:
    """(layout, position axes) of a K/V spec (.., B, C, H, Dh):
    ``"heads"`` where the heads split over ``model`` (positions whole),
    ``"seq"`` where the positions split — over ``model``, or over
    ``data`` and ``model`` where the batch does not divide over ``data``
    (the reference's ``cache_shardings``) —, else ``"replicated"``."""
    h_ax, c_ax = spec[-2], spec[-3]
    if h_ax is not None and SH.MODEL in h_ax:
        return "heads", None
    if c_ax is not None:
        return "seq", tuple(c_ax)
    return "replicated", None


def kv_partition_count(spec, mesh) -> int:
    """Distinct shards a leaf of ``spec`` has: the divisor from its
    logical bytes to each device's (the reference's
    ``kv_partition_count``)."""
    n = 1
    for e in spec:
        n *= SH.split_count(e, mesh)
    return n


class _MeshSlots:
    """What the mesh caches share. Slot ``s`` lives on data replica ``s
    // (B / data)`` at local row ``s % (B / data)``; where the batch does
    not divide over ``data`` every data replica holds every slot (and a
    contiguous cache splits its positions over every axis instead). A
    rank's share of a slot's K/V rows (.., 1, S, H, Dh) is its heads
    (``"heads"``) or all of them; of a recurrent state leaf, its heads
    or channels where :attr:`model_specs` splits them over ``model``,
    else all of it."""

    def _init_mesh(self, mesh, max_batch: int, layout: str, h_local: int,
                   pos_axes=None, model_specs=None):
        self.mesh = mesh
        self.layout = layout
        self.pos_axes = pos_axes
        # a state leaf split over model -> its spec's model entries alone
        self.model_specs = model_specs or {}
        self.split_rows = max_batch % mesh.shape[0] == 0
        self._rows_per_group = (max_batch // mesh.shape[0] if self.split_rows
                                else max_batch)
        self._h_local = h_local

    def _where(self, slot: int) -> tuple[int, int]:
        if not self.split_rows:
            return 0, int(slot)
        return divmod(int(slot), self._rows_per_group)

    def slot_ranks(self, slot: int) -> tuple:
        """The ranks that hold ``slot``'s rows."""
        if not self.split_rows:
            return tuple(range(self.mesh.size))
        return self.mesh.data_group(self._where(slot)[0])

    def _pos_index(self, rank: int) -> int:
        """The rank's position shard in the ``"seq"`` layout."""
        grp = self.mesh.group(rank, self.pos_axes)
        return grp.index(rank)

    def _export_ranks(self, slot: int, name: str) -> tuple:
        """The ranks whose shares of ``name``, in order, make ``slot``'s
        rows whole: its position shards, its data replica's heads, or
        its replica's first rank."""
        first = self.mesh.rank_of(self._where(slot)[0], 0)
        if name in _KV and self.layout == "seq":
            return self.mesh.group(first, self.pos_axes)
        if (name in _KV + _CROSS and self.layout == "heads"
                or name in self.model_specs):
            return self.mesh.data_group(self._where(slot)[0])
        return (first,)

    def _share(self, rows, name: str, rank: int) -> torch.Tensor:
        """Rank ``rank``'s share of a slot's rows, on its device: its own
        dispatch output when ``rows`` is a :class:`PerRank` (the ranks of
        one model index hold equal shares), else its cut of the whole
        rows (an imported packet)."""
        dev = self.mesh.devices[rank]
        mi = self.mesh.coords(rank)[1]
        if isinstance(rows, PerRank):
            src = next(r for i, r in enumerate(rows) if r is not None
                       and self.mesh.coords(i)[1] == mi)
            return src[name].to(dev)
        t = rows[name]
        if self.layout == "heads" and name in _KV + _CROSS:
            h = self._h_local
            t = t[..., mi * h:(mi + 1) * h, :]
        elif name in self.model_specs:
            t = t[SH.shard_slices(tuple(t.shape), self.model_specs[name],
                                  self.mesh, self.mesh.coords(rank))]
        return t.to(dev)

    def _whole_rows(self, name: str, parts: list) -> torch.Tensor:
        """A slot's rows of ``name`` from :meth:`_export_ranks`' shares
        (in that order) as the single device holds them."""
        if len(parts) == 1:
            return parts[0].cpu()
        if name in self.model_specs:
            # the state's heads or channels: the one dim split over model
            dim = next(d for d, e in enumerate(self.model_specs[name])
                       if e is not None)
        else:
            dim = -2 if self.layout == "heads" else -3   # heads, positions
        return torch.cat([p.cpu() for p in parts], dim=dim)


class MeshContiguousCache(_MeshSlots, ContiguousCache):
    """:class:`ContiguousCache` over a mesh, for every family: each rank
    holds its data replica's ``B / data`` slots (every slot where the
    batch does not divide over ``data``) and, by
    :func:`~repro_torch.distributed.sharding.cache_specs`, its KV heads
    (``"heads"``), a range of positions (``"seq"``: the heads do not
    divide ``model``, or the batch ``data``) or the whole rows
    (``"replicated"``). Whisper's encoder cache holds the rank's heads
    in ``"heads"``, every position otherwise; a recurrent family's
    ``ssm`` and ``mlstm`` state hold the rank's heads and its ``conv``
    state its channels where they divide ``model`` (the sLSTM's state
    whole, as its recurrence runs), and an xLSTM, which holds no K/V, is
    ``"replicated"``.
    The host bookkeeping is the base class's; exported packets are the
    single device's, byte for byte."""

    def __init__(self, cfg, ecfg, mesh):
        B, C = ecfg.max_batch, ecfg.max_seq_len
        meta = MD.cache_spec(cfg, B, C)
        self.specs = SH.cache_specs(meta, mesh)
        layout, pos_axes = (kv_placement(self.specs["k"]) if "k" in meta
                            else ("replicated", None))
        split_rows = B % mesh.shape[0] == 0
        data = (SH.DATA,) if split_rows else None
        place, model_specs = {}, {}
        for name, leaf in meta.items():
            nd = leaf.dim()
            if name == "len":
                continue
            if name in _KV:
                h = (SH.MODEL,) if layout == "heads" else None
                c = pos_axes if layout == "seq" else None
                place[name] = (None,) * (nd - 4) + (data, c, h, None)
            elif name in _CROSS:
                h = (SH.MODEL,) if layout == "heads" else None
                place[name] = (None,) * (nd - 4) + (data, None, h, None)
            else:
                # the state's batch over data; its heads or channels as
                # the rule splits them over model
                ax = MD.cache_batch_axes({name: leaf})[name]
                model = tuple(e if e is not None and SH.MODEL in e
                              else None for e in self.specs[name])
                place[name] = tuple(data if d == ax else model[d]
                                    for d in range(nd))
                if any(e is not None for e in model):
                    model_specs[name] = model
        self.placement = place
        local = {name: SH.local_shape(tuple(meta[name].shape), spec, mesh)
                 for name, spec in place.items()}
        h_local = local["k"][-2] if "k" in local else 0
        self._init_mesh(mesh, B, layout, h_local, pos_axes, model_specs)
        self._shards = PerRank(
            {**{name: torch.zeros(local[name], dtype=meta[name].dtype,
                                  device=dev) for name in place},
             "len": torch.zeros((), dtype=torch.int32, device=dev)}
            for dev in mesh.devices)
        self._cache = None
        self._axes = {name: ax for name, ax in
                      MD.cache_batch_axes(meta).items() if ax is not None}
        self._rolling = cfg.sliding_window is not None
        self._footprint = contiguous_kv_bytes(cfg, B, C)
        self.device = mesh.devices[0]
        self._occupied: set[int] = set()
        self.kv_partitions = (kv_partition_count(place["k"], mesh)
                              if "k" in place else 1)
        self._c_whole = meta["k"].shape[-3] if "k" in meta else 0
        self._meta = meta
        self._c_local = local["k"][-3] if "k" in local else 0

    def whole_spec(self) -> dict:
        """The one-device cache dict of a decode or verify dispatch, as
        meta tensors of the whole shapes."""
        return dict(self._meta)

    def splice(self, rows, slot: int, n_prompt: int, budget: int,
               prompt=None) -> None:
        """As :meth:`ContiguousCache.splice` on each rank holding the
        slot; in the ``"seq"`` layout a rank keeps the prompt's positions
        in its range (of the rolled window, on a rolling cache the
        prompt fills)."""
        self._occupied.add(slot)
        _, lr = self._where(slot)
        c = self._c_local
        for r in self.slot_ranks(slot):
            for name, ax in self._axes.items():
                src = self._share(rows, name, r)
                dst = self._shards[r][name].select(ax, lr)
                if name not in _KV:
                    dst.copy_(src.select(ax, 0))
                    continue
                s = src.shape[2]
                if self._rolling and s >= self._c_whole:
                    src = MD.roll_window(src, self._c_whole)
                    s = self._c_whole
                if self.layout == "seq":
                    off = self._pos_index(r) * c
                    part = src[:, 0, off:off + c]
                    n = part.shape[1]
                    dst[:, :n] = part
                    dst[:, n:].zero_()
                else:
                    dst[:, :s] = src[:, 0]
                    dst[:, s:].zero_()

    def splice_partial(self, k_rows, v_rows, slot: int, offset: int,
                       n_valid: int) -> None:
        """A chunk's K/V rows at positions ``offset .. offset + n_valid -
        1`` of each rank holding the slot — in the ``"seq"`` layout only
        those in the rank's range."""
        _, lr = self._where(slot)
        c = self._c_local
        for r in self.slot_ranks(slot):
            lo, hi = offset, offset + n_valid
            base = 0
            if self.layout == "seq":
                base = self._pos_index(r) * c
                lo, hi = max(lo, base), min(hi, base + c)
                if lo >= hi:
                    continue
            for name, rows in (("k", k_rows), ("v", v_rows)):
                src = self._share(_named(rows, name), name, r)
                self._shards[r][name][:, lr, lo - base:hi - base] = \
                    src[:, 0, lo - offset:hi - offset]

    def chunk_view(self, slot: int) -> dict:
        return {"kind": "contiguous",
                "k": PerRank(sh["k"] for sh in self._shards),
                "v": PerRank(sh["v"] for sh in self._shards),
                "slot": self._where(slot)[1]}

    def decode_view(self, pos, live) -> PerRank:
        return self._shards

    def verify_view(self, pos, live, n_tokens) -> PerRank:
        return self._shards

    def commit(self, new_cache) -> None:
        self._shards = PerRank(new_cache)

    def export_slot(self, slot: int, n_valid: int, prompt=None,
                    n_prompt=None) -> dict:
        """The single device's packet: the slot's rows gathered from the
        ranks holding their shares (heads, or positions, in order)."""
        _, lr = self._where(slot)
        rows = {}
        for name, ax in self._axes.items():
            full = self._whole_rows(name, [
                self._shards[r][name].narrow(ax, lr, 1)
                for r in self._export_ranks(slot, name)])
            if name in _KV:
                full = full[:, :, :min(_export_span(n_valid),
                                       full.shape[2])]
            rows[name] = full
        return _host_packet(n_valid, **rows)

    def import_slot(self, packet: dict, slot: int, n_prompt: int,
                    budget: int) -> None:
        if slot in self._occupied:
            raise RuntimeError(
                f"import_slot into occupied slot {slot}: a live stream's "
                "KV would be silently clobbered — free the slot first "
                "(preemption/requeue must never double-import)")
        self.splice({name: packet[name] for name in self._axes}, slot,
                    n_prompt, budget)


class MeshPagedCache(_MeshSlots, PagedCache):
    """:class:`PagedCache` over a mesh: one host allocator and block
    table; each rank's pool holds its KV heads (every head where they do
    not divide ``model``: :func:`~repro_torch.distributed.sharding.
    pool_spec`), whole over ``data``. Blocks written from the host (a
    prefill's splice, a chunk, an import) land in every data replica's
    pools, so a shared prefix block is whole wherever a table aliases
    it; a decode or verify dispatch writes its own rows' blocks."""

    def __init__(self, cfg, ecfg, mesh):
        self.mesh = mesh
        super().__init__(cfg, ecfg, mesh.devices[0])
        self._init_mesh(mesh, ecfg.max_batch, self._pool_layout,
                        self._h_pool)
        self.kv_partitions = kv_partition_count(self._pool_spec, mesh)

    def whole_spec(self) -> dict:
        """The one-device cache dict of a decode or verify dispatch, as
        meta tensors of the whole shapes."""
        shape, dt = self._pool_whole
        pool = torch.empty(shape, dtype=dt, device="meta")
        return {"k": pool, "v": pool,
                "block_tab": torch.empty(self.table.shape, dtype=torch.int32,
                                         device="meta"),
                "len": torch.empty((), dtype=torch.int32, device="meta")}

    def _make_pools(self, cfg, num_blocks, block_size, device):
        st = MD.paged_pool_struct(cfg, num_blocks, block_size)
        shape, dt = st["k"]
        self._pool_whole = (shape, dt)
        self._pool_spec = spec = SH.pool_spec(shape, self.mesh)
        self._pool_layout = "heads" if spec[-2] is not None else "replicated"
        local = SH.local_shape(shape, spec, self.mesh)
        self._h_pool = local[-2]
        self._pools_k = PerRank(torch.zeros(local, dtype=dt, device=d)
                                for d in self.mesh.devices)
        self._pools_v = PerRank(torch.zeros(local, dtype=dt, device=d)
                                for d in self.mesh.devices)
        return None, None

    def _write(self, k_rows, v_rows, slot: int, pos: np.ndarray) -> None:
        bs = self.block_size
        blk = torch.from_numpy(self.table[slot, pos // bs].astype(np.int64))
        off = torch.from_numpy(pos % bs)
        n = len(pos)
        for r, dev in enumerate(self.mesh.devices):
            b, o = blk.to(dev), off.to(dev)
            for pools, rows, name in ((self._pools_k, k_rows, "k"),
                                      (self._pools_v, v_rows, "v")):
                src = self._share(_named(rows, name), name, r)
                pools[r][:, b, o] = src[:, 0, :n].to(pools[r].dtype)

    def splice(self, rows, slot: int, n_prompt: int, budget: int,
               prompt=None) -> None:
        now = math.ceil(n_prompt / self.block_size)
        for b in range(now):
            self.table[slot, b] = self._alloc_block()
        self._reserved[slot] = self._need_blocks(n_prompt, budget) - now
        s = _rows_len(rows)
        n = min(s, now * self.block_size)
        self._write(_leaf(rows, "k"), _leaf(rows, "v"), slot, np.arange(n))
        if self.prefix is not None and prompt is not None:
            self.prefix_lookups += 1
            self.prefix_lookup_tokens += int(n_prompt)

    def chunk_view(self, slot: int) -> dict:
        tab = self.table[slot:slot + 1].copy()
        return {"kind": "paged", "k": self._pools_k, "v": self._pools_v,
                "table": PerRank(torch.from_numpy(tab).to(d)
                                 for d in self.mesh.devices)}

    def _view(self) -> PerRank:
        out = PerRank()
        for r, dev in enumerate(self.mesh.devices):
            g = self.mesh.coords(r)[0] if self.split_rows else 0
            rows = self.table[g * self._rows_per_group:
                              (g + 1) * self._rows_per_group]
            out.append({"k": self._pools_k[r], "v": self._pools_v[r],
                        "block_tab": torch.from_numpy(rows.copy()).to(dev),
                        "len": torch.zeros((), dtype=torch.int32)})
        return out

    def commit(self, new_cache) -> None:
        self._pools_k = PerRank(c["k"] for c in new_cache)
        self._pools_v = PerRank(c["v"] for c in new_cache)

    def _slot_rows(self, slot: int, nblk: int) -> tuple:
        idx = torch.from_numpy(self.table[slot, :nblk].astype(np.int64))
        span = nblk * self.block_size
        out = []
        for pools in (self._pools_k, self._pools_v):
            parts = []
            for r in self._export_ranks(slot, "k"):
                p = pools[r]
                parts.append(p[:, idx.to(p.device)].reshape(
                    p.shape[0], 1, span, *p.shape[3:]))
            out.append(self._whole_rows("k", parts))
        return tuple(out)


def _named(rows, name):
    """``rows`` for :meth:`_MeshSlots._share` given one leaf's rows: a
    PerRank of tensors becomes a PerRank of {name: tensor}."""
    if isinstance(rows, PerRank):
        return PerRank(None if r is None else {name: r} for r in rows)
    return {name: rows}


def _leaf(rows, name):
    """One leaf of splice ``rows``: a PerRank of dicts, or a dict."""
    if isinstance(rows, PerRank):
        return PerRank(None if r is None else r[name] for r in rows)
    return rows[name]


def _rows_len(rows) -> int:
    """Positions the splice ``rows`` carry (dim 2 of ``k``)."""
    if isinstance(rows, PerRank):
        return int(next(r for r in rows if r is not None)["k"].shape[2])
    return int(rows["k"].shape[2])


def make_kv_cache(cfg, ecfg, device, mesh=None) -> KVCacheManager:
    """Build the configured backend; families the paged layout cannot
    express (whisper's cross-attention cache, rolling SWA) fall back to
    contiguous with the reference's warning. With ``mesh`` (a
    :class:`~repro_torch.distributed.mesh.DeviceMesh`) the backend's
    mesh form holds per-rank shards."""
    kind = ecfg.kv_cache
    contiguous = (ContiguousCache if mesh is None
                  else lambda c, e, _: MeshContiguousCache(c, e, mesh))
    paged = (PagedCache if mesh is None
             else lambda c, e, _: MeshPagedCache(c, e, mesh))
    if kind == "contiguous":
        return contiguous(cfg, ecfg, device)
    if kind == "paged":
        if (cfg.family not in MD.TRANSFORMER_FAMILIES
                or cfg.sliding_window is not None):
            warnings.warn(
                f"paged KV cache unsupported for family={cfg.family!r} "
                f"sliding_window={cfg.sliding_window}; falling back to "
                "contiguous", stacklevel=2)
            return contiguous(cfg, ecfg, device)
        return paged(cfg, ecfg, device)
    raise ValueError(f"unknown kv_cache {kind!r}")
