"""KV-cache managers for the serving engine.

Counterpart of ``repro/serving/kv_cache.py``. :class:`KVCacheManager` is
the protocol the engine consumes; this slice ships the dense
:class:`ContiguousCache` — every slot owns ``max_seq_len`` positions of a
``(L, B, C, Hkv, Dh)`` cache on the device. The paged backend is the
next slice.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models import model as MD


def contiguous_kv_bytes(cfg, batch: int, capacity: int) -> int:
    """Total footprint of the dense layout (every leaf but the position
    counter) — the ``max_batch x max_seq_len`` charge."""
    total = 0
    for name, (sh, dt) in MD.cache_struct(cfg, batch, capacity).items():
        if name != "len":
            total += int(np.prod(sh)) * torch.tensor([], dtype=dt
                                                     ).element_size()
    return total


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

    def decode_view(self, pos: np.ndarray, live: np.ndarray) -> dict:
        """Device cache dict for one ragged decode dispatch."""
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

    def decode_view(self, pos, live) -> dict:
        return self._cache

    def commit(self, new_cache: dict) -> None:
        self._cache = new_cache

    def free(self, slot: int) -> None:
        pass  # the rows are overwritten by the next admission

    def resident_kv_bytes(self) -> int:
        return self._footprint


def make_kv_cache(cfg, ecfg, device) -> KVCacheManager:
    kind = ecfg.kv_cache
    if kind == "contiguous":
        return ContiguousCache(cfg, ecfg, device)
    if kind == "paged":
        raise NotImplementedError(
            "kv_cache='paged' (PagedCache over the paged decode kernel K2) "
            "is the next slice of the port")
    raise ValueError(f"unknown kv_cache {kind!r}")
