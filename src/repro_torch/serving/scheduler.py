"""Scheduling policy for the continuous-batching serving engine.

Counterpart of ``repro/serving/scheduler.py``. The engine keeps the
mechanism (prefills, chunks, the single ragged decode or verify
dispatch, retirement bookkeeping); a :class:`Scheduler` owns the policy
— which waiting request enters which slot, which prefill work runs this
step, and when a slot retires:

- :class:`BlockingScheduler`: a request's whole prompt prefills at
  admission in one bucketed dispatch;
- :class:`ChunkedScheduler`: admission only binds a slot; every step
  carries decode tokens for all live slots plus at most one
  ``chunk_tokens`` prefill chunk, shortest remaining prompt first;
- :class:`SpeculativeScheduler`: blocking admission (target and draft),
  then every step drafts ``spec_gamma`` tokens per live slot and
  verifies all slots' windows in one target dispatch.

The SLO policy (preemption) is a later slice of the port.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np


@dataclass
class PrefillState:
    """Host-side progress of one chunked prefill occupying a slot (the
    chunked policy's state; the blocking policy never creates one)."""
    prompt: np.ndarray   # already truncated to capacity
    n_prompt: int        # prompt positions
    budget: int          # generation budget at admission
    done: int = 0        # positions already cached

    @property
    def remaining(self) -> int:
        return self.n_prompt - self.done


class Scheduler:
    """Policy seam consulted once per :meth:`ServingEngine.step`: the
    engine calls :meth:`admit`, then — after the decode dispatch —
    :meth:`retire`. Policies only decide; device work
    and bookkeeping live in the engine helpers they call."""

    name = "base"

    def admit(self, eng) -> None:
        """Scan free slots and pop waiting requests FIFO into them. A
        request that finishes at admission leaves the slot free for the
        next one this step; a deferral pushes the request back and
        stops the scan to keep FIFO order."""
        for slot in [i for i, r in enumerate(eng.slot_req) if r is None]:
            while eng.waiting and eng.slot_req[slot] is None:
                req = eng.waiting.popleft()
                if not self._admit_request(eng, slot, req):
                    eng.waiting.appendleft(req)
                    return

    def _admit_request(self, eng, slot: int, req) -> bool:
        """Policy hook: admit ``req`` into ``slot``; False to defer."""
        raise NotImplementedError

    def select_chunk(self, eng) -> int | None:
        """Slot whose prefill receives this step's chunk (``None``: no
        prefill work pending)."""
        return None

    def retire(self, eng) -> None:
        """A decode-phase slot releases when its budget is spent, it
        sampled EOS, or it reached capacity."""
        for i, req in enumerate(eng.slot_req):
            if req is None or i in eng.prefilling:
                continue
            if (eng.slot_len[i] >= eng._budget(req)
                    or req.output[-1] == eng.ecfg.eos_token
                    or eng.slot_pos[i] >= eng.ecfg.max_seq_len - 1):
                eng._retire_slot(i)


class BlockingScheduler(Scheduler):
    """Each admission runs the request's whole prefill in one bucketed
    dispatch; decode slots wait behind it."""

    name = "blocking"

    def _admit_request(self, eng, slot: int, req) -> bool:
        return eng._admit_one(slot, req)


class ChunkedScheduler(Scheduler):
    """Sarathi-style mixed steps: admission binds a request to a slot
    (no dispatch); every step then carries decode tokens for all live
    slots plus at most one prefill chunk, shortest-remaining-first."""

    name = "chunked"

    def __init__(self, chunk_tokens: int):
        self.chunk_tokens = int(chunk_tokens)

    def _admit_request(self, eng, slot: int, req) -> bool:
        return eng._start_prefill(slot, req)

    def select_chunk(self, eng) -> int | None:
        best = None
        for slot, st in eng.prefilling.items():
            key = (st.remaining, eng.slot_req[slot].rid)
            if best is None or key < best[0]:
                best = (key, slot)
        return None if best is None else best[1]


class SpeculativeScheduler(BlockingScheduler):
    """Blocking admission (the engine also prefills the draft's cache);
    the engine's step then drafts and verifies instead of decoding one
    token — still one target dispatch per step."""

    name = "speculative"


def policy_supported(cfg) -> bool:
    """Whether chunked prefill / speculative verify can express this
    model: both resume attention from a KV view, which recurrent state
    and rolling-SWA caches cannot do."""
    return (cfg.family in ("dense", "moe", "vlm")
            and cfg.sliding_window is None)


def make_scheduler(cfg, ecfg) -> Scheduler:
    kind = ecfg.scheduler
    if kind == "blocking":
        return BlockingScheduler()
    if kind in ("chunked", "speculative"):
        if not policy_supported(cfg):
            warnings.warn(
                f"{kind} scheduling unsupported for family="
                f"{cfg.family!r} sliding_window={cfg.sliding_window}; "
                "falling back to blocking", stacklevel=2)
            return BlockingScheduler()
        if kind == "chunked":
            return ChunkedScheduler(ecfg.chunk_tokens)
        return SpeculativeScheduler()
    if kind == "slo":
        raise NotImplementedError(
            "scheduler='slo' (SLO admission with preemption through "
            "export_slot/import_slot) is a later slice of the port")
    raise ValueError(f"unknown scheduler {kind!r}")
