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
  verifies all slots' windows in one target dispatch;
- :class:`SLOScheduler`: blocking admission in (priority, TTFT-deadline
  slack, arrival) order; when every slot is busy a higher-priority
  arrival preempts the lowest-priority live slot, whose stream is packed
  to the host (``export_slot``) and later resumes from its exact
  position, so no token is lost.

Prefix caching sits under every policy at the admission seam: policies
only feel it through ``can_admit`` (a cached prefix charges nothing).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SLO:
    """Per-request service-level objective: time-to-first-token and
    inter-token-latency targets in seconds (``inf`` = no target)."""
    ttft_s: float = float("inf")
    itl_s: float = float("inf")


def slo_sort_key(req, now: float):
    """Admission order for the SLO policy: priority (desc) first, then
    TTFT-deadline slack, then arrival, with rid as the deterministic
    tiebreak."""
    ttft = req.slo.ttft_s if req.slo is not None else float("inf")
    slack = (req.t_submit + ttft - now) if math.isfinite(ttft) else float("inf")
    return (-req.priority, slack, req.t_submit, req.rid)


def preempt_victim_key(priority: int, remaining: int, slot: int):
    """Victim choice among live slots: lowest priority first, then the
    slot with the most remaining budget (evicting it wastes the least
    imminent completion), then slot index."""
    return (priority, -remaining, slot)


@dataclass
class PrefillState:
    """Host-side progress of one chunked prefill occupying a slot (the
    chunked policy's state; the blocking policy never creates one)."""
    prompt: np.ndarray   # already truncated to capacity
    n_prompt: int        # prompt positions
    budget: int          # generation budget at admission
    seed: int = 0        # sampling seed resolved at admission
    done: int = 0        # positions already cached (from the matched
                         # prefix on, with prefix caching)

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


class SLOScheduler(BlockingScheduler):
    """SLO-aware multi-tenant policy: deadline-slack-ordered admission
    plus preempt-and-requeue of lower-priority live slots.

    Each step re-sorts the waiting queue by :func:`slo_sort_key` and
    runs the inherited blocking admission over free slots. If requests
    are still waiting afterwards, a preemption pass evicts, for each
    waiting request that strictly outranks some live slot, the victim
    chosen by :func:`preempt_victim_key` (``ServingEngine.preempt_slot``
    packs and requeues it), and the high-priority request prefills into
    the freed slot this same step. Preemption never crosses equal
    priorities, so it cannot livelock."""

    name = "slo"

    def admit(self, eng) -> None:
        if len(eng.waiting) > 1:
            now = eng._now()
            ordered = sorted(eng.waiting, key=lambda r: slo_sort_key(r, now))
            eng.waiting.clear()
            eng.waiting.extend(ordered)
        super().admit(eng)
        self._preempt_pass(eng)

    def _preempt_pass(self, eng) -> None:
        # bounded: each iteration either preempts (at most max_batch
        # victims can exist) or stops
        for _ in range(2 * eng.ecfg.max_batch):
            if not eng.waiting:
                return
            head = eng.waiting[0]
            victim = self._pick_victim(eng, head.priority)
            if victim is None:
                return
            eng.preempt_slot(victim)          # frees slot, requeues victim
            req = eng.waiting.popleft()       # == head
            if not self._admit_request(eng, victim, req):
                eng.waiting.appendleft(req)   # cache deferral: retry next step
                return

    def _pick_victim(self, eng, priority: int) -> int | None:
        """Live decode slot with strictly lower priority, preferring the
        one ranked first by :func:`preempt_victim_key`."""
        best = None
        for slot, req in enumerate(eng.slot_req):
            if req is None or slot in eng.prefilling:
                continue
            if req.priority >= priority:
                continue
            remaining = eng._budget(req) - int(eng.slot_len[slot])
            key = preempt_victim_key(req.priority, remaining, slot)
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
    if kind == "slo":
        return SLOScheduler()  # blocking admission: every family
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
    raise ValueError(f"unknown scheduler {kind!r}")
