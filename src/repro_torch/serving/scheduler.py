"""Scheduling policy for the continuous-batching serving engine.

Counterpart of ``repro/serving/scheduler.py``. The engine keeps the
mechanism (prefills, the single ragged decode dispatch, retirement
bookkeeping); a :class:`Scheduler` owns the policy — which waiting
request enters which slot, which prefill work runs this step, and when
a slot retires. This slice ships :class:`BlockingScheduler`: a
request's whole prompt prefills at admission in one bucketed dispatch.
Chunked, speculative and SLO policies are later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PrefillState:
    """Host-side progress of one chunked prefill occupying a slot (the
    chunked policy's state; the blocking policy never creates one)."""
    prompt: np.ndarray   # token part, already truncated to capacity
    n_prefix: int        # non-token prefix positions (vlm image tokens)
    n_prompt: int        # total sequence positions incl. prefix
    budget: int          # generation budget at admission
    seed: int            # sampling seed resolved at admission
    done: int = 0        # sequence positions already cached

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


def make_scheduler(cfg, ecfg) -> Scheduler:
    kind = ecfg.scheduler
    if kind == "blocking":
        return BlockingScheduler()
    if kind in ("chunked", "speculative", "slo"):
        raise NotImplementedError(
            f"scheduler={kind!r} is a later slice of the port (chunked "
            "prefill and speculative verify come with the "
            "prefill-over-cache kernel K4); only 'blocking' runs")
    raise ValueError(f"unknown scheduler {kind!r}")
