"""Disaggregated prefill/decode cluster serving.

Counterpart of ``repro/serving/cluster.py``, method for method.
PIM-AI's cloud thesis is heterogeneous (§1.2, §3.4): prefill is
compute-bound and belongs on an xPU, decode is memory-bound and belongs
on PIM DIMMs, and the KV cache crosses the device boundary exactly once
per request. A :class:`ClusterEngine` routes requests across
``n_prefill`` prefill workers and ``n_decode`` decode workers — each a
full :class:`~repro_torch.serving.engine.ServingEngine` on its own
device — with:

- **KV handoff** at the prefill→decode boundary: ``export_slot`` packs a
  slot's live cache state (dense KV rows plus any recurrent or cross
  state) into a host packet, and ``import_slot`` re-lands it on the
  importing worker's device — paged backends re-run the worst-case
  reservation arithmetic there, so a migrated request keeps local
  admission's no-mid-decode-deadlock guarantee. Packets are host
  tensors even when both workers share a card, as in the reference;
  the bytes that cross are counted (``kv_transfer_bytes``).
- **A load-balancing router**: each packet goes to the least-loaded
  alive decode worker whose in-flight budget and cache accept it;
  packets that fit nowhere wait, and the same budget throttles prefill
  admission.
- **Prefix-affinity prefill routing** (with ``prefix_cache`` on): a
  waiting request goes to the prefill worker already holding the
  longest cached prefix of its prompt, else round-robin. Packets carry
  prefix provenance, so an importer re-matches against its own index.
- **Fault-tolerant slot migration**: :meth:`drain_worker` /
  :meth:`kill_worker` export every live slot of a decode worker
  mid-stream and re-import them elsewhere; a
  :class:`~repro_torch.distributed.fault_tolerance.StragglerMonitor`
  watches every decode worker's step latency, and
  ``auto_drain_stragglers`` turns its breaches into drains.
- **Autoscaling** between the tiers through the shared
  :func:`~repro_torch.serving.workload.autoscale_decision`.

Placement: ``ClusterConfig.devices`` lists ``torch.device``\\ s (strings
are accepted); ``()`` means every visible CUDA device and raises where
there is none — the CPU is used only when named (``devices=("cpu",)``).
With fewer devices than workers, workers share them round-robin. The
weights move to each distinct device once: workers on one device share
the same tensors and own only their caches; each worker's engine calls
run with its card current, and every kernel launches on its operands'
card. With ``EngineConfig.mesh = (data, model)`` each worker is a mesh
engine over its own disjoint group of ``data * model`` devices (as in
the reference; a device named several times in ``devices`` counts once
per naming), and the handoff moves the single device's packets, which a
mesh cache gathers on export and cuts on import.

Greedy outputs are bitwise the single blocking ``ServingEngine``'s,
migrations included: a decode dispatch runs over all ``max_batch``
slots under the live mask whichever rows are live, the attention
kernels split at fixed boundaries and combine in order, and sampling is
keyed by (seed, rid, position), not by worker or slot.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.serving.engine import (EngineConfig, Request, ServingEngine,
                                        SlotPacket, request_breakdowns)
from repro_torch.serving.scheduler import slo_sort_key
from repro_torch.serving.telemetry import NULL_TELEMETRY
from repro_torch.serving.workload import autoscale_decision

__all__ = ["ClusterConfig", "ClusterEngine", "SlotPacket", "Worker"]


@dataclass
class ClusterConfig:
    """Shape of the disaggregated cluster."""
    n_prefill: int = 1
    n_decode: int = 2
    devices: tuple = ()           # torch.devices (or strings); () -> every
                                  # visible CUDA device
    in_flight: int = 0            # per-decode-worker live-request budget;
                                  # 0 -> the worker's max_batch slots
    straggler_factor: float = 3.0  # StragglerMonitor deadline multiplier
    auto_drain_stragglers: bool = False
    slo_aware: bool = False       # order the cluster queue by priority /
                                  # deadline slack (scheduler.slo_sort_key)
                                  # instead of FIFO
    autoscale: bool = False       # re-provision workers between the
                                  # prefill and decode tiers as the
                                  # workload mix shifts
    autoscale_interval: int = 8   # cluster steps between rescale decisions
    prefill_rate: int = 0         # admissions per alive prefill worker per
                                  # step; 0 = unlimited. With autoscale on,
                                  # a finite rate makes the prefill tier
                                  # size a real step-space throughput knob

    def __post_init__(self):
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError(
                f"cluster needs >= 1 prefill and >= 1 decode worker, got "
                f"n_prefill={self.n_prefill} n_decode={self.n_decode}")
        if self.autoscale and self.autoscale_interval < 1:
            raise ValueError(
                f"autoscale_interval={self.autoscale_interval} must be >= 1")
        self.devices = tuple(torch.device(d) for d in self.devices)


def cluster_devices(devices) -> list[torch.device]:
    """The devices workers go on: ``devices`` as given (a bare "cuda" is
    the current card), or every visible CUDA device when empty — which
    raises where CUDA is absent rather than falling back to the CPU."""
    if not devices:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return out


def params_to(tree, device: torch.device):
    """``tree`` with every tensor leaf on ``device`` (a leaf already
    there is the same tensor, not a copy)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class Worker:
    """One ServingEngine on a device, over ``params`` already placed
    there — or, for a mesh worker, on a tuple of devices, over the whole
    tree its engine shards."""

    def __init__(self, role: str, idx: int, device, params,
                 cfg, ecfg: EngineConfig, straggler_factor: float, *,
                 telemetry=None):
        self.role = role
        self.idx = idx
        self.device = device
        self.alive = True
        self.draining = False
        self.steps = 0
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.params = params
        # every worker engine shares the cluster's telemetry hub and gets
        # its own span/metric track, keyed by its creation identity
        # (autoscaling may later change ``role``; the track name stays)
        if isinstance(device, tuple):
            self.eng = ServingEngine(params, cfg, ecfg, devices=device,
                                     telemetry=telemetry,
                                     telemetry_label=f"{role}{idx}")
            return
        with self.ctx():
            self.eng = ServingEngine(params, cfg, ecfg, device=device,
                                     telemetry=telemetry,
                                     telemetry_label=f"{role}{idx}")

    def ctx(self):
        """Context for host-driven engine calls: the worker's card
        current, or nothing on the CPU or on a mesh (each rank's thread
        enters its own device)."""
        if isinstance(self.device, tuple):
            return contextlib.nullcontext()
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def live_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.eng.slot_req) if r is not None]

    def free_slot(self) -> int | None:
        for i, r in enumerate(self.eng.slot_req):
            if r is None:
                return i
        return None


class ClusterEngine:
    """Route requests across prefill workers and decode workers with KV
    handoff at the phase boundary. API mirrors ``ServingEngine``:
    :meth:`submit`, :meth:`step`, :meth:`run`, :meth:`summary`,
    ``finished``."""

    def __init__(self, params, cfg, ecfg: EngineConfig,
                 ccfg: ClusterConfig | None = None, *,
                 telemetry=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.ccfg = ccfg = ccfg or ClusterConfig()
        # one shared telemetry hub across the router and every worker
        # engine: cluster-level phases land on the "cluster" track,
        # per-worker engine phases/dispatches on "<role><idx>" tracks
        self.telemetry = NULL_TELEMETRY if telemetry is None else telemetry
        self.tel_label = "cluster"
        if ecfg.scheduler != "blocking":
            raise ValueError(
                f"ClusterEngine requires scheduler='blocking', got "
                f"{ecfg.scheduler!r}: the prefill→decode handoff boundary "
                "is the end of a whole-prompt prefill (chunked prefill "
                "would hand off mid-stream state the importing worker "
                "cannot resume; a speculative draft's shadow cache would "
                "have to migrate too)")
        devices = cluster_devices(ccfg.devices)
        n = ccfg.n_prefill + ccfg.n_decode
        placed: dict = {}
        if ecfg.mesh is not None:
            # each worker takes a disjoint group of data * model devices
            # and builds its own mesh over it; its engine shards the
            # whole tree onto the group
            per = ecfg.mesh[0] * ecfg.mesh[1]
            if len(devices) < n * per:
                raise ValueError(
                    f"cluster of {n} workers with per-worker mesh "
                    f"{ecfg.mesh} needs {n * per} devices, but only "
                    f"{len(devices)} are available")
            groups = [tuple(devices[i * per:(i + 1) * per])
                      for i in range(n)]
            placed = {g: params for g in groups}
        else:
            if len(devices) < n:
                warnings.warn(
                    f"cluster wants {n} devices but only {len(devices)} "
                    "available; workers share devices round-robin (no "
                    "hardware parallelism, placement still exercised)",
                    stacklevel=2)
            groups = [devices[i % len(devices)] for i in range(n)]
            # the weights cross to each distinct device once; workers on
            # one device share the tensors
            for dev in groups:
                if dev not in placed:
                    placed[dev] = params_to(params, dev)

        def worker(role, i, dev):
            return Worker(role, i, dev, placed[dev], cfg, ecfg,
                          ccfg.straggler_factor, telemetry=telemetry)

        self.prefill_workers = [worker("prefill", i, groups[i])
                                for i in range(ccfg.n_prefill)]
        self.decode_workers = [worker("decode", i, groups[ccfg.n_prefill + i])
                               for i in range(ccfg.n_decode)]
        self.waiting: deque[Request] = deque()
        self.pending: deque[SlotPacket] = deque()  # awaiting a decode slot
        self.finished: list[Request] = []
        self._next_rid = 0
        self._pf_rr = 0  # prefill round-robin cursor
        self.prefix_routed = 0  # admissions routed by prefix affinity
        self._req_hops: dict[int, int] = {}  # rid -> migrations survived
        # transfer / migration accounting
        self.handoffs = 0
        self.migrations = 0
        self.kv_transfer_bytes = 0
        self.migration_bytes = 0
        # autoscaling / virtual-clock state (trace replay)
        self.steps = 0
        self.rescale_log: list[tuple[int, str]] = []  # (step, direction)
        self.clock = "wall"
        self.now_s = 0.0

    # -- public API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int | None = None,
               seed: int | None = None, *, tenant: str = "",
               priority: int = 0, slo=None,
               arrival_s: float | None = None) -> Request:
        req = Request(self._next_rid, np.asarray(prompt, np.int32),
                      max_new_tokens, seed=seed, tenant=tenant,
                      priority=int(priority), slo=slo, arrival_s=arrival_s,
                      t_submit=(arrival_s if arrival_s is not None
                                else self._now()))
        self._next_rid += 1
        self.waiting.append(req)
        return req

    def set_now(self, t: float) -> None:
        """Virtual clock for trace replay, propagated to every worker
        engine so all latency stamps share one simulated timeline."""
        self.clock = "virtual"
        self.now_s = float(t)
        for w in self.prefill_workers + self.decode_workers:
            w.eng.set_now(t)

    def _now(self) -> float:
        return self.now_s if self.clock == "virtual" else time.time()

    def _vnow(self):
        return self.now_s if self.clock == "virtual" else None

    def _span(self, name: str, cat: str = "phase", **labels):
        """A telemetry span on the cluster's own track (no-op when off)."""
        return self.telemetry.span(name, cat=cat, tid=self.tel_label,
                                   now_fn=self._vnow, **labels)

    def has_work(self) -> bool:
        return bool(self.waiting or self.pending or self._any_live())

    @property
    def decode_steps(self) -> int:
        # sum over *all* workers: autoscaling moves engines between
        # tiers and their history must not vanish with them
        return sum(w.eng.decode_steps
                   for w in self.prefill_workers + self.decode_workers)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until every submitted request finishes."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def step(self):
        """One cluster iteration: (optionally) rescale the tiers, admit
        waiting requests into prefill workers (whole-prompt prefill +
        KV export), place pending handoff packets on decode workers
        (least-loaded router), then run one engine step on every decode
        worker that holds live slots."""
        self.steps += 1
        with self._span("cluster_step", step=self.steps):
            if (self.ccfg.autoscale
                    and self.steps % self.ccfg.autoscale_interval == 0):
                with self._span("autoscale"):
                    self._autoscale()
            if self.ccfg.slo_aware and len(self.waiting) > 1:
                now = self._now()
                ordered = sorted(self.waiting,
                                 key=lambda r: slo_sort_key(r, now))
                self.waiting.clear()
                self.waiting.extend(ordered)
            with self._span("admit"):
                self._admit_prefills()
            with self._span("route"):
                self._place_pending()
            for w in self.decode_workers:
                if not w.alive or not w.live_slots():
                    continue
                # straggler detection clocks the worker step with a
                # monotonic timer. Under the virtual clock (trace replay)
                # wall jitter must never reach the monitor — replay is
                # deterministic — so it sees a constant 0.0, which never
                # breaches (the EMA stays 0 and 0 > factor * 0 is false)
                t0 = time.perf_counter()
                with w.ctx():
                    w.eng.step()
                dt = (0.0 if self.clock == "virtual"
                      else time.perf_counter() - t0)
                breached = w.monitor.observe(w.steps, dt)
                w.steps += 1
                self._collect(w.eng)
                if breached and self.ccfg.auto_drain_stragglers \
                        and not w.draining:
                    self.drain_worker(w.idx)

    # -- fault tolerance ---------------------------------------------------
    def drain_worker(self, idx: int):
        """Stop routing to decode worker ``idx`` and migrate its live
        slots elsewhere (planned maintenance / straggler mitigation).
        The worker stays alive and can be re-enabled via
        ``decode_workers[idx].draining = False``. The last routable
        worker refuses (warn + no-op) rather than stranding the whole
        cluster."""
        w = self.decode_workers[idx]
        others = [o for o in self.decode_workers
                  if o is not w and o.alive and not o.draining]
        if not others:
            warnings.warn(
                f"refusing to drain decode worker {idx}: it is the last "
                "routable decode worker (its slots would have nowhere to "
                "migrate)", stacklevel=2)
            return
        w.draining = True
        self._migrate_all(w)

    def kill_worker(self, idx: int):
        """Preempt decode worker ``idx``: migrate its live slots and
        remove it from the cluster permanently (fail-stop)."""
        w = self.decode_workers[idx]
        self._migrate_all(w)
        w.alive = False
        w.draining = True

    def _migrate_all(self, w: Worker):
        for slot in w.live_slots():
            self._export_slot(w, slot, migration=True)

    # -- autoscaling -------------------------------------------------------
    def _autoscale(self):
        """Re-provision one worker between the tiers when
        :func:`~repro_torch.serving.workload.autoscale_decision` says the
        observed mix has shifted. Decode→prefill drains the moved
        worker's live slots into the pending-packet buffer first, so no
        stream is lost; prefill→decode moves an always-empty engine. The
        decision reads only aggregate counts."""
        routable = [w for w in self.decode_workers
                    if w.alive and not w.draining]
        alive_pf = [w for w in self.prefill_workers if w.alive]
        decision = autoscale_decision(
            waiting=len(self.waiting), pending=len(self.pending),
            live=sum(len(w.live_slots()) for w in routable),
            n_prefill=len(alive_pf), n_decode=len(routable),
            slots_per_worker=self.ecfg.max_batch)
        if decision == "to_decode":
            w = alive_pf[-1]
            self.prefill_workers.remove(w)
            w.role = "decode"
            self.decode_workers.append(w)
        elif decision == "to_prefill":
            w = min(routable, key=lambda o: (len(o.live_slots()),
                                             self.decode_workers.index(o)))
            self._migrate_all(w)
            self.decode_workers.remove(w)
            w.role = "prefill"
            self.prefill_workers.append(w)
        if decision:
            self.rescale_log.append((self.steps, decision))

    # -- internals ---------------------------------------------------------
    def _any_live(self) -> bool:
        return any(w.alive and w.live_slots() for w in self.decode_workers)

    def _budget_slots(self, w: Worker) -> int:
        cap = self.ecfg.max_batch
        return min(self.ccfg.in_flight, cap) if self.ccfg.in_flight else cap

    def _decode_headroom(self) -> int:
        """Free in-flight capacity across routable decode workers, less
        the packets already queued for placement — the admission budget
        that throttles prefill."""
        cap = 0
        for w in self.decode_workers:
            if w.alive and not w.draining:
                cap += max(0, self._budget_slots(w) - len(w.live_slots()))
        return cap - len(self.pending)

    def _check_routable(self):
        if not any(w.alive and not w.draining for w in self.decode_workers):
            raise RuntimeError(
                "no routable decode worker (all killed or draining) but "
                "work remains — un-drain a surviving worker "
                "(decode_workers[i].draining = False) or add capacity; "
                "killed workers are gone for good (fail-stop)")

    def _collect(self, eng: ServingEngine):
        if eng.finished:
            self.finished.extend(eng.finished)
            eng.finished.clear()

    def _admit_prefills(self):
        head = self._decode_headroom()
        if not self.waiting:
            return
        self._check_routable()
        pws = [w for w in self.prefill_workers if w.alive]
        # a finite prefill_rate bounds admissions per step to the tier's
        # aggregate throughput
        rate = self.ccfg.prefill_rate
        quota = rate * len(pws) if rate > 0 else float("inf")
        while self.waiting and head > 0 and quota > 0:
            quota -= 1
            w = self._pick_prefill_worker(pws, self.waiting[0])
            req = self.waiting.popleft()
            with w.ctx():
                w.eng.waiting.append(req)
                w.eng.scheduler.admit(w.eng)
            self._collect(w.eng)  # admit-time retirements finish here
            if w.eng.waiting:
                # deferred by the worker's cache backend: push back and
                # stop — FIFO order is preserved, capacity frees later
                self.waiting.appendleft(w.eng.waiting.popleft())
                break
            for slot in w.live_slots():
                self._export_slot(w, slot)
                head -= 1

    def _pick_prefill_worker(self, pws: list[Worker], req: Request) -> Worker:
        """Prefix-affinity routing: among alive prefill workers, the one
        already holding the longest cached prefix of this prompt wins.
        Ties break in worker order; with no match anywhere, round-robin.
        The cursor advances either way, so a cold workload sees the
        exact round-robin schedule."""
        rr = pws[self._pf_rr % len(pws)]
        self._pf_rr += 1
        eng0 = pws[0].eng
        if not eng0._prefix_on:
            return rr
        prompt = req.prompt[:eng0._prompt_cap()]
        n_prompt = int(prompt.shape[0])
        best, score = None, 0
        for w in pws:
            s = w.eng.kv.prefix_match_tokens(prompt, n_prompt)
            if s > score:
                best, score = w, s
        if best is None:
            return rr
        self.prefix_routed += 1
        return best

    def _export_slot(self, w: Worker, slot: int, *, migration=False):
        """Pack one live slot into a SlotPacket and release it (the
        same ``_pack_slot`` snapshot the SLO policy uses to preempt)."""
        eng = w.eng
        req = eng.slot_req[slot]
        with self._span("migration" if migration else "handoff",
                        cat="kv", rid=req.rid, worker=w.idx):
            with w.ctx():
                pkt = eng._pack_slot(slot)
        hops = self._req_hops.get(req.rid, 0) + (1 if migration else 0)
        self._req_hops[req.rid] = hops
        pkt.hops = hops
        self.kv_transfer_bytes += pkt.kv["kv_bytes"]
        kind = "migration" if migration else "handoff"
        if migration:
            self.migrations += 1
            self.migration_bytes += pkt.kv["kv_bytes"]
        else:
            self.handoffs += 1
        self.telemetry.counter("cluster_kv_transfers_total",
                               kind=kind).inc()
        self.telemetry.counter("cluster_kv_transfer_bytes_total",
                               kind=kind).inc(int(pkt.kv["kv_bytes"]))
        self.pending.append(pkt)

    def _route(self, pkt: SlotPacket) -> Worker | None:
        """Least-loaded routable decode worker that can take ``pkt``."""
        best = None
        for w in self.decode_workers:
            if not w.alive or w.draining:
                continue
            live = len(w.live_slots())
            if live >= self._budget_slots(w) or w.free_slot() is None:
                continue
            if not w.eng.kv.can_admit(pkt.n_prompt, pkt.budget):
                continue
            if best is None or live < len(best.live_slots()):
                best = w
        return best

    def _place_pending(self):
        if self.pending:
            self._check_routable()
        still: deque[SlotPacket] = deque()
        while self.pending:
            pkt = self.pending.popleft()
            w = self._route(pkt)
            if w is None:
                still.append(pkt)  # transient: capacity frees as slots
                continue           # retire; budget throttles admission
            slot = w.free_slot()
            with w.ctx():
                w.eng._unpack_slot(pkt, slot)
        self.pending = still

    # -- metrics -----------------------------------------------------------
    def summary(self) -> dict:
        """Cluster report. Schema-stable: identical key set with zero
        finished requests (zero/NaN-free defaults) and with N."""
        done = self.finished
        n = len(done)
        lat = [r.latency_s for r in done]
        ttft = [r.ttft_s for r in done]
        itl = [r.itl_s for r in done if len(r.output) > 1]
        toks = sum(len(r.output) for r in done)
        wall = (max(r.t_done for r in done)
                - min(r.t_submit for r in done)) if done else 0.0
        dws = self.decode_workers
        aws = self.prefill_workers + dws  # every engine, both tiers
        hit_tok = sum(getattr(w.eng.kv, "prefix_hit_tokens", 0)
                      for w in aws)
        lookup_tok = sum(getattr(w.eng.kv, "prefix_lookup_tokens", 0)
                         for w in aws)
        return {
            "requests": n,
            "tokens": toks,
            "tokens_per_s": ((toks / wall if wall > 0 else float("inf"))
                             if done else 0.0),
            "qps": ((n / wall if wall > 0 else float("inf"))
                    if done else 0.0),
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p99_s": float(np.percentile(ttft, 99)) if ttft else 0.0,
            "mean_itl_s": float(np.mean(itl)) if itl else 0.0,
            "n_prefill": len(self.prefill_workers),
            "n_decode": len(dws),
            "handoffs": self.handoffs,
            "migrations": self.migrations,
            "max_migration_hops": max(self._req_hops.values(), default=0),
            "kv_transfer_bytes": self.kv_transfer_bytes,
            "migration_bytes": self.migration_bytes,
            # autoscaling + SLO accounting (empty/0 when disabled)
            "rescale_events": len(self.rescale_log),
            "rescale_log": list(self.rescale_log),
            "preemptions": sum(r.preemptions for r in done),
            "slo_attainment": (sum(r.slo_met for r in done) / n
                               if n else 1.0),
            **request_breakdowns(done),
            # prefills over *all* workers: autoscaling moves engines
            # between tiers and their dispatch history moves with them
            "prefills": sum(w.eng.prefills for w in aws),
            "decode_dispatches": sum(w.eng.decode_dispatches for w in aws),
            "decode_steps": self.decode_steps,
            # the single-dispatch invariant holds per worker
            "dispatches_per_step": (
                sum(w.eng.decode_dispatches for w in aws)
                / max(1, self.decode_steps)),
            "straggler_events": sum(len(w.monitor.events) for w in dws),
            "workers_alive": sum(w.alive for w in dws),
            "kv_cache": dws[0].eng.kv.name,
            # prefix-cache accounting over both tiers (admission-time
            # lookups happen on prefill workers; decode workers re-match
            # packet provenance at import but never register) + the
            # affinity router's wins
            "prefix_routed": self.prefix_routed,
            "prefix_hits": sum(getattr(w.eng.kv, "prefix_hits", 0)
                               for w in aws),
            "prefix_hit_tokens": hit_tok,
            "prefix_lookups": sum(
                getattr(w.eng.kv, "prefix_lookups", 0) for w in aws),
            "prefix_hit_rate": (hit_tok / lookup_tok
                                if lookup_tok else 0.0),
            "prefix_evictions": sum(
                w.eng.kv.prefix.evictions for w in aws
                if getattr(w.eng.kv, "prefix", None) is not None),
            "resident_shared_kv_bytes": sum(
                getattr(w.eng.kv, "resident_shared_kv_bytes", 0)
                for w in aws),
            # decode-tier KV residency (prefill workers release at export)
            "resident_kv_bytes": sum(
                w.eng.kv.peak_resident_kv_bytes for w in dws),
            "per_worker": [
                {"role": w.role, "idx": w.idx, "device": str(w.device),
                 "alive": w.alive, "draining": w.draining, "steps": w.steps,
                 "decode_dispatches": w.eng.decode_dispatches,
                 "straggler_events": len(w.monitor.events)}
                for w in aws],
            # telemetry fold-in: the cluster's own track plus every
            # worker engine's aggregates (always present; zero when off)
            "telemetry": {
                "cluster": self.telemetry.engine_aggregates(self.tel_label),
                "workers": {
                    w.eng.tel_label: self.telemetry.engine_aggregates(
                        w.eng.tel_label)
                    for w in aws},
            },
        }
