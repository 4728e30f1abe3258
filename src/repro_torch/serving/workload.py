"""Trace-driven multi-tenant workload layer.

Counterpart of ``repro/serving/workload.py`` (a copy: the module has no
framework dependency, and the same seed gives the same trace in both
packages). :func:`replay` drives the port's ``ServingEngine`` or its
``ClusterEngine`` (:mod:`repro_torch.serving.cluster`); the analytical
simulator named below is the reference's, and the port does not have
it yet.

The paper's cloud argument is TCO-per-QPS under sustained heavy
traffic (§1.2), but a fixed request list exercises none of it: no
arrival process, no tenant mix, no SLO pressure, no load shift for an
autoscaler to react to. This module is the traffic side of that
argument — a seeded trace generator plus a replay driver — so the
serving stack (and its analytical mirror) can be driven by the same
reproducible workload:

- :class:`TenantSpec` describes one tenant's traffic: arrival rate,
  prompt/output length ranges, priority, TTFT/ITL SLO, burstiness and
  an optional active window. The canonical mixes — short interactive
  chat, long-document summarization, bursty agent loops — are the
  presets in :func:`make_named_trace`.
- :func:`make_trace` samples a :class:`Trace`: Poisson arrivals per
  tenant, or a diurnal (sinusoidally-thinned) process whose rate swings
  over the horizon. Everything is keyed by one seed — the same trace
  replays bit-identically on the engine, the cluster and the simulator.
- :func:`replay` submits a trace against an engine on a **virtual
  clock**: arrivals are quantized to engine steps
  (``arrival_step = ceil(arrival_s / quantum)``), and because the
  engine advances exactly one token per live slot per step, the entire
  schedule — admissions, preemptions, rescales — is a deterministic
  function of (trace, policy). TTFT/ITL come out in simulated seconds
  with zero wall-clock noise, which is what makes the CI overload gate
  and the ``LLMSimulator.serve(trace=...)`` schedule-mirror test
  possible. Pass ``wall_clock=True`` to pace against real time instead
  (demo/serving mode; metrics then include host jitter).
- :func:`autoscale_decision` is the shared prefill<->decode rescale
  policy (HPIM-style tier re-provisioning): it reads only aggregate
  queue/slot counts, so ``ClusterEngine`` and the simulator mirror
  apply literally the same function and cannot drift.

Trace schema (what the bench uploads as the CI artifact, see
:meth:`Trace.schema`): ``{"name", "seed", "horizon_s", "arrival",
"requests": [{"rid", "arrival_s", "tenant", "priority", "prompt_len",
"max_new_tokens", "slo_ttft_s", "slo_itl_s"}, ...]}``.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.scheduler import SLO

__all__ = ["SLO", "TenantSpec", "TraceRequest", "Trace", "make_trace",
           "make_named_trace", "replay", "autoscale_decision"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model."""
    name: str
    rate_rps: float                    # mean arrival rate (events/s)
    prompt_len: tuple                  # (lo, hi) prompt tokens, inclusive
    new_tokens: tuple                  # (lo, hi) generation budget
    priority: int = 0                  # higher preempts lower
    slo: SLO = SLO()                   # TTFT/ITL targets (inf = none)
    burst: int = 1                     # requests per arrival event
                                       # (agent loops fan out > 1)
    window: tuple | None = None        # (t0, t1) active span; None = whole
                                       # horizon (mix-shift traces use this)
    prefix_len: int = 0                # shared-preamble tokens prepended to
                                       # every prompt (system prompt / few-
                                       # shot block — the prefix-cache
                                       # workload); prompt_len then sizes
                                       # the unique tail


@dataclass
class TraceRequest:
    """One request of a trace, in arrival order."""
    rid: int
    arrival_s: float
    tenant: str
    priority: int
    slo: SLO
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    seed: int = 0


@dataclass
class Trace:
    name: str
    seed: int
    horizon_s: float
    arrival: str                       # "poisson" | "diurnal"
    requests: list = field(default_factory=list)

    def __len__(self):
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def schema(self) -> dict:
        """JSON-serializable description (prompts as lengths, not
        tokens) — the artifact the CI overload bench uploads."""
        return {
            "name": self.name, "seed": self.seed,
            "horizon_s": self.horizon_s, "arrival": self.arrival,
            "requests": [{
                "rid": r.rid, "arrival_s": round(r.arrival_s, 6),
                "tenant": r.tenant, "priority": r.priority,
                "prompt_len": int(r.prompt.shape[0]),
                "max_new_tokens": r.max_new_tokens,
                "slo_ttft_s": r.slo.ttft_s, "slo_itl_s": r.slo.itl_s,
            } for r in self.requests],
        }


def make_trace(tenants, horizon_s: float, *, vocab_size: int, seed: int = 0,
               arrival: str = "poisson", diurnal_period_s: float | None = None,
               diurnal_depth: float = 0.8, len_step: int = 1,
               name: str = "trace") -> Trace:
    """Sample a seeded multi-tenant trace.

    ``arrival="poisson"`` draws each tenant's arrivals as a homogeneous
    Poisson process at ``rate_rps`` over its window. ``"diurnal"``
    draws an *inhomogeneous* process by thinning (Lewis-Shedler): the
    instantaneous rate is ``rate * (1 + depth * sin(2 pi t / period))``,
    so load swings around the mean — the time-varying profile the
    cluster autoscaler and the TCO-over-trace scenario react to.

    ``len_step > 1`` rounds prompt lengths up to multiples of it,
    bounding the set of distinct prefill shapes (the simulator traces
    one jaxpr per shape — essential at 70B scale).

    A tenant with ``prefix_len > 0`` shares one fixed preamble across
    all its requests (prepended to each sampled tail). Preambles come
    from a per-tenant *derived* rng — ``default_rng([seed, tenant
    index])`` — so tenants with ``prefix_len=0`` draw nothing extra
    from the main stream and every pre-existing trace stays
    bit-identical.
    """
    if arrival not in ("poisson", "diurnal"):
        raise ValueError(f"unknown arrival process {arrival!r}")
    rng = np.random.default_rng(seed)
    preamble = {}
    for idx, tn in enumerate(tenants):
        if tn.prefix_len > 0:
            prng = np.random.default_rng([seed, idx])
            preamble[tn.name] = prng.integers(
                0, vocab_size, size=tn.prefix_len).astype(np.int32)
    events = []
    for tn in tenants:
        t0, t1 = tn.window or (0.0, horizon_s)
        t1 = min(float(t1), horizon_s)
        depth = diurnal_depth if arrival == "diurnal" else 0.0
        peak = tn.rate_rps * (1.0 + depth)
        period = diurnal_period_s or horizon_s
        t = float(t0)
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= t1:
                break
            if depth:
                rate_t = tn.rate_rps * (
                    1.0 + depth * math.sin(2 * math.pi * t / period))
                if rng.random() * peak > rate_t:
                    continue   # thinned out of the inhomogeneous process
            for _ in range(tn.burst):
                events.append((t, tn))
    events.sort(key=lambda e: (e[0], e[1].name))
    requests = []
    for rid, (t, tn) in enumerate(events):
        lo, hi = tn.prompt_len
        n = int(rng.integers(lo, hi + 1))
        if len_step > 1:
            n = math.ceil(n / len_step) * len_step
        lo, hi = tn.new_tokens
        m = int(rng.integers(lo, hi + 1))
        prompt = rng.integers(0, vocab_size, size=n).astype(np.int32)
        if tn.name in preamble:
            prompt = np.concatenate([preamble[tn.name], prompt])
        requests.append(TraceRequest(
            rid=rid, arrival_s=float(t), tenant=tn.name,
            priority=tn.priority, slo=tn.slo, prompt=prompt,
            max_new_tokens=m, seed=seed))
    return Trace(name=name, seed=seed, horizon_s=horizon_s,
                 arrival=arrival, requests=requests)


def make_named_trace(name: str, *, vocab_size: int, seed: int = 0) -> Trace:
    """Canonical smoke-scale traces (sized for the CI engines:
    ``max_batch=4``, short prompts, 10 ms step quantum).

    - ``"overload"`` — the SLO gate: a 0.8 s burst of low-priority
      summarization jobs saturates every slot, while high-priority chat
      arrivals (40 ms TTFT SLO) trickle in throughout. FIFO queues chat
      behind the burst and blows the SLO by an order of magnitude; the
      SLO policy preempts and holds it.
    - ``"steady"`` — all three canonical tenants at sustainable Poisson
      rates (summary/breakdown tests).
    - ``"diurnal"`` — the same mix under a sinusoidal rate swing.
    - ``"mixshift"`` — prefill-heavy first half (long documents, tiny
      outputs), decode-heavy second half (bursty agent loops): drives
      the cluster autoscaler in both directions.
    - ``"sharedprefix"`` — the prefix-cache gate: two tenants whose
      requests share a 48-token preamble (3 full 16-token blocks)
      ahead of short unique tails, plus one cold ad-hoc tenant. Warm
      admissions should prefill only the tail.
    """
    chat = TenantSpec("chat", rate_rps=2.5, prompt_len=(6, 12),
                      new_tokens=(4, 4), priority=2,
                      slo=SLO(ttft_s=0.04, itl_s=0.05))
    summarize = TenantSpec("summarize", rate_rps=30.0, prompt_len=(24, 48),
                           new_tokens=(16, 16), priority=0,
                           window=(0.0, 0.8))
    agent = TenantSpec("agent", rate_rps=0.8, prompt_len=(8, 16),
                       new_tokens=(8, 8), priority=1,
                       slo=SLO(ttft_s=0.5), burst=2)
    if name == "overload":
        return make_trace((chat, summarize), 4.0, vocab_size=vocab_size,
                          seed=seed, name="overload")
    if name == "steady":
        tenants = (chat,
                   TenantSpec("summarize", rate_rps=1.0, prompt_len=(24, 48),
                              new_tokens=(12, 12), priority=0),
                   agent)
        return make_trace(tenants, 4.0, vocab_size=vocab_size, seed=seed,
                          name="steady")
    if name == "diurnal":
        tenants = (chat,
                   TenantSpec("summarize", rate_rps=1.5, prompt_len=(24, 48),
                              new_tokens=(12, 12), priority=0),
                   agent)
        return make_trace(tenants, 6.0, vocab_size=vocab_size, seed=seed,
                          arrival="diurnal", diurnal_period_s=6.0,
                          name="diurnal")
    if name == "mixshift":
        tenants = (
            TenantSpec("docs", rate_rps=60.0, prompt_len=(40, 56),
                       new_tokens=(2, 3), priority=1, window=(0.0, 0.5)),
            TenantSpec("agents", rate_rps=12.0, prompt_len=(6, 10),
                       new_tokens=(16, 24), priority=1, burst=2,
                       window=(0.5, 1.2)))
        return make_trace(tenants, 1.6, vocab_size=vocab_size, seed=seed,
                          name="mixshift")
    if name == "sharedprefix":
        tenants = (
            TenantSpec("assist", rate_rps=4.0, prompt_len=(4, 12),
                       new_tokens=(4, 6), priority=1, prefix_len=48),
            TenantSpec("rag", rate_rps=3.0, prompt_len=(6, 14),
                       new_tokens=(4, 6), priority=0, prefix_len=48),
            TenantSpec("adhoc", rate_rps=1.0, prompt_len=(10, 20),
                       new_tokens=(4, 6), priority=0))
        return make_trace(tenants, 2.0, vocab_size=vocab_size, seed=seed,
                          name="sharedprefix")
    raise ValueError(f"unknown named trace {name!r} (expected 'overload', "
                     "'steady', 'diurnal', 'mixshift' or 'sharedprefix')")


# ---------------------------------------------------------------------------
# replay driver
# ---------------------------------------------------------------------------

def replay(target, trace: Trace, *, step_quantum_s: float = 0.01,
           wall_clock: bool = False, max_steps: int = 200_000) -> dict:
    """Replay ``trace`` against a :class:`ServingEngine` or
    :class:`ClusterEngine`.

    Virtual-clock mode (default): the driver advances the target's
    clock by ``step_quantum_s`` per engine step, submits every request
    whose arrival has passed, and steps until the trace drains. The
    whole schedule is deterministic — TTFT/ITL in the returned summary
    are simulated seconds. Wall-clock mode sleeps between steps
    instead (no determinism, real pacing).

    Returns ``{"steps", "decode_steps", "tokens", "requests"
    (trace rid -> engine Request), "outputs", "summary",
    "admission_order", "preemption_log"}`` — the *_order/_log entries
    translated to trace rids and replay-relative steps, which is the
    exact shape ``LLMSimulator.serve(trace=...)`` reproduces.
    """
    import time as _time
    queue = deque(sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid)))
    reqs: dict[int, object] = {}
    # snapshot engine-side counters so warm-up runs on a reused engine
    # don't pollute the replay-relative schedule
    adm0 = len(getattr(target, "admission_log", ()))
    pre0 = len(getattr(target, "preemption_log", ()))
    step0 = getattr(target, "step_index", getattr(target, "steps", 0))
    dec0 = getattr(target, "decode_steps", 0)
    t_start = _time.time()
    it = 0
    while queue or target.has_work():
        if it >= max_steps:
            raise RuntimeError(
                f"trace {trace.name!r} did not drain in {max_steps} steps")
        now = (_time.time() - t_start) if wall_clock else it * step_quantum_s
        if not wall_clock:
            target.set_now(now)
        while queue and queue[0].arrival_s <= now:
            tr = queue.popleft()
            reqs[tr.rid] = target.submit(
                tr.prompt, tr.max_new_tokens, seed=tr.seed,
                tenant=tr.tenant, priority=tr.priority, slo=tr.slo,
                arrival_s=None if wall_clock else tr.arrival_s)
        target.step()
        it += 1
        if wall_clock and queue and not target.has_work():
            _time.sleep(min(step_quantum_s, 0.01))  # idle until next arrival
    if not wall_clock:
        target.set_now(it * step_quantum_s)
    rid_of = {req.rid: trid for trid, req in reqs.items()}
    admission = [rid_of[r] for r in
                 list(getattr(target, "admission_log", ()))[adm0:]]
    preemption = [(s - step0, rid_of[r]) for s, r in
                  list(getattr(target, "preemption_log", ()))[pre0:]]
    outputs = {trid: list(req.output) for trid, req in reqs.items()}
    return {
        "trace": trace.name,
        "steps": it,
        "step_quantum_s": step_quantum_s,
        "decode_steps": getattr(target, "decode_steps", 0) - dec0,
        "tokens": sum(len(o) for o in outputs.values()),
        "requests": reqs,
        "outputs": outputs,
        "summary": target.summary(),
        "admission_order": admission,
        "preemption_log": preemption,
    }


# ---------------------------------------------------------------------------
# autoscaling policy (shared: ClusterEngine and the simulator mirror)
# ---------------------------------------------------------------------------

def autoscale_decision(*, waiting: int, pending: int, live: int,
                       n_prefill: int, n_decode: int,
                       slots_per_worker: int) -> str | None:
    """Which way to move one worker between the prefill and decode
    tiers, given only aggregate queue/slot counts — pure and
    observation-based on purpose, so ``ClusterEngine._autoscale`` and
    ``LLMSimulator``'s trace mirror apply the identical policy to the
    identical aggregates and produce the identical rescale schedule.

    - ``"to_decode"``: prefilled packets are backing up (the decode
      tier can't place them) and the prefill tier can spare a worker.
    - ``"to_prefill"``: requests are queuing for prefill while the
      decode tier has at least two idle workers' worth of headroom —
      shift one decode worker (its live slots drain to the queue-side
      packet buffer first) to the prefill tier.
    - ``None``: balanced; keep the current split.

    Each tier keeps >= 1 worker, always.
    """
    if pending > 0 and n_prefill > 1:
        return "to_decode"
    free = n_decode * slots_per_worker - live - pending
    if (waiting > n_prefill and n_decode > 1
            and free >= 2 * slots_per_worker):
        return "to_prefill"
    return None
