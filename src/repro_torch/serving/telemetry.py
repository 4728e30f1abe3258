"""Serving telemetry: span tracing, metrics, and a dispatch profiler.

Counterpart of ``repro/serving/telemetry.py`` (a copy: the module has no
framework dependency but the calibration's lazy import of the port's
cost model). Three instruments:

* :class:`SpanTracer` — nested spans around every engine phase (admit,
  prefill chunk, decode dispatch, draft/verify, sampling, KV
  splice/commit/export/import, preemption) with both wall-clock
  (``time.perf_counter``) and virtual-clock (the engine's ``now_s``)
  timestamps, exportable as Chrome/Perfetto trace-event JSON.
* :class:`MetricsRegistry` — labeled counters / gauges / log-bucketed
  histograms with a snapshot/delta API and Prometheus text exposition.
  Bucketing is a pure function of the sample value, so merging two
  snapshots commutes with merging the underlying streams.
* :class:`DispatchProfiler` — per-dispatch wall time, timed to the
  dispatch's completion (the engine synchronises the card), keyed to the
  exact ``dispatch_log`` entry it measured (:func:`join_coverage`), and
  held against the cost model's prediction for that entry
  (:func:`dispatch_calibration`, :func:`format_calibration`).

Everything hangs off a single :class:`Telemetry` facade the engine
accepts. Disabled (the default, :data:`NULL_TELEMETRY`) every hook
short-circuits to a no-op singleton: no spans, no metric mutations, no
synchronisation — outputs are bitwise the same either way.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# null objects — the disabled-mode fast path
# ---------------------------------------------------------------------------

class _NullCtx:
    """Context manager that does nothing (returned when telemetry is off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NullMetric:
    """Absorbs counter/gauge/histogram mutations when telemetry is off."""

    __slots__ = ()

    def inc(self, n: float = 1.0):
        pass

    def dec(self, n: float = 1.0):
        pass

    def set(self, v: float):
        pass

    def observe(self, v: float):
        pass


_NULL_CTX = _NullCtx()
_NULL_METRIC = _NullMetric()


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

@dataclass
class Span:
    """One closed span. Wall times are relative to the tracer's origin."""

    name: str
    cat: str
    tid: str
    index: int            # global start-order sequence number
    depth: int            # nesting depth within its tid at start time
    wall_start_s: float
    wall_end_s: float
    v_start_s: Optional[float]   # engine virtual clock at enter (if any)
    v_end_s: Optional[float]     # engine virtual clock at exit (if any)
    labels: Dict[str, Any] = field(default_factory=dict)

    @property
    def wall_dur_s(self) -> float:
        return max(0.0, self.wall_end_s - self.wall_start_s)


class _SpanCtx:
    __slots__ = ("tracer", "name", "cat", "tid", "labels", "now_fn",
                 "index", "depth", "t0", "v0")

    def __init__(self, tracer, name, cat, tid, now_fn, labels):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.now_fn = now_fn
        self.labels = labels

    def __enter__(self):
        tr = self.tracer
        stack = tr._stacks.setdefault(self.tid, [])
        self.depth = len(stack)
        self.index = tr._n
        tr._n += 1
        stack.append(self)
        self.v0 = self.now_fn() if self.now_fn is not None else None
        self.t0 = time.perf_counter() - tr.origin
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter() - self.tracer.origin
        v1 = self.now_fn() if self.now_fn is not None else None
        stack = self.tracer._stacks.get(self.tid, [])
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer.spans.append(Span(
            name=self.name, cat=self.cat, tid=self.tid,
            index=self.index, depth=self.depth,
            wall_start_s=self.t0, wall_end_s=t1,
            v_start_s=self.v0, v_end_s=v1,
            labels=self.labels))
        return False


class SpanTracer:
    """Nested span recorder with wall + virtual timestamps.

    Spans nest per ``tid`` (one logical track per engine/worker); depth
    is the size of that track's open-span stack at enter. Wall times
    come from ``time.perf_counter`` relative to the tracer's creation,
    virtual times from the ``now_fn`` the caller supplies (the engine's
    ``now_s`` under trace replay) — so under a virtual clock the
    ``(name, tid, depth, index, v_start_s, v_end_s)`` tuple stream is
    bit-for-bit deterministic across runs.
    """

    def __init__(self):
        self.origin = time.perf_counter()
        self.spans: List[Span] = []
        self._stacks: Dict[str, list] = {}
        self._n = 0

    def span(self, name: str, cat: str = "phase", tid: str = "engine",
             now_fn: Optional[Callable[[], Optional[float]]] = None,
             **labels) -> _SpanCtx:
        return _SpanCtx(self, name, cat, tid, now_fn, labels)

    # -- queries ----------------------------------------------------------

    def slowest(self, n: int = 5) -> List[Span]:
        return sorted(self.spans, key=lambda s: -s.wall_dur_s)[:n]

    def virtual_schedule(self) -> List[Tuple]:
        """Deterministic fingerprint of the span stream under replay."""
        out = []
        for s in sorted(self.spans, key=lambda s: s.index):
            out.append((s.index, s.name, s.cat, s.tid, s.depth,
                        s.v_start_s, s.v_end_s))
        return out

    # -- Perfetto export --------------------------------------------------

    def trace_events(self, clock: str = "wall") -> Dict[str, Any]:
        """Chrome/Perfetto trace-event JSON ("X" complete events).

        ``clock="wall"`` uses perf_counter timestamps (the view you load
        in ui.perfetto.dev); ``clock="virtual"`` uses the engine virtual
        clock where recorded (deterministic under trace replay; spans
        with no virtual stamp fall back to wall).
        """
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual': {clock!r}")
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in sorted(self.spans, key=lambda s: s.index):
            if s.tid not in tids:
                t = len(tids)
                tids[s.tid] = t
                events.append({"name": "thread_name", "ph": "M", "pid": 0,
                               "tid": t, "args": {"name": s.tid}})
            if clock == "virtual" and s.v_start_s is not None:
                ts, te = s.v_start_s, (s.v_end_s if s.v_end_s is not None
                                       else s.v_start_s)
            else:
                ts, te = s.wall_start_s, s.wall_end_s
            args = {"depth": s.depth, "index": s.index}
            args.update(s.labels)
            if s.v_start_s is not None:
                args["virtual_start_s"] = s.v_start_s
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": ts * 1e6, "dur": max(0.0, (te - ts) * 1e6),
                "pid": 0, "tid": tids[s.tid], "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_trace_events(obj: Any) -> List[str]:
    """Schema check for a Chrome trace-event export. Returns problems."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a dict, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not a dict")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing '{key}'")
        ph = ev.get("ph")
        if ph == "X":
            for key in ("ts", "dur"):
                v = ev.get(key)
                if not isinstance(v, (int, float)) or not math.isfinite(v):
                    problems.append(f"event {i}: non-finite '{key}': {v!r}")
                elif key == "dur" and v < 0:
                    problems.append(f"event {i}: negative dur: {v!r}")
        elif ph == "M":
            if not isinstance(ev.get("args"), dict):
                problems.append(f"event {i}: metadata without args")
        elif ph is not None and ph not in ("B", "E", "i", "C"):
            problems.append(f"event {i}: unknown phase {ph!r}")
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

# Log-spaced histogram buckets: bucket 0 holds [0, HIST_BASE); bucket i
# holds [HIST_BASE * GROWTH**(i-1), HIST_BASE * GROWTH**i); the last
# bucket is unbounded. bucket_index is a pure function of the sample, so
# histogram merge commutes with sample-stream merge exactly (counts are
# integers; only float sums accumulate rounding).
HIST_BASE = 1e-6
HIST_GROWTH = 2.0
HIST_BUCKETS = 64


def bucket_index(v: float) -> int:
    """Bucket for a sample (pure; raises on NaN/negative)."""
    if not isinstance(v, (int, float)) or math.isnan(v):
        raise ValueError(f"histogram sample must be a real number: {v!r}")
    if v < 0:
        raise ValueError(f"histogram sample must be >= 0: {v!r}")
    if v < HIST_BASE:
        return 0
    i = 1 + int(math.floor(math.log(v / HIST_BASE, HIST_GROWTH)))
    # guard float-log edge cases at bucket boundaries
    while bucket_upper(i - 1) > v:
        i -= 1
    while v >= bucket_upper(i) and i < HIST_BUCKETS:
        i += 1
    return min(max(i, 0), HIST_BUCKETS)


def bucket_upper(i: int) -> float:
    """Exclusive upper bound of bucket ``i`` (+inf for the last)."""
    if i >= HIST_BUCKETS:
        return math.inf
    return HIST_BASE * (HIST_GROWTH ** i)


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0 or math.isnan(n):
            raise ValueError(f"counter increment must be >= 0: {n!r}")
        self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, n: float = 1.0):
        self.value += n

    def dec(self, n: float = 1.0):
        self.value -= n


class Histogram:
    __slots__ = ("name", "labels", "counts", "sum", "count", "min", "max")

    def __init__(self, name, labels):
        self.name = name
        self.labels = labels
        self.counts: Dict[int, int] = {}
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float):
        i = bucket_index(v)          # validates NaN/negative
        self.counts[i] = self.counts.get(i, 0) + 1
        self.sum += v
        self.count += 1
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the q-th bucket)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i in sorted(self.counts):
            seen += self.counts[i]
            if seen >= target:
                return min(bucket_upper(i), self.max if self.max is not None
                           else bucket_upper(i))
        return self.max if self.max is not None else 0.0


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_key(name: str, labels: Dict[str, Any]) -> str:
    inner = ",".join(f'{k}="{v}"' for k, v in _label_key(labels))
    return f"{name}{{{inner}}}" if inner else name


class MetricsRegistry:
    """Labeled counters/gauges/histograms with snapshot/delta/export."""

    def __init__(self):
        self._series: Dict[Tuple[str, Tuple], Any] = {}
        self._types: Dict[str, str] = {}

    def _get(self, cls, typ, name, labels):
        if self._types.setdefault(name, typ) != typ:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{self._types[name]}, not {typ}")
        key = (name, _label_key(labels))
        m = self._series.get(key)
        if m is None:
            m = cls(name, dict(labels))
            self._series[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, "counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, "gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, "histogram", name, labels)

    # -- snapshot / delta -------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-serializable point-in-time dump of every series."""
        out: Dict[str, Dict[str, Any]] = {}
        for (name, _), m in sorted(self._series.items()):
            entry: Dict[str, Any] = {
                "type": self._types[name], "name": name,
                "labels": dict(m.labels)}
            if isinstance(m, Histogram):
                entry.update(counts={str(i): c for i, c
                                     in sorted(m.counts.items())},
                             sum=m.sum, count=m.count,
                             min=m.min, max=m.max)
            else:
                entry["value"] = m.value
            out[_series_key(name, m.labels)] = entry
        return out

    def delta(self, prev: Dict[str, Dict[str, Any]]
              ) -> Dict[str, Dict[str, Any]]:
        """Current snapshot minus ``prev`` (counters/histograms subtract;
        gauges report their current value)."""
        cur = self.snapshot()
        out: Dict[str, Dict[str, Any]] = {}
        for key, entry in cur.items():
            p = prev.get(key)
            e = dict(entry)
            if p is not None and entry["type"] == "counter":
                e["value"] = entry["value"] - p["value"]
            elif p is not None and entry["type"] == "histogram":
                counts = dict(entry["counts"])
                for i, c in p.get("counts", {}).items():
                    counts[i] = counts.get(i, 0) - c
                e["counts"] = {i: c for i, c in counts.items() if c}
                e["sum"] = entry["sum"] - p["sum"]
                e["count"] = entry["count"] - p["count"]
            out[key] = e
        return out

    # -- validation / export ----------------------------------------------

    def validate(self) -> List[str]:
        """Sanity problems (NaN/negative state). Empty means healthy."""
        problems: List[str] = []
        for (name, _), m in sorted(self._series.items()):
            key = _series_key(name, m.labels)
            if isinstance(m, Histogram):
                if math.isnan(m.sum) or m.sum < 0:
                    problems.append(f"{key}: bad histogram sum {m.sum!r}")
                if any(c < 0 for c in m.counts.values()):
                    problems.append(f"{key}: negative bucket count")
                if m.count != sum(m.counts.values()):
                    problems.append(f"{key}: count/bucket mismatch")
                if m.min is not None and (math.isnan(m.min) or m.min < 0):
                    problems.append(f"{key}: bad histogram min {m.min!r}")
            elif isinstance(m, Counter):
                if math.isnan(m.value) or m.value < 0:
                    problems.append(f"{key}: bad counter value {m.value!r}")
            else:
                if math.isnan(m.value):
                    problems.append(f"{key}: NaN gauge")
        return problems

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one `# TYPE` per metric name)."""
        lines: List[str] = []
        by_name: Dict[str, List[Any]] = {}
        for (name, _), m in sorted(self._series.items()):
            by_name.setdefault(name, []).append(m)
        for name in sorted(by_name):
            typ = self._types[name]
            lines.append(f"# TYPE {name} {typ}")
            for m in by_name[name]:
                base = _label_key(m.labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for i in sorted(m.counts):
                        cum += m.counts[i]
                        le = bucket_upper(i)
                        le_s = "+Inf" if math.isinf(le) else repr(le)
                        lbl = ",".join([f'{k}="{v}"' for k, v in base]
                                       + [f'le="{le_s}"'])
                        lines.append(f"{name}_bucket{{{lbl}}} {cum}")
                    lbl = ",".join([f'{k}="{v}"' for k, v in base]
                                   + ['le="+Inf"'])
                    lines.append(f"{name}_bucket{{{lbl}}} {m.count}")
                    suffix = (f'{{{",".join(f"{k}={v!r}" for k, v in base)}}}'
                              .replace("'", '"') if base else "")
                    lines.append(f"{name}_sum{suffix} {m.sum}")
                    lines.append(f"{name}_count{suffix} {m.count}")
                else:
                    suffix = (f'{{{",".join(f"{k}={v!r}" for k, v in base)}}}'
                              .replace("'", '"') if base else "")
                    lines.append(f"{name}{suffix} {m.value}")
        return "\n".join(lines) + "\n"


def merge_snapshots(a: Dict[str, Dict[str, Any]],
                    b: Dict[str, Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Merge two registry snapshots (counters/histograms add; gauges
    last-write-wins). Because bucketing is pure per-sample, this equals
    the snapshot of a registry that saw both sample streams."""
    out = {k: dict(v) for k, v in a.items()}
    for key, entry in b.items():
        if key not in out:
            out[key] = dict(entry)
            continue
        cur = out[key]
        if cur["type"] != entry["type"]:
            raise ValueError(f"type conflict merging {key}: "
                             f"{cur['type']} vs {entry['type']}")
        if entry["type"] == "counter":
            cur["value"] = cur["value"] + entry["value"]
        elif entry["type"] == "gauge":
            cur["value"] = entry["value"]
        else:
            counts = dict(cur["counts"])
            for i, c in entry["counts"].items():
                counts[i] = counts.get(i, 0) + c
            cur["counts"] = dict(sorted(counts.items(),
                                        key=lambda kv: int(kv[0])))
            cur["sum"] = cur["sum"] + entry["sum"]
            cur["count"] = cur["count"] + entry["count"]
            mins = [m for m in (cur["min"], entry["min"]) if m is not None]
            maxs = [m for m in (cur["max"], entry["max"]) if m is not None]
            cur["min"] = min(mins) if mins else None
            cur["max"] = max(maxs) if maxs else None
    return out


# ---------------------------------------------------------------------------
# dispatch profiler
# ---------------------------------------------------------------------------

@dataclass
class DispatchSample:
    """Wall time of one dispatch, keyed to its dispatch_log row."""

    engine: str   # telemetry label of the engine that dispatched
    index: int    # position in that engine's ``dispatch_log``
    kind: str     # dispatch kind ("decode", "chunk_paged", ...)
    wall_s: float


class DispatchProfiler:
    def __init__(self):
        self.samples: List[DispatchSample] = []

    def record(self, engine: str, index: int, kind: str, wall_s: float):
        self.samples.append(DispatchSample(engine, index, kind, wall_s))


def join_coverage(engine, telemetry: "Telemetry"
                  ) -> Tuple[int, int]:
    """(# dispatch_log entries with a profiler sample, # entries)."""
    label = getattr(engine, "tel_label", "engine")
    sampled = {s.index for s in telemetry.profiler.samples
               if s.engine == label}
    return len(sampled & set(range(len(engine.dispatch_log)))), \
        len(engine.dispatch_log)


# Generic host-CPU reference point used when no HardwareProfile is
# given: the calibration table still reports finite ratios on any host;
# absolute values are only meaningful against a real profile.
HOST_REF_OPS_PER_S = 1e11
HOST_REF_BYTES_PER_S = 5e10


def dispatch_calibration(engines, telemetry: "Telemetry",
                         profile=None, *, memo: Optional[dict] = None
                         ) -> Dict[str, Dict[str, float]]:
    """Join measured dispatch wall times against traced FLOPs/bytes.

    For every profiler sample, the dispatch-log entry it measured is
    traced through ``core.costmodel.entry_tracer`` (the join the audit
    uses), and per dispatch kind we aggregate:

    ``n``, ``wall_s``, ``flops``, ``bytes``, ``achieved_flops_per_s``,
    ``achieved_bytes_per_s``, ``arithmetic_intensity``, ``predicted_s``
    (roofline max(flops/peak_ops, bytes/peak_bw) per dispatch against
    ``profile`` — a :class:`repro_torch.core.profiles.HardwareProfile`
    — or the generic host reference), and ``model_error_ratio`` =
    wall_s / predicted_s. Below 1, a dispatch beat the roofline: the
    cost model undercounts it. ``memo`` is the entry tracer's, shared
    with other calls (``core.costmodel.entry_tracer``).
    """
    # costmodel imports serving.engine, which imports this module —
    # resolve the cycle by importing lazily at call time
    from repro_torch.core import costmodel as CM
    from repro_torch.core import trace as T

    if not isinstance(engines, (list, tuple)):
        engines = [engines]
    if profile is not None:
        peak_ops = profile.ops_per_s
        peak_bw = profile.mem_bw_gbs * 1e9
    else:
        peak_ops, peak_bw = HOST_REF_OPS_PER_S, HOST_REF_BYTES_PER_S

    by_label = {}
    tracers = {}
    for eng in engines:
        label = getattr(eng, "tel_label", "engine")
        by_label[label] = eng
        tracers[label] = CM.entry_tracer(eng, memo)

    agg: Dict[str, Dict[str, float]] = {}
    for s in telemetry.profiler.samples:
        eng = by_label.get(s.engine)
        if eng is None or s.index >= len(eng.dispatch_log):
            continue
        entry = eng.dispatch_log[s.index]
        tot = T.totals(tracers[s.engine](entry))
        row = agg.setdefault(s.kind, {
            "n": 0, "wall_s": 0.0, "flops": 0.0, "bytes": 0.0,
            "predicted_s": 0.0})
        row["n"] += 1
        row["wall_s"] += s.wall_s
        row["flops"] += tot.flops
        row["bytes"] += tot.bytes
        row["predicted_s"] += max(tot.flops / peak_ops, tot.bytes / peak_bw)

    for kind, row in agg.items():
        wall = row["wall_s"]
        row["achieved_flops_per_s"] = row["flops"] / wall if wall > 0 else 0.0
        row["achieved_bytes_per_s"] = row["bytes"] / wall if wall > 0 else 0.0
        row["arithmetic_intensity"] = (row["flops"] / row["bytes"]
                                       if row["bytes"] > 0 else 0.0)
        row["model_error_ratio"] = (wall / row["predicted_s"]
                                    if row["predicted_s"] > 0
                                    else float("nan"))
    return agg


def format_calibration(table: Dict[str, Dict[str, float]]) -> str:
    """Human-readable achieved-vs-predicted table for one calibration."""
    hdr = (f"{'kind':<16} {'n':>5} {'wall_ms':>9} {'GFLOP/s':>9} "
           f"{'GB/s':>8} {'AI':>8} {'pred_ms':>9} {'meas/pred':>9}")
    lines = [hdr, "-" * len(hdr)]
    for kind in sorted(table):
        r = table[kind]
        lines.append(
            f"{kind:<16} {int(r['n']):>5} {r['wall_s'] * 1e3:>9.3f} "
            f"{r['achieved_flops_per_s'] / 1e9:>9.2f} "
            f"{r['achieved_bytes_per_s'] / 1e9:>8.2f} "
            f"{r['arithmetic_intensity']:>8.2f} "
            f"{r['predicted_s'] * 1e3:>9.3f} "
            f"{r['model_error_ratio']:>9.3f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

class Telemetry:
    """Shared telemetry hub: span tracer + metrics + dispatch profiler.

    Pass one instance to any number of engines/workers; every hook
    checks ``enabled`` first and returns a no-op singleton when off, so
    a disabled hub adds only an attribute load + branch per call site.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tracer = SpanTracer()
        self.metrics = MetricsRegistry()
        self.profiler = DispatchProfiler()

    # -- recording --------------------------------------------------------

    def span(self, name: str, cat: str = "phase", tid: str = "engine",
             now_fn: Optional[Callable[[], Optional[float]]] = None,
             **labels):
        if not self.enabled:
            return _NULL_CTX
        return self.tracer.span(name, cat=cat, tid=tid, now_fn=now_fn,
                                **labels)

    def counter(self, name: str, **labels):
        if not self.enabled:
            return _NULL_METRIC
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels):
        if not self.enabled:
            return _NULL_METRIC
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, **labels):
        if not self.enabled:
            return _NULL_METRIC
        return self.metrics.histogram(name, **labels)

    # -- aggregates -------------------------------------------------------

    def engine_aggregates(self, tid: str) -> Dict[str, Any]:
        """Always-present summary fold-in for one engine label."""
        out = {"enabled": bool(self.enabled), "spans": 0,
               "span_wall_s": 0.0, "dispatches": 0,
               "dispatch_wall_s": 0.0}
        if not self.enabled:
            return out
        for s in self.tracer.spans:
            if s.tid != tid:
                continue
            out["spans"] += 1
            if s.depth == 0:
                out["span_wall_s"] += s.wall_dur_s
        for d in self.profiler.samples:
            if d.engine != tid:
                continue
            out["dispatches"] += 1
            out["dispatch_wall_s"] += d.wall_s
        return out


NULL_TELEMETRY = Telemetry(enabled=False)
