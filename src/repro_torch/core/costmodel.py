"""Static-analysis cost model over the serving engine's own dispatch
functions, plus the dispatch-log audit.

Counterpart of ``repro/core/costmodel.py``. The engine's dispatch
functions (:func:`repro_torch.serving.engine.build_closures`, the same
objects a :class:`~repro_torch.serving.engine.ServingEngine` calls) are
run on ``meta`` tensors through :mod:`repro_torch.core.trace`: whatever
the engine dispatches is, op for op, what is priced, and a kernel is
priced by its own ``cost()``. Nothing is allocated, so a full-width
model of any size is priced on any host.

- :class:`DispatchPricer` — memoized op streams for each dispatch kind
  (bucketed prefill, ragged decode, prefill chunk, speculative verify),
  decode and verify fitted linear in the cache length
  (:func:`~repro_torch.core.trace.trace_linear`).
- :func:`audit_engine` — maps every ``dispatch_log`` entry of an engine
  to a priced op stream through the engine's own functions and reports
  an unpriced dispatch, a heavy ``"other"`` op, a kernel priced at zero
  FLOPs, a decode / verify stream that differs from the pricer's, or a
  step with more than one target dispatch; :func:`assert_no_drift`
  raises on any of them.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.core import trace as T
from repro_torch.models import model as MD
from repro_torch.serving.engine import build_closures

# target-model dispatch kinds (the per-step invariant applies to these;
# draft_* kinds are the speculative scheduler's small-model calls)
TARGET_STEP_KINDS = ("decode", "verify")


def params_spec(cfg) -> dict:
    """The model's parameter tree as meta tensors (no allocation)."""
    return MD.init_params(cfg, device="meta")


def _fit_window(max_len: int) -> tuple:
    """Two cache lengths bracketing ``max_len`` for the linear fit."""
    L1 = max(32, max_len // 2)
    L2 = max_len
    if L1 == L2:  # degenerate fit window (max_len == 32)
        L1 = max(1, L2 // 2)
    return L1, L2


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class DispatchPricer:
    """Traced op streams for every engine dispatch kind, memoized.

    The functions traced are ``engine.build_closures``'s — those the
    engine calls. Memo dicts are public, keyed per shape class: a reused
    pricer never returns one call's trace for another batch size or
    sequence length."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.decode_linear = {}   # (batch, max_len, ragged, kv, bs)
        self.prefill_cache = {}   # (batch, n_in)
        self.chunk_cache = {}     # (chunk_tokens, capacity, kind, bs)
        self.verify_linear = {}   # (batch, max_len, gamma, kv, bs)
        self._params = None
        self._closures = build_closures(cfg)

    def _params_spec(self):
        if self._params is None:
            self._params = params_spec(self.cfg)
        return self._params

    # -- dispatch kinds ----------------------------------------------------
    def prefill_ops(self, batch: int, n_in: int):
        """One bucketed whole-prompt prefill dispatch of ``n_in``
        positions (a vlm's image prefix included), every one valid."""
        key = (batch, n_in)
        if key not in self.prefill_cache:
            params = self._params_spec()
            spec = MD.batch_spec(self.cfg, batch, n_in, "prefill")
            self.prefill_cache[key] = T.trace_ops(
                self._closures["prefill"], params, spec, n_in - 1, n_in,
                weights=params)
        return self.prefill_cache[key]

    def decode_ops_linear(self, batch: int, max_len: int, *,
                          ragged: bool = False,
                          kv_cache: str = "contiguous",
                          kv_block_size: int = 16):
        """Linear-in-cache-length op stream of one decode step.

        ``ragged=True`` traces the engine's ragged decode function
        (per-row positions and a live mask); ``kv_cache="paged"`` feeds
        it the block-table cache, pools sized to the resident worst case.
        ``ragged=False`` is the aligned single-sequence step
        (``MD.decode_step`` without a live mask). A kernel's lengths are
        unknown on meta tensors, so it is priced at the capacity: every
        position up to the traced length."""
        key = (batch, max_len, ragged, kv_cache, kv_block_size)
        if key not in self.decode_linear:
            params = self._params_spec()
            cfg = self.cfg
            dec = self._closures["decode"]

            def of_len(L):
                if kv_cache == "paged":
                    cache = MD.paged_cache_spec(cfg, batch, L, kv_block_size,
                                                ragged=ragged)
                else:
                    cache = MD.cache_spec(cfg, batch, L)
                tok = _meta((batch, 1), torch.int32)
                if ragged:
                    cache["len"] = _meta((batch,), torch.int32)
                    vec = _meta((batch,), torch.int32)
                    live = _meta((batch,), torch.bool)
                    return dec, (params, tok, cache, vec, live), params

                def fn(p, t, c):
                    return MD.decode_step(p, cfg, t, c)

                return fn, (params, tok, cache), params

            self.decode_linear[key] = T.trace_linear(
                of_len, *_fit_window(max_len))
        return self.decode_linear[key]

    def verify_ops_linear(self, batch: int, max_len: int, gamma: int, *,
                          kv_cache: str = "contiguous",
                          kv_block_size: int = 16):
        """Linear-in-cache-length op stream of one speculative verify
        dispatch: ``gamma + 1`` candidates per row against the row's
        history — the engine's ragged ``verify`` function, traced at two
        cache lengths like the decode step."""
        key = (batch, max_len, gamma, kv_cache, kv_block_size)
        if key not in self.verify_linear:
            params = self._params_spec()
            ver = self._closures["verify"]

            def of_len(L):
                if kv_cache == "paged":
                    cache = MD.paged_cache_spec(self.cfg, batch, L,
                                                kv_block_size, ragged=True)
                else:
                    cache = MD.cache_spec(self.cfg, batch, L)
                cache["len"] = _meta((batch,), torch.int32)
                tok = _meta((batch, gamma + 1), torch.int32)
                vec = _meta((batch,), torch.int32)
                live = _meta((batch,), torch.bool)
                return ver, (params, tok, cache, vec, live), params

            self.verify_linear[key] = T.trace_linear(
                of_len, *_fit_window(max_len))
        return self.verify_linear[key]

    def chunk_ops(self, chunk_tokens: int, capacity: int,
                  kind: str = "contiguous", kv_block_size: int = 16):
        """Op stream of one chunked-prefill dispatch over a one-slot cache
        of the full ``capacity``: the slot's rows are a view (contiguous)
        or a block-table gather (paged) masked by ``hist_len``, which is
        unknown here, so K4 is priced over the whole capacity."""
        key = (chunk_tokens, capacity, kind, kv_block_size)
        if key not in self.chunk_cache:
            cfg = self.cfg
            MD.check_over_cache(cfg, "chunked prefill")
            params = self._params_spec()
            fn = self._closures[f"chunk_{kind}"]
            batch = {"tokens": _meta((1, chunk_tokens), torch.int32)}
            if kind == "paged":
                # one slot's resident worst case: W = ceil(cap/bs) blocks
                # in the table (and the pool's scratch block)
                w = -(-capacity // kv_block_size)
                st = MD.paged_pool_struct(cfg, w, kv_block_size)
                kh, vh = (_meta(*st[n]) for n in ("k", "v"))
                sel = _meta((1, w), torch.int32)
            else:
                st = MD.cache_struct(cfg, 1, capacity)
                kh, vh = (_meta(*st[n]) for n in ("k", "v"))
                sel = 0
            hist = _meta((), torch.int32)
            self.chunk_cache[key] = T.trace_ops(
                fn, params, batch, kh, vh, sel, hist, chunk_tokens - 1,
                weights=params)
        return self.chunk_cache[key]


# ---------------------------------------------------------------------------
# dispatch audit: engine log -> priced graphs, or fail
# ---------------------------------------------------------------------------

def entry_tracer(engine, memo: dict | None = None):
    """Memoized ``dispatch_log`` entry -> traced op stream for one engine.

    The join the audit uses: ``kind`` selects the engine's own dispatch
    function (``draft_*`` kinds the draft model's, with its params), and
    the entry's operand specs are traced through it on meta tensors.
    Shared by :func:`audit_engine` and the telemetry calibration
    (``repro_torch.serving.telemetry.dispatch_calibration``), so the
    seconds measured and the FLOPs / bytes predicted refer to the same
    function. ``memo`` (optional) is shared between engines: an entry
    traced for one engine is not traced again for another of the same
    model (its ``"entries"`` dict holds the traces). Raises ``KeyError``
    for a kind with no function. An engine on a device mesh is priced as
    the one program its dispatch is: its log holds the one-device
    engine's operands, traced through the whole model's functions and
    params (``ServingEngine.audit_functions``)."""
    if hasattr(engine, "audit_functions"):
        closures, params, draft_closures, draft_params = \
            engine.audit_functions()
    else:   # a record of an engine (its log, functions and params)
        closures = engine._closures
        draft_closures = getattr(engine, "_draft_closures", None)
        params = engine.params
        draft_params = getattr(engine, "draft_params", None)
    # params and operands as meta tensors (every tensor and TensorSpec);
    # other operands (slots, host lengths) keep their values
    pspec = T.to_meta(params)
    dspec = T.to_meta(draft_params) if draft_params is not None else None
    # (model config, kind, spec repr) -> op stream, traced once
    traced = {} if memo is None else memo.setdefault("entries", {})

    def trace_entry(entry):
        kind = entry["kind"]
        if kind.startswith("draft_"):
            fn = (draft_closures or {}).get(kind[len("draft_"):])
            ps = dspec
            cfg = getattr(engine, "draft_cfg", None)
        else:
            fn = closures.get(kind)
            ps = pspec
            cfg = engine.cfg
        if fn is None or ps is None:
            raise KeyError(f"no closure for dispatch kind {kind!r}")
        key = (cfg, kind, repr(entry["spec"]))
        if key not in traced:
            traced[key] = T.trace_ops(fn, ps, *entry["spec"],
                                      weights=ps)
        return traced[key]

    return trace_entry


def audit_engine(engine, *, other_bytes_threshold: float = 4096.0,
                 memo: dict | None = None) -> dict:
    """Map every dispatch an engine issued to a priced op stream.

    Traces each ``engine.dispatch_log`` entry through the engine's own
    dispatch functions; ``report["ok"]`` is False on any drift:

    - ``unpriced``: a dispatch kind with no function, or whose trace
      fails;
    - ``unknown_prims``: an op classified ``"other"`` carrying more than
      ``other_bytes_threshold`` bytes;
    - ``zero_flop_kernels``: a kernel record priced at zero FLOPs;
    - ``stream_mismatch``: the engine's decode / verify op stream
      differs positionally from :class:`DispatchPricer`'s for the same
      (batch, kv backend);
    - ``invariant_violations``: a step with more than one target-model
      dispatch, read from the log.

    ``memo`` is :func:`entry_tracer`'s; its ``"pricers"`` dict also
    keeps one :class:`DispatchPricer` per model.
    """
    log = engine.dispatch_log
    report = {
        "dispatches": len(log), "priced": 0, "kinds": Counter(),
        "unpriced": [], "unknown_prims": [], "zero_flop_kernels": [],
        "stream_mismatch": [], "invariant_violations": [],
    }
    trace_entry = entry_tracer(engine, memo)

    seen_streams = set()
    # one pricer per model across the engines sharing the memo
    pricers = {} if memo is None else memo.setdefault("pricers", {})
    if engine.cfg not in pricers:
        pricers[engine.cfg] = DispatchPricer(engine.cfg)
    pricer = pricers[engine.cfg]
    kv_kind = "paged" if "paged" in engine.kv.name else "contiguous"
    bs = engine.ecfg.kv_block_size
    for entry in log:
        kind = entry["kind"]
        report["kinds"][kind] += 1
        try:
            ops = trace_entry(entry)
        except Exception as e:  # noqa: BLE001 — the audit must report,
            report["unpriced"].append(          # not crash, on bad kinds
                {"step": entry["step"], "kind": kind, "error": repr(e)})
            continue
        report["priced"] += 1
        for o in ops:
            if (o.kind == "other"
                    and o.in_bytes + o.out_bytes > other_bytes_threshold):
                report["unknown_prims"].append(
                    {"kind": kind, "prim": o.prim,
                     "bytes": o.in_bytes + o.out_bytes})
            if o.kind == "kernel" and o.flops == 0 and o.count > 0:
                report["zero_flop_kernels"].append(
                    {"kind": kind, "kernel": o.kernel})
        # decode / verify: the engine's stream must equal the one the
        # pricer prices for the same shape class, op for op
        if kind in TARGET_STEP_KINDS:
            toks = entry["spec"][0]
            batch = int(toks.shape[0])
            skey = (kind, batch, int(toks.shape[1]))
            if skey in seen_streams:
                continue
            seen_streams.add(skey)
            if kind == "decode":
                model = pricer.decode_ops_linear(
                    batch, engine.ecfg.max_seq_len, ragged=True,
                    kv_cache=kv_kind, kv_block_size=bs)
            else:
                model = pricer.verify_ops_linear(
                    batch, engine.ecfg.max_seq_len,
                    int(toks.shape[1]) - 1,
                    kv_cache=kv_kind, kv_block_size=bs)
            got = [o.prim for o in ops]
            want = [o.prim for o in model]
            if got != want:
                report["stream_mismatch"].append(
                    {"kind": kind, "batch": batch,
                     "engine_ops": len(got), "model_ops": len(want)})
    per_step = Counter(e["step"] for e in log
                       if e["kind"] in TARGET_STEP_KINDS)
    report["invariant_violations"] = sorted(
        s for s, c in per_step.items() if c > 1)
    report["ok"] = not (report["unpriced"] or report["unknown_prims"]
                        or report["zero_flop_kernels"]
                        or report["stream_mismatch"]
                        or report["invariant_violations"])
    return report


def assert_no_drift(report: dict):
    """Raise AssertionError with a readable summary unless the audit
    came back clean."""
    if report.get("ok"):
        return
    lines = [f"dispatch audit failed "
             f"({report['priced']}/{report['dispatches']} priced):"]
    for k in ("unpriced", "unknown_prims", "zero_flop_kernels",
              "stream_mismatch"):
        for item in report[k]:
            lines.append(f"  {k}: {item}")
    if report["invariant_violations"]:
        lines.append(f"  >1 target dispatch at steps "
                     f"{report['invariant_violations']}")
    raise AssertionError("\n".join(lines))
