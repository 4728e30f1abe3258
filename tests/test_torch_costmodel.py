"""The port's static cost model (``repro_torch.core.costmodel``) — the
counterparts of ``tests/test_costmodel.py`` — and its parity with the
reference's ``repro.core.costmodel`` at the same shapes: equal weight
bytes and equal FLOPs over the products that read a weight, in every
family and dispatch kind, with each difference the two tracers are
known to have named and accounted for; the parameter specs of every
registry arch at full width; the W4A16 step's K6 records."""
from __future__ import annotations

import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import costmodel as JCM
from repro.models import model as JMD
from repro_torch.configs import registry
from repro_torch.core import costmodel as CM
from repro_torch.core import trace as T
from repro_torch.models import model as MD
from repro_torch.models import w4
from repro_torch.serving.engine import EngineConfig, ServingEngine
from _torch_threads import one_thread  # noqa: F401

CFG = registry.get_smoke_config("qwen1.5-0.5b").replace(dtype="float32")


@pytest.fixture(scope="module")
def params():
    return MD.init_params(CFG, seed=0, device="cpu")


def run_engine(params, **ekw):
    eng = ServingEngine(params, CFG, EngineConfig(
        max_batch=2, max_seq_len=64, max_new_tokens=4, **ekw), device="cpu")
    for p in ([1, 2, 3, 4, 5] * 4, [7, 8, 9]):
        eng.submit(np.array(p, np.int32))
    eng.run()
    return eng


# ---------------------------------------------------------------------------
# trace_linear over the engine's ragged functions (paged + verify)
# ---------------------------------------------------------------------------

def test_trace_linear_paged_decode_closure():
    """The paged ragged decode function traces to one positionally
    stable op stream across cache lengths, its cost growing in L."""
    pricer = CM.DispatchPricer(CFG)
    lin = pricer.decode_ops_linear(2, 256, ragged=True, kv_cache="paged",
                                   kv_block_size=16)
    assert lin  # trace_linear raises on a stream mismatch
    f_lo = sum(o.at(64).flops for o in lin)
    f_hi = sum(o.at(256).flops for o in lin)
    assert 0 < f_lo < f_hi
    b_lo = sum(o.at(64).in_bytes + o.at(64).out_bytes for o in lin)
    b_hi = sum(o.at(256).in_bytes + o.at(256).out_bytes for o in lin)
    assert b_lo < b_hi
    # the slope is the KV the step streams: 2 rows x K and V x layers,
    # plus each layer's K2 reading the int32 tables (W = L / 16 entries)
    kv = 2 * CFG.n_layers * CFG.n_kv_heads * CFG.d_head * 4
    assert (b_hi - b_lo) / 192 == pytest.approx(
        2 * kv + CFG.n_layers * 2 * 4 / 16)


def test_trace_linear_verify_closure():
    """The verify function (gamma + 1 candidates per row) fits linearly
    in the cache length and outworks the one-token decode at every
    length."""
    pricer = CM.DispatchPricer(CFG)
    ver = pricer.verify_ops_linear(2, 256, 3, kv_cache="contiguous")
    dec = pricer.decode_ops_linear(2, 256, ragged=True)
    assert ver
    for L in (64, 128, 256):
        fv = sum(o.at(L).flops for o in ver)
        fd = sum(o.at(L).flops for o in dec)
        assert fv > fd > 0


def test_pricer_memoizes_per_shape_class():
    pricer = CM.DispatchPricer(CFG)
    a = pricer.decode_ops_linear(1, 128, ragged=True)
    b = pricer.decode_ops_linear(1, 128, ragged=True)
    c = pricer.decode_ops_linear(2, 128, ragged=True)
    d = pricer.decode_ops_linear(1, 128, ragged=True, kv_cache="paged")
    assert a is b and a is not c and a is not d
    assert pricer.chunk_ops(16, 64) is pricer.chunk_ops(16, 64)
    assert pricer.chunk_ops(16, 64) is not pricer.chunk_ops(16, 64, "paged")
    assert set(pricer.decode_linear) == {
        (1, 128, True, "contiguous", 16), (2, 128, True, "contiguous", 16),
        (1, 128, True, "paged", 16)}


# ---------------------------------------------------------------------------
# dispatch audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ekw,kind", [
    ({}, "prefill"),
    ({"kv_cache": "paged", "kv_block_size": 8}, "decode"),
    ({"scheduler": "chunked", "chunk_tokens": 16, "prefill_bucket_min": 16},
     "chunk_contiguous"),
    ({"kv_cache": "paged", "scheduler": "chunked", "chunk_tokens": 16},
     "chunk_paged"),
    ({"scheduler": "speculative", "spec_gamma": 2}, "verify")],
    ids=["blocking", "paged", "chunked", "chunked_paged", "speculative"])
def test_audit_clean(params, ekw, kind):
    eng = run_engine(params, **ekw)
    rep = CM.audit_engine(eng)
    CM.assert_no_drift(rep)
    assert rep["priced"] == rep["dispatches"] > 0
    step_kind = "draft_decode" if kind == "verify" else "decode"
    assert rep["kinds"][kind] > 0 and rep["kinds"][step_kind] > 0
    # one target dispatch a step, read from the log
    steps = [e["step"] for e in eng.dispatch_log
             if e["kind"] in CM.TARGET_STEP_KINDS]
    assert len(steps) == len(set(steps))


def test_audit_traces_the_engines_own_functions(params, monkeypatch):
    """The audit's join goes through ``engine._closures`` — the objects
    the engine calls — not a second build."""
    eng = run_engine(params)
    seen = []
    dec = eng._closures["decode"]

    def spy(*a):
        seen.append(len(a))
        return dec(*a)

    monkeypatch.setitem(eng._closures, "decode", spy)
    CM.assert_no_drift(CM.audit_engine(eng))
    assert seen and eng._decode_ragged is dec


def test_audit_fails_on_unpriced_dispatch(params):
    eng = run_engine(params)
    eng.dispatch_log.append({"step": 999, "kind": "mystery", "spec": ()})
    rep = CM.audit_engine(eng)
    assert not rep["ok"]
    assert rep["unpriced"] and rep["unpriced"][0]["kind"] == "mystery"
    with pytest.raises(AssertionError, match="mystery"):
        CM.assert_no_drift(rep)


def test_audit_fails_on_double_dispatch(params):
    eng = run_engine(params)
    dup = next(e for e in eng.dispatch_log if e["kind"] == "decode")
    eng.dispatch_log.append(dict(dup))
    rep = CM.audit_engine(eng)
    assert rep["invariant_violations"] == [dup["step"]]
    with pytest.raises(AssertionError):
        CM.assert_no_drift(rep)


# ---------------------------------------------------------------------------
# cross-package parity with the reference's pricer
# ---------------------------------------------------------------------------

# one arch per family the port serves (danube: the rolling window)
PARITY_ARCHS = ("qwen1.5-0.5b", "deepseek-moe-16b", "internvl2-26b",
                "h2o-danube-1.8b", "whisper-large-v3", "zamba2-2.7b",
                "xlstm-350m")
ATTENTION_KINDS = ("prefill", "decode", "decode_paged", "chunk",
                   "chunk_paged", "verify")
SERVED = {"h2o-danube-1.8b": ("prefill", "decode"),
          "whisper-large-v3": ("prefill", "decode"),
          "zamba2-2.7b": ("prefill", "decode"),
          "xlstm-350m": ("prefill", "decode")}
B, LEN, S_PREFILL, CHUNK, GAMMA = 2, 64, 32, 16, 3


def _ops(pricer, kind):
    """The op stream of ``kind`` at the parity shapes (decode and verify
    read at the capacity ``LEN``)."""
    if kind == "prefill":
        return pricer.prefill_ops(1, S_PREFILL)
    if kind.startswith("chunk"):
        return pricer.chunk_ops(CHUNK, LEN, "paged" if kind.endswith(
            "paged") else "contiguous")
    if kind == "verify":
        lin = pricer.verify_ops_linear(B, LEN, GAMMA)
    else:
        lin = pricer.decode_ops_linear(
            B, LEN, ragged=True,
            kv_cache="paged" if kind.endswith("paged") else "contiguous")
    return [o.at(LEN) for o in lin]


def _tokens(kind) -> int:
    """Rows (tokens) of one dispatch of ``kind``."""
    return {"prefill": S_PREFILL, "chunk": CHUNK, "chunk_paged": CHUNK,
            "verify": B * (GAMMA + 1)}.get(kind, B)


def _ref_minus_port(cfg, kind) -> tuple[float, float]:
    """(weight bytes, weight-reading FLOPs) the reference's tracer
    charges beyond the port's, each from a named difference between the
    tracers (not between the models):

    - MoE router: the reference takes a product's weight to be its
      larger rank-2 operand, so where a dispatch's n token rows outweigh
      the (d, E) float32 router it charges the rows (n * d * 4) instead;
    - whisper's cross-attention decode: the reference projects the
      token through the cross wk / wv and drops them (``make_jaxpr``
      keeps dead code), two more products a layer; the port projects q
      only;
    - the sLSTM's recurrent product ``bhp,hpq->bhq``: jax's einsum puts
      the (H, p, 4p) weight first, so the reference's rank-3-rhs rule
      charges the (B, H, p) state instead, once a step (S steps in a
      prefill, one in a decode).
    Neither FLOP total moves but whisper's: the dead products are real
    work in the reference's stream."""
    elt = 2 if cfg.dtype == "bfloat16" else 4
    wb = fl = 0.0
    if cfg.is_moe:
        n, d, e = _tokens(kind), cfg.d_model, cfg.n_experts
        wb += (cfg.n_layers - cfg.first_dense_layers) * max(
            0, n * d * 4 - d * e * 4)
    if cfg.family == "audio" and kind == "decode":
        kvd = cfg.n_kv_heads * cfg.d_head
        wb += cfg.n_layers * 2 * cfg.d_model * kvd * elt
        fl += cfg.n_layers * 2 * 2 * B * cfg.d_model * kvd
    if cfg.family == "ssm" and cfg.slstm_every:
        n_super = MD.xlstm_dims(cfg)[0]
        h = cfg.n_heads
        ph = cfg.d_model // h
        rows, steps = (1, S_PREFILL) if kind == "prefill" else (B, 1)
        # the state (rows, H, ph) for the (H, ph, 4 ph) w_rec of
        # xlstm.init_slstm
        wb += n_super * steps * (rows * h * ph - h * ph * 4 * ph) * elt
    return wb, fl


# port / reference ratio of the contractions that read no weight
# (attention and recurrent products; K1-K4 records on the port's side),
# pinned per family and kind. Causes:
# - prefill: K3 counts the S(S+1)/2 (query, key) pairs the causal mask
#   keeps; the reference's chunked attention scores all S x S (whisper:
#   its encoder and cross-attention are non-causal, every pair on both
#   sides);
# - decode: K1 counts the self partial's PV product; the reference
#   weighs the self value elementwise, no contraction;
# - chunk / verify: K4 counts the causal half of the window's own block;
#   the reference scores the whole S x S block;
# - recurrent: torch's einsum turns the outer products of the Mamba2 and
#   mLSTM state updates (``bhp,bn->bhpn``, ``bhp,bhn->bhpn``) into
#   broadcast multiplies (elementwise); jax's into contractions.
BANDS = {("attention", "prefill"): (0.515, 0.517),
         ("attention", "decode"): (1.007, 1.016),
         ("attention", "decode_paged"): (1.007, 1.009),
         ("attention", "chunk"): (0.905, 0.907),
         ("attention", "chunk_paged"): (0.905, 0.907),
         ("attention", "verify"): (0.977, 0.979),
         ("audio", "prefill"): (0.72, 0.73),
         ("audio", "decode"): (1.006, 1.007),
         ("hybrid", "prefill"): (0.89, 0.90),
         ("hybrid", "decode"): (0.75, 0.76),
         ("ssm", "prefill"): (0.97, 0.98),
         ("ssm", "decode"): (0.5, 0.5)}


def _split(ops):
    """(weight bytes, FLOPs of weight-reading products, FLOPs of the
    contractions that read none)."""
    wb = sum(o.weight_bytes for o in ops)
    wf = sum(o.flops for o in ops if o.weight_bytes > 0)
    cf = sum(o.flops for o in ops if o.weight_bytes == 0 and (
        o.kind in ("gemm", "gemv") or (o.kind == "kernel"
                                       and o.prim != "add_rmsnorm")))
    return wb, wf, cf


@pytest.fixture(scope="module")
def pricers():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (JCM.DispatchPricer(jreg.get_smoke_config(arch)),
                           CM.DispatchPricer(registry.get_smoke_config(arch)))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in PARITY_ARCHS for k in SERVED.get(a, ATTENTION_KINDS)])
def test_pricer_parity_with_reference(pricers, arch, kind):
    jp, tp = pricers(arch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_wb, j_wf, j_cf = _split(_ops(jp, kind))
    t_wb, t_wf, t_cf = _split(_ops(tp, kind))
    d_wb, d_wf = _ref_minus_port(tp.cfg, kind)
    assert t_wb > 0 and t_wf > 0
    assert t_wb + d_wb == j_wb
    assert t_wf + d_wf == pytest.approx(j_wf, rel=1e-9)
    fam = tp.cfg.family
    key = (fam if fam in ("audio", "hybrid", "ssm") else "attention", kind)
    lo, hi = BANDS[key]
    assert lo <= t_cf / j_cf <= hi, (key, t_cf / j_cf)


def test_chunk_on_a_family_without_it_is_refused_on_both_sides(pricers):
    jp, tp = pricers("zamba2-2.7b")
    with pytest.raises(ValueError):
        jp.chunk_ops(CHUNK, LEN)
    with pytest.raises(ValueError):
        tp.chunk_ops(CHUNK, LEN)


# ---------------------------------------------------------------------------
# parameter specs and the W4A16 step
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", registry.list_archs(assigned_only=False))
def test_params_spec_matches_reference_at_full_width(arch):
    want = dict(_leaves(JCM.params_spec(jreg.get_config(arch))))
    got = dict(_leaves(CM.params_spec(registry.get_config(arch))))
    assert got.keys() == want.keys()
    for path, t in got.items():
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).split(".")[1] == str(want[path].dtype), path


def test_spec_functions_match_reference_structs():
    """``cache_spec``, ``paged_cache_spec`` and ``batch_spec``: the
    reference's shapes (the paged pools one scratch block longer)."""
    for arch in ("qwen1.5-0.5b", "internvl2-26b", "whisper-large-v3",
                 "zamba2-2.7b", "xlstm-350m"):
        jcfg, cfg = jreg.get_smoke_config(arch), registry.get_smoke_config(
            arch)
        for got, want in (
                (MD.cache_spec(cfg, 2, 48), JMD.cache_spec(jcfg, 2, 48)),
                (MD.batch_spec(cfg, 2, 40, "prefill"),
                 JMD.batch_spec(jcfg, 2, 40, "prefill")),
                (MD.batch_spec(cfg, 2, 1, "decode"),
                 JMD.batch_spec(jcfg, 2, 1, "decode"))):
            assert got.keys() == want.keys(), arch
            for k in got:
                assert got[k].is_meta
                assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
        with pytest.raises(ValueError, match="decode or prefill"):
            MD.batch_spec(cfg, 2, 40, "train")  # the port serves only
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    got = MD.paged_cache_spec(cfg, 2, 40, 16, ragged=True)
    want = JMD.paged_cache_spec(jreg.get_smoke_config("qwen1.5-0.5b"), 2,
                                40, 16, ragged=True)
    assert tuple(got["block_tab"].shape) == tuple(want["block_tab"].shape)
    assert tuple(got["len"].shape) == (2,)
    assert got["k"].shape[1] == want["k"].shape[1] + 1


def test_w4_decode_step_prices_one_k6_record_per_projection():
    cfg = registry.get_smoke_config("phi3-mini-3.8b")
    qp = w4.quantize_params(CM.params_spec(cfg), 16)
    cache = MD.cache_spec(cfg, 1, 32)
    tok = torch.empty((1, 1), dtype=torch.int32, device="meta")
    recs = T.trace_ops(lambda p, t, c: w4.w4_decode_step(p, cfg, t, c, 16),
                       qp, tok, cache)
    k6 = [o for o in recs if o.kernel == "quant_gemv"]
    assert len(k6) == 7 * cfg.n_layers
    assert all(o.flops > 0 and o.rows == 1 for o in k6)
    kernels = {o.kernel for o in recs if o.kind == "kernel"}
    assert kernels == {"quant_gemv", "add_rmsnorm", "decode_attention"}
