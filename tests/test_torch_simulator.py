"""The port's PIM-AI simulator (``repro_torch.core.simulator``) against
the reference's (``repro.core.simulator``): the pricing rules on the
same records, the kernel-record table, every case of
``tests/test_simulator.py`` on the port, the memo aliasing of
``tests/test_costmodel.py``, each ``serve`` mode's schedule against the
reference's, and the simulator parts of the port's examples."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from repro.configs import registry as jreg
from repro.core import profiles as JHW
from repro.core import simulator as JS
from repro.core import trace as JT
from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core import simulator as S
from repro_torch.core import trace as T
from repro_torch.core.simulator import (LLMSimulator, SimConfig,
                                        _host_transfer, _op_cost)
from repro_torch.kernels import ops
from repro_torch.models import layers as L

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

CFG = registry.get_config("llama2-7b")
FIELDS = [f.name for f in dataclasses.fields(S.PhaseResult)]


def make_sim(hw=HW.PIM_AI_MOBILE, **kw):
    return LLMSimulator(CFG, hw, SimConfig(**kw))


def _fields(r) -> tuple:
    return tuple(getattr(r, f) for f in FIELDS)


def _profiles():
    """(port profile, reference profile) pairs, every Table-1 row and
    the composed PIM engine."""
    names = ("PIM_AI_CHIP", "PIM_AI_MOBILE", "PIM_AI_SERVER", "A17_PRO",
             "SNAPDRAGON_8_GEN3", "DIMENSITY_9300", "DGX_H100")
    return ([(getattr(HW, n), getattr(JHW, n)) for n in names]
            + [(HW.pim_engine(), JHW.pim_engine())])


SIMS = ((16, 16, 0.0, 1), (4, 16, 0.09, 1), (16, 8, 0.0, 8),
        (8, 16, 5e-4, 128))

# one record of every kind, as (kind, prim, fields)
RECORDS = (
    ("gemm", "mm", dict(flops=1e12, in_bytes=2e9, out_bytes=1e6,
                        weight_bytes=2e9, rows=512)),
    ("gemm", "bmm", dict(flops=1e9, in_bytes=64e9, out_bytes=64e9,
                         batch_dims=2)),
    ("gemm", "bmm", dict(flops=1e9, in_bytes=5e8, out_bytes=1e6,
                         weight_bytes=4e8, batch_dims=1)),
    ("gemv", "mm", dict(flops=1e9, in_bytes=1e9, out_bytes=1e5)),
    ("gemv", "mm", dict(flops=3e8, in_bytes=2e8, out_bytes=4e3,
                        weight_bytes=1.5e8, rows=1)),
    ("conv", "convolution", dict(flops=5e9, in_bytes=3e7, out_bytes=2e7,
                                 weight_bytes=1e6)),
    ("elementwise", "mul", dict(flops=4e6, in_bytes=8e6, out_bytes=8e6)),
    ("reduce", "sum", dict(flops=4e6, in_bytes=8e6, out_bytes=2e3)),
    ("data", "index", dict(in_bytes=1e3, out_bytes=8e6)),
    ("data", "index_put_", dict(in_bytes=6e6, out_bytes=6e6)),
    ("other", "mystery", dict(in_bytes=5e5, out_bytes=5e5)),
    ("kernel", "decode_attention", dict(flops=2e9, in_bytes=3e9,
                                        out_bytes=1e5, rows=1,
                                        kernel="decode_attention")),
    ("kernel", "quant_gemv", dict(flops=1e9, in_bytes=5e8, out_bytes=1e4,
                                  rows=1, kernel="quant_gemv")),
)


# ---------------------------------------------------------------------------
# the pricing rules against the reference's, on the same records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sim", SIMS, ids=lambda s: "w%da%d_o%g_tp%d" % s)
@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: f"{r[0]}-{r[1]}")
def test_op_cost_equals_reference(rec, sim):
    """The same OpRecord fields through both ``_op_cost``s give the same
    PhaseResult, exactly, on every profile (for a kernel record: one of
    the kernels the table prices by the reference's kernel branch)."""
    kind, prim, kw = rec
    wb, ab, orch, tp = sim
    port = SimConfig(weight_bits=wb, act_bits=ab, orchestration_s=orch,
                     tp_degree=tp)
    ref = JS.SimConfig(weight_bits=wb, act_bits=ab, orchestration_s=orch,
                       tp_degree=tp)
    for hw, jhw in _profiles():
        got = _op_cost(T.OpRecord(kind, prim, **kw), hw, port)
        want = JS._op_cost(JT.OpRecord(kind, prim, **kw), jhw, ref)
        assert _fields(got) == _fields(want), (hw.name, kind, prim)


@pytest.mark.parametrize("aten", sorted(S.ATEN_DATA_PRIMS))
def test_aliased_aten_prim_prices_as_its_jax_name(aten):
    """Each aten reshuffle gives the PhaseResult its JAX primitive gives
    in the reference — nothing: it fuses into the surrounding op."""
    jax_name = S.ATEN_DATA_PRIMS[aten]
    kw = dict(in_bytes=3e8, out_bytes=3e8)
    for hw, jhw in _profiles():
        got = _op_cost(T.OpRecord("data", aten, **kw), hw, SimConfig())
        want = JS._op_cost(JT.OpRecord("data", jax_name, **kw), jhw,
                           JS.SimConfig())
        assert _fields(got) == _fields(want) == (0.0,) * len(FIELDS)
    # the reference's own names keep their meaning on the port
    for name in S.FUSED_DATA_PRIMS:
        assert _fields(_op_cost(T.OpRecord("data", name, **kw), HW.A17_PRO,
                                SimConfig())) == (0.0,) * len(FIELDS)


def _torch_prims(fn, *shapes) -> set:
    ops_ = T.trace_ops(fn, *(torch.empty(s, dtype=torch.bfloat16,
                                         device="meta") for s in shapes))
    return {o.prim for o in ops_ if o.kind in ("data", "other")}


def _jax_prims(fn, *shapes) -> set:
    """Every primitive of ``fn``'s jaxpr, sub-jaxprs included."""
    import jax

    def walk(jaxpr, out):
        for eqn in jaxpr.eqns:
            out.add(eqn.primitive.name)
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    walk(sub, out)
        return out

    specs = [jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shapes]
    return walk(jax.make_jaxpr(fn)(*specs).jaxpr, set())


# (aten op, the torch call the port's code makes, the JAX counterpart)
RESHUFFLES = (
    ("cat", lambda a, b: torch.cat([a, b], -1),
     lambda a, b: jnp.concatenate([a, b], -1)),
    ("stack", lambda a, b: torch.stack([a, b]),
     lambda a, b: jnp.stack([a, b])),
    ("roll", lambda a, b: torch.roll(a, 3, 1),
     lambda a, b: jnp.roll(a, 3, 1)),
    ("constant_pad_nd", lambda a, b: F.pad(a, (0, 5)),
     lambda a, b: jnp.pad(a, ((0, 0), (0, 5)))),
    ("flip", lambda a, b: torch.flip(a, (1,)),
     lambda a, b: jnp.flip(a, 1)),
    ("topk", lambda a, b: torch.topk(a, 2, -1),
     lambda a, b: lax.top_k(a, 2)),
)


@pytest.mark.parametrize("aten,tfn,jfn", RESHUFFLES,
                         ids=[r[0] for r in RESHUFFLES])
def test_aten_alias_is_what_each_tracer_records(aten, tfn, jfn):
    """The mapping pinned: the port's tracer records the aten op, the
    reference's records the JAX primitive it is mapped to."""
    assert aten in _torch_prims(tfn, (4, 16), (4, 16))
    assert S.ATEN_DATA_PRIMS[aten] in _jax_prims(jfn, (4, 16), (4, 16))


def test_every_reshuffle_the_tracer_records_is_mapped():
    """``trace.DATA_OPS`` less its gathers and scatters (real memory
    traffic) and ``repeat`` / ``repeat_interleave`` (a copy JAX lowers
    to a broadcast), and ``topk``, is the set the table maps (``sort``
    keeps its name); RoPE's rotation records a ``cat`` that costs
    nothing."""
    reshuffles = T.DATA_OPS - T.GATHER_OPS - T.SCATTER_OPS - {
        "repeat", "repeat_interleave"}
    assert reshuffles | {"topk"} == set(S.ATEN_DATA_PRIMS)
    assert {"sort", "topk"} <= T.GATHER_OPS and "sort" in S.FUSED_DATA_PRIMS
    x = torch.empty((2, 8, 4, 32), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((2, 8), dtype=torch.int32, device="meta")
    rope = T.trace_ops(lambda a, p: L.apply_rope(a, p, 10000.0), x, pos)
    cats = [o for o in rope if o.prim == "cat"]
    assert len(cats) == 1 and cats[0].kind == "data"
    assert _fields(_op_cost(cats[0], HW.A17_PRO, SimConfig())) == (
        0.0,) * len(FIELDS)


def test_host_transfer_and_tp_collective_equal_reference():
    for hw, jhw in _profiles():
        for n in (0.0, 4.0, 3.3e7, 1e11):
            for d2h in (False, True):
                assert _fields(_host_transfer(n, hw, d2h=d2h)) == _fields(
                    JS._host_transfer(n, jhw, d2h=d2h))
            assert _fields(S._tp_collective(n, hw)) == _fields(
                JS._tp_collective(n, jhw))


def test_profiles_equal_reference():
    for hw, jhw in _profiles():
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)


# ---------------------------------------------------------------------------
# the kernel-record table
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_record(name):
    """(the record the tracer makes of one call of wrapper ``name`` at
    smoke shapes, the call's (FLOPs, bytes) from ``ops.call_cost``)."""
    b, s, hq, hkv, dh, c = 2, 16, 4, 2, 32, 64
    q1 = _meta(b, 1, hq, dh)
    kc, vc = _meta(b, c, hkv, dh), _meta(b, c, hkv, dh)
    cl = _meta(b, dtype=torch.int32)
    calls = {
        "add_rmsnorm": ((_meta(b, s, 128), _meta(b, s, 128), _meta(128)),
                        {}),
        "flash_attention": ((_meta(b, s, hq, dh), _meta(b, s, hkv, dh),
                             _meta(b, s, hkv, dh)), {}),
        "decode_attention": ((q1, kc, vc, cl), {}),
        "paged_decode_attention": (
            (q1, _meta(9, 16, hkv, dh), _meta(9, 16, hkv, dh),
             _meta(b, 4, dtype=torch.int32), cl), {}),
        "prefill_attention": (
            (_meta(1, s, hq, dh), _meta(1, c, hkv, dh),
             _meta(1, c, hkv, dh), _meta(dtype=torch.int32),
             _meta(1, s, hkv, dh), _meta(1, s, hkv, dh)), {}),
        "quant_gemv": ((_meta(b, 256), _meta(128, 64, dtype=torch.uint8),
                        _meta(2, 64)), {"group": 128}),
    }
    args, kw = calls[name]
    recs = T.trace_ops(lambda *a: getattr(ops, name)(*a, **kw), *args)
    assert len(recs) == 1 and recs[0].kind == "kernel"
    return recs[0], ops.call_cost(name, *args, **kw)


@pytest.mark.parametrize("name", sorted(S.KERNEL_RULES))
def test_kernel_record_pricing_table(name):
    """K5 is a normalization (vector OPs, no memory), K3 the prefill's
    attention scores (compute only), K1 / K2 / K4 / K6 stream their
    cost() bytes from memory."""
    rec, (flops, nbytes) = _kernel_record(name)
    assert rec.kernel == name and rec.flops == flops
    assert rec.in_bytes + rec.out_bytes == pytest.approx(nbytes)
    for hw, _ in _profiles():
        for sim in (SimConfig(), SimConfig(weight_bits=4, act_bits=8)):
            r = _op_cost(rec, hw, sim)
            ascale = sim.act_bits / 16
            assert r.ops == flops
            rule = S.KERNEL_RULES[name]
            if rule == "normalization":
                assert r.mem_bytes == 0.0 and r.memory_s == 0.0
                assert r.seconds == flops / hw.vector_ops_per_s
                assert r.energy_j == flops * hw.pj_per_op * 1e-12
            elif rule == "attention_scores":
                assert r.mem_bytes == 0.0 and r.memory_s == 0.0
                assert r.seconds == flops / hw.ops_per_s
                assert r.energy_j == pytest.approx(
                    flops * hw.pj_per_op * ascale * 1e-12)
            else:
                assert r.mem_bytes == pytest.approx(nbytes * ascale)
                assert r.seconds == max(
                    flops / hw.ops_per_s,
                    r.mem_bytes / (hw.mem_bw_gbs * 1e9))
    assert {"add_rmsnorm": "normalization",
            "flash_attention": "attention_scores"}.get(
                name, "stream") == S.KERNEL_RULES[name]


def test_kernel_table_names_every_kernel_wrapper():
    assert set(S.KERNEL_RULES) == set(ops._COSTS)


def test_unknown_kernel_record_raises():
    rec = T.OpRecord("kernel", "mystery_kernel", flops=1.0, in_bytes=1.0,
                     kernel="mystery_kernel")
    with pytest.raises(ValueError, match="mystery_kernel"):
        _op_cost(rec, HW.A17_PRO, SimConfig())


# ---------------------------------------------------------------------------
# tests/test_simulator.py, on the port
# ---------------------------------------------------------------------------

def test_weight_gemm_is_roofline_max():
    """A weight GEMM costs max(compute, weight-stream) seconds."""
    op = T.OpRecord("gemm", "mm", flops=1e12, in_bytes=2e9, out_bytes=1e6,
                    weight_bytes=2e9)
    hw = HW.PIM_AI_MOBILE
    r = _op_cost(op, hw, SimConfig())
    assert r.seconds == pytest.approx(
        max(1e12 / hw.ops_per_s, 2e9 / (hw.mem_bw_gbs * 1e9)))


def test_gemv_memory_bound_charges_all_operands():
    """Decode GEMV (KV stream) pays the full operand traffic."""
    op = T.OpRecord("gemv", "mm", flops=1e9, in_bytes=1e9, out_bytes=1e5,
                    weight_bytes=0.0)
    r = _op_cost(op, HW.A17_PRO, SimConfig())
    assert r.memory_s > r.compute_s
    assert r.seconds == pytest.approx(r.memory_s)
    assert r.mem_bytes == pytest.approx(1e9 + 1e5)


def test_attention_scores_gemm_is_sram_resident():
    """>= 2 batch dims + no weight operand => flash-fused: no memory."""
    op = T.OpRecord("gemm", "bmm", flops=1e9, in_bytes=64e9,
                    out_bytes=64e9, weight_bytes=0.0, batch_dims=2)
    r = _op_cost(op, HW.A17_PRO, SimConfig())
    assert r.mem_bytes == 0.0
    assert r.seconds == pytest.approx(r.compute_s)


def test_stacked_expert_gemm_charges_weights():
    """Rank-3 expert weights (1 batch dim) remain a memory stream."""
    op = T.OpRecord("gemm", "bmm", flops=1e9, in_bytes=5e8, out_bytes=1e6,
                    weight_bytes=4e8, batch_dims=1)
    r = _op_cost(op, HW.A17_PRO, SimConfig())
    assert r.mem_bytes == pytest.approx(4e8)


def test_weight_bits_scale_weight_stream_and_mac_energy():
    op = T.OpRecord("gemm", "mm", flops=1e12, in_bytes=2e9, out_bytes=1e6,
                    weight_bytes=2e9)
    r16 = _op_cost(op, HW.A17_PRO, SimConfig(weight_bits=16))
    r4 = _op_cost(op, HW.A17_PRO, SimConfig(weight_bits=4))
    assert r4.mem_bytes == pytest.approx(r16.mem_bytes / 4)
    assert r4.energy_j < r16.energy_j


def test_host_transfer_uses_direction_params():
    hw = HW.PIM_AI_SERVER  # asymmetric: 22 h2d / 528 d2h
    up = _host_transfer(1e9, hw, d2h=False)
    down = _host_transfer(1e9, hw, d2h=True)
    assert up.seconds == pytest.approx(1e9 / 22e9)
    assert down.seconds == pytest.approx(1e9 / 528e9)
    assert up.energy_j > down.energy_j  # 1920 vs 50 pJ/bit


@pytest.fixture(scope="module")
def sim():
    return make_sim()


def test_encode_compute_bound_decode_memory_bound(sim):
    """Prefill is compute-bound, decode is memory-bound (§1.2)."""
    enc = sim.encode(1, 1000)
    dec = sim.decode(1, 1000, 100)
    assert enc.compute_s > enc.memory_s
    assert dec.memory_s > dec.compute_s


def test_decode_time_grows_with_context(sim):
    """KV history reads grow with cache length (§3.1)."""
    assert sim.decode(1, 4000, 100).seconds > sim.decode(1, 500, 100).seconds


def test_decode_scales_linearly_in_output_tokens(sim):
    d1 = sim.decode(1, 1000, 50)
    d2 = sim.decode(1, 1000, 100)
    assert d2.seconds / d1.seconds == pytest.approx(2.0, rel=0.05)
    assert d2.energy_j / d1.energy_j == pytest.approx(2.0, rel=0.05)


def test_orchestration_adds_per_step_latency():
    d0 = make_sim(orchestration_s=0.0).decode(1, 1000, 100).seconds
    d1 = make_sim(orchestration_s=0.05).decode(1, 1000, 100).seconds
    assert d1 - d0 == pytest.approx(0.05 * 100, rel=1e-6)


def test_quantization_speeds_up_decode():
    """W4 weights stream 4x fewer bytes -> faster memory-bound decode."""
    s16 = make_sim(weight_bits=16)
    s4 = make_sim(weight_bits=4)
    assert s4.decode(1, 1000, 100).seconds < s16.decode(1, 1000, 100).seconds


def test_batching_improves_tokens_per_second():
    """§1.2: batching balances bandwidth and compute."""
    cfg70 = registry.get_config("llama2-70b")
    r1 = LLMSimulator(cfg70, HW.pim_engine(), SimConfig()).generate(
        1, 100, 20)
    r8 = LLMSimulator(cfg70, HW.pim_engine(), SimConfig()).generate(
        8, 100, 20)
    assert r8["tokens_per_s"] > 4 * r1["tokens_per_s"]


def test_tp_collective_charged_per_layer():
    e1 = make_sim(tp_degree=1).encode(1, 1000)
    e2 = make_sim(hw=HW.pim_engine(), tp_degree=128).encode(1, 1000)
    assert e2.host_bytes > e1.host_bytes


def test_generate_metric_consistency(sim):
    r = sim.generate(1, 1000, 100)
    assert r["qps"] == pytest.approx(
        1.0 / (r["encode"].seconds + r["decode"].seconds))
    assert r["tokens_per_s"] == pytest.approx(100 / r["decode"].seconds)
    assert r["energy_per_query_j"] == pytest.approx(
        r["encode"].energy_j + r["decode"].energy_j)


def test_profile_scaling_preserves_energies():
    p = HW.PIM_AI_CHIP.scaled(16)
    assert p.tops == pytest.approx(16 * HW.PIM_AI_CHIP.tops)
    assert p.mem_pj_per_bit == HW.PIM_AI_CHIP.mem_pj_per_bit
    assert p.pj_per_op == HW.PIM_AI_CHIP.pj_per_op


def test_engine_count_per_8u():
    assert HW.ENGINES_PER_8U == 12  # 4 servers x 24 DIMMs / 8 per engine


def test_decode_trace_rekeyed_by_batch_and_len():
    """The decode trace is memoized per (batch, max_len): a reused
    simulator never returns one call's op stream for another batch size
    or sequence length."""
    sim = make_sim()
    ops_small = sim._decode_ops_linear(1, 256)
    ops_big = sim._decode_ops_linear(8, 1024)
    assert ops_small is not ops_big
    f1 = sum(o.at(128).flops for o in ops_small)
    f8 = sum(o.at(128).flops for o in ops_big)
    assert f8 > 4 * f1  # 8x batch must multiply the decode work
    assert sim.decode(8, 128, 4).seconds > sim.decode(1, 128, 4).seconds


def test_ragged_serve_single_dispatch():
    """The simulated cloud path charges one ragged dispatch per step and
    is keyed separately from the aligned trace."""
    sim = make_sim()
    r = sim.serve([64, 128, 256, 32], 16)
    assert r["decode_dispatches"] == 16
    assert r["tokens_per_s"] > 0 and r["energy_per_token_j"] > 0
    assert any(k[2] for k in sim._decode_linear)  # ragged trace cached
    sim.decode(4, 120, 16)
    keys = set(sim._decode_linear)
    assert (4, 136, True, "contiguous", 16) in keys
    assert (4, 136, False, "contiguous", 16) in keys


def test_simulator_aliases_pricer_memos():
    """The simulator's traced streams ARE the pricer's (tests/
    test_costmodel.py): serve() costs come from the engine's dispatch
    functions."""
    sim = LLMSimulator(registry.get_smoke_config("qwen1.5-0.5b"),
                       HW.PIM_AI_MOBILE)
    assert sim._decode_linear is sim.pricer.decode_linear
    assert sim._prefill_cache is sim.pricer.prefill_cache
    assert sim._chunk_cache is sim.pricer.chunk_cache
    assert sim._verify_linear is sim.pricer.verify_linear
    sim.serve([16, 24], 4)
    assert any(k[2] for k in sim.pricer.decode_linear)  # ragged traced
    # one pricer per config: a simulator of it on other hardware reuses
    # every stream traced so far
    other = LLMSimulator(sim.cfg, HW.DGX_H100, SimConfig(tp_degree=8))
    assert other.pricer is sim.pricer is S.pricer_of(sim.cfg)


# ---------------------------------------------------------------------------
# every serve mode: the reference's schedule and accounting
# ---------------------------------------------------------------------------

SMOKE = "qwen1.5-0.5b"
LENS = [6, 11, 17, 33]
# schedule and accounting keys: exact against the reference
EXACT = ("decode_dispatches", "prefill_chunks", "steps", "kv_cache",
         "scheduler", "resident_kv_bytes", "contiguous_kv_bytes",
         "draft_kv_bytes", "draft_dispatches", "accepted_tokens_per_step",
         "acceptance", "spec_gamma", "kv_transfer_bytes", "cluster", "mesh",
         "mesh_devices", "kv_partitions", "resident_kv_bytes_per_device")
MODES = {
    "blocking": dict(max_seq_len=96),
    "paged": dict(kv_cache="paged", kv_block_size=16, max_seq_len=96),
    "chunked": dict(scheduler="chunked", chunk_tokens=16),
    "chunked-paged": dict(scheduler="chunked", chunk_tokens=16,
                          kv_cache="paged", kv_block_size=8),
    "speculative": dict(scheduler="speculative", gamma=3, acceptance=0.7),
    "speculative-paged": dict(scheduler="speculative", gamma=2,
                              kv_cache="paged", draft_layers=1),
    "mesh": dict(mesh=(2, 2), kv_cache="paged"),
    "mesh-contiguous": dict(mesh=(1, 2)),
    "cluster": dict(cluster=(1, 2)),
    "cluster-paged": dict(cluster=(2, 3), kv_cache="paged"),
}


@pytest.fixture(scope="module")
def smoke_sims():
    cfg = registry.get_smoke_config(SMOKE)
    jcfg = jreg.get_smoke_config(SMOKE)
    return (LLMSimulator(cfg, HW.PIM_AI_CHIP, SimConfig()),
            JS.LLMSimulator(jcfg, JHW.PIM_AI_CHIP, JS.SimConfig()))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_mode_schedule_equals_reference(smoke_sims, mode):
    """Each non-trace ``serve`` mode returns the reference's keys, the
    same schedule and KV accounting, and finite positive prices."""
    sim, jsim = smoke_sims
    got = sim.serve(LENS, 8, **MODES[mode])
    want = jsim.serve(LENS, 8, **MODES[mode])
    assert set(got) == set(want)
    for k in EXACT:
        if k in want:
            assert got[k] == want[k], k
    assert len(got["ttft_per_req_s"]) == len(LENS)
    for k in ("tokens_per_s", "energy_per_token_j", "qps", "ttft_s"):
        assert np.isfinite(got[k]) and got[k] > 0, k


def test_serve_refusals_equal_reference(smoke_sims):
    sim, jsim = smoke_sims
    for kw, exc in ((dict(cluster=(1, 2), scheduler="chunked"), ValueError),
                    (dict(mesh=(0, 2)), ValueError),
                    (dict(mesh=(1, 2), cluster=(1, 1)), ValueError),
                    (dict(cluster=(0, 2)), ValueError)):
        for s in (sim, jsim):
            with pytest.raises(exc):
                s.serve(LENS, 4, **kw)
    for s in (sim, jsim):
        with pytest.raises(TypeError):
            s.serve(None, 4)


def test_unsupported_family_falls_back_with_warning():
    """A family the chunked / speculative policies cannot express is
    simulated on the blocking schedule, with the reference's warning
    and its degenerate speculative keys."""
    cfg = registry.get_smoke_config("zamba2-2.7b")
    sim = LLMSimulator(cfg, HW.PIM_AI_CHIP, SimConfig())
    with pytest.warns(UserWarning, match="unsupported"):
        r = sim.serve([8, 12], 4, scheduler="speculative")
    assert r["scheduler"] == "blocking" and r["draft_dispatches"] == 0


def test_draft_cfg_clamps_as_reference():
    for name in ("qwen1.5-0.5b", "deepseek-moe-16b"):
        sim = LLMSimulator(registry.get_smoke_config(name), HW.PIM_AI_CHIP)
        jsim = JS.LLMSimulator(jreg.get_smoke_config(name), JHW.PIM_AI_CHIP)
        for k in (0, 1, 2, 99):
            a, b = sim._draft_cfg(k), jsim._draft_cfg(k)
            assert (a.n_layers, a.first_dense_layers) == (
                b.n_layers, b.first_dense_layers)


# ---------------------------------------------------------------------------
# the examples' simulator parts
# ---------------------------------------------------------------------------

def test_example_quickstart_simulates(capsys):
    import torch_quickstart
    rows = torch_quickstart.mobile_rows()
    assert [r[0] for r in rows] == ["pim-ai-mobile", "a17-pro",
                                    "snapdragon-8-gen3", "dimensity-9300"]
    assert all(np.isfinite(v) and v > 0 for r in rows for v in r[1:])
    torch_quickstart.main()
    out = capsys.readouterr().out
    assert "3-yr TCO per QPS" in out and "a17-pro" in out


def test_example_simulate_hardware_sweeps(capsys):
    import torch_simulate_hardware
    torch_simulate_hardware.main()
    out = capsys.readouterr().out
    assert "NPU encode + PIM decode" in out
    tops = torch_simulate_hardware.tops_sweep()
    # TTFT falls with TOPS; decode is bandwidth-bound
    assert [r[1] for r in tops] == sorted((r[1] for r in tops),
                                          reverse=True)


def test_example_serve_batched_simulator_part(capsys):
    import torch_serve_batched
    rows = torch_serve_batched.analytical_serve([5, 23, 6, 7])
    assert len(rows) == 4
    for kv, hw, r in rows:
        assert r["tokens_per_s"] > 0 and r["energy_per_token_j"] > 0
        if kv == "paged":
            assert r["resident_kv_bytes"] < r["contiguous_kv_bytes"]
    assert "resident KV" in capsys.readouterr().out


def test_example_w4_mobile_decode_simulator_part(capsys):
    import torch_w4_mobile_decode
    r = torch_w4_mobile_decode.simulate()
    assert set(r) == {16, 4}
    assert r[4]["tokens_per_s"] > r[16]["tokens_per_s"]
    assert r[4]["energy_per_token_j"] < r[16]["energy_per_token_j"]
    assert "W 4" in capsys.readouterr().out
