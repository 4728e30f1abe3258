"""Target deployment scenarios (paper §3.3–3.4, §4).

Counterpart of ``repro/core/scenarios.py``, on the port's simulator.

Cloud: Llama2-70B / Mixtral-8x22B in bf16 on (a) one DGX-H100 (8 GPUs,
TP=8) and (b) four PIM-AI 2U servers = 96 PIM DIMMs = 12 independent
8-DIMM inference engines, each running one model copy. Batch sizes per
the paper's §4.1. Both GQA=8 and MHA variants.

Mobile: Llama2-7B / Mistral-7B, W4A16 (4-bit weights, 16-bit KV +
activations), batch 1, on the PIM-AI chip vs A17 Pro / Snapdragon 8
Gen 3 / Dimensity 9300. Host orchestration "tens of milliseconds"
(§3.3) — the one calibrated free parameter.

The standard experimental setup is 1000 input tokens, 100 output tokens
(§3.4); §5.1 additionally evaluates 1000/1000.
"""
from __future__ import annotations

from repro_torch.configs import registry
from repro_torch.configs.paper_models import mha_variant
from repro_torch.core import profiles as HW
from repro_torch.core.metrics import QueryMetrics, tco_3yr
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.serving.kv_cache import kv_bytes_per_token
from repro_torch.serving.workload import (TenantSpec, make_named_trace,
                                          make_trace)

# paper §4.1 batch sizes: (DGX-H100, PIM-AI per engine)
CLOUD_BATCH = {
    ("llama2-70b", "gqa"): (200, 80),
    ("llama2-70b", "mha"): (46, 10),
    ("mixtral-8x22b", "gqa"): (200, 80),
    ("mixtral-8x22b", "mha"): (88, 20),
}

CLOUD_ORCHESTRATION_S = 0.5e-3   # "sub-millisecond" host
MOBILE_ORCHESTRATION_S = 90e-3   # "tens of milliseconds" host service
                                 # period (calibrated once)

N_IN_DEFAULT, N_OUT_DEFAULT = 1000, 100


def _metrics(result: dict) -> QueryMetrics:
    return QueryMetrics(
        ttft_s=result["ttft_s"],
        tokens_per_s=result["tokens_per_s"],
        energy_per_token_j=result["energy_per_token_j"],
        qps=result["qps"],
        energy_per_query_j=result["energy_per_query_j"],
    )


def run_cloud(model: str = "llama2-70b", attn: str = "gqa",
              n_in: int = N_IN_DEFAULT, n_out: int = N_OUT_DEFAULT) -> dict:
    """One DGX-H100 vs four PIM-AI servers (12 engines). Returns per-system
    QueryMetrics + raw phase results (``"raw"``: each system's
    ``generate()``)."""
    cfg = registry.get_config(model)
    if attn == "mha":
        cfg = mha_variant(cfg)
    b_h100, b_pim = CLOUD_BATCH[(model, attn)]

    h100 = LLMSimulator(
        cfg, HW.DGX_H100,
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S, tp_degree=8))
    r_h100 = h100.generate(b_h100, n_in, n_out)

    engine = LLMSimulator(
        cfg, HW.pim_engine(),
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S,
                  tp_degree=HW.DIMMS_PER_ENGINE * HW.CHIPS_PER_DIMM))
    r_eng = engine.generate(b_pim, n_in, n_out)
    n_eng = HW.ENGINES_PER_8U  # 12 engines in 4 servers

    m_h100 = _metrics(r_h100)
    m_pim = _metrics(r_eng)
    # engines are independent: throughput scales, latency doesn't
    m_pim.tokens_per_s *= n_eng
    m_pim.qps *= n_eng

    tco_h100 = tco_3yr(HW.DGX_H100.cost_usd, m_h100.qps,
                       m_h100.energy_per_query_j)
    tco_pim = tco_3yr(HW.PIM_AI_SERVER.cost_usd * HW.SERVERS_PER_8U,
                      m_pim.qps, m_pim.energy_per_query_j)
    return {
        "model": model, "attn": attn, "n_in": n_in, "n_out": n_out,
        "batch": {"dgx-h100": b_h100, "pim-ai": b_pim},
        "dgx-h100": m_h100, "pim-ai-4srv": m_pim,
        # each system's generate(): one DGX-H100, one PIM engine
        "raw": {"dgx-h100": r_h100, "pim-ai-engine": r_eng},
        "tco": {"dgx-h100": tco_h100, "pim-ai-4srv": tco_pim},
        "ratios": {
            "ttft": m_pim.ttft_s / m_h100.ttft_s,
            "tokens_per_s": m_pim.tokens_per_s / m_h100.tokens_per_s,
            "energy_per_token": (m_h100.energy_per_token_j
                                 / m_pim.energy_per_token_j),
            "qps": m_pim.qps / m_h100.qps,
            "energy_per_query": (m_h100.energy_per_query_j
                                 / m_pim.energy_per_query_j),
            "tco_per_qps": (tco_h100["tco_per_qps"]
                            / tco_pim["tco_per_qps"]),
        },
    }


def run_cloud_mesh(model: str = "llama2-70b", attn: str = "gqa",
                   n_out: int = N_OUT_DEFAULT,
                   meshes: tuple = ((1, 1), (1, 2), (1, 4), (2, 4)),
                   batch: int = 8) -> dict:
    """Mesh-shape sweep for one serving engine: how the (data, model)
    split of ``EngineConfig.mesh`` trades throughput against KV
    residency per device on PIM-AI chips.

    The model axis aggregates chip bandwidth behind one engine (the
    DIMM-stacking argument of §3.4) and pays the per-layer
    partial-result exchange; the data axis replicates weights per KV
    shard — so decode, weight-stream-bound, gains little from ``data``
    but scales with ``model`` until the interconnect term bites. That
    asymmetry is the quantitative reason the cloud layout stacks DIMMs
    under few engines instead of replicating engines per device."""
    cfg = registry.get_config(model)
    if attn == "mha":
        cfg = mha_variant(cfg)
    sim = LLMSimulator(
        cfg, HW.PIM_AI_CHIP,
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S))
    # ragged workload around the paper's 1000-in standard
    lens = [(N_IN_DEFAULT * (i % 4 + 1)) // 4 for i in range(batch)]
    rows = {}
    for mesh in meshes:
        r = sim.serve(lens, n_out, kv_cache="paged",
                      mesh=(None if mesh == (1, 1) else mesh))
        rows[mesh] = {
            "tokens_per_s": r["tokens_per_s"],
            "energy_per_token_j": r["energy_per_token_j"],
            "ttft_s": r["ttft_s"],
            "devices": int(mesh[0]) * int(mesh[1]),
            "kv_partitions": r.get("kv_partitions", 1),
            "resident_kv_bytes": r["resident_kv_bytes"],
            "resident_kv_bytes_per_device": r.get(
                "resident_kv_bytes_per_device", r["resident_kv_bytes"]),
        }
    base = rows[meshes[0]]
    return {
        "model": model, "attn": attn, "n_out": n_out, "batch": batch,
        "meshes": {str(k): v for k, v in rows.items()},
        "ratios": {str(k): {
            "tokens_per_s": v["tokens_per_s"] / base["tokens_per_s"],
            "tokens_per_s_per_device": (v["tokens_per_s"] / v["devices"])
            / base["tokens_per_s"],
            "energy_per_token": (v["energy_per_token_j"]
                                 / base["energy_per_token_j"]),
        } for k, v in rows.items()},
    }


def run_cloud_disaggregated(model: str = "llama2-70b", attn: str = "gqa",
                            n_in: int = N_IN_DEFAULT,
                            n_out: int = N_OUT_DEFAULT) -> dict:
    """Heterogeneous xPU+PIM disaggregation: prefill (compute-bound) on
    the DGX-H100 profile, decode (memory-bound) on PIM-AI engines, with
    each request's KV handed off once over the PIM server's DDR ingest
    interface — the HPIM-style phase split the paper's cloud thesis
    implies, with the Sangam-style KV-movement cost made explicit.

    Pipeline model: the xPU emits one prefilled batch every
    ``t_prefill + t_transfer`` seconds; one PIM engine takes
    ``t_decode`` seconds per batch, so ``k = t_decode / (t_prefill +
    t_transfer)`` engines (fractional — this is an analytical model)
    keep pace with one xPU and the steady-state system throughput is
    one batch per ``t_prefill + t_transfer``. TCO charges the xPU plus
    ``k`` engines' share of PIM-server capex.

    Returns QueryMetrics + TCO-per-QPS for the disaggregated system
    against *both* homogeneous baselines (all-H100 and all-PIM, from
    :func:`run_cloud`)."""
    cfg = registry.get_config(model)
    if attn == "mha":
        cfg = mha_variant(cfg)
    base = run_cloud(model, attn, n_in, n_out)
    _, b = CLOUD_BATCH[(model, attn)]  # handoff unit: the PIM-side batch

    h100 = LLMSimulator(
        cfg, HW.DGX_H100,
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S, tp_degree=8))
    pim = LLMSimulator(
        cfg, HW.pim_engine(),
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S,
                  tp_degree=HW.DIMMS_PER_ENGINE * HW.CHIPS_PER_DIMM))
    enc = h100.encode(b, n_in)
    dec = pim.decode(b, n_in, n_out)

    # per-batch KV handoff over the DDR ingest path (Table-1 PIM-server
    # host->device row): every prompt position's KV crosses once
    kv_bytes = b * n_in * kv_bytes_per_token(cfg)
    t_xfer = kv_bytes / (HW.PIM_AI_SERVER.h2d_bw_gbs * 1e9)
    e_xfer = kv_bytes * 8 * HW.PIM_AI_SERVER.h2d_pj_per_bit * 1e-12

    t_stage = enc.seconds + t_xfer          # xPU stage period
    k_engines = dec.seconds / t_stage       # engines fed by one xPU
    qps = b / t_stage                       # steady-state, pipelined
    engine_capex = (HW.PIM_AI_SERVER.cost_usd * HW.SERVERS_PER_8U
                    / HW.ENGINES_PER_8U)
    capex = HW.DGX_H100.cost_usd + k_engines * engine_capex
    m = QueryMetrics(
        ttft_s=enc.seconds,                 # first token samples on the xPU
        tokens_per_s=b * n_out / t_stage,   # decode tier keeps pace
        energy_per_token_j=dec.energy_j / (b * n_out),
        qps=qps,
        energy_per_query_j=(enc.energy_j + e_xfer + dec.energy_j) / b,
    )
    tco = tco_3yr(capex, m.qps, m.energy_per_query_j)
    tco_h100 = base["tco"]["dgx-h100"]
    tco_pim = base["tco"]["pim-ai-4srv"]
    return {
        "model": model, "attn": attn, "n_in": n_in, "n_out": n_out,
        "batch": b,
        "prefill": {"profile": HW.DGX_H100.name, "seconds": enc.seconds,
                    "energy_j": enc.energy_j},
        "decode": {"profile": pim.hw.name, "seconds": dec.seconds,
                   "energy_j": dec.energy_j},
        "kv_transfer": {"bytes": kv_bytes, "seconds": t_xfer,
                        "energy_j": e_xfer,
                        "interface_gbs": HW.PIM_AI_SERVER.h2d_bw_gbs},
        "engines_per_xpu": k_engines,
        "disaggregated": m,
        "dgx-h100": base["dgx-h100"],
        "pim-ai-4srv": base["pim-ai-4srv"],
        "tco": {"disaggregated": tco, "dgx-h100": tco_h100,
                "pim-ai-4srv": tco_pim},
        "ratios": {
            # > 1: disaggregation buys cheaper sustained QPS
            "tco_per_qps_vs_h100": (tco_h100["tco_per_qps"]
                                    / tco["tco_per_qps"]),
            "tco_per_qps_vs_pim": (tco_pim["tco_per_qps"]
                                   / tco["tco_per_qps"]),
            "energy_per_query_vs_h100": (
                base["dgx-h100"].energy_per_query_j / m.energy_per_query_j),
            "energy_per_query_vs_pim": (
                base["pim-ai-4srv"].energy_per_query_j
                / m.energy_per_query_j),
        },
    }


def run_cloud_trace(model: str = "llama2-70b", attn: str = "gqa",
                    trace: str = "diurnal", seed: int = 0,
                    max_batch: int = 8,
                    prefix_sweep: tuple = ()) -> dict:
    """Time-varying multi-tenant load priced end-to-end: the seeded
    named trace (diurnal swing by default) replayed through the
    simulator's schedule mirror on (a) one DGX-H100, (b) one PIM-AI
    engine — both under the SLO-aware scheduler — and (c) the
    disaggregated split (xPU prefill tier feeding PIM decode workers,
    autoscaler live). Unlike :func:`run_cloud`'s steady-state batch,
    QPS here is *sustained over the trace horizon*, so idle troughs and
    bursty peaks move TCO-per-QPS the way a real diurnal tenant mix
    does. The named traces are schedule-scale (smoke-length prompts),
    so the absolute numbers calibrate the *shape* of the comparison,
    not paper-scale magnitudes.

    ``prefix_sweep`` (e.g. ``(0, 16, 32, 48)``) adds the prefix-cache
    TCO story: for each shared-preamble length, a sharedprefix-style
    tenant mix runs on the PIM engine with the paged prefix cache
    enabled, and the returned ``"prefix_sweep"`` rows chart realized
    hit-rate -> TTFT -> TCO-per-QPS (longer shared preambles -> higher
    hit rate -> cheaper sustained QPS; every avoided prefill token is
    avoided xPU work *and* avoided KV ingest)."""
    cfg = registry.get_config(model)
    if attn == "mha":
        cfg = mha_variant(cfg)
    tr = make_named_trace(trace, vocab_size=cfg.vocab_size, seed=seed)

    xpu = LLMSimulator(
        cfg, HW.DGX_H100,
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S, tp_degree=8))
    pim = LLMSimulator(
        cfg, HW.pim_engine(),
        SimConfig(orchestration_s=CLOUD_ORCHESTRATION_S,
                  tp_degree=HW.DIMMS_PER_ENGINE * HW.CHIPS_PER_DIMM))

    r_xpu = xpu.serve(trace=tr, scheduler="slo", max_batch=max_batch)
    r_pim = pim.serve(trace=tr, scheduler="slo", max_batch=max_batch)
    n_pf, n_dec = 1, 3
    r_dis = pim.serve(trace=tr, cluster=(n_pf, n_dec), max_batch=max_batch,
                      prefill_sim=xpu,
                      cluster_opts={"autoscale": True,
                                    "autoscale_interval": 8,
                                    "prefill_rate": 2})

    engine_capex = (HW.PIM_AI_SERVER.cost_usd * HW.SERVERS_PER_8U
                    / HW.ENGINES_PER_8U)

    def _system(r: dict, capex: float) -> dict:
        n = len(r["requests"])
        qps = n / max(r["virtual_s"], 1e-12)    # sustained over horizon
        epq = r["energy_j"] / max(1, n)
        tco = tco_3yr(capex, qps, epq)
        return {
            "requests": n, "tokens": r["tokens"], "steps": r["steps"],
            "virtual_s": r["virtual_s"], "qps_sustained": qps,
            "energy_j": r["energy_j"],
            "energy_per_token_j": r["energy_per_token_j"],
            "energy_per_query_j": epq,
            "slo_attainment": r["summary"]["slo_attainment"],
            "preemptions": r["summary"]["preemptions"],
            "tco": tco, "tco_per_qps": tco["tco_per_qps"],
        }

    # disaggregated capex at the provisioned (initial) topology — the
    # autoscaler re-balances roles, it doesn't buy hardware
    sys_xpu = _system(r_xpu, HW.DGX_H100.cost_usd)
    sys_pim = _system(r_pim, engine_capex)
    sys_dis = _system(r_dis, HW.DGX_H100.cost_usd * n_pf
                      + engine_capex * n_dec)
    sys_dis["rescale_log"] = r_dis["rescale_log"]
    sys_dis["handoffs"] = r_dis["handoffs"]

    sweep_rows = []
    for plen in prefix_sweep:
        # constant total prompt length (56..64 tokens) at every point —
        # only the *shared share* of it moves, so realized hit rate is
        # the swept variable, not prompt size. A constrained pool
        # (kv_blocks=12 over max_batch slots) makes admission wait on
        # block capacity: warm requests charge only the uncached
        # suffix, admit sooner, and TTFT/TCO respond to the hit rate.
        plen = int(plen)
        tenants = (
            TenantSpec("assist", rate_rps=4.0,
                       prompt_len=(56 - plen, 64 - plen),
                       new_tokens=(4, 6), priority=1, prefix_len=plen),
            TenantSpec("rag", rate_rps=3.0,
                       prompt_len=(56 - plen, 64 - plen),
                       new_tokens=(4, 6), priority=0, prefix_len=plen),
            TenantSpec("adhoc", rate_rps=1.0, prompt_len=(10, 20),
                       new_tokens=(4, 6), priority=0))
        tr_p = make_trace(tenants, 2.0, vocab_size=cfg.vocab_size,
                          seed=seed, name=f"sharedprefix-{plen}")
        r = pim.serve(trace=tr_p, scheduler="slo", max_batch=max_batch,
                      kv_cache="paged", kv_block_size=16,
                      max_seq_len=96, kv_blocks=12, prefix_cache=True)
        row = _system(r, engine_capex)
        sweep_rows.append({
            "prefix_len": plen,
            "prefix_hit_rate": r["prefix_hit_rate"],
            "prefix_hits": r["prefix_hits"],
            "prefix_evictions": r["prefix_evictions"],
            "mean_ttft_s": r["summary"]["mean_ttft_s"],
            "ttft_p99_s": r["summary"]["ttft_p99_s"],
            "qps_sustained": row["qps_sustained"],
            "energy_per_token_j": row["energy_per_token_j"],
            "tco_per_qps": row["tco_per_qps"],
        })

    return {
        "model": model, "attn": attn, "trace": tr.schema(),
        "max_batch": max_batch,
        "dgx-h100": sys_xpu,
        "pim-ai-engine": sys_pim,
        "disaggregated": sys_dis,
        "prefix_sweep": sweep_rows,
        "ratios": {
            # > 1: PIM (or the split) wins on that axis over the trace
            "energy_per_token": (sys_xpu["energy_per_token_j"]
                                 / sys_pim["energy_per_token_j"]),
            "tco_per_qps_pim_vs_h100": (sys_xpu["tco_per_qps"]
                                        / sys_pim["tco_per_qps"]),
            "tco_per_qps_disagg_vs_h100": (sys_xpu["tco_per_qps"]
                                           / sys_dis["tco_per_qps"]),
        },
    }


MOBILE_PROFILES = (HW.PIM_AI_MOBILE, HW.A17_PRO, HW.SNAPDRAGON_8_GEN3,
                   HW.DIMENSITY_9300)


def run_mobile(model: str = "llama2-7b", n_in: int = N_IN_DEFAULT,
               n_out: int = N_OUT_DEFAULT) -> dict:
    """Batch-1 W4A16 single-user inference across mobile profiles
    (``"raw"``: each profile's ``generate()``)."""
    cfg = registry.get_config(model)
    out = {"model": model, "n_in": n_in, "n_out": n_out, "profiles": {},
           "raw": {}}
    for hw in MOBILE_PROFILES:
        sim = LLMSimulator(
            cfg, hw, SimConfig(weight_bits=4, act_bits=16,
                               orchestration_s=MOBILE_ORCHESTRATION_S))
        r = out["raw"][hw.name] = sim.generate(1, n_in, n_out)
        out["profiles"][hw.name] = _metrics(r)
    pim = out["profiles"][MOBILE_PROFILES[0].name]
    out["ratios"] = {}
    for hw in MOBILE_PROFILES[1:]:
        m = out["profiles"][hw.name]
        out["ratios"][hw.name] = {
            "tokens_per_s": pim.tokens_per_s / m.tokens_per_s,
            "energy_per_token": m.energy_per_token_j / pim.energy_per_token_j,
            "qps": pim.qps / m.qps,
            "energy_per_query": (m.energy_per_query_j
                                 / pim.energy_per_query_j),
        }
    return out
