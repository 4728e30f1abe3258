"""The paper's quantitative claims (Fig 4, Fig 5, §5.1) on the port's
scenarios (``repro_torch.core.scenarios``), with the bands of
``tests/test_paper_claims.py`` unchanged, and each system's figures
against the reference's scenarios in pinned bands, each with its cause.

The port's simulator prices what the port's tracer records of the
engine's own functions; three differences from the reference's stream
move the per-system figures, and the bands below name which:

- GQA decode: the port's K1 / K2 records charge the KV history they
  stream; the reference's CPU trace prices a GQA decode's score product
  as a weightless (G-row) GEMM and charges it no bytes. The port's
  decode bytes are the reference's plus the closed form
  ``kv_bytes_per_token * batch * mean length * n_out``.
- prefill attention: K3's cost() counts the causal triangle of the
  score products (priced as compute only), where the reference's plain
  blocked attention at S = 1000 is one query chunk and counts the whole
  S x S square; and the reference charges that plain attention's gather
  of the visible KV blocks (``k_blocks[:, visible]``, one K- and one
  V-sized record per layer) as memory traffic. Encode energy comes out
  lower on the port: within 2% in the cloud cells, where the weight
  streams dominate, 7-9% in the mobile cells.
- everything else (weights, MHA decode, host transfers, collectives)
  agrees within 2%.

All figures are model outputs of the profiles in ``core/profiles.py``.
"""
from __future__ import annotations

import pytest

from repro.configs import registry as jreg
from repro.configs.paper_models import mha_variant as jmha
from repro.core import profiles as JHW
from repro.core import scenarios as JSC
from repro.core import simulator as JS
from repro_torch.configs import registry
from repro_torch.configs.paper_models import mha_variant
from repro_torch.core import profiles as HW
from repro_torch.core import scenarios as SC
from repro_torch.core import simulator as S
from repro_torch.core.metrics import battery_queries
from repro_torch.core.scenarios import run_cloud, run_mobile
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.serving.kv_cache import kv_bytes_per_token

CLOUD = [(m, a) for m in ("llama2-70b", "mixtral-8x22b")
         for a in ("gqa", "mha")]
MOBILE = ("llama2-7b", "mistral-7b")


@pytest.fixture(scope="module")
def cloud():
    return {k: run_cloud(*k) for k in CLOUD}


@pytest.fixture(scope="module")
def mobile():
    return {m: run_mobile(m) for m in MOBILE}


def _ref_cloud(model, attn):
    """The reference's per-system generate() of ``run_cloud``."""
    cfg = jreg.get_config(model)
    if attn == "mha":
        cfg = jmha(cfg)
    b_h100, b_pim = JSC.CLOUD_BATCH[(model, attn)]
    h100 = JS.LLMSimulator(cfg, JHW.DGX_H100, JS.SimConfig(
        orchestration_s=JSC.CLOUD_ORCHESTRATION_S, tp_degree=8))
    pim = JS.LLMSimulator(cfg, JHW.pim_engine(), JS.SimConfig(
        orchestration_s=JSC.CLOUD_ORCHESTRATION_S,
        tp_degree=JHW.DIMMS_PER_ENGINE * JHW.CHIPS_PER_DIMM))
    return {"dgx-h100": (h100, h100.generate(b_h100, 1000, 100), b_h100),
            "pim-ai-engine": (pim, pim.generate(b_pim, 1000, 100), b_pim)}


def _ref_mobile(model):
    cfg = jreg.get_config(model)
    out = {}
    for hw in JSC.MOBILE_PROFILES:
        sim = JS.LLMSimulator(cfg, hw, JS.SimConfig(
            weight_bits=4, act_bits=16,
            orchestration_s=JSC.MOBILE_ORCHESTRATION_S))
        out[hw.name] = (sim, sim.generate(1, 1000, 100), 1)
    return out


@pytest.fixture(scope="module")
def reference():
    """(cell, system) -> (reference simulator, its generate(), batch)."""
    out = {}
    for k in CLOUD:
        for name, v in _ref_cloud(*k).items():
            out[k, name] = v
    for m in MOBILE:
        for name, v in _ref_mobile(m).items():
            out[(m, "mobile"), name] = v
    return out


def _systems(cloud, mobile):
    """(cell, system, the port's config, its generate()) of every cell."""
    rows = []
    for (m, a), r in cloud.items():
        cfg = registry.get_config(m)
        cfg = mha_variant(cfg) if a == "mha" else cfg
        for name, raw in r["raw"].items():
            rows.append(((m, a), name, cfg, raw))
    for m, r in mobile.items():
        for name, raw in r["raw"].items():
            rows.append(((m, "mobile"), name, registry.get_config(m), raw))
    return rows


def _gqa(cfg) -> bool:
    return cfg.n_kv_heads < cfg.n_heads


# ---------------------------------------------------------------------------
# Table 1 / §2 composition
# ---------------------------------------------------------------------------

def test_table1_server_composition():
    """24 DIMMs x 16 chips reproduces the Table-1 server row exactly."""
    for got, want in HW.check_composition().values():
        assert abs(got - want) < 1e-6


def test_dimm_aggregates():
    """§2.2: one DIMM = 32GB, 1.6 TB/s, 128 TFLOPs."""
    d = HW.pim_dimm()
    assert abs(d.mem_bw_gbs - 1638.4) < 1e-6
    assert abs(d.tops - 128) < 1e-6


# ---------------------------------------------------------------------------
# Fig 4 — cloud (the reference's bands)
# ---------------------------------------------------------------------------

def test_cloud_ttft_gqa_about_3x(cloud):
    """§4.1.1: GQA first-token latency ~3x the DGX-H100."""
    for m in ("llama2-70b", "mixtral-8x22b"):
        assert 2.4 <= cloud[(m, "gqa")]["ratios"]["ttft"] <= 3.3


def test_cloud_ttft_mha_about_75pct_longer(cloud):
    """§4.1.1: MHA first-token latency ~1.75x the DGX-H100."""
    for m in ("llama2-70b", "mixtral-8x22b"):
        assert 1.3 <= cloud[(m, "mha")]["ratios"]["ttft"] <= 2.1


def test_cloud_decode_tokens_per_s_band(cloud):
    """§4.1.2: 2.23x-2.75x more tokens/s (paper band; +-25% tol)."""
    for k, r in cloud.items():
        assert 2.23 * 0.75 <= r["ratios"]["tokens_per_s"] <= 2.75 * 1.25, k


def test_cloud_decode_energy_per_token(cloud):
    """§4.1.2: 15-40% less energy per token (ratio 1.18-1.67; +25% tol
    above)."""
    for k, r in cloud.items():
        assert 1.18 <= r["ratios"]["energy_per_token"] <= 1.67 * 1.25, k


def test_cloud_qps_advantage(cloud):
    """§4.1.3: PIM processes more queries/s: the direction + ceiling."""
    ratios = [r["ratios"]["qps"] for r in cloud.values()]
    avg = sum(ratios) / len(ratios)
    assert all(x > 1.4 for x in ratios)
    assert 1.5 <= avg <= 2.2


def test_cloud_energy_per_query_equivalent(cloud):
    """§4.1.3: 'consuming equivalent energy per query'."""
    for k, r in cloud.items():
        assert 0.85 <= r["ratios"]["energy_per_query"] <= 1.35, k


def test_cloud_tco_band(cloud):
    """§5.1/abstract: TCO/QPS up to 6.94x better (6.2-6.94; +15% tol)."""
    ratios = [r["ratios"]["tco_per_qps"] for r in cloud.values()]
    assert all(6.2 * 0.9 <= x <= 6.94 * 1.15 for x in ratios), ratios


# ---------------------------------------------------------------------------
# Fig 5 — mobile (the reference's bands)
# ---------------------------------------------------------------------------

def test_mobile_ttft_similar(mobile):
    """§4.2.1: all profiles achieve similar first-token latency."""
    for r in mobile.values():
        tt = [m.ttft_s for m in r["profiles"].values()]
        assert max(tt) / min(tt) < 1.4, tt


def test_mobile_encode_energy_savings():
    """§4.2.1: encode energy savings ~28.5% (A17), ~16.4%/15.3%
    (Snapdragon/Dimensity) — +-7pp tolerance."""
    cfg = registry.get_config("llama2-7b")
    enc = {}
    for hw in SC.MOBILE_PROFILES:
        sim = LLMSimulator(cfg, hw, SimConfig(
            weight_bits=4, act_bits=16,
            orchestration_s=SC.MOBILE_ORCHESTRATION_S))
        enc[hw.name] = sim.encode(1, 1000).energy_j
    pim = enc[SC.MOBILE_PROFILES[0].name]
    saving = {k: 1 - pim / v for k, v in enc.items()
              if not k.startswith("pim")}
    assert abs(saving["a17-pro"] - 0.285) < 0.07, saving
    assert abs(saving["snapdragon-8-gen3"] - 0.164) < 0.07, saving
    assert abs(saving["dimensity-9300"] - 0.153) < 0.07, saving


def test_kernel_branch_for_every_kernel_misses_the_encode_band(
        monkeypatch):
    """Why the kernel-record table prices K5 as a normalization and K3 as
    attention scores: under the reference's kernel branch (their cost()
    bytes charged as memory) the a17-pro and snapdragon savings leave
    §4.2.1's bands."""
    monkeypatch.setattr(S, "KERNEL_RULES",
                        dict.fromkeys(S.KERNEL_RULES, "stream"))
    cfg = registry.get_config("llama2-7b")
    enc = {hw.name: LLMSimulator(cfg, hw, SimConfig(
        weight_bits=4, orchestration_s=SC.MOBILE_ORCHESTRATION_S)).encode(
            1, 1000).energy_j for hw in SC.MOBILE_PROFILES}
    saving = {k: 1 - enc["pim-ai-mobile"] / v for k, v in enc.items()}
    assert saving["a17-pro"] - 0.285 > 0.07, saving
    assert saving["snapdragon-8-gen3"] - 0.164 > 0.07, saving


def test_mobile_tokens_per_s(mobile):
    """§4.2.2: +49.6% vs A17 Pro, +24.5%/+24.7% vs the others."""
    for r in mobile.values():
        ra = r["ratios"]
        assert 1.40 <= ra["a17-pro"]["tokens_per_s"] <= 1.60
        assert 1.18 <= ra["snapdragon-8-gen3"]["tokens_per_s"] <= 1.35
        assert 1.18 <= ra["dimensity-9300"]["tokens_per_s"] <= 1.35


def test_mobile_energy_per_token_10_to_20x(mobile):
    """Abstract/§4.2.2: 20x less energy/token vs A17, 10x vs others."""
    for r in mobile.values():
        ra = r["ratios"]
        assert 17.0 <= ra["a17-pro"]["energy_per_token"] <= 22.0
        assert 8.5 <= ra["snapdragon-8-gen3"]["energy_per_token"] <= 11.5
        assert 8.5 <= ra["dimensity-9300"]["energy_per_token"] <= 11.5


def test_mobile_qps_25_to_45pct(mobile):
    """§4.2.3/abstract: ~45% more QPS than A17, ~25% more than others."""
    for r in mobile.values():
        ra = r["ratios"]
        assert 1.35 <= ra["a17-pro"]["qps"] <= 1.55
        assert 1.18 <= ra["snapdragon-8-gen3"]["qps"] <= 1.35
        assert 1.18 <= ra["dimensity-9300"]["qps"] <= 1.35


def test_mobile_energy_per_query_band(mobile):
    """§4.2.3: 13.4x less energy than A17, 6.9x than others (+-10%)."""
    for r in mobile.values():
        ra = r["ratios"]
        assert 11.5 <= ra["a17-pro"]["energy_per_query"] <= 14.8
        assert 6.0 <= ra["snapdragon-8-gen3"]["energy_per_query"] <= 7.6
        assert 6.0 <= ra["dimensity-9300"]["energy_per_query"] <= 7.6


def test_mobile_1000_token_epq_band():
    """§5.1: at 1000 output tokens the EPQ ratios rise to 9.8-19.5x."""
    ra = run_mobile("llama2-7b", 1000, 1000)["ratios"]
    assert 17.5 <= ra["a17-pro"]["energy_per_query"] <= 20.5
    assert 9.0 <= ra["snapdragon-8-gen3"]["energy_per_query"] <= 10.8


def test_mobile_battery_life_scales_with_epq(mobile):
    """§5.1: 6.9-13.4x more inferences per charge == the EPQ ratio."""
    r = mobile["llama2-7b"]
    pim_name = [k for k in r["profiles"] if k.startswith("pim")][0]
    pim = r["profiles"][pim_name]
    a17 = r["profiles"]["a17-pro"]
    ratio = (battery_queries(15.0, pim.energy_per_query_j)
             / battery_queries(15.0, a17.energy_per_query_j))
    assert abs(ratio - r["ratios"]["a17-pro"]["energy_per_query"]) < 1e-9


def test_cloud_advantage_grows_with_output_len(cloud):
    """§5.1: at 1000/1000 the PIM advantage is larger than at 1000/100."""
    r_long = run_cloud("llama2-70b", "gqa", 1000, 1000)
    r_short = cloud[("llama2-70b", "gqa")]
    assert r_long["ratios"]["qps"] > r_short["ratios"]["qps"]
    assert (r_long["ratios"]["energy_per_query"]
            > r_short["ratios"]["energy_per_query"])


# ---------------------------------------------------------------------------
# each system against the reference's, in pinned bands
# ---------------------------------------------------------------------------

def test_ttft_within_4pct_of_reference(cloud, mobile, reference):
    """Every cell: TTFT 0.96-1.0x the reference's (0.968-0.989 here) —
    prefill is weight- or compute-bound, and the port's K3 counts the
    causal half of the score products the reference counts whole."""
    for cell, name, _, raw in _systems(cloud, mobile):
        want = reference[cell, name][1]["ttft_s"]
        assert 0.96 <= raw["ttft_s"] / want <= 1.0, (cell, name)


def test_mha_decode_within_2pct_of_reference(cloud, mobile, reference):
    """MHA cells: decode bytes, tokens/s and energy/token within 2% —
    the reference's trace and the port's both stream the whole KV
    history when there is one query row per head."""
    n = 0
    for cell, name, cfg, raw in _systems(cloud, mobile):
        if _gqa(cfg):
            continue
        want = reference[cell, name][1]
        for got, ref in ((raw["decode"].mem_bytes, want["decode"].mem_bytes),
                         (raw["tokens_per_s"], want["tokens_per_s"]),
                         (raw["energy_per_token_j"],
                          want["energy_per_token_j"])):
            assert got == pytest.approx(ref, rel=0.02), (cell, name)
        n += 1
    assert n == 8    # 2 models x 2 systems + llama2-7b on 4 profiles


def test_gqa_decode_adds_the_closed_form_kv_reads(cloud, mobile, reference):
    """GQA cells: the port's decode bytes are the reference's plus the
    KV history the K1 records stream and the reference's CPU trace does
    not charge (its G-row score product is a weightless GEMM):
    kv_bytes_per_token x batch x mean length x n_out, within 2%."""
    n = 0
    for cell, name, cfg, raw in _systems(cloud, mobile):
        if not _gqa(cfg):
            continue
        _, want, batch = reference[cell, name]
        kv = kv_bytes_per_token(cfg) * batch * (1000 + 99 / 2) * 100
        assert raw["decode"].mem_bytes == pytest.approx(
            want["decode"].mem_bytes + kv, rel=0.02), (cell, name)
        assert raw["decode"].mem_bytes > want["decode"].mem_bytes + 0.9 * kv
        n += 1
    assert n == 8    # 2 models x 2 systems + mistral-7b on 4 profiles


def test_cloud_encode_energy_within_2pct(cloud, reference):
    """Cloud cells: encode energy 0.98-1.0x the reference's (0.986-0.992
    here): batch x 1000 tokens stream the weights once, and the score
    products and KV-block gathers (below) are a small share."""
    for cell, name, _, raw in _systems(cloud, {}):
        want = reference[cell, name][1]["encode"].energy_j
        assert 0.98 <= raw["encode"].energy_j / want <= 1.0, (cell, name)


def _attention_split(sim, mod, ops_):
    """(energy of the prefill's attention score products, energy of its
    gathers) of one traced prefill, priced by ``mod._op_cost``."""
    scores = gathers = 0.0
    for op in ops_:
        e = mod._op_cost(op, sim.hw, sim.sim).energy_j
        if op.kind == "kernel" and op.kernel == "flash_attention":
            scores += e
        elif (op.kind == "gemm" and op.weight_bytes == 0
              and op.batch_dims >= 2):
            scores += e
        elif op.kind == "data" and op.prim in ("gather", "index"):
            gathers += e
    return scores, gathers


def test_mobile_encode_energy_band_and_its_cause(mobile, reference):
    """Mobile cells: encode energy 0.90-0.94x the reference's (0.910 on
    a17-pro to 0.932 on pim-ai-mobile here). Batch 1 streams W4 weights
    once, so the attention's share is large, and its two differences
    account for the gap: the reference's score products count the whole
    1000 x 1000 square where K3 counts the causal triangle, and the
    reference charges its plain attention's KV-block gathers as memory.
    Taking both out of the reference leaves it within 1% of the port."""
    for m in MOBILE:
        cfg = registry.get_config(m)
        for hw in SC.MOBILE_PROFILES:
            raw = mobile[m]["raw"][hw.name]
            jsim, want, _ = reference[(m, "mobile"), hw.name]
            ratio = raw["encode"].energy_j / want["encode"].energy_j
            assert 0.90 <= ratio <= 0.94, (m, hw.name, ratio)
            sim = LLMSimulator(cfg, hw, SimConfig(
                weight_bits=4, act_bits=16,
                orchestration_s=SC.MOBILE_ORCHESTRATION_S))
            s_port, g_port = _attention_split(sim, S,
                                              sim._prefill_ops(1, 1000))
            s_ref, g_ref = _attention_split(jsim, JS,
                                            jsim._prefill_ops(1, 1000))
            assert s_ref == pytest.approx(2 * s_port, rel=0.01)
            explained = (want["encode"].energy_j - (s_ref - s_port)
                         - (g_ref - g_port))
            assert raw["encode"].energy_j == pytest.approx(explained,
                                                           rel=0.01)


def main() -> None:
    """Print each system's figures over the reference's (the ratios the
    bands above hold): ``PYTHONPATH=src python
    tests/test_torch_paper_claims.py``. Model outputs, not
    measurements."""
    cloud = {k: run_cloud(*k) for k in CLOUD}
    mobile = {m: run_mobile(m) for m in MOBILE}
    ref = {}
    for k in CLOUD:
        for name, v in _ref_cloud(*k).items():
            ref[k, name] = v
    for m in MOBILE:
        for name, v in _ref_mobile(m).items():
            ref[(m, "mobile"), name] = v
    print("cell system: port / reference — TTFT, tok/s, J/token, encode J, "
          "decode bytes; GQA: (reference + closed-form KV) / port")
    for cell, name, cfg, raw in _systems(cloud, mobile):
        _, want, batch = ref[cell, name]
        got_b, want_b = raw["decode"].mem_bytes, want["decode"].mem_bytes
        line = " ".join(f"{x:.4f}" for x in (
            raw["ttft_s"] / want["ttft_s"],
            raw["tokens_per_s"] / want["tokens_per_s"],
            raw["energy_per_token_j"] / want["energy_per_token_j"],
            raw["encode"].energy_j / want["encode"].energy_j,
            got_b / want_b))
        if _gqa(cfg):
            kv = kv_bytes_per_token(cfg) * batch * (1000 + 99 / 2) * 100
            line += (f"; {(want_b + kv) / got_b:.4f} (+"
                     f"{(got_b - want_b) / 1e12:.3f} TB, closed form "
                     f"{kv / 1e12:.3f} TB)")
        print(f"{cell[0]} {cell[1]} {name}: {line}")
    for (m, a), r in cloud.items():
        want = JSC.run_cloud(m, a)["ratios"]["tco_per_qps"]
        print(f"{m} {a} TCO per QPS: port {r['ratios']['tco_per_qps']:.4f}, "
              f"reference {want:.4f}")


if __name__ == "__main__":
    main()
