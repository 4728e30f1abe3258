"""Quickstart: the PIM-AI simulator of the PyTorch port in five minutes.

Counterpart of ``examples/quickstart.py``. Reproduces the paper's
headline numbers from the public API:
 1. pick a model config (paper's Llama2-7B),
 2. pick hardware profiles (Table 1),
 3. simulate a 1000-in/100-out query per profile,
 4. print the mobile-scenario comparison (Fig 5) + the cloud TCO (§5.1).

The simulator traces the serving engine's own dispatch functions on
``meta`` tensors: no device is used, and every figure is a model output
of the profiles in ``repro_torch.core.profiles``, not a measurement.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.metrics import battery_queries
from repro_torch.core.scenarios import MOBILE_ORCHESTRATION_S, run_cloud
from repro_torch.core.simulator import LLMSimulator, SimConfig


def mobile_rows(n_in=1000, n_out=100):
    """(profile, TTFT s, tokens/s, J/token, queries per 15 Wh charge) of
    Llama2-7B W4A16 at batch 1 on each mobile profile."""
    cfg = registry.get_config("llama2-7b")
    rows = []
    for hw in (HW.PIM_AI_MOBILE, HW.A17_PRO, HW.SNAPDRAGON_8_GEN3,
               HW.DIMENSITY_9300):
        sim = LLMSimulator(cfg, hw, SimConfig(
            weight_bits=4, act_bits=16,
            orchestration_s=MOBILE_ORCHESTRATION_S))
        r = sim.generate(batch=1, n_in=n_in, n_out=n_out)
        rows.append((hw.name, r["ttft_s"], r["tokens_per_s"],
                     r["energy_per_token_j"],
                     battery_queries(15.0, r["energy_per_query_j"])))
    return rows


def main():
    # --- mobile: Llama2-7B W4A16 on a phone -----------------------------
    cfg = registry.get_config("llama2-7b")
    print(f"model: llama2-7b ({cfg.param_count()/1e9:.1f}B params)")
    print(f"{'profile':22s} {'TTFT_s':>8s} {'tok/s':>8s} {'mJ/tok':>8s} "
          f"{'queries/charge':>14s}")
    for name, ttft, tps, ept, per_charge in mobile_rows():
        print(f"{name:22s} {ttft:8.2f} {tps:8.2f} {ept*1e3:8.1f} "
              f"{per_charge:14.0f}")

    # --- cloud: Llama2-70B, 1 DGX-H100 vs 4 PIM-AI servers --------------
    r = run_cloud("llama2-70b", "gqa")
    ra = r["ratios"]
    print("\ncloud llama2-70b GQA (4 PIM servers vs 1 DGX-H100):")
    print(f"  tokens/s advantage  : {ra['tokens_per_s']:.2f}x "
          f"(paper: 2.23-2.75x)")
    print(f"  queries/s advantage : {ra['qps']:.2f}x")
    print(f"  3-yr TCO per QPS    : {ra['tco_per_qps']:.2f}x cheaper "
          f"(paper: 6.2-6.94x)")
    tco = r["tco"]["pim-ai-4srv"]
    print(f"  PIM 3-yr TCO: ${tco['tco_usd']:,.0f} at "
          f"{tco['avg_power_w']:.0f} W avg")


if __name__ == "__main__":
    main()
