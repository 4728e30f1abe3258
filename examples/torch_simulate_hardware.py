"""Design-space exploration with the port's PIM-AI simulator: sweep the
hardware parameters the paper fixes and see how the architecture
responds — the experiment §5.2 hints at (more TOPS for the encode
phase; heterogeneous encode/decode split).

Counterpart of ``examples/simulate_hardware.py``. Every figure is a
model output of the profiles in ``repro_torch.core.profiles``; the
simulator traces on ``meta`` tensors and uses no device.

Run:  PYTHONPATH=src python examples/torch_simulate_hardware.py
"""
from dataclasses import replace

from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.simulator import LLMSimulator, SimConfig

ORCHESTRATION_S = 0.09


def _generate(hw):
    sim = LLMSimulator(registry.get_config("llama2-7b"), hw,
                       SimConfig(weight_bits=4,
                                 orchestration_s=ORCHESTRATION_S))
    return sim.generate(1, 1000, 100)


def tops_sweep(tops=(8, 16, 32, 64)):
    """(TOPS, TTFT s, tokens/s, QPS) of the mobile PIM package."""
    out = []
    for t in tops:
        r = _generate(replace(HW.PIM_AI_MOBILE, tops=t))
        out.append((t, r["ttft_s"], r["tokens_per_s"], r["qps"]))
    return out


def bandwidth_sweep(bws=(102.4, 204.8, 409.6, 819.2)):
    """(GB/s, tokens/s, J/token) of the mobile PIM package."""
    out = []
    for bw in bws:
        r = _generate(replace(HW.PIM_AI_MOBILE, mem_bw_gbs=bw))
        out.append((bw, r["tokens_per_s"], r["energy_per_token_j"]))
    return out


def main():
    print("== sweep: tensor TOPS of the mobile PIM package "
          "(paper §5.2: encode could be optimized by more TOPS) ==")
    print(f"{'TOPS':>6s} {'TTFT_s':>8s} {'tok/s':>8s} {'QPS':>8s}")
    for tops, ttft, tps, qps in tops_sweep():
        print(f"{tops:6d} {ttft:8.2f} {tps:8.2f} {qps:8.3f}")
    print("-> TTFT scales with TOPS; tokens/s doesn't (decode is "
          "bandwidth-bound): the paper's §5.2 heterogeneous conclusion.")

    print("\n== sweep: internal bandwidth per chip ==")
    print(f"{'GB/s':>8s} {'tok/s':>8s} {'mJ/tok':>8s}")
    for bw, tps, ept in bandwidth_sweep():
        print(f"{bw:8.1f} {tps:8.2f} {ept*1e3:8.1f}")
    print("-> tokens/s tracks bandwidth until the host orchestration "
          "floor; energy/token is bandwidth-independent (pJ/bit fixed).")

    print("\n== heterogeneous encode/decode split (paper §5.3) ==")
    # encode on a big-TOPS profile, decode on the PIM package
    cfg = registry.get_config("llama2-7b")
    npu = LLMSimulator(cfg, HW.SNAPDRAGON_8_GEN3,
                       SimConfig(weight_bits=4,
                                 orchestration_s=ORCHESTRATION_S))
    pim = LLMSimulator(cfg, HW.PIM_AI_MOBILE,
                       SimConfig(weight_bits=4,
                                 orchestration_s=ORCHESTRATION_S))
    enc = npu.encode(1, 1000)
    dec = pim.decode(1, 1000, 100)
    homo = pim.generate(1, 1000, 100)
    print(f"  PIM-only   : {homo['query_s']:.2f} s/query, "
          f"{homo['energy_per_query_j']:.2f} J/query")
    print(f"  NPU encode + PIM decode: {enc.seconds + dec.seconds:.2f} "
          f"s/query, {enc.energy_j + dec.energy_j:.2f} J/query")


if __name__ == "__main__":
    main()
