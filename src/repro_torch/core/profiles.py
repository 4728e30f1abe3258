"""Hardware profiles (paper Table 1) + PIM chip/DIMM/server composition.

A :class:`HardwareProfile` is the paper's configurable parameter set for
one accelerator: peak tensor throughput + energy/op, main-memory
bandwidth + energy/bit, host<->device (H2D/D2H) bandwidth + energy/bit,
and a vector-unit throughput standing in for the paper's "execution
cycles for other functions" knob.

The PIM-AI hierarchy is built *compositionally* (chip -> DIMM -> engine
-> server) from the chip parameters of §2, and the aggregate server
numbers reproduce the paper's Table-1 "PIM-AI server" row exactly:
24 DIMMs x 16 chips x 102.4 GB/s = 39321.6 GB/s, 24 x 128 TFLOPs =
3072 TOPS.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    tops: float                # peak tensor throughput, TOPS (16-bit)
    pj_per_op: float           # compute energy
    mem_bw_gbs: float          # main-memory bandwidth, GB/s
    mem_pj_per_bit: float      # main-memory access energy
    h2d_bw_gbs: float          # host -> device bandwidth
    d2h_bw_gbs: float          # device -> host bandwidth
    h2d_pj_per_bit: float
    d2h_pj_per_bit: float
    vector_gops: float = 0.0   # elementwise/normalization throughput, GOPS
                               # (0 -> tops/8 heuristic vector:tensor ratio)
    interconnect_bw_gbs: float = 0.0   # intra-node TP interconnect
    interconnect_pj_per_bit: float = 0.0
    cost_usd: float = 0.0      # server capex (TCO model)

    @property
    def ops_per_s(self) -> float:
        return self.tops * 1e12

    @property
    def vector_ops_per_s(self) -> float:
        return (self.vector_gops or self.tops * 1e12 / 8e9) * 1e9

    def scaled(self, n: int, name: str | None = None) -> "HardwareProfile":
        """n identical units operating in parallel (bandwidth + compute
        scale; per-bit/per-op energies unchanged)."""
        return replace(
            self, name=name or f"{self.name}x{n}",
            tops=self.tops * n, mem_bw_gbs=self.mem_bw_gbs * n,
            vector_gops=self.vector_gops * n,
            interconnect_bw_gbs=self.interconnect_bw_gbs * n,
        )


# ---------------------------------------------------------------------------
# Table 1 rows (verbatim from the paper)
# ---------------------------------------------------------------------------

PIM_AI_CHIP = HardwareProfile(
    name="pim-ai-chip", tops=5, pj_per_op=0.4,
    mem_bw_gbs=102.4, mem_pj_per_bit=0.95,
    h2d_bw_gbs=12.8, d2h_bw_gbs=12.8,
    h2d_pj_per_bit=20, d2h_pj_per_bit=20,
)

PIM_AI_SERVER = HardwareProfile(
    name="pim-ai-server", tops=3072, pj_per_op=0.5,
    mem_bw_gbs=39321.6, mem_pj_per_bit=0.95,
    h2d_bw_gbs=22, d2h_bw_gbs=528,
    h2d_pj_per_bit=1920, d2h_pj_per_bit=50,
    interconnect_bw_gbs=528, interconnect_pj_per_bit=50,
    cost_usd=15_000,
)

A17_PRO = HardwareProfile(
    name="a17-pro", tops=17, pj_per_op=0.4,
    mem_bw_gbs=51.2, mem_pj_per_bit=20,
    h2d_bw_gbs=51.2, d2h_bw_gbs=51.2,
    h2d_pj_per_bit=20, d2h_pj_per_bit=20,
)

SNAPDRAGON_8_GEN3 = HardwareProfile(
    name="snapdragon-8-gen3", tops=17, pj_per_op=0.4,
    mem_bw_gbs=77, mem_pj_per_bit=10,
    h2d_bw_gbs=77, d2h_bw_gbs=77,
    h2d_pj_per_bit=10, d2h_pj_per_bit=10,
)

DIMENSITY_9300 = HardwareProfile(
    name="dimensity-9300", tops=16, pj_per_op=0.4,
    mem_bw_gbs=76.8, mem_pj_per_bit=10,
    h2d_bw_gbs=76.8, d2h_bw_gbs=76.8,
    h2d_pj_per_bit=10, d2h_pj_per_bit=10,
)

DGX_H100 = HardwareProfile(
    name="dgx-h100", tops=7916, pj_per_op=0.5,
    mem_bw_gbs=26800, mem_pj_per_bit=7,
    h2d_bw_gbs=450, d2h_bw_gbs=450,
    h2d_pj_per_bit=280, d2h_pj_per_bit=40,
    # NVLink/NVSwitch: 20 pJ/bit GPU->switch + 20 pJ/bit switch->GPU (§3.2)
    interconnect_bw_gbs=3600, interconnect_pj_per_bit=40,
    cost_usd=300_000,
    # vector throughput: 67 TFLOP/s fp32 CUDA-core per H100 x 8
    vector_gops=536_000,
)

TABLE1 = {p.name: p for p in (
    PIM_AI_CHIP, PIM_AI_SERVER, A17_PRO, SNAPDRAGON_8_GEN3, DIMENSITY_9300,
    DGX_H100)}


# ---------------------------------------------------------------------------
# PIM-AI composition (§2.1–2.2)
# ---------------------------------------------------------------------------

# Server-grade PIM chip: the §2.1 stacked-die chip with 8-TOPS tensor
# units (the Table-1 "chip" row is the 5-TOPS mobile/LPDDR variant).
PIM_AI_CHIP_SERVER = replace(
    PIM_AI_CHIP, name="pim-ai-chip-server", tops=8, pj_per_op=0.5)

# Mobile PIM-AI package: two stacked LPDDR5 PIM chips with the §2.1
# 8-TOPS tensor units at the Table-1 mobile energy (0.4 pJ/OP). A 7B
# W4A16 model (~3.9 GB with KV) cannot fit one 2 GB chip, so the
# minimal mobile deployment is a 2-chip package: 16 TOPS aggregate —
# which is what makes Fig 5's "similar first-token latency due to
# comparable TOPS" (vs 16-17 TOPS SoC NPUs) hold — and 204.8 GB/s
# aggregate internal bandwidth at the same 0.95 pJ/bit.
PIM_AI_MOBILE = replace(
    PIM_AI_CHIP.scaled(2, "pim-ai-mobile"), tops=16,
    h2d_bw_gbs=12.8, d2h_bw_gbs=12.8)

CHIPS_PER_DIMM = 16
DIMMS_PER_SERVER = 24
DIMMS_PER_ENGINE = 8   # §3.4: each model instance spans 8 DIMMs
SERVERS_PER_8U = 4     # 2U servers; DGX-H100 comparison normalizes to 8U
ENGINES_PER_8U = (SERVERS_PER_8U * DIMMS_PER_SERVER) // DIMMS_PER_ENGINE  # 12


def pim_dimm() -> HardwareProfile:
    """32 GB DIMM: 16 chips, 1.6 TB/s aggregate, 128 TFLOPs (§2.2)."""
    p = PIM_AI_CHIP_SERVER.scaled(CHIPS_PER_DIMM, "pim-ai-dimm")
    return replace(p, h2d_bw_gbs=PIM_AI_SERVER.h2d_bw_gbs,
                   d2h_bw_gbs=PIM_AI_SERVER.d2h_bw_gbs,
                   h2d_pj_per_bit=PIM_AI_SERVER.h2d_pj_per_bit,
                   d2h_pj_per_bit=PIM_AI_SERVER.d2h_pj_per_bit,
                   interconnect_bw_gbs=PIM_AI_SERVER.interconnect_bw_gbs,
                   interconnect_pj_per_bit=PIM_AI_SERVER.interconnect_pj_per_bit)


def pim_engine(n_dimms: int = DIMMS_PER_ENGINE) -> HardwareProfile:
    """One inference engine = ``n_dimms`` DIMMs running one model copy."""
    p = pim_dimm().scaled(n_dimms, f"pim-ai-engine-{n_dimms}d")
    return replace(p, h2d_bw_gbs=PIM_AI_SERVER.h2d_bw_gbs,
                   d2h_bw_gbs=PIM_AI_SERVER.d2h_bw_gbs)


def pim_server(n_dimms: int = DIMMS_PER_SERVER) -> HardwareProfile:
    p = pim_dimm().scaled(n_dimms, "pim-ai-server-composed")
    return replace(p, h2d_bw_gbs=PIM_AI_SERVER.h2d_bw_gbs,
                   d2h_bw_gbs=PIM_AI_SERVER.d2h_bw_gbs,
                   cost_usd=PIM_AI_SERVER.cost_usd)


def check_composition() -> dict:
    """The composed server must reproduce the Table-1 aggregate row."""
    s = pim_server()
    return {
        "tops": (s.tops, PIM_AI_SERVER.tops),
        "mem_bw": (s.mem_bw_gbs, PIM_AI_SERVER.mem_bw_gbs),
    }
