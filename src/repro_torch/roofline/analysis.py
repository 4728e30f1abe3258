"""Three-term roofline analysis of the dry-run records (§Roofline).

Counterpart of ``repro/roofline/analysis.py``, with its formulas. For
every (arch x shape x mesh) cell recorded by
:mod:`repro_torch.launch.dryrun` we derive, against the H100 constants
of the port's own profile (``core/profiles.DGX_H100``, a DGX's eight
cards, divided by eight):

  compute term    = trace FLOPs / (chips x 989.5 TFLOP/s bf16 dense)
  memory term     = trace bytes / (chips x 3350 GB/s HBM)
  collective term = collective_bytes / link (450 GB/s NVLink a card)

Sources: both leading terms come from the tracer (``core/trace.py``),
which runs the step on meta tensors — every loop iteration is recorded,
and a hand-written kernel is priced by its own ``cost()``:

  - compute_s  = trace.flops / chips / PEAK  (global)
  - memory_s   = trace.bytes / chips / HBM_BW when the record's trace
    carries byte totals (``launch/dryrun.py`` writes them); a record
    without falls back to bytes_accessed * kappa / HBM_BW, where kappa
    = (trace.flops / chips) / flops — the per-device flops are the
    representative rank's own trace, so kappa is the ratio of the
    global program's share to a rank's work; with no trace, kappa = 1.
  - collective_s = the recorded per-device payload bytes / LINK_BW
    (``roofline/collective_bytes.py``: every collective call counted as
    it runs).

Derived qualities:
  - bottleneck: argmax of the three terms.
  - MODEL_FLOPS: 6·N_active·D (train) or 2·N_active·D (prefill/decode),
    D = processed tokens; the ratio MODEL_FLOPS/trace FLOPs exposes
    remat/redundancy overhead.
  - roofline_frac: useful-model-FLOPs MFU at the bound =
    (MODEL_FLOPS/chips/PEAK) / max(term).
"""
from __future__ import annotations

import json

from repro_torch.core.profiles import DGX_H100
from repro_torch.launch.dryrun import DEFAULT_OUT, peak_memory_bytes

# H100 SXM per-card constants: the DGX H100 profile over its 8 cards
CARDS_PER_DGX = 8
PEAK_FLOPS = DGX_H100.tops * 1e12 / CARDS_PER_DGX        # 989.5e12, bf16
HBM_BW = DGX_H100.mem_bw_gbs * 1e9 / CARDS_PER_DGX       # 3350e9 bytes/s
LINK_BW = DGX_H100.interconnect_bw_gbs * 1e9 / CARDS_PER_DGX  # 450e9

DEFAULT_RESULTS = DEFAULT_OUT

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,       # one token per sequence
    "long_500k": 1,
}
TRAIN_SHAPES = {"train_4k"}


def model_flops(rec: dict) -> float:
    n_active = rec.get("active_params") or rec.get("params") or 0
    tokens = SHAPE_TOKENS.get(rec["shape"], 0)
    mult = 6.0 if rec["shape"] in TRAIN_SHAPES else 2.0
    return mult * n_active * tokens


def analyze_record(rec: dict) -> dict:
    chips = rec.get("devices", 256)
    cost_flops = rec.get("flops", 0.0) or 1.0
    trace = rec.get("trace") or {}
    g_flops = trace.get("flops") or cost_flops * chips
    kappa = (g_flops / chips) / cost_flops if cost_flops else 1.0
    compute_s = g_flops / chips / PEAK_FLOPS
    t_bytes = trace.get("bytes") or 0.0
    if t_bytes:
        # global bytes straight from the tracer
        memory_s = t_bytes / chips / HBM_BW
    else:
        memory_s = rec.get("bytes_accessed", 0.0) * kappa / HBM_BW
    coll = (rec.get("collectives") or {}).get("total_bytes", 0)
    collective_s = coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(rec)
    bound_s = max(terms.values()) or 1.0
    out = {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": rec.get("mesh", "single"), "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "bottleneck": bottleneck,
        "kappa": kappa,
        "hlo_flops_global": g_flops,
        "model_flops": mf,
        "model_flops_ratio": mf / g_flops if g_flops else 0.0,
        "roofline_frac": (mf / chips / PEAK_FLOPS) / bound_s,
        "peak_bytes_per_chip": peak_memory_bytes(rec.get("memory") or {}),
    }
    return out


def load_records(path: str = DEFAULT_RESULTS, mesh: str | None = None
                 ) -> list[dict]:
    """Latest record per (arch, shape, mesh) cell."""
    latest: dict[tuple, dict] = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not r.get("ok"):
                continue
            latest[(r["arch"], r["shape"], r.get("mesh", "single"))] = r
    recs = [r for k, r in sorted(latest.items())
            if mesh is None or k[2] == mesh]
    return recs


def analyze_file(path: str = DEFAULT_RESULTS, mesh: str | None = "single"
                 ) -> list[dict]:
    return [analyze_record(r) for r in load_records(path, mesh)]


def advice(cell: dict) -> str:
    """One sentence on what would move the dominant term down."""
    b = cell["bottleneck"]
    if b == "compute":
        if cell["model_flops_ratio"] < 0.4:
            return ("compute-bound with low useful/HLO ratio: relax the "
                    "remat policy (checkpoint dots) to stop recompute "
                    "dominating")
        return ("compute-bound near the useful-FLOP floor: only larger "
                "per-chip batch or lower-precision matmuls move this")
    if b == "memory":
        return ("memory-bound: raise arithmetic intensity — larger batch "
                "per chip, fuse KV/weight streams (flash/decode kernels), "
                "or quantize the streamed weights")
    return ("collective-bound: reshard to cut the dominant collective "
            "(FSDP all-gather <-> TP all-reduce trade), overlap "
            "collectives with compute, or compress gradients")


def to_markdown(cells: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "bound | 6ND/HLO | roofline | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{c['compute_s']:.3e} | {c['memory_s']:.3e} | "
            f"{c['collective_s']:.3e} | {c['bottleneck']} | "
            f"{c['model_flops_ratio']:.2f} | {c['roofline_frac']:.3f} | "
            f"{advice(c)} |")
    return "\n".join(lines)
