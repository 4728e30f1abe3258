"""Lint: every registry model's serving dispatches must price cleanly.

The port's counterpart of ``scripts/lint_prims.py``. For each arch
(assigned and paper models) at full width it traces the engine's own
prefill, ragged decode and 16-token paged chunk functions on ``meta``
tensors through the cost model (``repro_torch.core.costmodel.
DispatchPricer``) — nothing is allocated, so the largest models cost
nothing — and exits non-zero if any aten op lands in the ``"other"``
class while moving more than ``--threshold`` bytes (an "other" op
carries no FLOPs, so a heavy one is a silent undercount: classify it in
``repro_torch/core/trace.py`` or justify it below the threshold), or if
a kernel is priced at zero FLOPs.

Usage: PYTHONPATH=src python scripts/torch_lint_prims.py
       [--threshold BYTES] [arch ...]
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import registry
from repro_torch.core import costmodel as CM

PREFILL_TOKENS = 16
DECODE_MAX_LEN = 64
BATCH = 2
CHUNK_TOKENS = 16      # suffix-prefill chunk: the dispatch a prefix-cache
KV_BLOCK_SIZE = 16     # hit issues for the uncached tail


def offenders(ops, threshold: float) -> list[str]:
    out = []
    for o in ops:
        nbytes = o.in_bytes + o.out_bytes
        if o.kind == "other" and nbytes > threshold:
            out.append(f"{o.prim} ({nbytes:.0f} B)")
        elif o.kind == "kernel" and o.flops <= 0:
            out.append(f"{o.kernel} (0 FLOPs)")
    return out


def lint_arch(name: str, threshold: float) -> list[str]:
    cfg = registry.get_config(name)
    pricer = CM.DispatchPricer(cfg)
    # a vlm prompt's positions start with its image prefix
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    entries = [
        ("prefill", pricer.prefill_ops(BATCH, n_img + PREFILL_TOKENS)),
        ("decode", [o.at(DECODE_MAX_LEN) for o in pricer.decode_ops_linear(
            BATCH, DECODE_MAX_LEN, ragged=True)])]
    # the paged chunk is what a prefix-cache hit dispatches for its
    # uncached suffix; families the engine refuses chunked prefill or
    # paged pools on (rolling window, audio, recurrent) never issue it
    try:
        entries.append(("suffix-chunk", pricer.chunk_ops(
            CHUNK_TOKENS, DECODE_MAX_LEN, kind="paged",
            kv_block_size=KV_BLOCK_SIZE)))
    except ValueError:
        pass
    problems = []
    for label, ops in entries:
        bad = offenders(ops, threshold)
        if bad:
            problems.append(f"{label}: " + ", ".join(bad))
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*",
                    help="arch ids (default: every registry model)")
    ap.add_argument("--threshold", type=float, default=4096.0,
                    help="max bytes an 'other' op may move")
    args = ap.parse_args(argv)
    archs = args.archs or registry.list_archs(assigned_only=False)
    failed = 0
    for name in archs:
        t0 = time.perf_counter()
        try:
            problems = lint_arch(name, args.threshold)
        except Exception as e:  # noqa: BLE001 — a dispatch that won't
            problems = [f"trace failed: {type(e).__name__}: {e}"]  # trace
        dt = time.perf_counter() - t0                 # is itself fatal
        if problems:
            failed += 1
            for p in problems:
                print(f"FAIL {name:20s} {p}")
        else:
            print(f"OK   {name:20s} {dt:.2f} s")
    if failed:
        print(f"\n{failed}/{len(archs)} archs have unpriced heavy ops or "
              f"zero-FLOP kernels (threshold {args.threshold:.0f} B)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
