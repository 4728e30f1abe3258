"""Per-shape collective breakdown of one dry-run cell: the top 15
(kind, result shape) of a device by bytes, with their call counts.

Counterpart of ``scripts/collective_breakdown.py``, which re-parses a
compiled cell's HLO and multiplies loop trip counts through. Here the
cell's rank run (:mod:`repro_torch.launch.dryrun`) counts each
collective as it runs (:mod:`repro_torch.roofline.collective_bytes`),
so the bytes already carry every iteration.

Usage: PYTHONPATH=src python scripts/torch_collective_breakdown.py
       ARCH SHAPE ['{"cfg_field": value}']
"""
from __future__ import annotations

import argparse
import json
import sys


def breakdown(arch: str, shape: str, overrides=None, mesh_shape=None,
              top: int = 15) -> list:
    """[(kind, shape, bytes, calls)] of the cell's fullest rank, on the
    single pod (or a mesh of ``mesh_shape``)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun as D
    cfg = registry.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    spec = SHAPES[shape]
    cell = D.Cell(cfg, spec.kind, spec.global_batch, spec.seq_len,
                  mesh_shape or D.production_shape("single"))
    cell.run(trace=False)
    cell.close()
    return cell.collectives.breakdown(top=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("overrides", nargs="?", default=None,
                    help="a JSON dict of config overrides")
    args = ap.parse_args(argv)
    over = json.loads(args.overrides) if args.overrides else None
    for kind, shape, nbytes, calls in breakdown(args.arch, args.shape,
                                                over):
        print(f"{nbytes / 1e9:9.3f}GB  n={calls:6d}  {kind:18s} "
              f"{shape[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
