"""Inject/refresh the roofline markdown tables of the port's dry-run
records into a markdown file (``EXPERIMENTS.md`` by default).

Counterpart of ``scripts/render_experiments.py``, over
``results/torch_dryrun.jsonl`` (and ``results/torch_dryrun_opt.jsonl``
where it exists). Idempotent: everything between a marker and the next
``## `` heading is replaced; a file without the marker is left as it is.

Usage: PYTHONPATH=src python scripts/torch_render_experiments.py
       [TARGET.md]
"""
from __future__ import annotations

import argparse
import os
import re
import sys

BASE = "<!-- ROOFLINE_BASELINE -->"
OPT = "<!-- ROOFLINE_OPT -->"
OPT_RESULTS = os.path.join("results", "torch_dryrun_opt.jsonl")


def inject(md: str, marker: str, title: str, table: str) -> str:
    block = f"{marker}\n\n{title}\n\n{table}\n\n"
    pat = re.compile(re.escape(marker) + r".*?(?=\n## )", re.S)
    if pat.search(md):
        return pat.sub(lambda m: block, md)
    return md.replace(marker, block)


def render(target: str, results: str, opt_results: str | None) -> None:
    from repro_torch.roofline.analysis import analyze_file, to_markdown
    if os.path.basename(target) == "PERF.md":
        raise ValueError("the roofline tables are not written into PERF.md")
    with open(target) as f:
        md = f.read()
    md = inject(md, BASE, "### Baseline (the port's placements) — single "
                "pod", to_markdown(analyze_file(results, mesh="single")))
    if opt_results and os.path.exists(opt_results):
        md = inject(md, OPT, "### Optimized — full single-pod table",
                    to_markdown(analyze_file(opt_results, mesh="single")))
    with open(target, "w") as f:
        f.write(md)


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import DEFAULT_OUT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", nargs="?", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    render(args.target, DEFAULT_OUT, OPT_RESULTS)
    print("tables injected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
