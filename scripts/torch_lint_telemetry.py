"""CI lint: every engine dispatch of the port must ride the telemetry
wrapper.

Counterpart of ``scripts/lint_telemetry.py``, over the port's engine.
Two checks, both fatal (nonzero exit):

1. **Static (AST)** — in ``src/repro_torch/serving/engine.py``, every
   call to ``self._log_dispatch`` must occur inside
   ``ServingEngine._dispatch``, the one site that logs the dispatch,
   opens the span named after the kind and records the profiler sample.
   A bare ``_log_dispatch`` anywhere else is a dispatch the span tracer
   and the measured-vs-predicted calibration would miss.

2. **Runtime** — drive mini engines (blocking / chunked on paged /
   speculative) with a live ``Telemetry`` hub and require that every
   kind in ``dispatch_log`` is a ``cat="dispatch"`` span on that
   engine's track, and that the dispatch profiler joined all of
   ``dispatch_log``.

Usage: PYTHONPATH=src python scripts/torch_lint_telemetry.py
       [--skip-runtime] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import ast
import pathlib
import sys

ENGINE_PY = (pathlib.Path(__file__).resolve().parent.parent
             / "src" / "repro_torch" / "serving" / "engine.py")
MODEL = "qwen1.5-0.5b"


def _enclosing_function(tree: ast.AST) -> dict:
    """Every node -> the name of its nearest enclosing function."""
    owner = {}

    def walk(node, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        for child in ast.iter_child_nodes(node):
            owner[child] = fn
            walk(child, fn)

    walk(tree, None)
    return owner


def lint_static(path=None) -> list[str]:
    path = pathlib.Path(path or ENGINE_PY)
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = _enclosing_function(tree)
    problems = []
    sites = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "_log_dispatch"
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"):
            continue
        sites += 1
        fn = owner.get(node)
        if fn != "_dispatch":
            problems.append(
                f"{path.name}:{node.lineno}: self._log_dispatch called "
                f"from {fn!r} — dispatches must go through _dispatch so "
                "the span tracer and profiler see them")
    if sites == 0:
        problems.append(f"{path.name}: no _log_dispatch call sites found "
                        "— lint is looking at the wrong seam")
    return problems


def lint_runtime(device: str = "cuda") -> list[str]:
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import (EngineConfig, ServingEngine, Telemetry,
                                     join_coverage)

    cfg = registry.get_smoke_config(MODEL).replace(dtype="float32")
    params = MD.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    tel = Telemetry()
    flavors = [
        ("blocking", dict(kv_cache="contiguous", scheduler="blocking")),
        ("chunked", dict(kv_cache="paged", scheduler="chunked",
                         chunk_tokens=16)),
        ("speculative", dict(kv_cache="contiguous",
                             scheduler="speculative", spec_gamma=2)),
    ]
    problems = []
    for label, kw in flavors:
        eng = ServingEngine(params, cfg, EngineConfig(
            max_batch=2, max_seq_len=64, max_new_tokens=3, **kw),
            device=device, telemetry=tel, telemetry_label=label)
        for n in (5, 9):
            eng.submit(rng.integers(0, cfg.vocab_size, size=n))
        eng.run()
        logged = {e["kind"] for e in eng.dispatch_log}
        spanned = {s.name for s in tel.tracer.spans
                   if s.tid == label and s.cat == "dispatch"}
        missing = logged - spanned
        if missing:
            problems.append(
                f"{label}: dispatch kinds {sorted(missing)} logged but "
                "never spanned")
        if not logged:
            problems.append(f"{label}: engine made no dispatches — "
                            "workload too small to lint")
        joined, total = join_coverage(eng, tel)
        if joined != total:
            problems.append(
                f"{label}: profiler joined {joined}/{total} "
                "dispatch-log entries")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-runtime", action="store_true",
                    help="AST check only (no engine, sub-second)")
    ap.add_argument("--device", default="cuda",
                    help="where the runtime check's engines run")
    args = ap.parse_args(argv)
    failed = 0
    checks = (("static", lint_static),
              ("runtime", None if args.skip_runtime
               else lambda: lint_runtime(args.device)))
    for label, check in checks:
        if check is None:
            print(f"SKIP {label}")
            continue
        try:
            problems = check()
        except Exception as e:  # noqa: BLE001 — a check that won't run
            problems = [f"check failed: {type(e).__name__}: {e}"]
        if problems:
            failed += 1
            for p in problems:
                print(f"FAIL {label:8s} {p}")
        else:
            print(f"OK   {label}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
