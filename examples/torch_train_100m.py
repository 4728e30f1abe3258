"""End-to-end training driver of the port: a ~100M-parameter dense LM
for a few hundred steps on the deterministic synthetic stream, with
checkpoints and restart-on-failure supervision.

Counterpart of ``examples/train_100m.py``. By default a ~10M float32
stand-in of the same family and code path (CPU-sized); ``--full-100m``
takes the real 100M bf16 config. ``--inject-failure-at N`` fails once
at step N: the run restores its newest checkpoint (kept in a temporary
directory) and replays. Runs on the card unless ``--device cpu`` is
given.

Run:  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data import make_train_stream  # noqa: E402
from repro_torch.distributed.fault_tolerance import RestartPolicy  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.optim import AdamW, OptConfig  # noqa: E402


def make_cfg(full: bool) -> ArchConfig:
    if full:  # ~100M params (GPT-2-small-ish, RoPE + SwiGLU)
        return ArchConfig(
            name="repro-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=12, d_ff=2048, vocab_size=32000,
            dtype="bfloat16", remat="none", microbatch=1)
    return ArchConfig(  # CPU-sized stand-in, same family and code path
        name="repro-10m", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=8, d_ff=688, vocab_size=4096,
        dtype="float32", remat="none", microbatch=1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="crash once at this step to demo restart")
    ap.add_argument("--device", default="cuda")
    return ap


def run(argv=None, *, verbose=True) -> dict:
    """Train as the flags say; returns {"losses", "end", "restarts",
    "seconds", "params"}."""
    args = parser().parse_args(argv)
    say = print if verbose else (lambda *a, **k: None)
    cfg = make_cfg(args.full_100m)
    params = MD.init_params(cfg, seed=0, device=args.device)
    n = sum(p.numel() for p in T.leaves(params))
    say(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps, "
        f"batch {args.batch} x seq {args.seq}")
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps,
                          weight_decay=0.01))
    stream = make_train_stream(cfg, args.batch, args.seq, seed=0)
    train_step = ST.build_train_step(cfg, opt)
    dev = torch.device(args.device)
    losses = []

    def step_fn(state, batch):
        p, o, m = train_step(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        if len(losses) % 20 == 0:
            say(f"  step {len(losses):4d}  loss {losses[-1]:.4f}")
        return {"params": p, "opt": o}

    def data_at(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}

    crashed = []

    def inject(step):
        if step == args.inject_failure_at and not crashed:
            crashed.append(step)
            say(f"  !! injected node failure at step {step}")
            raise RuntimeError("injected failure")

    with tempfile.TemporaryDirectory() as tmp:
        pol = RestartPolicy(CheckpointManager(tmp, keep=2),
                            checkpoint_every=50)
        t0 = time.perf_counter()
        state, end = pol.run(
            state={"params": params, "opt": opt.init(params)},
            step_fn=step_fn, data_at=data_at, n_steps=args.steps,
            inject_failure=inject if args.inject_failure_at >= 0 else None)
        dt = time.perf_counter() - t0
    say(f"\nfinished {end} steps in {dt:.0f}s "
        f"({dt / max(1, end) * 1e3:.0f} ms/step), restarts={pol.restarts}")
    say(f"loss: {np.mean(losses[:10]):.3f} (first 10) -> "
        f"{np.mean(losses[-10:]):.3f} (last 10)")
    return {"losses": losses, "end": end, "restarts": pol.restarts,
            "seconds": dt, "params": state["params"]}


def main(argv=None) -> int:
    res = run(argv)
    losses = res["losses"]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "did not learn"
    print("loss decreased — training works end to end.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
