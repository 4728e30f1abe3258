"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

Counterpart of ``repro/launch/train.py`` on one device: registry config
-> params from ``--seed`` -> the deterministic synthetic stream
(:mod:`repro_torch.data`) -> the train step (:func:`~repro_torch.launch.
steps.build_train_step`: microbatched, each layer under the config's
``remat``, every RMSNorm K5 forward and K5b backward on the card) ->
:class:`~repro_torch.distributed.fault_tolerance.RestartPolicy`, which
checkpoints every ``--ckpt-every`` steps (``CheckpointManager``, keep 3,
the reference's file format, written on a background thread) and on a
failure restores the newest valid checkpoint and replays. ``--resume`` starts from the newest checkpoint
in ``--ckpt-dir``; ``--inject-failure-at`` fails once at that step (the
restart drill). Runs on the card unless ``--device cpu`` is given; a
missing card raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import make_train_stream
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.optim import AdamW, OptConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="fail once at this step (restart drill)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def train(argv=None, *, log=print) -> dict:
    """Run the launcher, each line of its log through ``log``; returns
    {"state": {"params", "opt"}, "step", "losses" and "step_seconds" (by
    step, a replayed step's last run), "restarts", "stragglers",
    "cfg"}."""
    args = parser().parse_args(argv)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    dev = torch.device(args.device)
    params = MD.init_params(cfg, seed=args.seed, device=dev)
    log(f"arch={cfg.name or args.arch} family={cfg.family} "
        f"params~{cfg.param_count() / 1e6:.1f}M device={dev}")
    opt = AdamW(OptConfig(lr=args.lr,
                          warmup_steps=min(50, args.steps // 10),
                          total_steps=args.steps,
                          moment_dtype=cfg.optimizer_state_dtype))
    state = {"params": params, "opt": opt.init(params)}
    stream = make_train_stream(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = ST.build_train_step(cfg, opt)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    losses, seconds = {}, {}

    def data_at(step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        batch["step"] = step
        return batch

    def run_step(st, batch):
        step = batch.pop("step")
        ts = time.perf_counter()
        p, o, metrics = step_fn(st["params"], st["opt"], batch)
        loss = float(metrics["loss"])   # waits for the step
        dt = time.perf_counter() - ts
        losses[step], seconds[step] = loss, dt
        if (step + 1) % args.log_every == 0 or step == start:
            log(f"step {step + 1:5d}  loss {loss:.4f}  "
                f"lr {float(metrics['lr']):.2e}  {dt:.2f}s/step")
        return {"params": p, "opt": o}

    start = 0
    if args.resume:
        got_step, got = mgr.restore_latest(state)
        if got is not None:
            state, start = got, got_step
            log(f"resumed from step {start}")

    failed = []

    def inject(step):
        if step == args.inject_failure_at and not failed:
            failed.append(step)
            log(f"injected failure at step {step}")
            raise RuntimeError("injected failure")

    # checkpoints written on the manager's thread while training goes on,
    # as the reference's launcher saves (``blocking=False``)
    policy = RestartPolicy(mgr, checkpoint_every=args.ckpt_every,
                           blocking=False)
    t0 = time.perf_counter()
    state, end = policy.run(state=state, step_fn=run_step, data_at=data_at,
                            n_steps=args.steps, start_step=start,
                            inject_failure=inject)
    mgr.wait()
    log(f"done: {end - start} steps in {time.perf_counter() - t0:.1f}s; "
        f"checkpoints in {args.ckpt_dir}; restarts: {policy.restarts}; "
        f"stragglers observed: {len(policy.straggler_events)}")
    return {"state": state, "step": end, "losses": losses,
            "step_seconds": seconds, "restarts": policy.restarts,
            "stragglers": policy.straggler_events, "cfg": cfg}


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
