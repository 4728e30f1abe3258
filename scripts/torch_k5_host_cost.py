"""Host time per K5 call on the card (the port's RMSNorm, ``ops.rmsnorm``,
and its fused residual add, ``ops.add_rmsnorm``).

    PYTHONPATH=src python scripts/torch_k5_host_cost.py [--calls N] [--rounds R]

K5 takes 1.5-2.6 us of device time at the serving shapes, far less than
the Python and ctypes work of one call, and it runs 2L + 1 times per
dispatch, so its host time adds up. For each op and shape the script
issues ``--calls`` calls back to back, ``--rounds`` times, and prints
the median and the least host time per call over the rounds (the clock
read before the card is synchronised: the card finishes each call long
before the next one is issued; the least is the one the host's other
load disturbed least) and the median wall time per call (after it). The ops: ``ops.rmsnorm``
at the qwen1.5-0.5b decode rows (M=8, d=1024, bf16) and the residual
add with the norm at the same rows and at the prefill bucket (M=1024).
A tree whose ``ops`` has no ``add_rmsnorm`` is timed on ``x + a`` then
``ops.rmsnorm``, the two calls the model made at each norm site before
the add was fused, so two trees can be compared by running this script
with each tree's ``src`` on ``PYTHONPATH``. The last line names the card
and its power limit.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import ops


def _time(fn, calls: int, rounds: int) -> tuple[float, float, float]:
    """(median host us, least host us, median wall us) per call over
    ``rounds``."""
    for _ in range(max(calls // 10, 10)):
        fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / calls * 1e6)
        wall.append((t2 - t0) / calls * 1e6)
    return statistics.median(host), min(host), statistics.median(wall)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K5 runs on the card only")
    fused = hasattr(ops, "add_rmsnorm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, dt = 1024, torch.bfloat16
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
    for m in (8, 1024):
        x, a = (torch.randn((m, d), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        cases = [] if m != 8 else [
            ("rmsnorm", lambda x=x: ops.rmsnorm(x, w))]
        cases.append(("add_rmsnorm", (lambda x=x, a=a: ops.add_rmsnorm(
            x, a, w)) if fused else (lambda x=x, a=a: ops.rmsnorm(x + a, w))))
        for name, fn in cases:
            host, least, wall = _time(fn, args.calls, args.rounds)
            form = "x+a,rmsnorm" if name == "add_rmsnorm" and not fused \
                else "one_call"
            print(f"[k5_host] op={name} form={form} M={m} d={d} "
                  f"dtype=bfloat16 host_us_per_call={host:.3f} "
                  f"least_host_us_per_call={least:.3f} "
                  f"wall_us_per_call={wall:.3f}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
