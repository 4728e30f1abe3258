"""Where a serving step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.serving.profile

Builds the full-width bf16 qwen1.5-0.5b engine (random weights from a
seed), fills its 8 slots, then traces with ``torch.profiler`` (CPU and
CUDA activities) one bucketed 1024-token prefill and a window of decode
steps. For each window it prints the wall time, the summed device time
of the kernels, the device's idle share of the wall time, kernel
launches, and the kernels that take the most device time, with the
card's name and power limit.
"""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving.engine import EngineConfig, ServingEngine


def _report(window: str, prof, wall_s: float, n: int, top: int) -> None:
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[profile] window={window} n={n} "
          f"wall_ms_per={wall_s * 1e3 / n:.3f} "
          f"device_ms_per={dev_us / 1e3 / n:.3f} "
          f"idle_share={1 - dev_us / 1e6 / wall_s:.3f} "
          f"kernel_launches_per={launches / n:.0f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {window} {e.self_device_time_total / 1e3 / n:9.3f}"
              f" ms/{'step' if window == 'decode' else 'call'}"
              f" x{e.count // n:<4d} {e.key[:90]}", flush=True)


DECODE_STEPS = 10   # steps in the decode window
TOP = 12            # kernels listed per window


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[profile] card='{card}' torch={torch.__version__}", flush=True)
    cfg = registry.get_config("qwen1.5-0.5b")
    params = MD.init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=10_000))
    for n in rng.integers(256, 1024, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n))
    for _ in range(3):          # admit all 8 slots, warm every shape
        eng.step()

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device="cuda")
    windows = {
        "prefill": (1, lambda: eng._prefill_one(params, {"tokens": toks},
                                                1000)),
        # one ragged decode dispatch over 8 live slots per step
        "decode": (DECODE_STEPS, eng.step),
    }
    for name, (n, fn) in windows.items():
        fn()                                  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()              # wall, profiler off
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        _report(name, prof, wall, n, TOP)


if __name__ == "__main__":
    main()
