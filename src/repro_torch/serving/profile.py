"""Where a serving step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.serving.profile [--w4]

Builds the full-width bf16 qwen1.5-0.5b engine (random weights from a
seed), fills its 8 slots, then traces with ``torch.profiler`` (CPU and
CUDA activities) one bucketed 1024-token prefill and a window of decode
steps. With ``--w4`` it traces instead a window of batch-1 W16
``decode_step``s and one of W4A16 ``w4_decode_step``s (group 128) of
full-width bf16 phi3-mini-3.8b over a 512-token cache. For each window
it prints the wall time, the summed device time of the kernels, the
device's idle share of the wall time, kernel launches, and the kernels
that take the most device time, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving.engine import EngineConfig, ServingEngine


def report(window: str, prof, wall_s: float, n: int, top: int) -> None:
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
              f" ms/{'step' if 'decode' in window else 'call'}"
              f" x{e.count // n:<4d} {e.key[:90]}", flush=True)


DECODE_STEPS = 10   # steps in the decode window
TOP = 12            # kernels listed per window


def live_engine(params, cfg, rng) -> ServingEngine:
    """An engine (8 slots, capacity 2048) with all 8 slots admitted from
    prompts of 256–1023 tokens and every shape warm: its ``step`` is one
    ragged decode dispatch over 8 live slots."""
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=10_000))
    for n in rng.integers(256, 1024, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n))
    for _ in range(3):
        eng.step()
    return eng


def measure(window: str, n: int, fn, top: int = 12) -> None:
    """Warm ``fn``, time ``n`` calls with the profiler off (wall), then
    trace ``n`` more and :func:`report` them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    report(window, prof, wall, n, top)


def serving_windows() -> dict:
    """The qwen1.5-0.5b engine's prefill and 8-slot decode windows."""
    cfg = registry.get_config("qwen1.5-0.5b")
    params = MD.init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    eng = live_engine(params, cfg, rng)

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device="cuda")
    return {
        "prefill": (1, lambda: eng._prefill_one(params, {"tokens": toks},
                                                1000)),
        # one ragged decode dispatch over 8 live slots per step
        "decode": (DECODE_STEPS, eng.step),
    }


def w4_windows() -> dict:
    """Batch-1 W16 and W4A16 decode steps of phi3-mini-3.8b, each on its
    own copy of one 512-token prefill's cache."""
    from repro_torch.models import w4
    cfg = registry.get_config("phi3-mini-3.8b")
    params = MD.init_params(cfg, seed=0)
    qp = w4.quantize_params(params, 128)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 512)),
                           dtype=torch.int32, device="cuda")
    logits, cache = MD.prefill(params, cfg, {"tokens": toks}, 1024)
    tok = torch.argmax(logits, -1)[:, None]
    caches = {w: {k: v.clone() for k, v in cache.items()}
              for w in ("w16", "w4")}

    def w16_step():
        caches["w16"] = MD.decode_step(params, cfg, tok, caches["w16"])[1]

    def w4_step():
        caches["w4"] = w4.w4_decode_step(qp, cfg, tok, caches["w4"], 128)[1]

    return {"w16_decode": (DECODE_STEPS, w16_step),
            "w4_decode": (DECODE_STEPS, w4_step)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--w4", action="store_true",
                    help="phi3-mini-3.8b W16 vs W4A16 decode steps instead "
                    "of the qwen1.5-0.5b serving windows")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[profile] card='{card}' torch={torch.__version__}", flush=True)
    windows = w4_windows() if args.w4 else serving_windows()
    for name, (n, fn) in windows.items():
        measure(name, n, fn, TOP)


if __name__ == "__main__":
    main()
