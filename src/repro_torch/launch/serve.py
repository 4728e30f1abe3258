"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``.

Counterpart of ``repro/launch/serve.py``: stands up the continuous-
batching engine (``serving/engine.py``) on a registry model with random
weights from ``--seed``, drives a synthetic request workload and reports
the serving metrics (TTFT, tokens/s, QPS). Runs on the card unless
``--device cpu`` is given. Restoring weights from a training checkpoint
(the reference's ``--ckpt-dir``) waits for the port's checkpoint module.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import model as MD
from repro_torch.serving import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="--ckpt-dir (serving weights from a training checkpoint) "
               "is not available yet: the port has no checkpoint module.")
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="registry model id: the dense, MoE and vlm "
                    "decoders (rolling sliding windows too, e.g. "
                    "h2o-danube-1.8b, mistral-7b), whisper-large-v3 and "
                    "the recurrent zamba2-2.7b and xlstm-350m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-cache", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="KV-cache backend (paged = block tables)")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--sample", default="greedy",
                    choices=("greedy", "temperature"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    params = MD.init_params(cfg, seed=args.seed, device=args.device)
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=args.slots, max_seq_len=args.capacity,
        max_new_tokens=args.max_new, kv_cache=args.kv_cache,
        kv_block_size=args.kv_block_size, sample=args.sample,
        temperature=args.temperature, top_k=args.top_k, seed=args.seed),
        device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len))
    done = eng.run()
    s = eng.summary()
    print(f"served {s['requests']} requests / {s['tokens']} tokens | "
          f"{s['tokens_per_s']:.1f} tok/s | {s['qps']:.2f} QPS | "
          f"mean TTFT {s['mean_ttft_s']*1e3:.0f} ms | "
          f"mean latency {s['mean_latency_s']*1e3:.0f} ms | "
          f"kv={s['kv_cache']} peak resident "
          f"{s['peak_resident_kv_bytes']/2**20:.1f} MiB "
          f"(dense {s['contiguous_kv_bytes']/2**20:.1f} MiB)")
    print(f"sample output (rid 0): {done[0].output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
