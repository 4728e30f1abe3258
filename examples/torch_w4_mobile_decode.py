"""W4A16 mobile decode on the PyTorch port — the paper's §3.4 on-device
mode, end to end.

Counterpart of ``examples/w4_mobile_decode.py``: quantizes every dense
projection to packed int4 plus per-group scales
(``repro_torch.models.w4``), then runs greedy decode with every weight
GEMV through the int4 GEMV kernel, teacher-forced beside the
full-precision ``decode_step`` from one shared prefill, and reports the
per-step logit fidelity. Runs on the card unless ``--device cpu`` is
given (the plain PyTorch versions of the kernels).

Run:  PYTHONPATH=src python examples/torch_w4_mobile_decode.py --device cpu
      (on the card: no flag; full-width phi3-mini-3.8b)

Then, as the reference example does, it prints the simulator's
W16-vs-W4 figures for full-width phi3-mini on the mobile PIM package
(``repro_torch.core.simulator``, traced on ``meta`` tensors: model
outputs of ``core/profiles.py``, not measurements).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import profiles as HW
from repro_torch.core.simulator import LLMSimulator, SimConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as MD
from repro_torch.models import w4


def run_config():
    """The reference ``run()``'s model: the phi3-mini smoke config at
    d_model 128, 4 heads of 32, d_ff 256, float32."""
    return registry.get_smoke_config("phi3-mini-3.8b").replace(
        dtype="float32", d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=256)


def fidelity(la: torch.Tensor, lb: torch.Tensor) -> tuple[float, float]:
    """(Pearson correlation, max |difference|) of the two logits'
    log-softmax, in float64 on the host, as the reference computes
    them."""
    a = torch.log_softmax(la.float(), -1).double().cpu().numpy().ravel()
    b = torch.log_softmax(lb.float(), -1).double().cpu().numpy().ravel()
    return float(np.corrcoef(a, b)[0, 1]), float(np.max(np.abs(a - b)))


def _clone(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def teacher_forced(params, qp, cfg, logits, cache, n_steps, group, *,
                   tokens=None):
    """From one prefill's ``(logits, cache)``: ``n_steps`` of the W16
    ``decode_step`` beside ``w4_decode_step``, each on its own copy of
    the cache, both fed the same token — the W16 greedy choice, or
    ``tokens[i]`` when given. Returns a dict of per-step lists: the
    logits of each (``w16``, ``w4``), the ``tokens`` fed, the wall
    milliseconds of each step (``w16_ms``, ``w4_ms``; the card is
    synchronised around each) and the kernel launches of each W4 step
    (``w4_launches``)."""
    dev = logits.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache_a, cache_b = _clone(cache), _clone(cache)
    tok = torch.argmax(logits, -1)[:, None]
    out = {k: [] for k in ("w16", "w4", "tokens", "w16_ms", "w4_ms",
                           "w4_launches")}
    for i in range(n_steps):
        if tokens is not None:
            tok = tokens[i]
        out["tokens"].append(tok)
        sync()
        t0 = time.perf_counter()
        la, cache_a = MD.decode_step(params, cfg, tok, cache_a)
        sync()
        t1 = time.perf_counter()
        before = ops.launch_counts()
        lb, cache_b = w4.w4_decode_step(qp, cfg, tok, cache_b, group)
        sync()
        t2 = time.perf_counter()
        after = ops.launch_counts()
        out["w16"].append(la)
        out["w4"].append(lb)
        out["w16_ms"].append((t1 - t0) * 1e3)
        out["w4_ms"].append((t2 - t1) * 1e3)
        out["w4_launches"].append({k: after[k] - before[k] for k in after})
        tok = torch.argmax(la, -1)[:, None]
    return out


def run(n_steps=8, group=64, device="cuda", cfg=None, params=None, *,
        prompt_len=12, capacity=32, seed=0, verbose=True):
    """Teacher-forced fidelity of the W4 decode against the W16 one:
    prefill a seeded prompt with ``model.prefill``, copy the cache, run
    ``n_steps`` of ``decode_step`` and ``w4_decode_step`` side by side.
    ``cfg`` defaults to :func:`run_config`, ``params`` to a seeded
    ``init_params``. Returns the per-step (corr, max |Δ log-prob|)."""
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else run_config()
    if params is None:
        params = MD.init_params(cfg, seed=seed, device=dev)
    qp = w4.quantize_params(params, group)
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(1, prompt_len)),
        dtype=torch.int32, device=dev)
    logits, cache = MD.prefill(params, cfg, {"tokens": prompt}, capacity)
    res = teacher_forced(params, qp, cfg, logits, cache, n_steps, group)
    corr, mad = zip(*(fidelity(a, b) for a, b in zip(res["w16"],
                                                     res["w4"])))
    if verbose:
        print(f"logit fidelity over {n_steps} teacher-forced steps: "
              f"min corr {min(corr):.4f}, max|dlogprob| {max(mad):.3f}")
    return list(corr), list(mad)


def simulate(n_in=1000, n_out=100):
    """The simulator's W16 and W4 figures for full-width phi3-mini on the
    mobile PIM package (the reference example's): {bits: generate()}."""
    full = registry.get_config("phi3-mini-3.8b")
    print(f"\nsimulator: phi3-mini on pim-ai-mobile, {n_in} in / {n_out} "
          "out")
    out = {}
    for bits in (16, 4):
        sim = LLMSimulator(full, HW.PIM_AI_MOBILE,
                           SimConfig(weight_bits=bits, orchestration_s=0.09))
        r = out[bits] = sim.generate(1, n_in, n_out)
        print(f"  W{bits:2d}: {r['tokens_per_s']:6.2f} tok/s, "
              f"{r['energy_per_token_j']*1e3:6.1f} mJ/token")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels, on phi3-mini-3.8b at its "
                    "published width (bf16, seeded weights, a 512-token "
                    "prompt, group 128); cpu: their plain versions, on the "
                    "reference run()'s model (head dim 32, which the "
                    "kernels do not take)")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        run(args.steps, 128, args.device,
            cfg=registry.get_config("phi3-mini-3.8b"), prompt_len=512,
            capacity=1024)
    else:
        run(args.steps, 64, args.device)
    simulate()


if __name__ == "__main__":
    main()
