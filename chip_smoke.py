#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device — the card, its power limit, the toolchain; every kernel of
   the main path built from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernels — each kernel against its plain PyTorch version at the main
   path's shapes, in bf16 and float32, with its time (CUDA events),
   the plain version's, one PyTorch library call's where one computes
   the same function, and the bound the card's roofline allows;
3. engine, float32 gate — full-width qwen1.5-0.5b (random weights from a
   seed) served greedily by ``ServingEngine``; the streams must equal
   the port's own batch-1 prefill + decode_step loop;
4. engine, bf16 run — 16 seeded requests through 8 slots: tok/s, TTFT,
   inter-token latency; the first prefill's logits held against a run
   through the plain versions; every kernel's launch count checked.

The line before last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. It needs CUDA and the repository's
``src/`` beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core bf16
              "float32": 67e12}         # fp32 outside the tensor cores
# kernel vs plain version: float32 differs only in summation order;
# bf16 outputs may differ by a rounding step (1 ulp is 2^-8 relative)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCH = "qwen1.5-0.5b"
SEED = 0


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events around the launches (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

def phase_device() -> str:
    import torch
    from repro_torch.kernels import _build
    card = card_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        so = _build.library_path(name)
        ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        log("build", kernel=name, lib=so.name, ptxas=" | ".join(ptxas))
    log("build", seconds=f"{build_s:.1f}", parallel_nvcc=len(_build.SOURCES))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _compare(name, case, dtype_name, got, want, *, ms, plain_ms, lib_ms,
             nbytes, flops):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    bms, by = bound_ms(nbytes, flops, dtype_name)
    log("kernels", kernel=name, case=case, dtype=dtype_name,
        max_abs_err=f"{err:.3e}", tol=tol, ok=ok, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by)
    if not ok:
        raise AssertionError(f"{name} {case} {dtype_name}: max |err| "
                             f"{err:.3e} exceeds {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}


def kernel_cases(gen, dtype):
    """(name, case, kernel_fn, plain_fn, library_fn|None, bytes, flops)
    at the main path's shapes for one dtype."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    elt = torch.tensor([], dtype=dtype).element_size()
    cases = []
    d = 1024
    for m in (8, 512):
        x = _rand(gen, (m, d), dtype)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
             ).to(dtype)
        cases.append((
            "rmsnorm", f"M={m},d={d}",
            lambda x=x, w=w: krn.rmsnorm(x, w),
            lambda x=x, w=w: ref.rmsnorm(x, w),
            lambda x=x, w=w, d=d: F.rms_norm(x, (d,), w, eps=1e-6),
            (2 * m * d + d) * elt, 4 * m * d))

    def sdpa(q, k, v, mask=None, causal=True):
        g = q.shape[2] // k.shape[2]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=g > 1).transpose(1, 2)

    s, dh = 512, 64
    for case, hq, hkv, window in (("causal", 16, 16, None),
                                  ("gqa", 8, 2, None),
                                  ("window", 16, 16, 128)):
        q = _rand(gen, (1, s, hq, dh), dtype)
        k = _rand(gen, (1, s, hkv, dh), dtype)
        v = _rand(gen, (1, s, hkv, dh), dtype)
        pos = torch.arange(s, device="cuda")
        ok = pos[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[None, :] > pos[:, None] - window
        pairs = int(ok.sum().item())
        mask = ok if window is not None else None
        cases.append((
            "flash_attention",
            f"B=1,S={s},Hq={hq},Hkv={hkv},Dh={dh},{case}",
            lambda q=q, k=k, v=v, w=window: kfa.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, w=window: ref.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, m=mask: sdpa(q, k, v, m),
            (2 * q.numel() + k.numel() + v.numel()) * elt,
            4 * pairs * hq * dh))

    b, cap = 8, 2048
    for case, hq, hkv in (("mha", 16, 16), ("gqa", 8, 2)):
        q = _rand(gen, (b, 1, hq, dh), dtype)
        kc = _rand(gen, (b, cap, hkv, dh), dtype)
        vc = _rand(gen, (b, cap, hkv, dh), dtype)
        ek = _rand(gen, (b, 1, hkv, dh), dtype)
        ev = _rand(gen, (b, 1, hkv, dh), dtype)
        lens = torch.randint(1, cap + 1, (b,), generator=gen,
                             device="cuda", dtype=torch.int32)
        lens[0] = cap  # one full row
        tot = int(lens.sum().item())
        cases.append((
            "decode_attention",
            f"B={b},C={cap},Hq={hq},Hkv={hkv},Dh={dh},sum_len={tot},self",
            lambda q=q, kc=kc, vc=vc, lens=lens, ek=ek, ev=ev:
                kdec.decode_attention(q, kc, vc, lens, extra_k=ek,
                                      extra_v=ev),
            lambda q=q, kc=kc, vc=vc, lens=lens, ek=ek, ev=ev:
                ref.decode_attention(q, kc, vc, lens, extra_k=ek,
                                     extra_v=ev),
            None,
            (2 * tot * hkv * dh + 2 * q.numel() + 2 * b * hkv * dh) * elt
            + 4 * b,
            4 * (tot + b) * hq * dh))
    return cases


def phase_kernels() -> dict:
    """Every kernel vs its plain version, both dtypes. Returns, per
    kernel, the bf16 numbers at its first (main-path) shape and the
    largest error seen."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name, case, kfn, pfn, lfn, nbytes, flops in kernel_cases(
                gen, dtype):
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            res = _compare(
                name, case, dname, got, want, ms=time_ms(kfn),
                plain_ms=time_ms(pfn),
                lib_ms=None if lfn is None else time_ms(lfn),
                nbytes=nbytes, flops=flops)
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
            if dname == "bfloat16" and "ms" not in row:
                row.update({k: v for k, v in res.items()
                            if k != "max_abs_err"}, case=case)
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel ops to their plain versions for a
    reference run on the card (this script's comparison only; the
    package itself never falls back)."""
    from repro_torch.kernels import ops, ref
    saved = (ops.rmsnorm, ops.flash_attention, ops.decode_attention)
    ops.rmsnorm = lambda x, w, *, eps=1e-6: ref.rmsnorm(x, w, eps)
    ops.flash_attention = ref.flash_attention
    ops.decode_attention = ref.decode_attention
    try:
        yield
    finally:
        ops.rmsnorm, ops.flash_attention, ops.decode_attention = saved


def straight_line_generate(params, cfg, prompt, n_new, capacity):
    """Batch-1 prefill + greedy decode_step loop (the engine's oracle)."""
    import torch
    from repro_torch.models import model as MD
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    logits, cache = MD.prefill(params, cfg, {"tokens": toks}, capacity)
    cur = torch.argmax(logits, -1)[:, None]
    out = [int(cur[0, 0])]
    for _ in range(n_new - 1):
        logits, cache = MD.decode_step(params, cfg, cur, cache)
        cur = torch.argmax(logits, -1)[:, None]
        out.append(int(cur[0, 0]))
    return out


def check_launches(phase, counts, prefills, decodes, n_layers) -> None:
    """Every kernel of the path ran, exactly as often as the path says:
    2 RMSNorms per layer + 1 final per dispatch, one flash prefill per
    layer per prefill, one split-KV decode per layer per decode step."""
    want = {"rmsnorm": (2 * n_layers + 1) * (prefills + decodes),
            "flash_attention": n_layers * prefills,
            "decode_attention": n_layers * decodes}
    log(phase, launches=json.dumps(counts), expected=json.dumps(want))
    if counts != want or not all(counts.values()):
        raise AssertionError(f"{phase}: kernel launches {counts} != {want}")


def run_engine(params, cfg, prompts, max_new):
    """Serve ``prompts`` on a fresh engine; returns (engine, counts)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=max_new))
    for p in prompts:
        eng.submit(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    return eng, ops.launch_counts()


def phase_engine_f32() -> None:
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH).replace(dtype="float32")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (17, 200, 511, 1000)]
    eng, counts = run_engine(params, cfg, prompts, 16)
    s = eng.summary()
    check_launches("engine_f32", counts, s["prefills"],
                   s["decode_dispatches"], cfg.n_layers)
    if s["decode_dispatches"] != s["decode_steps"]:
        raise AssertionError(f"decode dispatches {s['decode_dispatches']} "
                             f"!= steps {s['decode_steps']}")
    got = {r.rid: r.output for r in eng.finished}
    for i, p in enumerate(prompts):
        want = straight_line_generate(params, cfg, p, 16, 2048)
        log("engine_f32", request=i, prompt_len=len(p),
            equal=got[i] == want, tokens=got[i][:8])
        if got[i] != want:
            raise AssertionError(f"request {i}: engine {got[i]} != "
                                 f"straight-line {want}")
    log("engine_f32", requests=s["requests"], tokens=s["tokens"],
        decode_dispatches=s["decode_dispatches"],
        decode_steps=s["decode_steps"], prefills=s["prefills"],
        streams_equal=True)


def phase_engine_bf16(card: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{ARCH} serves in {cfg.dtype}, not bfloat16")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(32, 1025, size=16)]

    # the first prefill through the kernels and through the plain versions
    n0 = len(prompts[0])
    nb = 16
    while nb < n0:
        nb *= 2
    toks = np.zeros((1, nb), np.int32)
    toks[0, :n0] = prompts[0]
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    got, _ = MD.prefill(params, cfg, batch, None, logit_index=n0 - 1)
    with plain_kernels():
        want, _ = MD.prefill(params, cfg, batch, None, logit_index=n0 - 1)
    rel = ((got - want).norm() / want.norm()).item()
    log("engine_bf16", first_prefill_len=n0, bucket=nb,
        logits_max_abs_err=f"{(got - want).abs().max().item():.3e}",
        logits_rel_err=f"{rel:.3e}", tol=TOL["bfloat16"],
        argmax_equal=bool((got.argmax(-1) == want.argmax(-1)).all()))
    if not rel <= TOL["bfloat16"]:
        raise AssertionError(f"bf16 prefill logits: relative error {rel}")

    run_engine(params, cfg, prompts[:2], 4)  # warm-up (allocator, cuBLAS)
    eng, counts = run_engine(params, cfg, prompts, 64)
    s = eng.summary()
    check_launches("engine_bf16", counts, s["prefills"],
                   s["decode_dispatches"], cfg.n_layers)
    if s["decode_dispatches"] != s["decode_steps"] or s["requests"] != 16:
        raise AssertionError(f"bf16 engine summary off: {s}")
    for r in eng.finished:
        if len(r.output) != 64:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
    log("engine_bf16", requests=s["requests"], tokens=s["tokens"],
        tok_per_s=f"{s['tokens_per_s']:.1f}",
        ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
        ttft_p99_ms=f"{s['ttft_p99_s'] * 1e3:.1f}",
        itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
        itl_p99_ms=f"{s['itl_p99_s'] * 1e3:.2f}",
        decode_steps=s["decode_steps"], prefills=s["prefills"],
        card=f"'{card}'")
    return counts


SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:84"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:230"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:25"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    # float32 products in full float32 (no TF32) for every gate below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_device()
    rows = phase_kernels()
    phase_engine_f32()
    torch.cuda.empty_cache()
    counts = phase_engine_bf16(card)
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"]})
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
