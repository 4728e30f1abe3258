#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device — the card, its power limit, the toolchain; every kernel
   built from ``src/repro_torch/kernels/csrc`` with nvcc, one process
   per source, all started together; per library the ptxas registers
   of each instantiation and its SASS count of tensor-core MMAs,
   cp.async (LDGSTS), ldmatrix, 128-bit global loads and int -> float
   conversions;
2. kernels — each kernel against its plain PyTorch version at the
   paths' shapes, in bf16 and float32, with its time per call (CUDA
   events, host launch cost included), its device time per call
   (``torch.profiler``), the plain version's time, one PyTorch library
   call's where one computes the same function (both times), and the
   bound the card's roofline allows; for every kernel also both times
   cold in L2, kernel and library, round-robin over copies of its
   operands that exceed the L2; K5 with the residual add fused
   (``add_rmsnorm``) at the decode, prefill and W4 rows, its ``s``
   bitwise torch's ``x + a`` and its ``h`` bitwise the kernel without
   the add on ``s``, beside the lone ``x + a`` (the launch floor); the
   paged decode (K2) must also be
   bitwise equal to the contiguous one (K1) on the same rows, and the
   prefill over a cache (K4) to its second run and to a run over a
   block-table gather of the same rows from a larger pool; the int4
   GEMV (K6) at phi3-mini's projection shapes, K1 / K2 / K3 / K4 at its
   head dim 96, K1 / K2 also at the W4 step's one-row call; K1 / K2 /
   K3 / K4 at phase 7's head dim 128 (GQA 48/8 and MHA 16/16), K3 also
   after the vlm's 256-row image prefix;
3. engine, float32 gate — full-width qwen1.5-0.5b (random weights from a
   seed) served greedily by ``ServingEngine``: contiguous + blocking
   must equal the port's own batch-1 prefill + decode_step loop, and
   paged + blocking, chunked and speculative on both backends must
   equal contiguous + blocking;
4. engine, bf16 runs — 16 seeded requests through 8 slots on contiguous
   + blocking, paged + chunked and paged + speculative: tok/s, TTFT,
   inter-token latency, resident KV, chunk dispatches, acceptance; the
   first prefill's and the first chunked prefill's logits held against
   runs through the plain versions;
5. W4A16 mobile decode — full-width phi3-mini-3.8b in bf16, every
   projection int4 at group 128: a 512-token prefill, then 16
   teacher-forced W16 ``decode_step``s beside ``w4_decode_step``s
   (``examples/torch_w4_mobile_decode.py``): per-step fidelity and wall
   ms, the prefill's and every W4 step's logits held against runs
   through the plain versions;
6. request surface — full-width qwen1.5-0.5b again, float32 for the
   stream gates: the overload trace replayed under FIFO and SLO on
   both backends (SLO streams == FIFO streams, >= 1 preemption, chat
   p99 TTFT <= 0.04 virtual s under SLO and > 0.04 under FIFO, tokens
   per step >= 0.95x FIFO's); prefix caching on against off for 8
   requests on a 512-token preamble, blocking and chunked, and the
   sharedprefix trace (equal streams, hit tokens equal to the host's
   block-aligned matches); the four fixed preemption plans with the
   prefix index on; telemetry on against off (equal tokens, a valid
   trace, every dispatch joined); then bf16: an export -> import round
   trip (``torch.equal`` rows), seeded temperature sampling (same seed,
   same stream, also under preemption; another seed, another stream)
   and the device time of a cold against a warm admission. Every pool
   must balance after its drain;
7. families — the MoE and vlm families at full width, random weights
   from the seed, one model at a time: (a) float32, 4 layers deep,
   deepseek-moe-16b (its dense layer 0 and 3 MoE layers) and
   internvl2-26b through phase 3's gates, deepseek at capacity factor
   E / k, where no dispatch can drop a routed slot; then deepseek at
   its config's 1.25 on the same six configurations, the dropped slots
   per dispatch kind printed, only paged == contiguous gated; (b) bf16
   at full depth, both models: the first prefill's logits, whole and
   chunked, against the plain versions (an MoE's plain run replays the
   kernel run's experts; the tokens its own routing would move may be
   at most twice those that one-ulp noise at every MoE input moves in
   the plain path), phase 4's three serving runs, and one decode
   step of 8 live slots traced by ``torch.profiler``; (c) dbrx-132b,
   2 layers, LayerNorm: a 512-token prefill and 8 decode steps with
   exact launches (no K5) and every step's logits against the plain
   versions, its routing flips held as in (b). Each model's step ends the process past 420 s.

Every engine run and every W4 step checks each kernel's launch count
against what its path must launch.

The line before last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. It needs CUDA and the repository's
``src/`` and ``examples/`` beside it; it imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import re
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


DEVICE_TRIES = 3   # fresh profiler traces before a device time is missing
device_misses = 0  # traces that held no device time, over the whole run


def device_ms(fn, *, reps: int = 20) -> float | None:
    """Device time per call: the kernels' summed device time in a
    ``torch.profiler`` trace of ``reps`` calls (after a warm-up), over
    ``reps`` — what ``time_ms`` reads without the host's launch cost.
    A trace that holds no device activity (CUPTI now and then hands the
    profiler an empty activity buffer) is taken again, fresh, up to
    ``DEVICE_TRIES`` times; None (not measured) only if every try is
    empty. Misses are counted in ``device_misses``."""
    global device_misses
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        device_misses += 1
    return None


COLD_BYTES = 120e6    # what a round of copies streams: > 2x the 50 MB L2


def cold_copies(nbytes: float) -> int:
    """Copies of an operand set of ``nbytes`` that one round-robin round
    must visit so that each copy is evicted from L2 before its next
    call."""
    return max(2, -(-int(COLD_BYTES) // max(int(nbytes), 1)))


def round_robin(fns):
    """One call per step, to each of ``fns`` (kernels on different
    copies of their operands) in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def cold_times(fns) -> tuple[float, float | None]:
    """(ms, device ms) per call over ``fns`` taken round-robin, in
    multiples of a whole round: each call finds its operands cold in L2,
    as a step streaming the model's weights or caches finds them."""
    reps = len(fns) * max(1, -(-20 // len(fns)))
    fn = round_robin(fns)
    return time_ms(fn, reps=reps), device_ms(fn, reps=reps)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

def _instantiation(mangled: str) -> str:
    """``kernel<args>`` from a mangled kernel name (float, bf16, int and
    file-local struct template arguments), or the mangled name itself."""
    for m in re.finditer(r"\d+", mangled):  # <length><identifier>
        end = m.end() + int(m.group())
        if not mangled[m.end():end].endswith("_kernel"):
            continue
        if mangled[end:end + 1] == "E":            # not a template
            return mangled[m.end():end]
        if mangled[end:end + 1] == "I" and "EEv" in mangled[end:]:
            break
    else:
        return mangled
    kernel, rest = mangled[m.end():end], mangled[end + 1:]
    rest = rest[:rest.index("EEv")]
    args = []
    while rest:
        if rest.startswith("13__nv_bfloat16"):
            args.append("bf16")
            rest = rest[15:]
        elif rest.startswith("f"):
            args.append("f32")
            rest = rest[1:]
        elif re.match(r"NS_\d+", rest):          # a struct of the file
            m = re.match(r"NS_(\d+)", rest)
            args.append(rest[m.end():m.end() + int(m.group(1))])
            rest = rest[m.end() + int(m.group(1)) + 1:]
        elif rest.startswith(("Li", "Lb")) and "E" in rest:
            args.append(rest[2:rest.index("E")])
            rest = rest[rest.index("E") + 1:]
        elif re.match(r"S\d*_", rest):   # a repeat of an earlier type:
            args.append("bf16")            # bf16 is the only one named
            rest = rest[re.match(r"S\d*_", rest).end():]
        else:
            return mangled
    return f"{kernel}<{','.join(args)}>"


def ptxas_summary(log_text: str) -> list:
    """One ``kernel<args>=registers/static smem bytes[/spills]`` entry
    per instantiation in an ``nvcc -Xptxas -v`` log (dynamic shared
    memory is set at launch and does not appear here)."""
    out, name, spill = [], None, ""
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = _instantiation(m.group(1)), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and m.group(1) + m.group(2) != "00":
            spill = f"/spill{m.group(1)}+{m.group(2)}B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and name is not None:
            out.append(f"{name}={m.group(1)}r/{m.group(2) or 0}B{spill}")
            name = None
    return out


# tensor-core MMA, cp.async, ldmatrix, 128-bit global loads, int ->
# float conversions
SASS_OPS = {"HMMA": r"\bHMMA\b", "LDGSTS": r"\bLDGSTS\b",
            "LDSM": r"\bLDSM\b", "LDG.E.128": r"\bLDG\.E\.128\b",
            "I2F": r"\bI2FP?\b"}


def sass_counts(so: Path) -> str:
    """How many of each ``SASS_OPS`` instruction the library's machine
    code holds (``cuobjdump -sass``)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return "cuobjdump_not_found"
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts = {op: len(re.findall(pat, sass)) for op, pat in SASS_OPS.items()}
    return ",".join(f"{op}:{n}" for op, n in counts.items())


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
        log("build", kernel=name, lib=so.name, sass=sass_counts(so),
            ptxas=" ".join(ptxas_summary(so.with_suffix(".log").read_text())))
    log("build", seconds=f"{build_s:.1f}", parallel_nvcc=len(_build.SOURCES))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _flat(out):
    """A kernel's output, or its tuple of outputs, as one float32
    vector (for the comparison only, never timed)."""
    import torch
    if isinstance(out, tuple):
        return torch.cat([t.float().flatten() for t in out])
    return out.float()


def _equal(a, b) -> bool:
    """``torch.equal`` of two outputs or tuples of outputs."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


def _compare(name, case, dtype_name, got, want, *, ms, plain_ms, lib_ms,
             dev_ms, lib_dev_ms, nbytes, flops):
    import torch
    outs = got if isinstance(got, tuple) else (got,)
    # an output rounded to bf16 is held to bf16's tolerance
    tol = TOL["bfloat16" if any(t.dtype == torch.bfloat16 for t in outs)
              else dtype_name]
    got, want = _flat(got), _flat(want)
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, atol=tol, rtol=tol)
    bms, by = bound_ms(nbytes, flops, dtype_name)
    log("kernels", kernel=name, case=case, dtype=dtype_name,
        max_abs_err=f"{err:.3e}", tol=tol, ok=ok, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
        device_ms="null" if dev_ms is None else f"{dev_ms:.4f}",
        library_device_ms="null" if lib_dev_ms is None
        else f"{lib_dev_ms:.4f}",
        bound_ms=f"{bms:.6f}", bound_by=by)
    if not ok:
        raise AssertionError(f"{name} {case} {dtype_name}: max |err| "
                             f"{err:.3e} exceeds {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bms,
            "bound_by": by}


def _cold(name, case, dtype_name, kfns, lfns) -> dict:
    """Kernel and library times with every call's operands cold in L2:
    round-robin over ``len(kfns)`` copies of the weights or caches."""
    import torch
    ms, dev = cold_times(kfns)
    lib_ms, lib_dev = (None, None) if lfns is None else cold_times(lfns)
    res = {"cold_ms": ms, "cold_device_ms": dev, "library_cold_ms": lib_ms,
           "library_cold_device_ms": lib_dev, "cold_copies": len(kfns)}
    log("kernels", kernel=name, case=case, dtype=dtype_name,
        cold_copies=len(kfns), **{k: "null" if v is None else f"{v:.4f}"
                                  for k, v in res.items()
                                  if k != "cold_copies"})
    del kfns, lfns
    torch.cuda.empty_cache()
    return res


def sdpa(q, k, v, mask=None, causal=True):
    """``scaled_dot_product_attention`` on the model's (B, S, H, Dh)
    layout (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=g > 1).transpose(1, 2)


def decode_cases(gen, dtype, b, cap, hq, hkv, dh, bs=16, first_len=None):
    """K1 over a ragged contiguous cache with the self partial, and K2
    on the same rows in a pool of scattered blocks (bitwise K1); row 0
    holds ``first_len`` positions (default: the capacity). Library
    yardstick of both: SDPA over cache ++ self with a boolean mask —
    the mask, the concatenation and, for K2, the table gather built
    here, outside the timed call."""
    import torch
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import paged_decode_attention as kpdec
    from repro_torch.kernels import ref
    elt = torch.tensor([], dtype=dtype).element_size()
    nb, w = b * cap // bs, cap // bs
    q = _rand(gen, (b, 1, hq, dh), dtype)
    kc = _rand(gen, (b, cap, hkv, dh), dtype)
    vc = _rand(gen, (b, cap, hkv, dh), dtype)
    ek = _rand(gen, (b, 1, hkv, dh), dtype)
    ev = _rand(gen, (b, 1, hkv, dh), dtype)
    lens = torch.randint(1, cap + 1, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens[0] = cap if first_len is None else first_len
    tot = int(lens.sum().item())
    dec_bytes = ((2 * tot * hkv * dh + 2 * q.numel() + 2 * b * hkv * dh)
                 * elt + 4 * b)
    pos = torch.arange(cap + 1, device="cuda")
    mask = ((pos[None, :] < lens[:, None]) | (pos[None, :] == cap)
            )[:, None, None, :]                     # (B, 1, 1, C + 1)
    k_cat, v_cat = torch.cat([kc, ek], 1), torch.cat([vc, ev], 1)

    def k1_cold():
        caches = [(kc.clone(), vc.clone())
                  for _ in range(cold_copies(dec_bytes))]
        cats = [(torch.cat([k, ek], 1), torch.cat([v, ev], 1))
                for k, v in caches]
        return ([lambda k=k, v=v: kdec.decode_attention(
                    q, k, v, lens, extra_k=ek, extra_v=ev)
                 for k, v in caches],
                [lambda k=k, v=v: sdpa(q, k, v, mask) for k, v in cats])

    cases = [(
        "decode_attention",
        f"B={b},C={cap},Hq={hq},Hkv={hkv},Dh={dh},sum_len={tot},self",
        lambda: kdec.decode_attention(q, kc, vc, lens, extra_k=ek,
                                      extra_v=ev),
        lambda: ref.decode_attention(q, kc, vc, lens, extra_k=ek,
                                     extra_v=ev),
        lambda: sdpa(q, k_cat, v_cat, mask),
        dec_bytes, 4 * (tot + b) * hq * dh, [], {"cold": k1_cold})]
    # K2: the same rows in a pool of NB blocks, at a seeded random
    # permutation of block ids; entries past each row's length are
    # sentinels (NB)
    perm = torch.randperm(nb, generator=gen, device="cuda")
    tab = perm.reshape(b, w).to(torch.int32)
    kp = torch.empty((nb, bs, hkv, dh), dtype=dtype, device="cuda")
    vp = torch.empty_like(kp)
    kp[tab.reshape(-1).long()] = kc.reshape(b * w, bs, hkv, dh)
    vp[tab.reshape(-1).long()] = vc.reshape(b * w, bs, hkv, dh)
    n_blk = (lens.long() + bs - 1) // bs
    tab[torch.arange(w, device="cuda")[None, :] >= n_blk[:, None]] = nb
    kg = torch.cat([ref.gather_kv_blocks(kp, tab), ek], 1)
    vg = torch.cat([ref.gather_kv_blocks(vp, tab), ev], 1)

    def k2_cold():
        pools = [(kp.clone(), vp.clone())
                 for _ in range(cold_copies(dec_bytes))]
        views = [(kg.clone(), vg.clone()) for _ in pools]
        return ([lambda k=k, v=v: kpdec.paged_decode_attention(
                    q, k, v, tab, lens, extra_k=ek, extra_v=ev)
                 for k, v in pools],
                [lambda k=k, v=v: sdpa(q, k, v, mask) for k, v in views])

    cases.append((
        "paged_decode_attention",
        f"B={b},C={cap},bs={bs},NB={nb},Hq={hq},Hkv={hkv},Dh={dh},"
        f"sum_len={tot},self,scattered",
        lambda: kpdec.paged_decode_attention(q, kp, vp, tab, lens,
                                             extra_k=ek, extra_v=ev),
        lambda: ref.paged_decode_attention(q, kp, vp, tab, lens,
                                           extra_k=ek, extra_v=ev),
        lambda: sdpa(q, kg, vg, mask),
        dec_bytes + 4 * tab.numel(), 4 * (tot + b) * hq * dh,
        # K1 on the dense copy of the same rows: bitwise equal
        [("K1_on_the_same_rows",
          lambda: kdec.decode_attention(q, kc, vc, lens, extra_k=ek,
                                        extra_v=ev))], {"cold": k2_cold}))
    return cases


def gathered_history(gen, kh, hist_len, bs=16, extra_w=2):
    """``kh``'s rows in a pool twice the size they need, at seeded
    scattered block ids, read back through block tables ``extra_w``
    blocks wider than the capacity (entries past each row's length are
    the sentinel): the dense view a paged chunk or verify dispatch
    gathers, longer than ``kh`` and holding other blocks' data past the
    lengths."""
    import torch
    from repro_torch.kernels import ref
    b, cap = kh.shape[:2]
    w = cap // bs + extra_w
    nb = 2 * b * w
    tab = torch.randperm(nb, generator=gen, device="cuda")[:b * w].reshape(
        b, w).to(torch.int32)
    pool = _rand(gen, (nb, bs, *kh.shape[2:]), kh.dtype)
    pool[tab[:, :cap // bs].reshape(-1).long()] = kh.reshape(
        -1, bs, *kh.shape[2:])
    n_blk = (hist_len.long() + bs - 1) // bs
    tab[torch.arange(w, device="cuda")[None, :] >= n_blk[:, None]] = nb
    return ref.gather_kv_blocks(pool, tab)


def prefill_cases(gen, dtype, dh, specs, cap=2048):
    """K4 at (case, B, S, Hq, Hkv, hist_len or None for ragged rows, one
    near capacity), each with two bitwise checks: a second run, and the
    history read through a block-table gather of a larger pool. Library
    yardstick: SDPA over history ++ self with a boolean mask, both built
    here, outside the timed call."""
    import torch
    from repro_torch.kernels import prefill_attention as kpre
    from repro_torch.kernels import ref
    elt = torch.tensor([], dtype=dtype).element_size()
    cases = []
    for case, bq, s, hq, hkv, hist in specs:
        q = _rand(gen, (bq, s, hq, dh), dtype)
        kh = _rand(gen, (bq, cap, hkv, dh), dtype)
        vh = _rand(gen, (bq, cap, hkv, dh), dtype)
        ks = _rand(gen, (bq, s, hkv, dh), dtype)
        vs = _rand(gen, (bq, s, hkv, dh), dtype)
        if hist is None:  # ragged per-row history, one row near capacity
            hl = torch.randint(1, cap - s + 1, (bq,), generator=gen,
                               device="cuda", dtype=torch.int32)
            hl[0] = cap - s
        else:
            hl = torch.tensor([hist], dtype=torch.int32, device="cuda")
        tot = int(hl.sum().item())
        pairs = tot * s + bq * s * (s + 1) // 2
        k_cat, v_cat = torch.cat([kh, ks], 1), torch.cat([vh, vs], 1)
        pos = torch.arange(cap + s, device="cuda")
        rel = torch.arange(s, device="cuda")
        mask = torch.where(pos[None, None, :] < cap,
                           pos[None, None, :] < hl[:, None, None],
                           pos[None, None, :] - cap <= rel[None, :, None])
        mask = mask[:, None]                        # (B, 1, S, C + S)
        kg, vg = gathered_history(gen, kh, hl), gathered_history(gen, vh, hl)
        shape = "tiles"  # the launch shape; for splits, how many are read
        if kpre.launch_plan(bq, s, cap, hq, dh, dtype).splits:
            shape = f"splits={sum(kpre.live_splits(hl, bq, cap))}"
        nbytes = ((2 * q.numel() + (2 * tot + 2 * bq * s) * hkv * dh) * elt
                  + 4 * bq)

        def make(q, kh, vh, ks, vs, hl=hl, m=mask):
            kc, vc = torch.cat([kh, ks], 1), torch.cat([vh, vs], 1)
            return (lambda: kpre.prefill_attention(q, kh, vh, hl, ks, vs),
                    lambda: sdpa(q, kc, vc, m))

        cases.append((
            "prefill_attention",
            f"{case},B={bq},S={s},C={cap},hist_len="
            f"{hist if hist is not None else 'ragged'},sum_hist={tot},"
            f"Hq={hq},Hkv={hkv},Dh={dh},{shape}",
            lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                kpre.prefill_attention(q, kh, vh, hl, ks, vs),
            lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                ref.prefill_attention(q, kh, vh, hl, ks, vs),
            lambda q=q, k=k_cat, v=v_cat, m=mask: sdpa(q, k, v, m),
            nbytes, 4 * pairs * hq * dh,
            [("second_run",
              lambda q=q, kh=kh, vh=vh, hl=hl, ks=ks, vs=vs:
                  kpre.prefill_attention(q, kh, vh, hl, ks, vs)),
             (f"block_table_gather_C={kg.shape[1]}",
              lambda q=q, kg=kg, vg=vg, hl=hl, ks=ks, vs=vs:
                  kpre.prefill_attention(q, kg, vg, hl, ks, vs))],
            {"cold": cold_of(nbytes, make, q, kh, vh, ks, vs)}))
    return cases


def cold_of(nbytes, make, *tensors):
    """A cold factory for ``_cold``: ``make(*copy)`` -> (kernel fn,
    library fn or None) on each of ``cold_copies(nbytes)`` copies of
    ``tensors``."""
    def cold():
        pairs = [make(*(t.clone() for t in tensors))
                 for _ in range(cold_copies(nbytes))]
        lib = [lf for _, lf in pairs]
        return [kf for kf, _ in pairs], None if None in lib else lib
    return cold


def add_rmsnorm_case(gen, m, d, xdt, adt, hdt):
    """K5 with the residual add at (m, d), (x, a, h) dtypes: (s, h)
    against the plain version; bitwise, torch's ``x + a`` and the kernel
    without the add on it; library: ``x + a`` then ``F.rms_norm`` (cast
    to h's dtype where it differs); the lone ``x + a`` as the launch
    floor; cold: copies of x, a and w. Bytes: x and a read, s and h
    written, w once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as krn
    x, a = _rand(gen, (m, d), xdt), _rand(gen, (m, d), adt)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(xdt)
    ex, ea, eh = (torch.tensor([], dtype=t).element_size()
                  for t in (xdt, adt, hdt))
    nbytes = m * d * (2 * ex + ea + eh) + d * ex

    def kern(x=x, a=a, w=w):
        return krn.add_rmsnorm(x, a, w, out_dtype=hdt)

    def lib(x=x, a=a, w=w):
        out = F.rms_norm(x + a, (d,), w, eps=1e-6)
        return out if hdt == xdt else out.to(hdt)

    names = ",".join(str(t).removeprefix("torch.") for t in (xdt, adt, hdt))
    return (
        "add_rmsnorm", f"M={m},d={d},x+a->h={names}", kern,
        lambda: ref.add_rmsnorm(x, a, w, out_dtype=hdt), lib,
        nbytes, 5 * m * d,
        [("x_plus_a_then_the_kernel_without_a",
          lambda: (x + a, krn.add_rmsnorm(x + a, None, w,
                                          out_dtype=hdt)[1]))],
        {"cold": cold_of(nbytes, lambda *c: (lambda: kern(*c),
                                              lambda: lib(*c)), x, a, w),
         "floor": lambda: x + a})


def kernel_cases(gen, dtype):
    """(name, case, kernel_fn, plain_fn, library_fn|None, bytes, flops,
    same[, opts]) at the paths' shapes for one dtype; ``same`` lists
    (label, fn) of kernel runs whose output must be bitwise equal to the
    first; ``opts`` may hold ``cold`` (a factory of round-robin kernel
    and library calls on copies beyond the L2), ``floor`` (the lone
    elementwise op a fused kernel absorbs)."""
    import torch
    import torch.nn.functional as F
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
        nbytes = (2 * m * d + d) * elt
        cases.append((
            "rmsnorm", f"M={m},d={d}",
            lambda x=x, w=w: krn.rmsnorm(x, w),
            lambda x=x, w=w: ref.rmsnorm(x, w),
            lambda x=x, w=w, d=d: F.rms_norm(x, (d,), w, eps=1e-6),
            nbytes, 4 * m * d, [],
            {"cold": cold_of(nbytes, lambda x, w, d=d: (
                lambda: krn.rmsnorm(x, w),
                lambda: F.rms_norm(x, (d,), w, eps=1e-6)), x, w)}))
    # the fused add: qwen's decode rows and its prefill bucket, in the
    # serving dtype (the float32 gates' in float32)
    for m in (8, 1024):
        cases.append(add_rmsnorm_case(gen, m, d, dtype, dtype, dtype))

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
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        cases.append((
            "flash_attention",
            f"B=1,S={s},Hq={hq},Hkv={hkv},Dh={dh},{case}",
            lambda q=q, k=k, v=v, w=window: kfa.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, w=window: ref.flash_attention(
                q, k, v, causal=True, window=w),
            lambda q=q, k=k, v=v, m=mask: sdpa(q, k, v, m),
            nbytes, 4 * pairs * hq * dh, [],
            {"cold": cold_of(nbytes, lambda q, k, v, w=window, m=mask: (
                lambda: kfa.flash_attention(q, k, v, causal=True, window=w),
                lambda: sdpa(q, k, v, m)), q, k, v)}))

    b, cap = 8, 2048
    for case, hq, hkv in (("mha", 16, 16), ("gqa", 8, 2)):
        cases += decode_cases(gen, dtype, b, cap, hq, hkv, dh)

    # K4: one chunk over a cached history, then a ragged verify (MHA and
    # GQA 8/2); then K3 at the qwen prefill's 1024-token bucket
    cases += prefill_cases(gen, dtype, dh, (("chunk", 1, 256, 16, 16, 768),
                                            ("chunk,gqa", 1, 256, 8, 2, 768),
                                            ("verify", 8, 5, 16, 16, None),
                                            ("verify,gqa", 8, 5, 8, 2, None)))
    s, hq = 1024, 16
    q, k, v = (_rand(gen, (1, s, hq, dh), dtype) for _ in range(3))
    cases.append((
        "flash_attention", f"B=1,S={s},Hq={hq},Hkv={hq},Dh={dh},causal",
        lambda: kfa.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention(q, k, v, causal=True),
        lambda: sdpa(q, k, v),
        4 * q.numel() * elt, 4 * (s * (s + 1) // 2) * hq * dh, [],
        {"cold": cold_of(4 * q.numel() * elt, lambda q, k, v: (
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(q, k, v)), q, k, v)}))
    return cases


def int4pack_library(x, packed, scales, group):
    """PyTorch's int4 weight-only GEMM (``aten._weight_int4pack_mm``)
    on the same weight as a library yardstick: repacked here, outside
    the timed call, into its (N, K/2) uint8 input — unsigned nibbles
    q = v + 8, even k in the high nibble — which it dequantizes as
    (q - 8) * scale + zero, with zero = 0 and the scales rounded to
    bf16. Returns (fn, note), or (None, why) when the installed PyTorch
    refuses the shape or disagrees with the plain version."""
    import torch
    from repro_torch.kernels import ref
    q = ref.unpack_int4(packed).t().to(torch.int32) + 8          # (N, K)
    w_u8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
    sz = torch.stack([scales, torch.zeros_like(scales)], -1).to(
        torch.bfloat16).contiguous()                         # (K/g, N, 2)
    try:
        w4d = torch.ops.aten._convert_weight_to_int4pack(w_u8, 8)
        got = torch.ops.aten._weight_int4pack_mm(x, w4d, group, sz).float()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        return None, f"refused: {str(e).splitlines()[0][:120]}"
    want = ref.quant_gemv(x, packed, scales, group=group).float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=TOL["bfloat16"],
                          rtol=TOL["bfloat16"]):
        return None, ("disagrees with the plain version: "
                      f"max_abs_err={err:.3e}")
    return (lambda: torch.ops.aten._weight_int4pack_mm(x, w4d, group, sz)
            ), f"max_abs_err={err:.3e}"


# K6 at the W4 path's projection shapes of phi3-mini-3.8b (d 3072,
# d_ff 8192), then B=8, group 64 and a ragged column tile
QUANT_SHAPES = (("w_gate", 1, 3072, 8192, 128),
                ("w_down", 1, 8192, 3072, 128),
                ("wq", 1, 3072, 3072, 128),
                ("w_gate", 8, 3072, 8192, 128),
                ("w_gate", 1, 3072, 8192, 64),
                ("ragged_N", 1, 3072, 3000, 128))


def w4_path_cases(gen, dtype):
    """The W4 path's kernels and phi3-mini's serving shapes (its own
    generator, so the earlier cases' inputs stay as they were): K6 at
    ``QUANT_SHAPES``; K3, K1 (with K2 bitwise K1) and K4 chunk and verify
    at phi3-mini's head dim 96 and 32 heads."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import quant_gemv as kqg
    from repro_torch.kernels import ref
    elt = torch.tensor([], dtype=dtype).element_size()
    dname = str(dtype).removeprefix("torch.")
    cases = []
    for label, b, k, n, group in QUANT_SHAPES:
        case = f"{label},B={b},K={k},N={n},group={group}"
        x = _rand(gen, (b, k), dtype)
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        packed, scales = ref.quantize_int4(w, group=group)
        lib = None
        if dtype == torch.bfloat16:
            lib, note = int4pack_library(x, packed, scales, group)
            w_deq = (ref.unpack_int4(packed).float()
                     * scales.repeat_interleave(group, 0)).to(dtype)
            log("kernels", kernel="quant_gemv", case=case, dtype=dname,
                library="aten._weight_int4pack_mm", library_note=note,
                w16_matmul_ms=f"{time_ms(lambda: x @ w_deq):.4f}")
            del w_deq
        nbytes = k * n // 2 + 4 * (k // group) * n + (b * k + b * n) * elt

        def cold(x=x, packed=packed, scales=scales, group=group,
                 nbytes=nbytes, lib=lib):
            ws = [(packed.clone(), scales.clone())
                  for _ in range(cold_copies(nbytes))]
            libs = None
            if lib is not None:
                libs = [int4pack_library(x, p, s, group)[0] for p, s in ws]
                libs = None if None in libs else libs
            return ([lambda p=p, s=s: kqg.quant_gemv(x, p, s, group=group)
                     for p, s in ws], libs)

        cases.append((
            "quant_gemv", case,
            lambda x=x, p=packed, s=scales, g=group: kqg.quant_gemv(
                x, p, s, group=g),
            lambda x=x, p=packed, s=scales, g=group: ref.quant_gemv(
                x, p, s, group=g),
            lib, nbytes, 2 * b * k * n, [], {"cold": cold}))

    s, h, dh = 512, 32, 96
    q = _rand(gen, (1, s, h, dh), dtype)
    k = _rand(gen, (1, s, h, dh), dtype)
    v = _rand(gen, (1, s, h, dh), dtype)
    cases.append((
        "flash_attention", f"B=1,S={s},Hq={h},Hkv={h},Dh={dh},causal",
        lambda: kfa.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention(q, k, v, causal=True),
        lambda: sdpa(q, k, v),
        4 * q.numel() * elt, 4 * (s * (s + 1) // 2) * h * dh, [],
        {"cold": cold_of(4 * q.numel() * elt, lambda q, k, v: (
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: sdpa(q, k, v)), q, k, v)}))
    if dtype == torch.float32:
        # K5 at the W4 step's norm: float32 residual, K6's bf16 output
        # added, bf16 h for K6
        cases.append(add_rmsnorm_case(gen, 1, 3072, torch.float32,
                                      torch.bfloat16, torch.bfloat16))
    cases += decode_cases(gen, dtype, 8, 2048, h, h, dh)
    # K1 and K2 at the W4 step's call: one row, 512 of 1024 positions
    cases += decode_cases(gen, dtype, 1, 1024, h, h, dh, first_len=512)
    # K4 at phi3-mini's head dim: its chunked-prefill and verify shapes
    cases += prefill_cases(gen, dtype, dh, (("chunk", 1, 256, h, h, 768),
                                            ("verify", 8, 5, h, h, None)))
    return cases


def families_cases(gen, dtype):
    """Phase 7's attention shapes (its own generator): head dim 128,
    GQA 48/8 (internvl2-26b, dbrx-132b: G 6) and MHA 16/16
    (deepseek-moe-16b). K1 and K2 over 8 slots at capacity 2048; K4's
    verify window (gamma 4), its 256-token chunk over a history and
    internvl2's first chunk (256 image positions + 256 tokens, no
    history); K3 at the vlm buckets after the 256-row image prefix
    (S = 256 + 32, 256 + 1024), dbrx's 512-token prefill and
    deepseek's 1024-token bucket."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    elt = torch.tensor([], dtype=dtype).element_size()
    dh = 128
    cases = []
    for hq, hkv in ((48, 8), (16, 16)):
        cases += decode_cases(gen, dtype, 8, 2048, hq, hkv, dh)
    cases += prefill_cases(gen, dtype, dh, (
        ("verify,g6", 8, 5, 48, 8, None),
        ("verify,mha", 8, 5, 16, 16, None),
        ("chunk,g6", 1, 256, 48, 8, 768),
        ("chunk,g6,image_prefix", 1, 512, 48, 8, 0)))
    for s, hq, hkv in ((288, 48, 8), (1280, 48, 8), (512, 48, 8),
                       (1024, 16, 16)):
        q = _rand(gen, (1, s, hq, dh), dtype)
        k = _rand(gen, (1, s, hkv, dh), dtype)
        v = _rand(gen, (1, s, hkv, dh), dtype)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        cases.append((
            "flash_attention", f"B=1,S={s},Hq={hq},Hkv={hkv},Dh={dh},causal",
            lambda q=q, k=k, v=v: kfa.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: ref.flash_attention(q, k, v, causal=True),
            lambda q=q, k=k, v=v: sdpa(q, k, v),
            nbytes, 4 * (s * (s + 1) // 2) * hq * dh, [],
            {"cold": cold_of(nbytes, lambda q, k, v: (
                lambda: kfa.flash_attention(q, k, v, causal=True),
                lambda: sdpa(q, k, v)), q, k, v)}))
    return cases


def phase_kernels() -> dict:
    """Every kernel vs its plain version, both dtypes. Returns, per
    kernel, the bf16 numbers at its first (main-path) shape and the
    largest error seen."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen_w4 = torch.Generator(device="cuda").manual_seed(SEED + 13)
    gen_fam = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name, case, kfn, pfn, lfn, nbytes, flops, same, *opts in (
                kernel_cases(gen, dtype) + w4_path_cases(gen_w4, dtype)
                + families_cases(gen_fam, dtype)):
            opts = opts[0] if opts else {}
            got, want = kfn(), pfn()
            torch.cuda.synchronize()
            for label, fn in same:
                equal = _equal(got, fn())
                log("kernels", kernel=name, case=case, dtype=dname,
                    bitwise_equal=equal, against=label)
                if not equal:
                    raise AssertionError(f"{name} {case} {dname}: not "
                                         f"bitwise equal to {label}")
            res = _compare(
                name, case, dname, got, want, ms=time_ms(kfn),
                plain_ms=time_ms(pfn),
                lib_ms=None if lfn is None else time_ms(lfn),
                dev_ms=device_ms(kfn),
                lib_dev_ms=None if lfn is None else device_ms(lfn),
                nbytes=nbytes, flops=flops)
            if "cold" in opts:
                res.update(_cold(name, case, dname, *opts["cold"]()))
            if "floor" in opts:
                res.update(floor_ms=time_ms(opts["floor"]),
                           floor_device_ms=device_ms(opts["floor"]))
                log("kernels", kernel=name, case=case, dtype=dname,
                    floor_ms=res["floor_ms"],
                    floor_device_ms=res["floor_device_ms"])
            row = rows.setdefault(name, {"max_abs_err": 0.0, "cases": []})
            row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
            row["cases"].append({"case": case, "dtype": dname, **res})
            if dname == "bfloat16" and "ms" not in row:
                row.update({k: v for k, v in res.items()
                            if k != "max_abs_err"}, case=case)
    log("kernels", device_time_misses=device_misses,
        device_time_tries=DEVICE_TRIES)
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
    # ops.rmsnorm goes through ops.add_rmsnorm
    names = ("add_rmsnorm", "flash_attention", "decode_attention",
             "paged_decode_attention", "prefill_attention", "quant_gemv")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def routes(replay=None):
    """The experts each MoE routing call picks, in call order: recorded
    (``replay`` None; yields the list of (N, k) ids), or replayed from
    ``replay`` — the weights are then this run's own router
    probabilities at the recorded experts, renormalised, and the yielded
    list counts, per call, the tokens whose expert set this run's own
    routing would have changed. A bf16 comparison of kernels against
    their plain versions replays the kernel run's routes: the plain
    run's rounding moves a near-tie of the top-k to another expert now
    and then, a discrete jump that says nothing of the kernels (this
    script's comparison only)."""
    import torch
    from repro_torch.models import moe as M
    route = M.route
    seen = []

    def recording(router_w, x, top_k):
        w, ids = route(router_w, x, top_k)
        seen.append(ids)
        return w, ids

    def replaying(router_w, x, top_k):
        _, own = route(router_w, x, top_k)
        ids = replay[len(seen)]
        seen.append((own.sort(-1).values != ids.sort(-1).values)
                    .any(-1).sum())
        w = torch.softmax(x.float() @ router_w, dim=-1).gather(1, ids)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids

    M.route = recording if replay is None else replaying
    try:
        yield seen
    finally:
        M.route = route


def route_flips(seen) -> int:
    return int(sum(int(n) for n in seen))


@contextlib.contextmanager
def nudged_moe_inputs(seed=SEED):
    """Every MoE layer's input moved by one ulp of its dtype, away from
    or toward zero at a seeded random choice per element (zeros stay):
    rounding noise of the size a kernel's differs from its plain
    version's, put in at every MoE layer (this script's measurement
    only)."""
    import torch
    from repro_torch.models import moe as M
    apply_moe = M.apply_moe
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}

    def nudged(p, cfg, x):
        up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        bits = x.contiguous().view(ints[x.dtype])
        moved = (bits + torch.where(up, 1, -1).to(bits.dtype)).view(x.dtype)
        return apply_moe(p, cfg, torch.where(x == 0, x, moved))

    M.apply_moe = nudged
    try:
        yield
    finally:
        M.apply_moe = apply_moe


# the kernels' routing flips against the plain versions' may be at most
# this many times those of the plain path under one-ulp noise at every
# MoE input (:func:`nudged_moe_inputs`)
FLIP_WITNESS_FACTOR = 2


def flip_gate(phase, picked, flips, run) -> None:
    """``picked``: the kernel run's experts per routing call; ``flips``:
    per call, the tokens whose experts the plain run's own routing moves
    while it replays them. The witness: ``run()`` through the plain
    versions, recording its experts, then again under one-ulp noise
    (:func:`nudged_moe_inputs`) replaying them. Fails past
    ``FLIP_WITNESS_FACTOR`` times the witness's flips."""
    with plain_kernels(), routes() as base:
        run()
    with plain_kernels(), nudged_moe_inputs(), routes(replay=base) as seen:
        run()
    routed = sum(int(i.shape[0]) for i in picked)
    flips, witness = route_flips(flips), route_flips(seen)
    log(phase, routing_calls=len(picked), routed_tokens=routed,
        route_flips_kernels_vs_plain=flips,
        route_flips_plain_vs_plain_one_ulp=witness,
        flip_share=f"{flips / routed:.4f}",
        witness_share=f"{witness / routed:.4f}",
        limit=f"{FLIP_WITNESS_FACTOR} x witness",
        note="each plain run replays the first run's experts")
    if flips > FLIP_WITNESS_FACTOR * witness:
        raise AssertionError(
            f"{phase}: the kernels move {flips} of {routed} routes against "
            f"the plain versions, more than {FLIP_WITNESS_FACTOR} x the "
            f"{witness} that one-ulp noise moves in the plain path")


def model_batch(toks, images=None) -> dict:
    batch = {"tokens": toks}
    if images is not None:
        batch["images"] = images
    return batch


def straight_line_generate(params, cfg, prompt, n_new, capacity):
    """Batch-1 prefill + greedy decode_step loop (the engine's oracle),
    after the engine's zero image prefix on a vlm."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import stub_images
    toks = torch.as_tensor(prompt[None, :], device="cuda")
    logits, cache = MD.prefill(params, cfg,
                               model_batch(toks, stub_images(cfg, "cuda")),
                               capacity)
    cur = torch.argmax(logits, -1)[:, None]
    out = [int(cur[0, 0])]
    for _ in range(n_new - 1):
        logits, cache = MD.decode_step(params, cfg, cur, cache)
        cur = torch.argmax(logits, -1)[:, None]
        out.append(int(cur[0, 0]))
    return out


def check_launches(phase, eng, counts) -> None:
    """Every kernel of the path ran, exactly as often as the path says.
    Target model (L layers): 2L + 1 RMSNorms per dispatch, L flash
    prefills per blocking prefill, L split-KV decodes (contiguous) or L
    paged decodes per decode step, L prefill-over-cache launches per
    chunk and per verify dispatch. Draft (k layers): 2k + 1 RMSNorms per
    dispatch, k flash prefills per draft prefill, k split-KV decodes per
    draft decode (its shadow cache is contiguous)."""
    s = eng.summary()
    n = eng.cfg.n_layers
    k = eng.draft_cfg.n_layers if eng.draft_cfg is not None else 0
    decodes = s["decode_dispatches"] - s["verify_dispatches"]
    draft_decodes = s["draft_dispatches"] - s["draft_prefills"]
    over_cache = s["prefill_chunk_dispatches"] + s["verify_dispatches"]
    paged = s["kv_cache"] == "paged"
    want = {
        "rmsnorm": ((2 * n + 1) * (s["prefills"] + s["decode_dispatches"]
                                   + s["prefill_chunk_dispatches"])
                    + (2 * k + 1) * s["draft_dispatches"]),
        "flash_attention": n * s["prefills"] + k * s["draft_prefills"],
        "decode_attention": (0 if paged else n * decodes) + k * draft_decodes,
        "paged_decode_attention": n * decodes if paged else 0,
        "prefill_attention": n * over_cache,
        "quant_gemv": 0,
    }
    # the kernels this path must have launched at least once
    path = {"rmsnorm",
            "flash_attention" if s["prefills"] else "prefill_attention"}
    if s["prefill_chunk_dispatches"]:   # chunks and warm prefix admissions
        path.add("prefill_attention")
    if s["scheduler"] == "speculative":
        path |= {"decode_attention", "prefill_attention"}
    else:
        path.add("paged_decode_attention" if paged else "decode_attention")
    log(phase, launches=json.dumps(counts), expected=json.dumps(want),
        path=",".join(sorted(path)))
    if counts != want or not all(counts[name] for name in path):
        raise AssertionError(f"{phase}: kernel launches {counts} != {want} "
                             f"or a kernel of {sorted(path)} never ran")


def run_engine(params, cfg, prompts, max_new, **ecfg):
    """Serve ``prompts`` on a fresh engine; returns (engine, counts) with
    the launch counts of exactly this run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(params, cfg, EngineConfig(
        max_batch=8, max_seq_len=2048, max_new_tokens=max_new, **ecfg))
    for p in prompts:
        eng.submit(p)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    return eng, ops.launch_counts()


# engine configurations (EngineConfig fields) held to contiguous +
# blocking in the float32 gate; phase 4 serves the paged ones in bf16
CHUNK_TOKENS = 256
CHUNKED = {"scheduler": "chunked", "chunk_tokens": CHUNK_TOKENS}
SPECULATIVE = {"scheduler": "speculative", "spec_gamma": 4}
GATE_CONFIGS = {
    "paged+blocking": {"kv_cache": "paged"},
    "contiguous+chunked": CHUNKED,
    "paged+chunked": {"kv_cache": "paged", **CHUNKED},
    "contiguous+speculative": SPECULATIVE,
    "paged+speculative": {"kv_cache": "paged", **SPECULATIVE},
}


def _check_engine(phase, eng, counts, n_requests):
    s = eng.summary()
    check_launches(phase, eng, counts)
    if s["decode_dispatches"] != s["decode_steps"]:
        raise AssertionError(f"{phase}: target dispatches "
                             f"{s['decode_dispatches']} != steps "
                             f"{s['decode_steps']}")
    if s["requests"] != n_requests:
        raise AssertionError(f"{phase}: {s['requests']} of {n_requests} "
                             "requests finished")
    if s["kv_cache"] == "paged":
        target_peak = s["peak_resident_kv_bytes"] - s["draft_kv_bytes"]
        if not target_peak < s["contiguous_kv_bytes"]:
            raise AssertionError(f"{phase}: paged peak {target_peak} B not "
                                 f"below {s['contiguous_kv_bytes']} B")
    return s


def stream_gates(phase, params, cfg, prompts, label_extra=None,
                 total=None) -> None:
    """contiguous + blocking == the batch-1 prefill + decode_step loop,
    then every GATE_CONFIGS run == contiguous + blocking (16 new tokens
    each); each engine run's launches go into ``total`` where given."""
    import torch
    extra = label_extra or {}
    total = {} if total is None else total
    eng, counts = run_engine(params, cfg, prompts, 16)
    s = _check_engine(phase, eng, counts, len(prompts))
    _add(total, counts)
    base = {r.rid: r.output for r in eng.finished}
    for i, p in enumerate(prompts):
        want = straight_line_generate(params, cfg, p, 16, 2048)
        log(phase, **extra, request=i, prompt_len=len(p),
            equal=base[i] == want, tokens=base[i][:8])
        if base[i] != want:
            raise AssertionError(f"{phase} request {i}: engine {base[i]} "
                                 f"!= straight-line {want}")
    log(phase, **extra, config="contiguous+blocking", requests=s["requests"],
        tokens=s["tokens"], decode_dispatches=s["decode_dispatches"],
        decode_steps=s["decode_steps"], prefills=s["prefills"],
        streams_equal=True)
    del eng
    for label, kw in GATE_CONFIGS.items():
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 16, **kw)
        s = _check_engine(f"{phase} {label}", eng, counts, len(prompts))
        _add(total, counts)
        got = {r.rid: r.output for r in eng.finished}
        log(phase, **extra, config=label, streams_equal=got == base,
            decode_dispatches=s["decode_dispatches"],
            decode_steps=s["decode_steps"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            draft_dispatches=s["draft_dispatches"],
            accepted_per_step=f"{s['accepted_tokens_per_step']:.3f}",
            peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
            contiguous_kv_bytes=s["contiguous_kv_bytes"])
        if got != base:
            raise AssertionError(f"{phase} {label}: streams {got} != "
                                 f"contiguous blocking {base}")
        del eng


def gate_prompts(cfg):
    """Phase 3's traffic: 4 seeded prompts of 17–1000 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (17, 200, 511, 1000)]


def phase_engine_f32() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH).replace(dtype="float32")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    stream_gates("engine_f32", params, cfg, gate_prompts(cfg))


def _first_logits(params, cfg, prompt, chunk, images=None):
    """The prompt's logits through bucketed prefill and through chunked
    prefill over a one-slot contiguous cache (the engine's route); a
    vlm's ``images`` go before the prompt, in the first chunk."""
    import numpy as np
    import torch
    from repro_torch.models import model as MD
    n = len(prompt)
    pre = 0 if images is None else images.shape[1]
    nb = 16
    while nb < n:
        nb *= 2
    toks = np.zeros((1, nb), np.int32)
    toks[0, :n] = prompt
    whole, _ = MD.prefill(
        params, cfg, model_batch(torch.as_tensor(toks, device="cuda"), images),
        None, logit_index=pre + n - 1)
    cache = MD.init_cache(cfg, 1, 2048, device="cuda")
    done = 0
    while done < n:
        m = min(chunk, n - done)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :m] = prompt[done:done + m]
        first = done == 0 and images is not None
        at = done + (pre if done else 0)     # the chunk's first position
        rows = m + (pre if first else 0)
        logits, ks, vs = MD.prefill_chunk(
            params, cfg,
            model_batch(torch.as_tensor(toks, device="cuda"),
                        images if first else None),
            cache["k"], cache["v"], at, logit_index=rows - 1)
        cache["k"][:, :, at:at + rows] = ks[:, :, :rows]
        cache["v"][:, :, at:at + rows] = vs[:, :, :rows]
        done += m
    return whole, logits


def logit_gates(phase, params, cfg, prompt, images=None) -> None:
    """The first prefill's logits, whole and chunked, through the kernels
    against the plain versions: normwise <= 3e-2, same argmax. An MoE
    model's plain run takes the kernel run's routes (:func:`routes`),
    and the tokens whose experts its own routing would have moved are
    held to :func:`flip_gate`."""
    def first():
        return _first_logits(params, cfg, prompt, CHUNK_TOKENS, images)

    with routes() as picked:
        got = first()
    with plain_kernels(), routes(replay=picked) as flips:
        want = first()
    for what, g, w in (("prefill", got[0], want[0]),
                       ("chunked_prefill", got[1], want[1])):
        _logit_gate(f"{phase} {what}", g, w)
        log(phase, logits=what, prompt_len=len(prompt),
            image_prefix=0 if images is None else images.shape[1],
            chunk=CHUNK_TOKENS,
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            rel_err=f"{((g - w).norm() / w.norm()).item():.3e}",
            tol=TOL["bfloat16"], argmax_equal=True)
    if picked:
        flip_gate(phase, picked, flips, first)


def serve_prompts(cfg):
    """Phase 4's traffic: 16 seeded prompts of 32–1024 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in rng.integers(32, 1025, size=16)]


def serve_bf16(phase, params, cfg, prompts, card, total) -> None:
    """The 16 requests (64 new tokens each) on contiguous + blocking,
    paged + chunked and paged + speculative, each checked (launches,
    dispatches, requests, paged KV) and reported; adds the launches to
    ``total``."""
    import torch
    run_engine(params, cfg, prompts[:2], 4)  # warm-up (allocator, cuBLAS)
    for label in ("contiguous+blocking", "paged+chunked",
                  "paged+speculative"):
        kw = GATE_CONFIGS.get(label, {})
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 64, **kw)
        s = _check_engine(f"{phase} {label}", eng, counts, 16)
        for r in eng.finished:
            if len(r.output) != 64:
                raise AssertionError(f"{phase} {label} request {r.rid}: "
                                     f"{len(r.output)} tokens")
        log(phase, config=label, requests=s["requests"],
            tokens=s["tokens"], tok_per_s=f"{s['tokens_per_s']:.1f}",
            ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.1f}",
            ttft_p99_ms=f"{s['ttft_p99_s'] * 1e3:.1f}",
            itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
            itl_p99_ms=f"{s['itl_p99_s'] * 1e3:.2f}",
            decode_steps=s["decode_steps"], prefills=s["prefills"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            verify_dispatches=s["verify_dispatches"],
            draft_dispatches=s["draft_dispatches"],
            acceptance=f"{s['accepted_tokens_per_step']:.3f}",
            peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
            draft_kv_bytes=s["draft_kv_bytes"],
            contiguous_kv_bytes=s["contiguous_kv_bytes"],
            launches=json.dumps(counts), card=f"'{card}'")
        _add(total, counts)
        del eng


def phase_engine_bf16(card: str) -> dict:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(ARCH)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{ARCH} serves in {cfg.dtype}, not bfloat16")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    prompts = serve_prompts(cfg)
    # the first prefill, whole and chunked, through the kernels and
    # through the plain versions
    logit_gates("engine_bf16", params, cfg, prompts[0])
    total: dict = {}
    serve_bf16("engine_bf16", params, cfg, prompts, card, total)
    return total


# ---------------------------------------------------------------------------
# phase 5: the W4A16 mobile decode path at full width
# ---------------------------------------------------------------------------

W4_ARCH = "phi3-mini-3.8b"
W4_GROUP = 128
W4_PROMPT = 512
W4_CAPACITY = 1024
W4_STEPS = 16


def _logit_gate(what, got, want) -> float:
    """Normwise relative error of ``got`` against ``want`` within the
    bf16 tolerance, and the same argmax in every row."""
    import torch
    rel = ((got - want).norm() / want.norm()).item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not (rel <= TOL["bfloat16"] and same):
        raise AssertionError(f"{what}: relative error {rel:.3e} (tolerance "
                             f"{TOL['bfloat16']}), argmax equal {same}")
    return rel


def phase_w4(card: str) -> dict:
    """Full-width phi3-mini-3.8b in bf16 (seeded weights), every
    projection quantized to int4 at group 128: a 512-token prefill at
    capacity 1024, then 16 teacher-forced steps of the W16
    ``decode_step`` beside ``w4_decode_step``, through
    ``examples/torch_w4_mobile_decode.py``. Gates: the prefill logits
    and every W4 step's logits against the same run through the plain
    versions, and the exact launches of each W4 step. Returns the launch
    counts of the prefill and the teacher-forced run."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO / "examples"))
    import torch_w4_mobile_decode as tw4
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    from repro_torch.models import w4
    cfg = registry.get_config(W4_ARCH)
    if cfg.dtype != "bfloat16" or cfg.d_head != 96:
        raise AssertionError(f"{W4_ARCH}: dtype {cfg.dtype}, Dh "
                             f"{cfg.d_head}; expected bfloat16 and 96")
    n = cfg.n_layers
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    t0 = time.perf_counter()
    qp = w4.quantize_params(params, W4_GROUP)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    packed = scales = dense = 0
    for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_up", "w_down"))):
        for name in names:
            packed += qp["layers"][sub][name]["packed"].numel()
            scales += qp["layers"][sub][name]["scales"].numel() * 4
            dense += params["layers"][sub][name].numel() * 2
    log("w4", arch=W4_ARCH, layers=n, d_model=cfg.d_model,
        heads=cfg.n_heads, d_head=cfg.d_head, d_ff=cfg.d_ff,
        vocab=cfg.vocab_size, group=W4_GROUP, quantize_s=f"{quant_s:.1f}",
        packed_bytes=packed, scale_bytes=scales, bf16_proj_bytes=dense,
        proj_byte_ratio=f"{dense / (packed + scales):.3f}")

    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(1, W4_PROMPT)),
        dtype=torch.int32, device="cuda")
    batch = {"tokens": prompt}
    with plain_kernels():
        want, _ = MD.prefill(params, cfg, batch, None)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits, cache = MD.prefill(params, cfg, batch, W4_CAPACITY)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    want_prefill = {k: 0 for k in total} | {"flash_attention": n,
                                            "rmsnorm": 2 * n + 1}
    if total != want_prefill:
        raise AssertionError(f"w4 prefill launches {total} != "
                             f"{want_prefill}")
    rel = _logit_gate("w4 bf16 prefill logits", logits, want)
    log("w4", logits="prefill", prompt_len=W4_PROMPT, rel_err=f"{rel:.3e}",
        tol=TOL["bfloat16"], argmax_equal=True,
        launches=json.dumps(total))

    tw4.teacher_forced(params, qp, cfg, logits, cache, 2, W4_GROUP)  # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = tw4.teacher_forced(params, qp, cfg, logits, cache, W4_STEPS,
                             W4_GROUP)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    per_step = {k: 0 for k in counts} | {"quant_gemv": 7 * n,
                                         "rmsnorm": 2 * n + 1,
                                         "decode_attention": n}
    want_run = {k: 0 for k in counts} | {
        "quant_gemv": 7 * n * W4_STEPS,
        "rmsnorm": (2 * n + 1) * 2 * W4_STEPS,
        "decode_attention": n * 2 * W4_STEPS}
    log("w4", launches=json.dumps(counts), expected=json.dumps(want_run),
        per_w4_step=json.dumps(res["w4_launches"][0]),
        expected_per_w4_step=json.dumps(per_step))
    if counts != want_run or any(c != per_step for c in res["w4_launches"]):
        raise AssertionError(f"w4: launches {counts} != {want_run}, or a "
                             f"W4 step's launches != {per_step}")
    with plain_kernels():
        plain = tw4.teacher_forced(params, qp, cfg, logits, cache, W4_STEPS,
                                   W4_GROUP, tokens=res["tokens"])
    corr, mad = [], []
    for i in range(W4_STEPS):
        c, m = tw4.fidelity(res["w16"][i], res["w4"][i])
        corr.append(c)
        mad.append(m)
        rel = _logit_gate(f"w4 step {i} logits", res["w4"][i],
                          plain["w4"][i])
        rel16 = ((res["w16"][i] - plain["w16"][i]).norm()
                 / plain["w16"][i].norm()).item()
        log("w4", step=i, token=int(res["tokens"][i][0, 0]),
            corr=f"{c:.4f}", max_abs_dlogprob=f"{m:.4f}",
            w16_ms=f"{res['w16_ms'][i]:.2f}", w4_ms=f"{res['w4_ms'][i]:.2f}",
            w4_vs_plain_rel_err=f"{rel:.3e}",
            w16_vs_plain_rel_err=f"{rel16:.3e}")
    log("w4", steps=W4_STEPS, min_corr=f"{min(corr):.4f}",
        max_abs_dlogprob=f"{max(mad):.4f}",
        w16_ms_median=f"{statistics.median(res['w16_ms']):.2f}",
        w4_ms_median=f"{statistics.median(res['w4_ms']):.2f}",
        w4_plain_ms_median=f"{statistics.median(plain['w4_ms']):.2f}",
        tol=TOL["bfloat16"], card=f"'{card}'")
    for name, c in counts.items():
        total[name] += c
    return total


# ---------------------------------------------------------------------------
# phase 6: the serving engine's request surface at full width
# ---------------------------------------------------------------------------

QUANTUM = 0.01          # virtual seconds per engine step (trace replay)
CHAT_TTFT_SLO = 0.04    # the overload trace's chat TTFT target
PREAMBLE = 512          # shared-prefix run: 32 blocks of 16
BS = 16


def counted(fn):
    """(fn(), the kernel launches fn made), the counts reset just before
    and read just after."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def _add(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def _engine(params, cfg, telemetry=None, **kw):
    from repro_torch.serving import EngineConfig, ServingEngine
    kw.setdefault("eos_token", -1)
    return ServingEngine(params, cfg, EngineConfig(**kw),
                         telemetry=telemetry)


def _outputs(eng) -> dict:
    return {r.rid: r.output for r in eng.finished}


def _pool_balanced(what, kv) -> None:
    """Every alias released, every block free or a resident shared one."""
    if kv.name != "paged":
        return
    prefix = kv.prefix
    shared = prefix.resident_blocks if prefix is not None else 0
    refs = list(prefix._refs.values()) if prefix is not None else []
    if (any(refs) or kv.allocator.allocated_blocks != shared
            or kv.allocator.free_blocks + shared != kv.allocator.num_blocks
            or kv._reserved.any()):
        raise AssertionError(
            f"{what}: pool unbalanced — free {kv.allocator.free_blocks} + "
            f"shared {shared} vs {kv.allocator.num_blocks} blocks, "
            f"allocated {kv.allocator.allocated_blocks}, refcounts "
            f"{sorted(set(refs))}, reserved {int(kv._reserved.sum())}")


def _shared_blocks(a, b, bs=BS) -> int:
    """Leading 16-token blocks of ``a`` equal to ``b``'s, capped where
    the prefix index caps a match of ``a`` against registered ``b``."""
    n = min((len(a) - 1) // bs, len(b) // bs)
    k = 0
    while k < n and (a[k * bs:(k + 1) * bs] == b[k * bs:(k + 1) * bs]).all():
        k += 1
    return k


def slo_runs(params, cfg, total) -> dict:
    """The overload trace under FIFO (blocking) and SLO on both backends,
    max_batch 4, capacity 96 (the reference test's engine)."""
    from repro_torch.serving.workload import make_named_trace, replay
    tr = make_named_trace("overload", vocab_size=cfg.vocab_size, seed=SEED)
    reps = {}
    for kv in ("paged", "contiguous"):
        for sched in ("blocking", "slo"):
            eng = _engine(params, cfg, max_batch=4, max_seq_len=96,
                          max_new_tokens=16, scheduler=sched, kv_cache=kv)
            rep, counts = counted(lambda: replay(eng, tr,
                                                 step_quantum_s=QUANTUM))
            check_launches(f"request_surface slo {kv}+{sched}", eng, counts)
            _pool_balanced(f"overload {kv}+{sched}", eng.kv)
            _add(total, counts)
            reps[kv, sched] = rep
            s = rep["summary"]
            chat = s["by_tenant"]["chat"]
            log("request_surface", run=f"overload {kv}+{sched}",
                requests=len(tr), steps=rep["steps"], tokens=rep["tokens"],
                preemptions=s["preemptions"],
                preempted_kv_bytes=s["preempted_kv_bytes"],
                chat_ttft_p99_s=f"{chat['ttft_p99_s']:.4f}",
                chat_slo_attainment=f"{chat['slo_attainment']:.3f}",
                tokens_per_step=f"{rep['tokens'] / rep['steps']:.4f}")
    base = reps["contiguous", "blocking"]["outputs"]
    for kv in ("paged", "contiguous"):
        fifo, slo = reps[kv, "blocking"], reps[kv, "slo"]
        ratio = ((slo["tokens"] / slo["steps"])
                 / (fifo["tokens"] / fifo["steps"]))
        p99 = (slo["summary"]["by_tenant"]["chat"]["ttft_p99_s"],
               fifo["summary"]["by_tenant"]["chat"]["ttft_p99_s"])
        log("request_surface", gate=f"slo {kv}",
            slo_streams_equal_fifo=slo["outputs"] == fifo["outputs"],
            equal_contiguous_fifo=fifo["outputs"] == base,
            preemptions=slo["summary"]["preemptions"],
            chat_p99_slo_fifo=f"{p99[0]:.4f},{p99[1]:.4f}",
            throughput_ratio=f"{ratio:.4f}")
        if not (slo["outputs"] == fifo["outputs"] == base
                and slo["summary"]["preemptions"] >= 1
                and len(slo["preemption_log"])
                == slo["summary"]["preemptions"]
                and p99[0] <= CHAT_TTFT_SLO < p99[1] and ratio >= 0.95):
            raise AssertionError(f"SLO gate on {kv}: streams equal "
                                 f"{slo['outputs'] == fifo['outputs']}, "
                                 f"preemptions "
                                 f"{slo['summary']['preemptions']}, chat "
                                 f"p99 {p99}, throughput ratio {ratio}")
    return reps


def _drive_staged(eng, prompts):
    """Prompt 0 alone until its prefill is done (its blocks registered
    with prefix caching on), then the rest; run to the end."""
    eng.submit(prompts[0])
    while eng.waiting or eng.prefilling:
        eng.step()
    for p in prompts[1:]:
        eng.submit(p)
    eng.run()


def prefix_runs(params, cfg, total) -> None:
    """8 requests sharing a 512-token preamble with 32–256-token tails,
    prefix caching on against off, blocking and chunked (256), and the
    sharedprefix trace on a 6-block pool, on the paged backend."""
    import numpy as np
    from repro_torch.serving.workload import make_named_trace, replay
    rng = np.random.default_rng(SEED + 6)
    pre = rng.integers(0, cfg.vocab_size, size=PREAMBLE)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=n)]).astype(np.int32)
               for n in rng.integers(32, 257, size=8)]
    runs = {}
    for sched, kw in (("blocking", {}), ("chunked", CHUNKED)):
        for on in (False, True):
            eng = _engine(params, cfg, max_batch=8, max_seq_len=2048,
                          max_new_tokens=32, kv_cache="paged",
                          kv_block_size=BS, prefix_cache=on,
                          **{"scheduler": sched, **kw})
            _, counts = counted(lambda: _drive_staged(eng, prompts))
            check_launches(f"request_surface prefix {sched} on={on}", eng,
                           counts)
            _pool_balanced(f"prefix {sched} on={on}", eng.kv)
            _add(total, counts)
            runs[sched, on] = (eng.summary(), _outputs(eng), counts)
        # the host's own block-aligned matches: blocking admits (and
        # registers) one request after another; chunked binds requests
        # 1..7 together, when only request 0's blocks are registered
        earlier = (lambda i: range(i)) if sched == "blocking" else (
            lambda i: range(min(i, 1)))
        want = sum(max([_shared_blocks(prompts[i], prompts[j])
                        for j in earlier(i)] or [0]) * BS
                   for i in range(len(prompts)))
        (off_s, off_o, off_c), (on_s, on_o, on_c) = (runs[sched, False],
                                                     runs[sched, True])
        log("request_surface", gate=f"prefix {sched}",
            streams_equal=on_o == off_o, prefix_hits=on_s["prefix_hits"],
            prefix_hit_tokens=on_s["prefix_hit_tokens"],
            host_hit_tokens=want,
            prefix_hit_rate=f"{on_s['prefix_hit_rate']:.4f}",
            k3_prefills_off_on=f"{off_s['prefills']},{on_s['prefills']}",
            chunk_dispatches_off_on=(f"{off_s['prefill_chunk_dispatches']},"
                                     f"{on_s['prefill_chunk_dispatches']}"),
            prefill_dispatches_saved=(
                off_s["prefills"] + off_s["prefill_chunk_dispatches"]
                - on_s["prefills"] - on_s["prefill_chunk_dispatches"]),
            k4_launches_off_on=(f"{off_c['prefill_attention']},"
                                f"{on_c['prefill_attention']}"),
            resident_shared_kv_bytes=on_s["resident_shared_kv_bytes"])
        if not (on_o == off_o and on_s["prefix_hit_tokens"] == want > 0):
            raise AssertionError(f"prefix {sched}: streams equal "
                                 f"{on_o == off_o}, hit tokens "
                                 f"{on_s['prefix_hit_tokens']} != {want}")
    if runs["chunked", True][1] != runs["blocking", True][1]:
        raise AssertionError("prefix: chunked streams != blocking streams")
    tr = make_named_trace("sharedprefix", vocab_size=cfg.vocab_size, seed=1)
    outs = {}
    for on in (False, True):
        eng = _engine(params, cfg, max_batch=4, max_seq_len=96,
                      max_new_tokens=16, kv_cache="paged", kv_block_size=BS,
                      kv_blocks=6, prefix_cache=on)
        rep, counts = counted(lambda: replay(eng, tr, step_quantum_s=QUANTUM))
        check_launches(f"request_surface sharedprefix on={on}", eng, counts)
        _pool_balanced(f"sharedprefix on={on}", eng.kv)
        _add(total, counts)
        outs[on] = rep["outputs"]
        s = rep["summary"]
        log("request_surface", run=f"sharedprefix on={on}", requests=len(tr),
            steps=rep["steps"], prefix_hits=s["prefix_hits"],
            prefix_hit_tokens=s["prefix_hit_tokens"],
            prefix_evictions=s["prefix_evictions"],
            ttft_p99_s=f"{s['ttft_p99_s']:.4f}")
    if outs[True] != outs[False]:
        raise AssertionError("sharedprefix: streams differ with prefix "
                             "caching on")


# the reference test's fixed preemption plans (an entry per engine step:
# None, or the index among live slots of the victim)
PLANS = ((), (0,) * 24, (None, 1, None, 0, 3, None, 2) * 3,
         (None, None, None, 1, 1, 1, 1, 1))


def _drive_plan(eng, prompts, plan):
    for p in prompts:
        eng.submit(p)
    it = 0
    while eng.has_work():
        if it >= 500:
            raise AssertionError("preemption interleaving did not drain")
        live = [i for i, r in enumerate(eng.slot_req) if r is not None]
        if live and it < len(plan) and plan[it] is not None:
            eng.preempt_slot(live[plan[it] % len(live)])
        eng.step()
        it += 1


def interleaving_runs(params, cfg, total) -> None:
    """The four fixed preemption plans, paged with prefix caching on
    (8-block pool, 2 slots): streams equal to a run with no preemption
    and no prefix caching; no leak."""
    import numpy as np
    rng = np.random.default_rng(7)
    pre = rng.integers(0, cfg.vocab_size, size=3 * BS)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, size=n)])
               for n in (4, 7, 9, 12, 5)]
    kw = dict(max_batch=2, max_seq_len=96, max_new_tokens=5,
              kv_cache="paged", kv_block_size=BS)
    ref = _engine(params, cfg, **kw)
    _, counts = counted(lambda: _drive_plan(ref, prompts, ()))
    _add(total, counts)
    want = _outputs(ref)
    for k, plan in enumerate(PLANS):
        eng = _engine(params, cfg, prefix_cache=True, kv_blocks=8, **kw)
        _, counts = counted(lambda: _drive_plan(eng, prompts, plan))
        check_launches(f"request_surface plan {k}", eng, counts)
        _pool_balanced(f"plan {k}", eng.kv)
        _add(total, counts)
        got = _outputs(eng)
        log("request_surface", plan=k, preemptions=eng.preemptions,
            streams_equal=got == want,
            prefix_hits=eng.summary()["prefix_hits"])
        if got != want:
            raise AssertionError(f"plan {k}: {got} != {want}")


def export_import_bf16(params, cfg) -> None:
    """A bf16 ``export_slot`` -> ``import_slot`` into another slot gives
    rows ``torch.equal`` to the originals, on both backends and across
    them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(0, cfg.vocab_size, size=300).astype(np.int32)
    engines = {}
    for kv in ("paged", "contiguous"):
        eng = _engine(params, cfg, max_batch=4, max_seq_len=2048,
                      max_new_tokens=64, kv_cache=kv)
        eng.submit(prompt)
        for _ in range(5):
            eng.step()
        engines[kv] = eng
    for src, dst in (("paged", "paged"), ("contiguous", "contiguous"),
                     ("paged", "contiguous"), ("contiguous", "paged")):
        a, b = engines[src], engines[dst]
        n = int(a.slot_pos[0])
        pkt = a.kv.export_slot(0, n)
        slot = 3 if dst == src else 2
        b.kv.import_slot(pkt, slot, len(prompt), 64)
        back = b.kv.export_slot(slot, n)
        same = all(torch.equal(pkt[x][:, :, :n], back[x][:, :, :n])
                   for x in ("k", "v"))
        log("request_surface", export_import=f"{src}->{dst}",
            dtype=str(pkt["k"].dtype), positions=n,
            kv_bytes=pkt["kv_bytes"], rows_equal=same)
        if not same or pkt["k"].dtype != torch.bfloat16:
            raise AssertionError(f"bf16 export {src} -> import {dst}: rows "
                                 f"equal {same}, dtype {pkt['k'].dtype}")
        b.kv.free(slot)


def sampled(params, cfg, prompts, seed, plan=(), total=None):
    eng = _engine(params, cfg, max_batch=4, max_seq_len=2048,
                  max_new_tokens=16, kv_cache="paged", sample="temperature",
                  temperature=0.8, top_k=50, seed=seed)
    _, counts = counted(lambda: _drive_plan(eng, prompts, plan))
    check_launches(f"request_surface sampled seed={seed}", eng, counts)
    _add(total, counts)
    return eng


def cuda_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def sampling_runs(params, cfg, total) -> None:
    """Temperature 0.8, top-k 50 on bf16 paged: the same seed twice, the
    same seed under a preemption plan, another seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (40, 130, 260, 75, 500, 20)]
    a = sampled(params, cfg, prompts, 7, total=total)
    b = sampled(params, cfg, prompts, 7, total=total)
    c = sampled(params, cfg, prompts, 7, plan=PLANS[2], total=total)
    d = sampled(params, cfg, prompts, 8, total=total)
    oa, ob, oc, od = (_outputs(e) for e in (a, b, c, d))
    logits = torch.randn(4, cfg.vocab_size, device="cuda")
    per_step = cuda_kernels(lambda: a._sample(
        logits, a.slot_seed, a.slot_rid, a.slot_pos))
    log("request_surface", sampling="temperature=0.8 top_k=50",
        same_seed_equal=oa == ob, preempted_equal=oa == oc,
        preemptions=c.preemptions, other_seed_differs=oa != od,
        sampler_kernels_per_step=per_step,
        sample_calls_per_decode_step=1)
    if not (oa == ob == oc and oa != od and c.preemptions >= 1):
        raise AssertionError(f"sampling: same seed {oa == ob}, preempted "
                             f"{oa == oc} ({c.preemptions}), other seed "
                             f"differs {oa != od}")


def telemetry_runs(params, cfg, total) -> None:
    """Greedy float32, paged + chunked: telemetry on gives the tokens of
    the run with it off; the trace validates and every dispatch joins."""
    import numpy as np
    from repro_torch.serving import (Telemetry, join_coverage,
                                     validate_trace_events)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (17, 200, 511, 1000)]
    outs = []
    for tel in (None, Telemetry()):
        eng = _engine(params, cfg, telemetry=tel, max_batch=8,
                      max_seq_len=2048, max_new_tokens=16, kv_cache="paged",
                      **CHUNKED)
        for p in prompts:
            eng.submit(p)
        _, counts = counted(eng.run)
        check_launches(f"request_surface telemetry={tel is not None}", eng,
                       counts)
        _add(total, counts)
        outs.append(_outputs(eng))
    problems = [validate_trace_events(tel.tracer.trace_events(clock=c))
                for c in ("wall", "virtual")]
    joined = join_coverage(eng, tel)
    slow = ", ".join(f"{sp.name}:{sp.wall_dur_s * 1e3:.2f}ms"
                     for sp in tel.tracer.slowest(5))
    log("request_surface", telemetry="on vs off",
        tokens_equal=outs[0] == outs[1], trace_problems=sum(map(len, problems)),
        join_coverage=f"{joined[0]}/{joined[1]}",
        spans=len(tel.tracer.spans), slowest=f"'{slow}'")
    if not (outs[0] == outs[1] and problems == [[], []]
            and joined[0] == joined[1] > 0):
        raise AssertionError(f"telemetry: tokens equal {outs[0] == outs[1]},"
                             f" trace problems {problems}, join {joined}")


def admission_device_ms(params, cfg) -> None:
    """bf16 device time of one cold admission (512-token preamble + 64-
    token tail: a 1024-bucket prefill, K3) against one warm admission of
    the same preamble with another tail (a 64-token chunk over the 512
    shared positions, K4), each admission alone under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 9)
    eng = _engine(params, cfg, max_batch=1, max_seq_len=2048,
                  max_new_tokens=2, kv_cache="paged", prefix_cache=True)

    def admit_ms(prompt):
        """(device ms, the five kernels with the most device time)."""
        eng.submit(prompt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.scheduler.admit(eng)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in rows)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:5]
        eng.run()
        return (us / 1e3 if us > 0 else None,
                "; ".join(f"{e.key[:48]} x{e.count} "
                          f"{e.self_device_time_total / 1e3:.4f}"
                          for e in top))

    cold, warm = [], []
    for rep in range(4):          # rep 0 warms the allocator and cuBLAS
        pre = rng.integers(0, cfg.vocab_size, size=PREAMBLE)
        tails = rng.integers(0, cfg.vocab_size, size=(2, 64))
        c = admit_ms(np.concatenate([pre, tails[0]]).astype(np.int32))
        w = admit_ms(np.concatenate([pre, tails[1]]).astype(np.int32))
        if rep:
            cold.append(c)
            warm.append(w)
    s = eng.summary()
    log("request_surface", admission="bf16 cold vs warm, 512 + 64 tokens",
        cold_device_ms=",".join(f"{x:.4f}" if x else "none"
                                for x, _ in cold),
        warm_device_ms=",".join(f"{x:.4f}" if x else "none"
                                for x, _ in warm),
        prefix_hits=s["prefix_hits"], prefills=s["prefills"],
        chunk_dispatches=s["prefill_chunk_dispatches"])
    for what, runs in (("cold", cold), ("warm", warm)):
        log("request_surface", admission_top_kernels=what,
            ms=f"'{runs[-1][1]}'")
    if s["prefix_hits"] != 4 or s["prefills"] != 4:
        raise AssertionError(f"admission timing: {s['prefix_hits']} warm, "
                             f"{s['prefills']} cold admissions of 4 each")


def phase_request_surface(card: str) -> dict:
    """Full-width qwen1.5-0.5b: SLO preemption, prefix caching,
    preemption interleavings and telemetry in float32 (the conditions of
    phase 3's gates); sampling, export/import and admission device time
    in bf16. Returns the launch counts of its engine runs."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    t0 = time.perf_counter()
    total: dict = {}
    cfg = registry.get_config(ARCH).replace(dtype="float32")
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    slo_runs(params, cfg, total)
    prefix_runs(params, cfg, total)
    interleaving_runs(params, cfg, total)
    telemetry_runs(params, cfg, total)
    del params
    torch.cuda.empty_cache()
    cfg = registry.get_config(ARCH)
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    export_import_bf16(params, cfg)
    sampling_runs(params, cfg, total)
    admission_device_ms(params, cfg)
    log("request_surface", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total


# ---------------------------------------------------------------------------
# phase 7: the MoE and vlm families at full width
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-moe-16b", "internvl2-26b")
GATE_LAYERS = 4        # 7a's depth: deepseek keeps its dense layer 0
DBRX_LAYERS = 2        # 7c's depth
STEP_SECONDS = 420     # each step of phase 7 ends the process past this


@contextlib.contextmanager
def step_deadline(seconds=STEP_SECONDS):
    """SIGALRM's default action ends the process: a hung kernel costs
    minutes, not the call."""
    import signal
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)


def dropless(cfg):
    """``cfg`` at capacity factor E / k, where no dispatch can drop a
    routed slot (every expert's capacity is the token count)."""
    return cfg.replace(moe_capacity_factor=cfg.n_experts / cfg.moe_top_k)


@contextlib.contextmanager
def counting_drops():
    """Routed slots dropped past an expert's capacity, per dispatch kind,
    while the engine runs: wrappers around the port's ``moe.apply_moe``
    and the engine's ``_dispatch`` (this script's measurement only; the
    outputs are the unwrapped ones). Yields {kind: [count tensors]}."""
    from repro_torch.models import moe as M
    from repro_torch.serving import engine as E
    drops: dict = {}
    kind = [None]
    apply_moe, dispatch = M.apply_moe, E.ServingEngine._dispatch

    def counted(p, cfg, x):
        xf = x.reshape(-1, x.shape[-1])
        _, ids = M.route(p["router"], xf, cfg.moe_top_k)
        pos = M.slot_positions(ids, cfg.n_experts)
        drops.setdefault(kind[0], []).append(
            (pos >= M._capacity(xf.shape[0], cfg)).sum())
        return apply_moe(p, cfg, x)

    def tagged(self, k, *args):
        kind[0] = k
        return dispatch(self, k, *args)

    M.apply_moe, E.ServingEngine._dispatch = counted, tagged
    try:
        yield drops
    finally:
        M.apply_moe, E.ServingEngine._dispatch = apply_moe, dispatch


def drop_runs(params, cfg, prompts, total) -> None:
    """7a at the config's capacity factor: every gate configuration with
    its dropped slots per dispatch kind; only paged + blocking ==
    contiguous + blocking is gated (the same dispatch shapes)."""
    import torch
    runs = {}
    for label, kw in {"contiguous+blocking": {}, **GATE_CONFIGS}.items():
        torch.cuda.empty_cache()
        with counting_drops() as drops:
            eng, counts = run_engine(params, cfg, prompts, 16, **kw)
        _check_engine(f"families_f32 {label}", eng, counts, len(prompts))
        _add(total, counts)
        runs[label] = {r.rid: r.output for r in eng.finished}
        log("families_f32", arch=cfg.name, depth=cfg.n_layers,
            capacity_factor=cfg.moe_capacity_factor, config=label,
            gated=label == "paged+blocking",
            equal_to_blocking=runs[label] == runs["contiguous+blocking"],
            dropped_slots=json.dumps({k: int(sum(v).item())
                                      for k, v in drops.items()}),
            moe_calls=json.dumps({k: len(v) for k, v in drops.items()}))
        del eng
    if runs["paged+blocking"] != runs["contiguous+blocking"]:
        raise AssertionError(f"{cfg.name} at capacity factor "
                             f"{cfg.moe_capacity_factor}: paged + blocking "
                             "!= contiguous + blocking")


def phase_families_f32() -> dict:
    """7a: float32 stream gates at full width, 4 layers deep — for MoE at
    capacity factor E / k, then the same runs at the config's."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    total: dict = {}
    for arch in FAMILY_ARCHS:
        with step_deadline():
            cfg = registry.get_config(arch).replace(dtype="float32",
                                                    n_layers=GATE_LAYERS)
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            prompts = gate_prompts(cfg)
            gate_cfg, extra = cfg, {"arch": arch, "depth": GATE_LAYERS}
            if cfg.is_moe:
                gate_cfg = dropless(cfg)
                extra["capacity_factor"] = \
                    f"{gate_cfg.moe_capacity_factor:.4g}"
            with counting_drops() as drops:
                stream_gates("families_f32", params, gate_cfg, prompts,
                             extra, total)
            if any(int(sum(v).item()) for v in drops.values()):
                raise AssertionError(f"{arch}: a slot dropped at E / k")
            if cfg.is_moe:
                log("families_f32", arch=arch, note="capacity factor 1.25 "
                    "runs below: streams other than paged + blocking are "
                    "printed, not gated")
                drop_runs(params, cfg, prompts, total)
            del params
            torch.cuda.empty_cache()
    return total


def phase_families_bf16(card: str) -> dict:
    """7b: bf16 at full width and depth, one model at a time: logits
    against the plain versions, phase 4's serving runs, and one decode
    step of 8 live slots traced by ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import profile
    total: dict = {}
    for arch in FAMILY_ARCHS:
        with step_deadline():
            cfg = registry.get_config(arch)
            t0 = time.perf_counter()
            params = MD.init_params(cfg, seed=SEED, device="cuda")
            torch.cuda.synchronize()
            log("families_bf16", arch=arch, layers=cfg.n_layers,
                params=cfg.param_count(),
                weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
                init_s=f"{time.perf_counter() - t0:.1f}")
            prompts = serve_prompts(cfg)
            images = None
            if cfg.family == "vlm":   # a seeded prefix, not the zero stub
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                images = (torch.randn((1, cfg.n_image_tokens, cfg.d_model),
                                      generator=gen, device="cuda")
                          * 0.1).to(torch.bfloat16)
            logit_gates(f"families_bf16 {arch}", params, cfg, prompts[0],
                        images)
            serve_bf16(f"families_bf16 {arch}", params, cfg, prompts, card,
                       total)
            eng = profile.live_engine(params, cfg,
                                      np.random.default_rng(SEED))
            profile.measure(f"{arch}_decode", 3, eng.step, top=14)
            del eng, params
            torch.cuda.empty_cache()
    return total


def phase_dbrx(card: str) -> dict:
    """7c: dbrx-132b at full width, 2 layers (LayerNorm, 16 experts
    top-4, GQA 48/8): a 512-token prefill and 8 greedy decode steps
    with exact launches (no K5: LayerNorm has none), then the same
    tokens and experts (:func:`routes`) through the plain versions:
    every step's logits normwise <= 3e-2 with the same argmax, and the
    routing flips held to :func:`flip_gate`."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import model as MD
    cfg = registry.get_config("dbrx-132b").replace(n_layers=DBRX_LAYERS)
    assert cfg.norm == "layernorm" and cfg.dtype == "bfloat16"
    params = MD.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 512)),
                             dtype=torch.int32, device="cuda")
    n_steps = 8

    def run(feed=None):
        logits, cache = MD.prefill(params, cfg, {"tokens": prompt}, 1024)
        out, toks = [logits], []
        for i in range(n_steps):
            tok = (feed[i] if feed is not None
                   else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
            toks.append(tok)
            logits, cache = MD.decode_step(params, cfg, tok, cache)
            out.append(logits)
        return out, toks

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with routes() as picked:
        got, toks = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n = cfg.n_layers
    want = {"rmsnorm": 0, "flash_attention": n,
            "decode_attention": n_steps * n, "paged_decode_attention": 0,
            "prefill_attention": 0, "quant_gemv": 0}
    log("families_dbrx", launches=json.dumps(counts),
        expected=json.dumps(want),
        note="LayerNorm model: K5 (RMSNorm) is not launched, by design")
    if counts != want:
        raise AssertionError(f"dbrx launches {counts} != {want}")
    with plain_kernels(), routes(replay=picked) as flips:
        ref_out, _ = run(feed=toks)
    for i, (g, w) in enumerate(zip(got, ref_out)):
        rel = _logit_gate(f"dbrx {'prefill' if i == 0 else f'step {i}'}",
                          g, w)
        log("families_dbrx", logits="prefill" if i == 0 else f"decode_{i}",
            rel_err=f"{rel:.3e}",
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            tol=TOL["bfloat16"], argmax_equal=True)
    flip_gate("families_dbrx", picked, flips, lambda: run(feed=toks))
    log("families_dbrx", arch=cfg.name, layers=n, prompt_len=512,
        decode_steps=n_steps, wall_s=f"{wall:.3f}",
        weight_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
        card=f"'{card}'")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_families(card: str) -> dict:
    t0 = time.perf_counter()
    total = phase_families_f32()
    _add(total, phase_families_bf16(card))
    with step_deadline():
        _add(total, phase_dbrx(card))
    log("families", seconds=f"{time.perf_counter() - t0:.1f}",
        launches=json.dumps(total), card=f"'{card}'")
    return total



SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:84"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:134"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/flash_attention.py:148"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:230"),
    "add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:25"),
    "quant_gemv": ("src/repro_torch/kernels/csrc/quant_gemv.cu",
                   "src/repro/kernels/quant_gemv.py:56"),
}


# the launch counter of each kernel of the JSON line, where it is named
# otherwise (``ops.launch_counts()``)
COUNTERS = {"add_rmsnorm": "rmsnorm"}


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
    torch.cuda.empty_cache()
    for name, c in phase_w4(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_request_surface(card).items():
        counts[name] += c
    torch.cuda.empty_cache()
    for name, c in phase_families(card).items():
        counts[name] += c
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows[name]
        cases, err = r["cases"], r["max_abs_err"]
        if name == "add_rmsnorm":   # K5 also runs without the add, and
            cases = cases + rows["rmsnorm"]["cases"]   # counts both
            err = max(err, rows["rmsnorm"]["max_abs_err"])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": counts[COUNTERS.get(name, name)],
            "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "cases": cases})
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
