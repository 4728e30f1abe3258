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
   head dim 96, K1 / K2 also at the W4 step's one-row call;
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
   through the plain versions.

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


def phase_kernels() -> dict:
    """Every kernel vs its plain version, both dtypes. Returns, per
    kernel, the bf16 numbers at its first (main-path) shape and the
    largest error seen."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gen_w4 = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for name, case, kfn, pfn, lfn, nbytes, flops, same, *opts in (
                kernel_cases(gen, dtype) + w4_path_cases(gen_w4, dtype)):
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
    s = _check_engine("engine_f32", eng, counts, len(prompts))
    base = {r.rid: r.output for r in eng.finished}
    for i, p in enumerate(prompts):
        want = straight_line_generate(params, cfg, p, 16, 2048)
        log("engine_f32", request=i, prompt_len=len(p),
            equal=base[i] == want, tokens=base[i][:8])
        if base[i] != want:
            raise AssertionError(f"request {i}: engine {base[i]} != "
                                 f"straight-line {want}")
    log("engine_f32", config="contiguous+blocking", requests=s["requests"],
        tokens=s["tokens"], decode_dispatches=s["decode_dispatches"],
        decode_steps=s["decode_steps"], prefills=s["prefills"],
        streams_equal=True)
    del eng
    for label, kw in GATE_CONFIGS.items():
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 16, **kw)
        s = _check_engine(f"engine_f32 {label}", eng, counts, len(prompts))
        got = {r.rid: r.output for r in eng.finished}
        log("engine_f32", config=label, streams_equal=got == base,
            decode_dispatches=s["decode_dispatches"],
            decode_steps=s["decode_steps"],
            chunk_dispatches=s["prefill_chunk_dispatches"],
            draft_dispatches=s["draft_dispatches"],
            accepted_per_step=f"{s['accepted_tokens_per_step']:.3f}",
            peak_resident_kv_bytes=s["peak_resident_kv_bytes"],
            contiguous_kv_bytes=s["contiguous_kv_bytes"])
        if got != base:
            raise AssertionError(f"{label}: streams {got} != contiguous "
                                 f"blocking {base}")
        del eng


def _first_logits(params, cfg, prompt, chunk):
    """The prompt's logits through bucketed prefill and through chunked
    prefill over a one-slot contiguous cache (the engine's route)."""
    import numpy as np
    import torch
    from repro_torch.models import model as MD
    n = len(prompt)
    nb = 16
    while nb < n:
        nb *= 2
    toks = np.zeros((1, nb), np.int32)
    toks[0, :n] = prompt
    whole, _ = MD.prefill(params, cfg,
                          {"tokens": torch.as_tensor(toks, device="cuda")},
                          None, logit_index=n - 1)
    cache = MD.init_cache(cfg, 1, 2048, device="cuda")
    done = 0
    while done < n:
        m = min(chunk, n - done)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :m] = prompt[done:done + m]
        logits, ks, vs = MD.prefill_chunk(
            params, cfg, {"tokens": torch.as_tensor(toks, device="cuda")},
            cache["k"], cache["v"], done, logit_index=m - 1)
        cache["k"][:, :, done:done + m] = ks[:, :, :m]
        cache["v"][:, :, done:done + m] = vs[:, :, :m]
        done += m
    return whole, logits


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

    # the first prefill, whole and chunked, through the kernels and
    # through the plain versions
    got = _first_logits(params, cfg, prompts[0], CHUNK_TOKENS)
    with plain_kernels():
        want = _first_logits(params, cfg, prompts[0], CHUNK_TOKENS)
    for what, g, w in (("prefill", got[0], want[0]),
                       ("chunked_prefill", got[1], want[1])):
        rel = ((g - w).norm() / w.norm()).item()
        log("engine_bf16", logits=what, prompt_len=len(prompts[0]),
            chunk=CHUNK_TOKENS, max_abs_err=f"{(g - w).abs().max().item():.3e}",
            rel_err=f"{rel:.3e}", tol=TOL["bfloat16"],
            argmax_equal=bool((g.argmax(-1) == w.argmax(-1)).all()))
        if not rel <= TOL["bfloat16"]:
            raise AssertionError(f"bf16 {what} logits: relative error {rel}")

    run_engine(params, cfg, prompts[:2], 4)  # warm-up (allocator, cuBLAS)
    total: dict = {}
    for label in ("contiguous+blocking", "paged+chunked",
                  "paged+speculative"):
        kw = GATE_CONFIGS.get(label, {})
        torch.cuda.empty_cache()
        eng, counts = run_engine(params, cfg, prompts, 64, **kw)
        s = _check_engine(f"engine_bf16 {label}", eng, counts, 16)
        for r in eng.finished:
            if len(r.output) != 64:
                raise AssertionError(f"{label} request {r.rid}: "
                                     f"{len(r.output)} tokens")
        log("engine_bf16", config=label, requests=s["requests"],
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
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c
        del eng
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
