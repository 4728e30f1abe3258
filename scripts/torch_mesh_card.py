#!/usr/bin/env python3
"""Mesh serving of the PyTorch/CUDA port across four NVIDIA cards.

    python3 scripts/torch_mesh_card.py

It needs four CUDA devices of one host and exits non-zero with fewer (a
missing card is an error, never a skip). It builds the kernels from
``src/repro_torch/kernels/csrc`` and runs, one line per result:

(a) float32 qwen1.5-0.5b at full width and depth (random weights from
    the seed) at (1, 4) and (2, 2) over ``cuda:0..3``, contiguous and
    paged, on ``chip_smoke.py``'s phase 3 traffic: every stream equal to
    one engine's on ``cuda:0``, the launches exactly the mesh path's;
(b) bf16 llama2-70b, all 80 layers, at (1, 4), its shards made on their
    cards (``init_params_sharded``: the whole tree never exists): 8
    requests of 256–1023 tokens, 64 new each, paged + blocking — TTFT,
    ITL and tok/s, one dispatch a step, ``memory_allocated`` per card;
    the same traffic again with every K1 / K2 / K3 / K5 call held to its
    plain version on its own inputs (3e-2); a prefill and 8 greedy
    decode steps of one prompt through the mesh, every step's logits
    held to the plain versions' on the same mesh (3e-2, argmax equal or
    a tie at rounding level); one decode step of 8 live slots traced by
    ``torch.profiler``: per card device ms, peer-copy ms, kernel
    launches and idle share; beside them, labelled as a model output,
    the port simulator's ``serve(mesh=(1, 4))`` for the same shape on
    one DGX-H100 card group;
(c) bf16 dbrx-132b, all 40 layers, at (1, 4): a 512-token prefill and 8
    greedy decode steps with exact launches, every step's logits held to
    the plain versions replaying the kernel run's experts, the routing
    flips at most twice what one-ulp noise at every MoE input moves in
    the plain path (``chip_smoke.py``'s phase 7c gate, per rank), and
    ``memory_allocated`` / ``max_memory_allocated`` per card.

The line before last lists the cards' names and power limits; the last
line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402  (the one-card script's helpers)

N_CARDS = 4
MESH = (1, 4)
LLAMA = "llama2-70b"
DBRX = "dbrx-132b"
LLAMA_CAPACITY = 1152   # the longest prompt (1023) + 64 new, in blocks of 16
DBRX_PROMPT = 512
STEPS = 8
log = CS.log


def cards() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def devices():
    import torch
    return tuple(torch.device("cuda", i) for i in range(N_CARDS))


def memory(phase, what, peak=False) -> list:
    """``memory_allocated`` (and the peak) per card, in GB."""
    import torch
    now = [torch.cuda.memory_allocated(i) / 1e9 for i in range(N_CARDS)]
    fields = {"memory_allocated_gb": json.dumps([round(x, 3) for x in now])}
    if peak:
        fields["max_memory_allocated_gb"] = json.dumps(
            [round(torch.cuda.max_memory_allocated(i) / 1e9, 3)
             for i in range(N_CARDS)])
    log(phase, at=what, **fields)
    return now


def sync_all() -> None:
    import torch
    for i in range(N_CARDS):
        torch.cuda.synchronize(i)


def serve(params, cfg, mesh, prompts, max_new, **ecfg):
    """A fresh engine (on ``cuda:0`` alone when ``mesh`` is None) over
    ``prompts``: (engine, launch counts of the run, wall seconds)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    kw = {"max_batch": 8, "max_seq_len": 2048, **ecfg,
          "max_new_tokens": max_new}
    if mesh is None:
        eng = ServingEngine(params, cfg, EngineConfig(**kw), device="cuda:0")
    else:
        eng = ServingEngine(params, cfg, EngineConfig(mesh=mesh, **kw),
                            devices=devices()[:mesh[0] * mesh[1]])
    for p in prompts:
        eng.submit(p)
    sync_all()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    sync_all()
    return eng, ops.launch_counts(), time.perf_counter() - t0


def streams(eng) -> dict:
    return {r.rid: r.output for r in eng.finished}


def close(eng) -> None:
    if eng.mesh is not None:
        eng.mesh.close()


# ---------------------------------------------------------------------------
# (a) float32 qwen across the four cards
# ---------------------------------------------------------------------------

def qwen_f32() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    cfg = registry.get_config(CS.ARCH).replace(dtype="float32")
    params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
    prompts = CS.gate_prompts(cfg)
    for kv in ("contiguous", "paged"):
        single, _, _ = serve(params, cfg, None, prompts, 16, kv_cache=kv)
        want = streams(single)
        del single
        for mesh in ((1, 4), (2, 2)):
            eng, counts, wall = serve(params, cfg, mesh, prompts, 16,
                                      kv_cache=kv)
            CS.mesh_checks("mesh4_f32", eng, counts, len(prompts),
                           devices=",".join(str(d) for d in eng.mesh.devices),
                           wall_s=f"{wall:.2f}")
            CS.mesh_stream_gate("mesh4_f32", streams(eng), want,
                                "one engine on cuda:0")
            close(eng)
            del eng
    del params
    CS.gc_empty()


# ---------------------------------------------------------------------------
# kernels against the plain versions on the mesh
# ---------------------------------------------------------------------------

def logit_gates(phase, eng, prompt, n_steps, replay=False):
    """Every step's logits of :func:`chip_smoke.mesh_forward` through the
    kernels against the plain versions feeding the same tokens — on an
    MoE model, replaying the kernel run's experts
    (:func:`chip_smoke.mesh_routes`) and holding the routing flips to
    :func:`flip_gate`."""
    with CS.mesh_routes() as picked:
        got, fed = CS.mesh_forward(eng, prompt, n_steps)
    with CS.plain_kernels(), CS.mesh_routes(
            replay=picked if replay else None) as flips:
        want, _ = CS.mesh_forward(eng, prompt, n_steps, feed=fed)
    for i, (g, w) in enumerate(zip(got, want)):
        rel, ties = CS._tie_gate(f"{phase} step {i}", g, w)
        log(phase, logits="prefill" if i == 0 else f"decode_{i}",
            rel_err=f"{rel:.3e}",
            max_abs_err=f"{(g - w).abs().max().item():.3e}",
            tol=CS.TOL["bfloat16"], ties=json.dumps(ties))
    if replay:
        flip_gate(phase, eng, prompt, n_steps, picked[0], flips[0], fed)


def flip_gate(phase, eng, prompt, n_steps, picked, flips, fed) -> None:
    """Phase 7c's gate on rank 0's routing: the kernels' flips against
    the plain versions at most ``FLIP_WITNESS_FACTOR`` times those that
    one-ulp noise at every MoE input moves in the plain path."""
    with CS.plain_kernels(), CS.mesh_routes() as base:
        CS.mesh_forward(eng, prompt, n_steps, feed=fed)
    with CS.plain_kernels(), CS.mesh_nudged(), \
            CS.mesh_routes(replay=base) as seen:
        CS.mesh_forward(eng, prompt, n_steps, feed=fed)
    routed = sum(int(i.shape[0]) for i in picked)
    n_flips, witness = CS.route_flips(flips), CS.route_flips(seen[0])
    log(phase, routing_calls=len(picked), routed_tokens=routed,
        route_flips_kernels_vs_plain=n_flips,
        route_flips_plain_vs_plain_one_ulp=witness,
        limit=f"{CS.FLIP_WITNESS_FACTOR} x witness")
    if n_flips > CS.FLIP_WITNESS_FACTOR * witness:
        raise AssertionError(f"{phase}: the kernels move {n_flips} routes, "
                             f"more than {CS.FLIP_WITNESS_FACTOR} x "
                             f"{witness}")


# ---------------------------------------------------------------------------
# (b) llama2-70b
# ---------------------------------------------------------------------------

def llama_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(CS.SEED + 3)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(256, 1024, size=8)]


def profile_step(phase, eng, card_names) -> dict:
    """Engine steps of 8 live decode slots: one timed on the host clock
    (the cards synchronised), the next traced by ``torch.profiler`` (the
    card's activity only: recording every host op of four threads would
    take seconds a step) — per card the kernels' device ms, the copies'
    ms (peer copies of the gathers), the kernel launches, and the idle
    share of the timed step's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync_all()
    t0 = time.perf_counter()
    eng.step()
    sync_all()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(CS.DEVICE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.step()
            sync_all()
        per = {i: {"kernel_us": 0.0, "copy_us": 0.0, "launches": 0}
               for i in range(N_CARDS)}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            d = per.setdefault(e.device_index, {"kernel_us": 0.0,
                                                "copy_us": 0.0,
                                                "launches": 0})
            us = e.device_time
            if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                d["copy_us"] += us
            else:
                d["kernel_us"] += us
                d["launches"] += 1
        if any(v["kernel_us"] for v in per.values()):
            break
    else:
        log(phase, profile="not measured (no device activity traced)")
        return {}
    out = {}
    for i in range(N_CARDS):
        v = per[i]
        busy = (v["kernel_us"] + v["copy_us"]) / 1e3
        out[i] = {"device_ms": round(v["kernel_us"] / 1e3, 4),
                  "copy_ms": round(v["copy_us"] / 1e3, 4),
                  "launches": v["launches"],
                  "idle_share": round(max(0.0, 1 - busy / wall_ms), 4)}
        log(phase, profile=f"cuda:{i}", step_wall_ms=f"{wall_ms:.3f}",
            device_ms=f"{v['kernel_us'] / 1e3:.4f}",
            copy_ms=f"{v['copy_us'] / 1e3:.4f}",
            launches=v["launches"],
            idle_share=f"{out[i]['idle_share']:.4f}",
            card=f"'{card_names[i]}'")
    return out


def checked_paged(errs):
    """:func:`chip_smoke.checked_kernels` and K2 too: every paged decode
    call also runs its plain version on the same inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    stack = contextlib.ExitStack()
    stack.enter_context(CS.checked_kernels(errs))
    saved = ops.paged_decode_attention

    def call(*a, **k):
        got = saved(*a, **k)
        want = ref.paged_decode_attention(*a, **k)
        err = (got.float() - want.float()).abs().max().item()
        n, worst = errs.get("paged_decode_attention", (0, 0.0))
        errs["paged_decode_attention"] = (n + 1, max(worst, err))
        tol = CS.TOL["bfloat16"]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"paged_decode_attention call {n}: "
                                 f"max |kernel - plain| {err:.3e}")
        return got

    ops.paged_decode_attention = call
    stack.callback(setattr, ops, "paged_decode_attention", saved)
    return stack


def llama(card_names) -> None:
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.simulator import LLMSimulator, SimConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_llama"
    cfg = registry.get_config(LLAMA)
    t0 = time.perf_counter()
    shards = SH.init_params_sharded(cfg, DeviceMesh(MESH, devices()),
                                    seed=CS.SEED)
    sync_all()
    log(phase, arch=LLAMA, layers=cfg.n_layers, mesh="1x4",
        params=cfg.param_count(), init_s=f"{time.perf_counter() - t0:.1f}")
    memory(phase, "weights")
    prompts = llama_prompts(cfg)
    kw = dict(kv_cache="paged", max_seq_len=LLAMA_CAPACITY)
    warm, _, _ = serve(shards, cfg, MESH, prompts[:1], 2, **kw)
    close(warm)
    del warm
    eng, counts, wall = serve(shards, cfg, MESH, prompts, 64, **kw)
    s = CS.mesh_checks(phase, eng, counts, len(prompts), tokens=
                       sum(len(r.output) for r in eng.finished),
                       wall_s=f"{wall:.2f}")
    log(phase, ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.2f}",
        itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
        tok_per_s=f"{s['tokens_per_s']:.2f}",
        decode_steps=s["decode_steps"],
        dispatches_per_step=s["dispatches_per_step"],
        card=f"'{card_names[0]}'")
    memory(phase, "after serving")
    close(eng)
    del eng
    errs: dict = {}
    with checked_paged(errs):
        eng, counts, wall = serve(shards, cfg, MESH, prompts, 64, **kw)
    CS.mesh_checks(phase, eng, counts, len(prompts), wall_s=f"{wall:.2f}",
                   note="every K1 / K2 / K3 / K5 call checked")
    log(phase, checked_calls=json.dumps({k: n for k, (n, _) in errs.items()}),
        max_abs_err=json.dumps({k: f"{e:.3e}" for k, (_, e) in errs.items()}),
        tol=CS.TOL["bfloat16"])
    for name in ("add_rmsnorm", "flash_attention", "paged_decode_attention"):
        if not errs.get(name, (0, 0))[0]:
            raise AssertionError(f"{phase}: no {name} call was checked")
    close(eng)
    del eng
    # one decode step of the 8 live slots, traced
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=8, max_new_tokens=10_000, mesh=MESH, **kw),
        devices=devices())
    for p in prompts:
        eng.submit(p)
    while eng.waiting:
        eng.step()
    for _ in range(3):
        eng.step()
    prof = profile_step(phase, eng, card_names)
    # the logits of one prompt, kernels against the plain versions on the
    # same mesh (a contiguous one-row cache per rank: K1, K3, K5)
    logit_gates(phase, eng, prompts[0], STEPS)
    close(eng)
    del eng
    sim = LLMSimulator(cfg, CS.h100_profile(), SimConfig()).serve(
        [len(p) for p in prompts], 64, mesh=MESH, kv_cache="paged",
        max_seq_len=LLAMA_CAPACITY)
    log(phase, model_output="simulator serve(mesh=(1, 4)), not measured",
        profile=f"'{CS.h100_profile().name} x 4'",
        decode_step_ms=f"{sim['decode'].seconds / 64 * 1e3:.4f}",
        ttft_mean_ms=f"{sim['ttft_s'] * 1e3:.3f}",
        tok_per_s=f"{sim['tokens_per_s']:.2f}",
        kv_partitions=sim["kv_partitions"],
        measured_step_device_ms=json.dumps(
            {i: v["device_ms"] for i, v in prof.items()}))
    del shards
    CS.gc_empty()
    memory(phase, "freed")


# ---------------------------------------------------------------------------
# (c) dbrx-132b
# ---------------------------------------------------------------------------

def dbrx(card_names) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_dbrx"
    cfg = registry.get_config(DBRX)
    for i in range(N_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    shards = SH.init_params_sharded(cfg, DeviceMesh(MESH, devices()),
                                    seed=CS.SEED)
    sync_all()
    log(phase, arch=DBRX, layers=cfg.n_layers, mesh="1x4",
        params=cfg.param_count(), init_s=f"{time.perf_counter() - t0:.1f}")
    memory(phase, "weights", peak=True)
    # the engine holds the mesh, its shards and the shard config; its
    # one-slot cache is not used by the step-by-step run
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=1, max_seq_len=16, max_new_tokens=1, mesh=MESH),
        devices=devices())
    rng = np.random.default_rng(CS.SEED + 2)
    prompt = rng.integers(0, cfg.vocab_size, size=DBRX_PROMPT).astype(
        np.int32)
    sync_all()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    CS.mesh_forward(eng, prompt, STEPS)
    sync_all()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n, m = cfg.n_layers, MESH[1]
    want = {"rmsnorm": 0, "flash_attention": n * m,
            "decode_attention": STEPS * n * m, "paged_decode_attention": 0,
            "prefill_attention": 0, "quant_gemv": 0}
    log(phase, launches=json.dumps(counts), expected=json.dumps(want),
        prompt_len=DBRX_PROMPT, decode_steps=STEPS, wall_s=f"{wall:.3f}",
        note="LayerNorm model: K5 (RMSNorm) is not launched, by design")
    if counts != want:
        raise AssertionError(f"dbrx launches {counts} != {want}")
    logit_gates(phase, eng, prompt, STEPS, replay=True)
    memory(phase, "after the gates", peak=True)
    log(phase, card=f"'{card_names[0]}'")
    close(eng)
    del eng, shards
    CS.gc_empty()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_mesh_card: torch.cuda.is_available() is False; this "
              "run needs four NVIDIA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < N_CARDS:
        print(f"torch_mesh_card: needs {N_CARDS} CUDA devices, sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = cards()
    for i, line in enumerate(names):
        log("mesh4_device", card=f"cuda:{i}", name_power=f"'{line}'")
    _build.build_all()
    log("mesh4_device", build_s=f"{time.perf_counter() - t0:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda)
    steps = (("a", qwen_f32, ()), ("b", llama, (names,)),
             ("c", dbrx, (names,)))
    for label, fn, args in steps:
        t1 = time.perf_counter()
        fn(*args)
        log("mesh4", part=label, seconds=f"{time.perf_counter() - t1:.1f}")
    log("mesh4", seconds=f"{time.perf_counter() - t0:.1f}")
    print("\n".join(cards()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
