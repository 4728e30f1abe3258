#!/usr/bin/env python3
"""The rest of mesh serving across four NVIDIA cards: every family, a
batch that does not divide over ``data``, the sequence-sharded layout
under chunked prefill and speculation, a rolling window, weights split
over ``data``, and nemotron-4-340b's attention.

    python3 scripts/torch_mesh_serve_families_card.py [--parts abcdefhi]

It needs four CUDA devices of one host and exits non-zero with fewer (a
missing card is an error, never a skip). It builds the kernels from
``src/repro_torch/kernels/csrc`` and runs, from seed 0 at full width,
one line per result:

(a) float32 whisper-large-v3 (4 + 4 layers), zamba2-2.7b (12) and
    xlstm-350m (8) at (2, 2) and (1, 4), on ``chip_smoke.py``'s phase 3
    traffic (4 requests of 17–1000 tokens, 16 new), contiguous and
    paged (paged falls back to contiguous for these families, with the
    reference's warning): every stream equal to one engine's on
    ``cuda:0``, the launches exactly the mesh path's;
(b) float32 qwen1.5-0.5b at phase 3's depth at (1, 3) over capacity
    1152 — 16 KV heads over 3: the sequence-sharded layout on the
    contiguous cache, whole pools on the paged one — chunked (256) and
    speculative (gamma 4) on both caches: phase 3's streams;
(c) bf16 mistral-7b and h2o-danube-1.8b, 8 layers each, at (1, 3): the
    4096 window over a 6000-token prompt that rolls, then 8 greedy
    decode steps, every step's logits held to one card's (3e-2, argmax
    equal or a tie at rounding level);
(d) float32 qwen at (2, 2) with ``max_batch`` 7 (every data replica
    serves every slot; the contiguous cache splits its positions over
    both axes), both caches: phase 3's streams;
(e) bf16 llama2-70b, all 80 layers, at (2, 2) with its weights split
    over ``data`` (the reference's placement over the serve budget,
    gathered layer by layer at use): 34.5 GB a card, as at (1, 4). A
    prefill and 8 greedy steps held to the (1, 4) run on the same
    weights (resharded through the host) at 3e-2; 8 requests served
    (TTFT, ITL, tok/s) and one decode step of 8 live slots traced: per
    card wall, device ms, peer-copy ms and idle share;
(f) bf16 nemotron-4-340b, 16 of 96 layers, at (1, 4) (G 12 and Dh 192 on
    every card, ≈ 32 GB a card): 8 requests of 64–512 tokens, 8 new
    each, paged + chunked (256), every K1–K4 call held to its plain
    version on its own inputs; a prefill and 8 steps through the mesh
    against the plain versions on the same mesh;
(g) ``audit_engine`` clean on every engine run above;
(h) an MoE's capacity over a batch split over ``data``: float32
    deepseek-moe-16b (4 layers) and dbrx-132b (2) at capacity factor
    1.25, speculative (gamma 4) on both caches, on phase 3's traffic at
    (2, 2) and (4, 1): the streams and every dispatch's dropped slots
    equal one engine's on ``cuda:0``, some dispatch dropping;
(i) the recurrent sublayers split over ``model``: zamba2-2.7b at all
    54 layers and xlstm-350m at full width (8 layers in float32, all 24
    in bf16) at (2, 2) and (1, 4) — float32 streams on phase 3's
    traffic equal one engine's on ``cuda:0``, rank 0 holding 1 / model
    of Mamba2's and the mLSTM's columns and state heads; bf16 shards
    made on their cards, each card's bytes for the weights and the
    engine's cache (8 slots of 2048) — the bytes its tensors asked the
    allocator for, and ``memory_allocated`` less the whole cached blocks
    the allocator handed over where under 1 MB of a block would remain
    (read from its snapshot) — within 0.1% of the dry-run's meta
    prediction, beside ``memory_allocated`` itself, gated on nothing,
    and the prediction of the placement that kept them whole over
    model; a 256-token prefill and 8 greedy
    steps through the mesh against one card's on the gathered weights
    under phase 9b's rule (max(3e-2, 2 x a one-ulp-noise witness of the
    one-card run)); one decode step of 8 live slots traced (device ms
    and idle share per card).

The line before last lists the cards' names and power limits; the last
line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as CS  # noqa: E402  (the one-card script's helpers)
import torch_mesh_card as MC  # noqa: E402  (the four-card helpers)

log = CS.log
FAMILIES = (("whisper-large-v3", 4), ("zamba2-2.7b", 12),
            ("xlstm-350m", 8))
SEQ_MESH = (1, 3)
WINDOW_ARCHS = ("mistral-7b", "h2o-danube-1.8b")
WINDOW_LAYERS = 8
WINDOW_PROMPT = 6000
ODD_BATCH = 7
LLAMA_NEW = 16
NEMOTRON_LAYERS = 16
STEPS = 8
DROP_ARCHS = (("deepseek-moe-16b", CS.GATE_LAYERS),
              ("dbrx-132b", CS.DBRX_LAYERS))
DROP_MESHES = ((2, 2), (4, 1))
SPLIT_ARCHS = (("zamba2-2.7b", 54, 54), ("xlstm-350m", 8, 24))
SPLIT_MESHES = ((2, 2), (1, 4))
SPLIT_PROMPT = 256
MEM_RTOL = 1e-3


def audited(phase, eng) -> None:
    """(g): the engine's dispatch audit is clean."""
    from repro_torch.core.costmodel import assert_no_drift, audit_engine
    report = audit_engine(eng)
    assert_no_drift(report)
    log(phase, audit_ok=report["ok"], audited_dispatches=report["dispatches"])


def run(phase, params, cfg, mesh, prompts, max_new, want, what, **ecfg):
    """One engine run (on ``cuda:0`` alone when ``mesh`` is None): the
    mesh checks, the streams against ``want`` (when given) and the
    audit. Returns the streams."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng, counts, wall = MC.serve(params, cfg, mesh, prompts, max_new,
                                     **ecfg)
    fell_back = [str(w.message) for w in caught if "falling back" in
                 str(w.message)]
    got = MC.streams(eng)
    if mesh is not None:
        CS.mesh_checks(phase, eng, counts, len(prompts),
                       partitioned=eng.kv.layout != "replicated",
                       arch=cfg.name,
                       config=json.dumps(ecfg), wall_s=f"{wall:.2f}",
                       fallback_warned=bool(fell_back))
        CS.mesh_stream_gate(phase, got, want, what)
    audited(phase, eng)
    MC.close(eng)
    del eng
    CS.gc_empty()
    return got


# ---------------------------------------------------------------------------
# (a) whisper and the recurrent families
# ---------------------------------------------------------------------------

def families() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    for arch, depth in FAMILIES:
        cfg = registry.get_config(arch).replace(dtype="float32",
                                                n_layers=depth)
        if cfg.family == "audio":
            cfg = cfg.replace(n_encoder_layers=depth)
        params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
        prompts = CS.gate_prompts(cfg)
        want = run("mesh4_families", params, cfg, None, prompts, 16, None,
                   "")
        for mesh in ((2, 2), (1, 4)):
            for kv in ("contiguous", "paged"):
                run("mesh4_families", params, cfg, mesh, prompts, 16, want,
                    "one engine on cuda:0", kv_cache=kv)
        del params
        CS.gc_empty()


# ---------------------------------------------------------------------------
# (b) and (d): qwen's sequence-sharded layout and an odd batch
# ---------------------------------------------------------------------------

def qwen_layouts(parts) -> None:
    from repro_torch.models import model as MD
    cfg = CS.qwen_f32_cfg()
    params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
    prompts = CS.gate_prompts(cfg)
    base = run("mesh4_qwen", params, cfg, None, prompts, 16, None, "")
    what = "phase 3's streams (one engine on cuda:0)"
    if "b" in parts:
        for kv in ("contiguous", "paged"):
            for policy in (CS.CHUNKED, CS.SPECULATIVE):
                run("mesh4_seq", params, cfg, SEQ_MESH, prompts, 16, base,
                    what, kv_cache=kv, max_seq_len=CS.FALLBACK_CAPACITY,
                    **policy)
    if "d" in parts:
        for kv in ("contiguous", "paged"):
            run("mesh4_odd_batch", params, cfg, (2, 2), prompts, 16, base,
                what, kv_cache=kv, max_batch=ODD_BATCH)
    del params
    CS.gc_empty()


# ---------------------------------------------------------------------------
# (c) a rolling window over three cards
# ---------------------------------------------------------------------------

def single_forward(params, cfg, prompt, capacity, feed=None):
    """:func:`chip_smoke.mesh_forward`'s run on ``cuda:0`` alone."""
    import torch
    from repro_torch.models import model as MD
    toks = torch.as_tensor(prompt[None], dtype=torch.int32, device="cuda:0")
    logits, cache = MD.prefill(params, cfg, {"tokens": toks}, capacity)
    out, fed = [logits], []
    for i in range(STEPS):
        tok = (feed[i].to("cuda:0") if feed is not None
               else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
        fed.append(tok)
        logits, cache = MD.decode_step(params, cfg, tok, cache)
        out.append(logits)
    return out, fed


def windows() -> None:
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_window"
    for arch in WINDOW_ARCHS:
        cfg = registry.get_config(arch).replace(n_layers=WINDOW_LAYERS)
        window = cfg.sliding_window
        params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
        rng = np.random.default_rng(CS.SEED + 4)
        prompt = rng.integers(0, cfg.vocab_size,
                              size=WINDOW_PROMPT).astype(np.int32)
        want, fed = single_forward(params, cfg, prompt, window)
        eng = ServingEngine(params, cfg, EngineConfig(
            max_batch=1, max_seq_len=8192, max_new_tokens=1,
            mesh=SEQ_MESH), devices=MC.devices()[:3])
        got, _ = CS.mesh_forward(eng, prompt, STEPS, feed=fed,
                                 capacity=window)
        for i, (g, w) in enumerate(zip(got, want)):
            rel, ties = CS._tie_gate(f"{phase} {arch} step {i}",
                                     g.to("cuda:0"), w)
            log(phase, arch=arch, layers=cfg.n_layers, window=window,
                prompt_len=WINDOW_PROMPT, layout=eng.kv.layout,
                logits="prefill" if i == 0 else f"decode_{i}",
                rel_err=f"{rel:.3e}", tol=CS.TOL["bfloat16"],
                ties=json.dumps(ties), against="one card")
        MC.close(eng)
        del eng, params
        CS.gc_empty()


# ---------------------------------------------------------------------------
# (e) llama2-70b with its weights split over data
# ---------------------------------------------------------------------------

def reshard(src, src_mesh, dst_mesh):
    """``src`` per-rank trees placed on ``src_mesh`` moved, leaf by leaf
    through the host, to the serve placement of ``dst_mesh``; each
    source leaf is freed once its destination shards exist, so a card
    never holds both placements whole."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    cfg = registry.get_config(MC.LLAMA)
    meta = MD.init_params(cfg, device="meta")
    s_specs = SH.serve_specs(meta, src_mesh)
    d_specs = SH.serve_specs(meta, dst_mesh)
    out = [SH._map(meta, lambda n, x: None) for _ in range(dst_mesh.size)]
    for names, leaf in SH._walk(meta):
        whole = SH.gather_tree([SH._lookup(t, names) for t in src],
                               SH._lookup(s_specs, names), src_mesh)
        spec = SH._lookup(d_specs, names)
        for r in range(dst_mesh.size):
            sl = SH.shard_slices(tuple(leaf.shape), spec, dst_mesh,
                                 dst_mesh.coords(r))
            _put(out[r], names,
                 whole[sl].to(dst_mesh.devices[r]).contiguous())
        for t in src:
            _put(t, names, None)
        del whole
    return out


def _put(tree, names, value) -> None:
    for n in names[:-1]:
        tree = tree[int(n)] if isinstance(tree, list) else tree[n]
    last = names[-1]
    tree[int(last) if isinstance(tree, list) else last] = value


def llama_data_split(card_names) -> None:
    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_llama_data"
    cfg = registry.get_config(MC.LLAMA)
    prompts = MC.llama_prompts(cfg)
    t0 = time.perf_counter()
    mesh14 = DeviceMesh(MC.MESH, MC.devices())
    shards = SH.init_params_sharded(cfg, mesh14, seed=CS.SEED)
    MC.sync_all()
    log(phase, arch=MC.LLAMA, layers=cfg.n_layers,
        init_s=f"{time.perf_counter() - t0:.1f}")
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=1, max_seq_len=16, max_new_tokens=1, mesh=MC.MESH),
        devices=MC.devices())
    want, fed = CS.mesh_forward(eng, prompts[0], STEPS)
    MC.close(eng)
    del eng
    mesh14.close()
    t0 = time.perf_counter()
    mesh22 = DeviceMesh((2, 2), MC.devices())
    shards = reshard(shards, DeviceMesh(MC.MESH, MC.devices()), mesh22)
    MC.sync_all()
    specs = SH.infer_serve_specs(shards[0], cfg, mesh22)
    log(phase, mesh="2x2", reshard_s=f"{time.perf_counter() - t0:.1f}",
        weights_split_over_data=SH.splits_over_data(specs, mesh22))
    if not SH.splits_over_data(specs, mesh22):
        raise AssertionError(f"{phase}: the (2, 2) placement keeps every "
                             "weight whole over data")
    mesh22.close()
    MC.memory(phase, "weights")
    kw = dict(kv_cache="paged", max_seq_len=MC.LLAMA_CAPACITY)
    # two slots: one a data replica, so the cache splits by heads
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=2, max_seq_len=16, max_new_tokens=1, mesh=(2, 2)),
        devices=MC.devices())
    got, _ = CS.mesh_forward(eng, prompts[0], STEPS, feed=fed)
    for i, (g, w) in enumerate(zip(got, want)):
        rel, ties = CS._tie_gate(f"{phase} step {i}", g, w.to(g.device))
        log(phase, logits="prefill" if i == 0 else f"decode_{i}",
            rel_err=f"{rel:.3e}", tol=CS.TOL["bfloat16"],
            ties=json.dumps(ties), against="the (1, 4) run")
    MC.close(eng)
    del eng
    warm, _, _ = MC.serve(shards, cfg, (2, 2), prompts[:1], 2, **kw)
    MC.close(warm)
    del warm
    eng, counts, wall = MC.serve(shards, cfg, (2, 2), prompts, LLAMA_NEW,
                                 **kw)
    s = CS.mesh_checks(phase, eng, counts, len(prompts),
                       tokens=sum(len(r.output) for r in eng.finished),
                       wall_s=f"{wall:.2f}")
    log(phase, ttft_p50_ms=f"{s['ttft_p50_s'] * 1e3:.2f}",
        itl_p50_ms=f"{s['itl_p50_s'] * 1e3:.2f}",
        tok_per_s=f"{s['tokens_per_s']:.2f}",
        card=f"'{card_names[0]}'")
    audited(phase, eng)
    MC.close(eng)
    del eng
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=8, max_new_tokens=10_000, mesh=(2, 2), **kw),
        devices=MC.devices())
    for p in prompts:
        eng.submit(p)
    while eng.waiting:
        eng.step()
    for _ in range(2):
        eng.step()
    MC.profile_step(phase, eng, card_names)
    MC.memory(phase, "serving", peak=True)
    MC.close(eng)
    del eng, shards
    CS.gc_empty()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (f) nemotron-4-340b over four cards
# ---------------------------------------------------------------------------

def nemotron(card_names) -> None:
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_nemotron"
    cfg = registry.get_config(CS.NEMOTRON).replace(n_layers=NEMOTRON_LAYERS)
    t0 = time.perf_counter()
    shards = SH.init_params_sharded(cfg, DeviceMesh(MC.MESH, MC.devices()),
                                    seed=CS.SEED)
    MC.sync_all()
    log(phase, arch=CS.NEMOTRON, layers=cfg.n_layers, mesh="1x4",
        g_per_rank=cfg.n_heads // cfg.n_kv_heads, d_head=cfg.d_head,
        init_s=f"{time.perf_counter() - t0:.1f}")
    MC.memory(phase, "weights")
    rng = np.random.default_rng(CS.SEED + 16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(64, 513, size=8)]
    errs: dict = {}
    with CS.checked_kernels(errs, CS.ATTENTION_OPS):
        eng, counts, wall = MC.serve(
            shards, cfg, MC.MESH, prompts, CS.NEMOTRON_NEW,
            kv_cache="paged", max_seq_len=CS.NEMOTRON_CAPACITY, **CS.CHUNKED)
    CS.mesh_checks(phase, eng, counts, len(prompts), wall_s=f"{wall:.2f}",
                   checked_calls=json.dumps({k: n for k, (n, _) in
                                             errs.items()}),
                   max_abs_err=json.dumps({k: f"{e:.3e}" for k, (_, e) in
                                           errs.items()}))
    for name in ("paged_decode_attention", "prefill_attention"):
        if not errs.get(name, (0, 0))[0]:
            raise AssertionError(f"{phase}: no {name} call was checked")
    audited(phase, eng)
    MC.close(eng)
    del eng
    eng = ServingEngine(shards, cfg, EngineConfig(
        max_batch=1, max_seq_len=16, max_new_tokens=1, mesh=MC.MESH),
        devices=MC.devices())
    MC.logit_gates(phase, eng, prompts[0], STEPS)
    MC.memory(phase, "after the gates", peak=True)
    log(phase, card=f"'{card_names[0]}'")
    MC.close(eng)
    del eng, shards
    CS.gc_empty()


# ---------------------------------------------------------------------------
# (h) an MoE's capacity over a data-split batch
# ---------------------------------------------------------------------------

def moe_drops() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    phase = "mesh4_moe_drops"
    for arch, depth in DROP_ARCHS:
        cfg = registry.get_config(arch).replace(dtype="float32",
                                                n_layers=depth)
        params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
        prompts = CS.gate_prompts(cfg)
        for kv in ("contiguous", "paged"):
            kw = {"kv_cache": kv, **CS.SPECULATIVE}
            with CS.counting_dispatch_drops() as want_drops:
                single, _, _ = MC.serve(params, cfg, None, prompts, 16, **kw)
            want = MC.streams(single)
            del single
            for mesh in DROP_MESHES:
                with CS.counting_dispatch_drops() as drops:
                    eng, counts, wall = MC.serve(params, cfg, mesh, prompts,
                                                 16, **kw)
                CS.mesh_checks(phase, eng, counts, len(prompts),
                               partitioned=not (kv == "paged"
                                                and mesh[1] == 1),
                               arch=arch, depth=depth,
                               capacity_factor=cfg.moe_capacity_factor,
                               config=f"{kv}+speculative",
                               wall_s=f"{wall:.2f}")
                n = sum(want_drops.values())
                log(phase, arch=arch, kv_cache=kv,
                    mesh=f"{mesh[0]}x{mesh[1]}", dropped_slots=n,
                    dispatches_dropping=sum(v > 0
                                            for v in want_drops.values()),
                    drops_equal=drops == want_drops)
                CS.mesh_stream_gate(phase, MC.streams(eng), want,
                                    "one engine on cuda:0")
                if not n:
                    raise AssertionError(f"{phase} {arch}: no dispatch "
                                         "dropped a routed slot")
                if drops != want_drops:
                    raise AssertionError(f"{phase} {arch} {kv} {mesh}: "
                                         f"dropped {drops}, one card "
                                         f"{want_drops}")
                audited(phase, eng)
                MC.close(eng)
                del eng
                CS.gc_empty()
        del params
        CS.gc_empty()


# ---------------------------------------------------------------------------
# (i) the recurrent sublayers split over model
# ---------------------------------------------------------------------------

def _allocated() -> list:
    """Per card, (``memory_allocated``, the bytes its tensors asked for,
    {address: excess} of its live blocks). The allocator splits a free
    block for a request of over 1 MB only where more than 1 MB would
    remain, and otherwise hands over the whole block: a block's excess
    is its size less its request in 512-byte blocks, read from
    ``torch.cuda.memory_snapshot()``, and ``memory_allocated`` less the
    excess of the blocks a placement made is the 512-byte blocks its
    tensors asked for."""
    import torch
    from repro_torch.launch import dryrun as D
    MC.sync_all()
    excess = [{} for _ in range(MC.N_CARDS)]
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] >= MC.N_CARDS:
            continue
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                excess[seg["device"]][b["address"]] = (
                    b["size"] - D._block(b.get("requested_size", 0)))
    return [(torch.cuda.memory_allocated(i),
             torch.cuda.memory_stats(i)["requested_bytes.all.current"],
             excess[i]) for i in range(MC.N_CARDS)]


def _new_excess(before, after) -> tuple:
    """(bytes, blocks) of whole-block excess in the live blocks of
    ``after`` that ``before`` did not hold."""
    new = [v for a, v in after.items() if a not in before]
    return sum(new), sum(v > 0 for v in new)


def _block_bytes(shape, dtype) -> int:
    import math
    import torch
    from repro_torch.launch import dryrun as D
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return D._block(n)


def predicted_bytes(cfg, mesh) -> dict:
    """A card's bytes of the bf16 weights and of the engine's cache (8
    slots of 2048) as the dry-run places them on ``meta`` — its argument
    bytes (each storage in the allocator's 512-byte blocks) and the
    tensors' own — and as the placement before the split held them: the
    recurrent sublayers' leaves and their state whole over ``model``."""
    from repro_torch.core import trace as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    cell = D.Cell(cfg, "decode", 8, 2048, mesh)
    args = cell._arg_shapes(0)
    new = {"params": D.storage_bytes(args["params"]),
           "cache": D.storage_bytes(args["cache"]),
           "tensor_bytes": sum(t.numel() * t.element_size() for t in
                               T._tensors([args["params"], args["cache"]]))}

    def whole_over_model(spec):
        return tuple(None if e is not None and SH.MODEL in e else e
                     for e in spec)

    old_params = 0
    for names, leaf in SH._walk(cell.params):
        spec = SH._lookup(cell.param_specs, names)
        if any(n in SH.WHOLE_STACKS for n in names):
            spec = whole_over_model(spec)
        old_params += _block_bytes(SH.local_shape(tuple(leaf.shape), spec,
                                                  cell.mesh), leaf.dtype)
    kv = cell.kv
    old_cache = _block_bytes((), kv._meta["len"].dtype)
    for name, spec in kv.placement.items():
        if name in kv.model_specs:
            spec = whole_over_model(spec)
        leaf = kv._meta[name]
        old_cache += _block_bytes(SH.local_shape(tuple(leaf.shape), spec,
                                                 cell.mesh), leaf.dtype)
    cell.close()
    return {**new, "old_params": old_params, "old_cache": old_cache}


def split_f32(arch, depth) -> None:
    """(i)'s float32 streams."""
    from repro_torch.configs import registry
    from repro_torch.models import model as MD
    phase = "mesh4_split_f32"
    cfg = registry.get_config(arch).replace(dtype="float32", n_layers=depth)
    params = MD.init_params(cfg, seed=CS.SEED, device="cuda:0")
    prompts = CS.gate_prompts(cfg)
    want = run(phase, params, cfg, None, prompts, 16, None, "")
    for mesh in SPLIT_MESHES:
        eng, counts, wall = MC.serve(params, cfg, mesh, prompts, 16)
        CS.mesh_checks(phase, eng, counts, len(prompts),
                       partitioned=cfg.family != "ssm", arch=arch,
                       depth=depth, wall_s=f"{wall:.2f}")
        CS.mesh_stream_gate(phase, MC.streams(eng), want,
                            "one engine on cuda:0")
        CS.recurrent_split_check(eng, params)
        audited(phase, eng)
        MC.close(eng)
        del eng
        CS.gc_empty()
    del params
    CS.gc_empty()


def split_bf16(arch, depth, card_names) -> None:
    """(i)'s bf16 bytes, logits and profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.serving import EngineConfig, ServingEngine
    phase = "mesh4_split_bf16"
    cfg = registry.get_config(arch).replace(n_layers=depth)
    rng = np.random.default_rng(CS.SEED + 31)
    prompt = rng.integers(0, cfg.vocab_size,
                          size=SPLIT_PROMPT).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(64, 257, size=8)]
    for shape in SPLIT_MESHES:
        CS.gc_empty()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pred = predicted_bytes(cfg, shape)
        dry_s = time.perf_counter() - t0
        n = shape[0] * shape[1]
        mesh = DeviceMesh(shape, MC.devices()[:n])
        base = _allocated()
        shards = SH.init_params_sharded(cfg, mesh, seed=CS.SEED)
        after_w = _allocated()
        eng = ServingEngine(shards, cfg, EngineConfig(
            max_batch=8, max_seq_len=2048, max_new_tokens=10_000,
            mesh=shape), devices=MC.devices()[:n])
        after_c = _allocated()
        want = pred["params"] + pred["cache"]
        old = pred["old_params"] + pred["old_cache"]
        for i in range(n):
            w, c = (after_w[i][0] - base[i][0],
                    after_c[i][0] - after_w[i][0])
            asked = after_c[i][1] - base[i][1]
            extra, handed = _new_excess(base[i][2], after_c[i][2])
            rel = abs(w + c - want) / want
            rel_b = abs(w + c - extra - want) / want
            rel_t = abs(asked - pred["tensor_bytes"]) / pred["tensor_bytes"]
            log(phase, arch=arch, layers=depth, mesh=f"{shape[0]}x{shape[1]}",
                card=f"cuda:{i}", weights_gb=f"{w / 1e9:.4f}",
                cache_gb=f"{c / 1e9:.4f}",
                measured_gb=f"{(w + c) / 1e9:.4f}",
                predicted_gb=f"{want / 1e9:.4f}",
                predicted_weights_gb=f"{pred['params'] / 1e9:.4f}",
                predicted_cache_gb=f"{pred['cache'] / 1e9:.4f}",
                rel_err_allocated=f"{rel:.2e}",
                allocated_within_tol=rel <= MEM_RTOL,
                whole_block_excess=extra, whole_blocks=handed,
                allocated_less_excess=w + c - extra,
                predicted_blocks=want, rel_err_blocks=f"{rel_b:.2e}",
                tensor_bytes=asked, predicted_tensor_bytes=pred[
                    "tensor_bytes"], rel_err=f"{rel_t:.2e}", tol=MEM_RTOL,
                before_split_gb=f"{old / 1e9:.4f}",
                before_split_weights_gb=f"{pred['old_params'] / 1e9:.4f}",
                dryrun_s=f"{dry_s:.1f}", name_power=f"'{card_names[i]}'")
            if rel_t > MEM_RTOL or rel_b > MEM_RTOL:
                raise AssertionError(f"{phase} {arch} {shape} cuda:{i}: "
                                     f"{asked} bytes asked, "
                                     f"{w + c - extra} in blocks, against "
                                     f"{pred['tensor_bytes']} and {want} "
                                     "predicted")
        # the prefill and 8 steps through the mesh, then one card's on
        # the gathered weights, and the one-card run under one-ulp noise
        got, fed = CS.mesh_forward(eng, prompt, STEPS)
        specs = SH.infer_serve_specs(shards[0], cfg, mesh)
        whole = SH.gather_tree(shards, specs, mesh, "cuda:0")
        capacity = len(prompt) + STEPS + 1
        want_l, _ = single_forward(whole, cfg, prompt, capacity, feed=fed)
        with CS.ulp_noise():
            noisy, _ = single_forward(whole, cfg, prompt, capacity,
                                      feed=fed)
        del whole
        for i, (g, w, z) in enumerate(zip(got, want_l, noisy)):
            g = g.to(w.device)
            wit = ((z - w).norm() / w.norm()).item()
            tol = max(CS.TOL["bfloat16"], CS.FLIP_WITNESS_FACTOR * wit)
            rel, ties = CS._tie_gate(f"{phase} {arch} step {i}", g, w, tol)
            log(phase, arch=arch, mesh=f"{shape[0]}x{shape[1]}",
                logits="prefill" if i == 0 else f"decode_{i}",
                rel_err=f"{rel:.3e}", witness_rel=f"{wit:.3e}",
                limit=f"{tol:.3e}",
                within_3e_2=rel <= CS.TOL["bfloat16"],
                ties=json.dumps(ties), against="one card")
        del want_l, noisy
        for p in prompts:
            eng.submit(p)
        while eng.waiting:
            eng.step()
        for _ in range(2):
            eng.step()
        MC.profile_step(phase, eng, card_names)
        MC.memory(phase, f"{arch} {shape[0]}x{shape[1]} serving", peak=True)
        MC.close(eng)
        mesh.close()
        del eng, shards
        CS.gc_empty()
        torch.cuda.empty_cache()


def recurrent_split(card_names) -> None:
    for arch, f32_depth, bf16_depth in SPLIT_ARCHS:
        split_f32(arch, f32_depth)
        split_bf16(arch, bf16_depth, card_names)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="abcdefhi",
                    help="which of (a)-(f), (h) and (i) to run; (g) runs "
                    "with each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_serve_families_card: torch.cuda.is_available() "
              "is False; this run needs four NVIDIA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < MC.N_CARDS:
        print(f"torch_mesh_serve_families_card: needs {MC.N_CARDS} CUDA "
              f"devices, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = MC.cards()
    for i, line in enumerate(names):
        log("mesh4_device", card=f"cuda:{i}", name_power=f"'{line}'")
    _build.build_all()
    log("mesh4_device", build_s=f"{time.perf_counter() - t0:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda,
        nvcc_seconds=json.dumps({n: _build.build_seconds(
            _build.library_path(n).with_suffix(".log").read_text())
            for n in _build.SOURCES}))
    steps = (("a", families, ()), ("bd", qwen_layouts, (args.parts,)),
             ("c", windows, ()), ("e", llama_data_split, (names,)),
             ("f", nemotron, (names,)), ("h", moe_drops, ()),
             ("i", recurrent_split, (names,)))
    failed = []
    for label, fn, fargs in steps:
        if not set(label) & set(args.parts):
            continue
        t1 = time.perf_counter()
        try:
            fn(*fargs)
        except Exception:   # noqa: BLE001 — report, run the other parts
            traceback.print_exc()
            failed.append(label)
            CS.gc_empty()
        log("mesh4", part=label, ok=label not in failed,
            seconds=f"{time.perf_counter() - t1:.1f}")
    log("mesh4", seconds=f"{time.perf_counter() - t0:.1f}",
        failed=",".join(failed) or "none")
    if failed:
        return 1
    print("\n".join(MC.cards()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
