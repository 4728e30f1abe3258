#!/usr/bin/env python3
"""The dry-run (``repro_torch.launch.dryrun``) held to four NVIDIA cards
of one host.

    python3 scripts/torch_dryrun_card.py

It needs four CUDA devices and exits non-zero with fewer (a missing card
is an error, never a skip). One line per result:

(a) bf16 llama2-70b at full depth, its shards made on their cards
    (``sharding.init_params_sharded`` under the serve placement) with
    the engine's paged caches of 8 slots at capacity 1152 (blocks of
    16), at (1, 4) and at (2, 2): the dry-run's argument bytes per card
    — computed on ``meta`` before anything is placed — against
    ``memory_allocated`` per card after placement, within 1%; the
    params' share printed apart;
(b) bf16 qwen1.5-0.5b at (2, 2), one train step of B 8 x S 2048 (remat
    full), its shards made on their cards: the collective bytes and
    counts every rank records on the cards equal the dry-run's meta
    rank run of the same cell, rank by rank, kind and shape; per card
    the peer-copy ms of a profiled step beside the collective term at
    450 GB/s, and the predicted peak beside ``max_memory_allocated``.

The line before last lists the cards' names and power limits; the last
line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It imports
nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as CS  # noqa: E402  (the one-card script's helpers)
import torch_mesh_card as MC  # noqa: E402  (four-card helpers)

N_CARDS = MC.N_CARDS
LLAMA_SLOTS = 8
LLAMA_MESHES = ((1, 4), (2, 2))
ARG_RTOL = 0.01
QWEN_MESH = (2, 2)
QWEN_SHAPE = (8, 2048)
log = CS.log


def _allocated() -> list:
    import torch
    MC.sync_all()
    return [torch.cuda.memory_allocated(i) for i in range(N_CARDS)]


def llama_bytes(card_names) -> None:
    """(a)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun as D
    cfg = registry.get_config(MC.LLAMA)
    for shape in LLAMA_MESHES:
        phase = f"dryrun_llama_{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        dry = D.Cell(cfg, "decode", LLAMA_SLOTS, MC.LLAMA_CAPACITY, shape,
                     kv_cache="paged")
        arg = dry.argument_bytes()[0]
        shares = {k: D.storage_bytes(v)
                  for k, v in dry._arg_shapes(0).items()}
        dry.close()
        dry_s = time.perf_counter() - t0
        base = _allocated()
        t0 = time.perf_counter()
        cell = D.Cell(cfg, "decode", LLAMA_SLOTS, MC.LLAMA_CAPACITY, shape,
                      kv_cache="paged", devices=MC.devices())
        args = cell.place(CS.SEED)
        now = [a - b for a, b in zip(_allocated(), base)]
        place_s = time.perf_counter() - t0
        rel = [(n - arg) / arg for n in now]
        log(phase, arch=MC.LLAMA, layers=cfg.n_layers, mesh=f"{shape}",
            slots=LLAMA_SLOTS, capacity=MC.LLAMA_CAPACITY, kv="paged",
            predicted_gb_per_card=f"{arg / 1e9:.4f}",
            predicted_params_gb=f"{shares['params'] / 1e9:.4f}",
            predicted_cache_gb=f"{shares['cache'] / 1e9:.4f}",
            measured_gb=json.dumps([round(n / 1e9, 4) for n in now]),
            rel=json.dumps([round(r, 6) for r in rel]),
            dry_s=f"{dry_s:.1f}", place_s=f"{place_s:.1f}",
            card=f"'{card_names[0]}'")
        if max(abs(r) for r in rel) > ARG_RTOL:
            raise AssertionError(f"{phase}: argument bytes {arg} a card "
                                 f"against {now}")
        del args
        cell.close()
        del cell
        CS.gc_empty()
        torch.cuda.empty_cache()


def profiled_peers(fn) -> dict:
    """Per card, (kernel ms, peer-copy ms) of one more call of ``fn``
    (``torch.profiler``, the cards' activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    MC.sync_all()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        MC.sync_all()
    per = {i: [0.0, 0.0] for i in range(N_CARDS)}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        d = per.setdefault(e.device_index, [0.0, 0.0])
        name = e.name.lower()
        if "ptop" in name:
            d[1] += e.device_time / 1e3
        elif "memcpy" not in name and "memset" not in name:
            d[0] += e.device_time / 1e3
    return per


def qwen_collectives(card_names) -> None:
    """(b)."""
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as A
    from repro_torch.roofline import collective_bytes as CB
    phase = "dryrun_qwen_train_2x2"
    cfg = CS.train_cfg()
    b, s = QWEN_SHAPE
    t0 = time.perf_counter()
    meta = D.Cell(cfg, "train", b, s, QWEN_MESH, every_rank=True)
    rec = meta.run(trace=False)
    meta.close()
    peak_pred = rec["memory"]["peak_memory_in_bytes"]
    log(phase, dry_s=f"{time.perf_counter() - t0:.1f}",
        predicted=json.dumps(rec["collectives"]),
        predicted_peak_gb=f"{peak_pred / 1e9:.3f}")
    base = _allocated()
    cell = D.Cell(cfg, "train", b, s, QWEN_MESH, devices=MC.devices())
    args = cell.place(CS.SEED)
    placed = [a - b0 for a, b0 in zip(_allocated(), base)]
    cell.step_on(args)            # warm
    for i in range(N_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    MC.sync_all()
    with CB.recording(cell.mesh) as got:
        t0 = time.perf_counter()
        cell.step_on(args)
        MC.sync_all()
        wall = time.perf_counter() - t0
    peaks = [torch.cuda.max_memory_allocated(i) - base[i]
             for i in range(N_CARDS)]
    equal = (got.per_rank == meta.collectives.per_rank
             and got.report() == rec["collectives"])
    log(phase, measured=json.dumps(got.report()), equal=equal,
        step_wall_ms=f"{wall * 1e3:.1f}")
    if not equal:
        raise AssertionError(f"{phase}: the cards' collectives "
                             f"{got.report()} against the dry-run's "
                             f"{rec['collectives']}")
    coll_ms = rec["collectives"]["total_bytes"] / A.LINK_BW * 1e3
    per = profiled_peers(lambda: cell.step_on(args))
    arg = rec["memory"]["argument_size_in_bytes"]
    for i in range(N_CARDS):
        log(phase, profile=f"cuda:{i}", kernel_ms=f"{per[i][0]:.1f}",
            peer_copy_ms=f"{per[i][1]:.1f}",
            collective_term_ms=f"{coll_ms:.2f}",
            arg_pred_gb=f"{arg / 1e9:.4f}",
            arg_meas_gb=f"{placed[i] / 1e9:.4f}",
            peak_pred_gb=f"{peak_pred / 1e9:.3f}",
            peak_meas_gb=f"{peaks[i] / 1e9:.3f}",
            card=f"'{card_names[i]}'")
    del args
    cell.close()
    CS.gc_empty()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_dryrun_card: torch.cuda.is_available() is False; "
              "this run needs four NVIDIA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < N_CARDS:
        print(f"torch_dryrun_card: needs {N_CARDS} CUDA devices, sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = MC.cards()
    for i, line in enumerate(names):
        log("dryrun_card_device", card=f"cuda:{i}", name_power=f"'{line}'")
    _build.build_all(("rmsnorm",))
    log("dryrun_card_device", build_s=f"{time.perf_counter() - t0:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda)
    for label, fn in (("a", llama_bytes), ("b", qwen_collectives)):
        t1 = time.perf_counter()
        fn(names)
        log("dryrun_card", part=label,
            seconds=f"{time.perf_counter() - t1:.1f}")
    log("dryrun_card", seconds=f"{time.perf_counter() - t0:.1f}")
    print("\n".join(names), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
