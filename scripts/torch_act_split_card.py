#!/usr/bin/env python3
"""The reference's two activation placements — the logits kept split
over ``model`` by vocabulary through a vocab-parallel loss, and
``act_shard`` (the residual stream split over ``model``) — held on four
NVIDIA cards of one host.

    python3 scripts/torch_act_split_card.py [--layers N] [--parts abcd]
    python3 scripts/torch_act_split_card.py --one-card --parts d

It needs four CUDA devices and exits non-zero with fewer (a missing card
is an error, never a skip); ``--one-card`` runs part (d) with its four
ranks on ``cuda:0`` (a serving mesh may share a card; a training mesh
takes a card a rank, so (a)–(c) need four), nemotron at (1, 4) only
(its (2, 2) holds the weights twice and does not fit). It builds K5 / K5b and
K1–K4 from the checkout. One line per result:

(a) float32 qwen1.5-0.5b, 24 layers at full width (random weights from
    the seed), one batch of B 8 x S 512 at (1, 4) and (2, 2): the loss
    and gradients of the split logits (``collectives.vocab_nll``) against
    the gathered logits of the earlier path (``hints.logits`` gathering
    the vocab on every model rank, the loss over the whole vocab) on the
    same shards and batch — the loss within LOSS_RTOL, every reassembled
    gradient leaf within ``chip_smoke.py`` 14b's per-leaf gate, each
    path's loss the same bits on every rank;
(b) bf16 qwen1.5-0.5b at full depth, one train step of B 8 x S 2048 at
    (2, 2) through the dry-run's ``Cell`` placed on the cards (as
    ``scripts/torch_dryrun_card.py`` (b)): ``max_memory_allocated`` a
    card, gathered and split, each against the meta dry-run's prediction
    of the same cell (``chip_smoke.py`` phase 17's range);
(c) bf16 nemotron-4-340b at full width, 2 layers, B 2 x S 4096 at
    (1, 4), act_shard "dmodel" against "none" on the same shards and
    batch: the loss and every gradient the same bits on each card, and
    the peak a card of each;
(d) nemotron-4-340b's and dbrx-132b's bf16 greedy streams (2 layers,
    full width) at (1, 4) and (2, 2), act_shard "dmodel" against
    "none": blocking on the contiguous cache, chunked (256) on the paged
    one, speculative (gamma 4) on the contiguous one — equal.

``--layers N`` cuts (a) and (b) to N layers (a short check of the
path). The line before last lists the cards' names and power limits;
the last line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
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
import torch_mesh_train_card as TC  # noqa: E402  (four-card training)

N_CARDS = MC.N_CARDS
F32_MESHES = ((1, 4), (2, 2))
F32_SHAPE = (8, 512)
LOSS_RTOL = TC.LOSS_RTOL
BF16_MESH = (2, 2)
BF16_SHAPE = (8, 2048)
NEMOTRON = "nemotron-4-340b"
SPLIT_LAYERS = 2
NEMOTRON_MESH = (1, 4)
NEMOTRON_SHAPE = (2, 4096)
SERVE_MESHES = ((1, 4), (2, 2))
# --one-card: nemotron's (2, 2) holds its 2 layers' weights twice on the
# one card (70 GB with the 18.9 GB of embedding and head), and runs out
ONE_CARD_MESHES = {NEMOTRON: ((1, 4),), MC.DBRX: SERVE_MESHES}
SERVE_CONFIGS = (dict(kv_cache="contiguous", scheduler="blocking"),
                 dict(kv_cache="paged", scheduler="chunked",
                      chunk_tokens=CS.CHUNK_TOKENS),
                 dict(kv_cache="contiguous", scheduler="speculative",
                      spec_gamma=4))
SERVE_LENS = (64, 200, 333, 512)
SERVE_NEW = 8
log = CS.log


def rank_grads(mt, pr, parts):
    """Per rank (loss, gradients) of :meth:`MeshTrain.grads` on its
    shards and microbatches."""
    return mt.run(lambda r: mt.grads(pr[r], r, parts[r]))


def losses_same_bits(phase, what, outs) -> float:
    import torch
    vals = [o[0].cpu() for o in outs]
    if not all(torch.equal(v, vals[0]) for v in vals):
        raise AssertionError(f"{phase} {what}: the loss differs between "
                             f"ranks: {vals}")
    return vals[0].item()


def vocab_f32(layers) -> None:
    """(a)."""
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    phase = "split_vocab_f32"
    cfg = CS.train_cfg(dtype="float32", n_layers=layers or 24)
    params = MD.init_params(cfg, seed=CS.SEED, device=TC.HOME)
    batch = TC.stream_batch(cfg, F32_SHAPE)
    for shape in F32_MESHES:
        what = f"{shape[0]}x{shape[1]}"
        mesh = DeviceMesh(shape, MC.devices())
        mt = ST.MeshTrain(cfg, mesh)
        pr = mt.shard(params)
        parts = ST.mesh_parts(mt, batch)
        t0 = time.perf_counter()
        split = rank_grads(mt, pr, parts)
        MC.sync_all()
        split_s = time.perf_counter() - t0
        with CS.gathered_logits():
            whole = rank_grads(mt, pr, parts)
        got = losses_same_bits(phase, f"{what} split", split)
        want = losses_same_bits(phase, f"{what} gathered", whole)
        rel = abs(got - want) / abs(want)
        log(phase, mesh=what, layers=cfg.n_layers, batch=F32_SHAPE[0],
            seq=F32_SHAPE[1], split_loss=f"{got:.8f}",
            gathered_loss=f"{want:.8f}", loss_rel_err=f"{rel:.3e}",
            tol=LOSS_RTOL, same_bits_every_rank=True,
            split_grads_s=f"{split_s:.2f}")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{phase} {what}: the split loss {got} "
                                 f"against the gathered {want}")
        CS.grad_gate(phase, f"split_vs_gathered_{what}",
                     mt.gather([o[1] for o in split], TC.HOME),
                     mt.gather([o[1] for o in whole], TC.HOME))
        del split, whole, pr
        mesh.close()
        CS.gc_empty()


def vocab_peak(layers, card_names) -> None:
    """(b)."""
    import torch
    from repro_torch.launch import dryrun as D
    phase = "split_vocab_bf16"
    cfg = CS.train_cfg(**({"n_layers": layers} if layers else {}))
    b, s = BF16_SHAPE
    peaks = {}
    for label, ctx in (("gathered", CS.gathered_logits),
                       ("split", contextlib.nullcontext)):
        with ctx():
            t0 = time.perf_counter()
            meta = D.Cell(cfg, "train", b, s, BF16_MESH)
            pred = meta.run(trace=False)["memory"]["peak_memory_in_bytes"]
            meta.close()
            dry_s = time.perf_counter() - t0
            MC.sync_all()
            base = [torch.cuda.memory_allocated(i) for i in range(N_CARDS)]
            cell = D.Cell(cfg, "train", b, s, BF16_MESH,
                          devices=MC.devices())
            args = cell.place(CS.SEED)
            cell.step_on(args)        # warm: the step's first call
            MC.sync_all()
            for i in range(N_CARDS):
                torch.cuda.reset_peak_memory_stats(i)
            t0 = time.perf_counter()
            outs = cell.step_on(args)
            MC.sync_all()
            wall = time.perf_counter() - t0
            meas = [torch.cuda.max_memory_allocated(i) - base[i]
                    for i in range(N_CARDS)]
            ratios = [pred / m for m in meas]
            log(phase, logits=label, mesh="2x2", layers=cfg.n_layers,
                batch=b, seq=s, loss=f"{outs[0][2]['loss'].item():.5f}",
                peak_pred_gb=f"{pred / 1e9:.3f}",
                peak_meas_gb=json.dumps([round(m / 1e9, 3) for m in meas]),
                pred_over_meas=json.dumps([round(r, 4) for r in ratios]),
                range=json.dumps(CS.PEAK_RANGE),
                step_wall_ms=f"{wall * 1e3:.1f}", dry_s=f"{dry_s:.1f}",
                card=f"'{card_names[0]}'")
            if not all(CS.PEAK_RANGE[0] <= r <= CS.PEAK_RANGE[1]
                       for r in ratios):
                raise AssertionError(f"{phase} {label}: predicted peak "
                                     f"{pred} against {meas}")
            peaks[label] = meas
            del args, outs
            cell.close()
            CS.gc_empty()
            torch.cuda.empty_cache()
    fall = [(g - p) / 1e9 for g, p in zip(peaks["gathered"],
                                            peaks["split"])]
    log(phase, check="peak_falls", fall_gb=json.dumps(
        [round(f, 3) for f in fall]))
    if min(fall) <= 0:
        raise AssertionError(f"{phase}: the split logits' peak {peaks}")


def act_train(card_names) -> None:
    """(c)."""
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    phase = "split_act_train"
    cfg = CS.train_cfg(NEMOTRON, n_layers=SPLIT_LAYERS, microbatch=1)
    assert cfg.act_shard == "dmodel"
    mesh = DeviceMesh(NEMOTRON_MESH, MC.devices())
    runs = {m: ST.MeshTrain(cfg.replace(act_shard=m), mesh)
            for m in ("none", "dmodel")}
    t0 = time.perf_counter()
    pr = SH.init_params_sharded(cfg, mesh, seed=CS.SEED,
                                specs=runs["none"].specs)
    batch = TC.stream_batch(cfg, NEMOTRON_SHAPE)
    parts = ST.mesh_parts(runs["none"], batch)
    MC.sync_all()
    log(phase, arch=NEMOTRON, layers=SPLIT_LAYERS, mesh="1x4",
        batch=NEMOTRON_SHAPE[0], seq=NEMOTRON_SHAPE[1],
        made_shards_s=f"{time.perf_counter() - t0:.1f}")
    outs, peaks = {}, {}
    for mode, mt in runs.items():
        base = [torch.cuda.memory_allocated(i) for i in range(N_CARDS)]
        for i in range(N_CARDS):
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        outs[mode] = rank_grads(mt, pr, parts)
        MC.sync_all()
        peaks[mode] = [torch.cuda.max_memory_allocated(i) - base[i]
                       for i in range(N_CARDS)]
        loss = losses_same_bits(phase, mode, outs[mode])
        log(phase, act_shard=mode, loss=f"{loss:.6f}",
            grads_s=f"{time.perf_counter() - t0:.1f}",
            peak_over_weights_gb=json.dumps(
                [round(p / 1e9, 3) for p in peaks[mode]]))
    equal = [torch.equal(a[0], b[0]) and TC.same_bits(a[1], b[1])
             for a, b in zip(outs["dmodel"], outs["none"])]
    log(phase, check="dmodel_vs_none_bitwise", equal_by_card=json.dumps(
        equal), peak_fall_gb=json.dumps(
        [round((a - b) / 1e9, 3) for a, b in zip(peaks["none"],
                                                 peaks["dmodel"])]),
        card=f"'{card_names[0]}'")
    if not all(equal):
        raise AssertionError(f"{phase}: act_shard dmodel's loss or "
                             f"gradients differ from none's: {equal}")
    del outs, pr
    mesh.close()
    CS.gc_empty()
    torch.cuda.empty_cache()


def act_serve(card_names, meshes=None) -> None:
    """(d); ``meshes`` per arch (default SERVE_MESHES for both)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    phase = "split_act_serve"
    for arch in (NEMOTRON, MC.DBRX):
        cfg = registry.get_config(arch).replace(n_layers=SPLIT_LAYERS)
        assert cfg.act_shard == "dmodel"
        rng = np.random.default_rng(CS.SEED + 3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in SERVE_LENS]
        for shape in (meshes or {}).get(arch, SERVE_MESHES):
            what = f"{shape[0]}x{shape[1]}"
            mesh = DeviceMesh(shape, MC.devices())
            shards = SH.init_params_sharded(cfg, mesh, seed=CS.SEED)
            mesh.close()
            for ecfg in SERVE_CONFIGS:
                got = {}
                for mode in ("none", "dmodel"):
                    eng, counts, wall = MC.serve(
                        shards, cfg.replace(act_shard=mode), shape, prompts,
                        SERVE_NEW, max_batch=4, max_seq_len=1024, **ecfg)
                    got[mode] = MC.streams(eng)
                    MC.close(eng)
                    log(phase, arch=arch, mesh=what, act_shard=mode,
                        engine=f"{ecfg['kv_cache']}+{ecfg['scheduler']}",
                        wall_s=f"{wall:.2f}", launches=json.dumps(counts))
                equal = got["dmodel"] == got["none"]
                log(phase, arch=arch, mesh=what, check="streams_equal_none",
                    engine=f"{ecfg['kv_cache']}+{ecfg['scheduler']}",
                    equal=equal, tokens=sum(len(v) for v in
                                            got["none"].values()),
                    card=f"'{card_names[0]}'")
                if not equal:
                    raise AssertionError(f"{phase} {arch} {what} {ecfg}: "
                                         "dmodel's streams differ")
            del shards
            CS.gc_empty()
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut (a) and (b) to this depth (0: full)")
    ap.add_argument("--parts", default="abcd",
                    help="the parts to run, of abcd")
    ap.add_argument("--one-card", action="store_true",
                    help="part (d) only, its four ranks on cuda:0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_act_split_card: torch.cuda.is_available() is False; "
              "this run needs NVIDIA cards", file=sys.stderr)
        return 2
    need = 1 if args.one_card else N_CARDS
    if torch.cuda.device_count() < need:
        print(f"torch_act_split_card: needs {need} CUDA devices, sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.one_card:
        if set(args.parts) - {"d"}:
            print("torch_act_split_card: --one-card runs part d only",
                  file=sys.stderr)
            return 2
        MC.devices = lambda: (torch.device("cuda", 0),) * N_CARDS
        MC.sync_all = lambda: torch.cuda.synchronize(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = MC.cards()
    for i, line in enumerate(names):
        log("split_card_device", card=f"cuda:{i}", name_power=f"'{line}'")
    _build.build_all()
    log("split_card_device", build_s=f"{time.perf_counter() - t0:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda,
        layers=args.layers or "full", one_card=args.one_card)
    parts = {"a": (vocab_f32, (args.layers,)),
             "b": (vocab_peak, (args.layers, names)),
             "c": (act_train, (names,)),
             "d": (act_serve, (names, ONE_CARD_MESHES if args.one_card
                                   else None))}
    for label in args.parts:
        fn, fargs = parts[label]
        t1 = time.perf_counter()
        fn(*fargs)
        log("split_card", part=label,
            seconds=f"{time.perf_counter() - t1:.1f}")
    log("split_card", seconds=f"{time.perf_counter() - t0:.1f}")
    print("\n".join(MC.cards()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
