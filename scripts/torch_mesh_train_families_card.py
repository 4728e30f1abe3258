#!/usr/bin/env python3
"""Training the port's other families over a mesh of NVIDIA cards — the
recurrent and audio families, widths that do not divide ``model``, the
``pod`` axis — and elastic restart over a mesh.

    python3 scripts/torch_mesh_train_families_card.py [--layers N]
        [--parts defgh]

It needs four CUDA devices of one host and exits non-zero with fewer (a
missing card is an error, never a skip). It builds the kernel of the
training path (K5 and its backward K5b, ``src/repro_torch/kernels/csrc/
rmsnorm.cu``) and runs ``launch.steps.build_train_step`` /
``MeshTrain`` over ``cuda:0..3``, random weights from the seed, one
line per result (a float32 tolerance gate not met is logged and the
part goes on for its other figures; the script then exits 1). The
float32 gates of every part hold one mesh step against
``accumulated_grads`` + AdamW on ``cuda:0`` on the same batch, over the
mesh's row partition (``microbatch`` = its microbatches x FSDP ranks;
beside it the config's microbatch, and the spread between the two):
loss and ``grad_norm`` within LOSS_RTOL, every reassembled gradient leaf
within ``chip_smoke.py`` 14b's per-leaf gate, every param after AdamW
off 14b's tolerance only where the two gradients sit at float32 noise
(``torch_mesh_train_card.adamw_gate``), the metrics the same bits on
every rank, the same mesh step twice the same bits, every rank's copy
of a shared shard the same bits, and every card's K5 / K5b launches the
one-card step's.

(d) zamba2-2.7b at full width: float32 at ZAMBA_F32_LAYERS layers (two
    groups of 6 Mamba2 layers and the shared block twice) at (pod, data,
    model) = (2, 1, 2) and (1, 2, 2), B x S = F32_SHAPE; then bf16 at
    full depth (54 Mamba2 layers) at (2, 1, 2), ZAMBA_BF16_STEPS steps
    of B x S = BF16_SHAPE: step wall, device ms, peer-copy ms and idle
    share per card, tokens/s, peak GB per card beside one card's step;
(e) xlstm-350m, all 24 layers, float32 at (2, 2), S = XLSTM_SHAPE's
    (the sLSTM runs S steps of small ops on every rank from one
    interpreter: the step is host-bound, its wall printed);
(f) whisper-large-v3 at full width, float32 at WHISPER_F32_LAYERS
    encoder + decoder layers at (2, 2) and at (1, 4) — where the vocab
    (51866) does not divide model: the head whole over it —; then bf16
    at all 32 + 32 layers at (2, 2) with its figures;
(g) float32 qwen1.5-0.5b at (1, 3) on three of the cards: its 16 heads,
    d_ff 2816 and vocab 151936 do not divide 3, every sublayer runs
    whole on each model rank;
(h) elastic restart: bf16 qwen at (2, 2), B 8 x S 2048, through
    ``RestartPolicy`` with checkpoints every 5 steps: 20 steps, then the
    same 20 with a failure injected at step 13 — its final state on
    every rank bitwise the first run's (deterministic algorithms,
    cuBLAS's workspace set before CUDA starts) —; then the step-15
    checkpoint restored onto (1, 2) (a lost node) and onto one card and
    5 more steps, each loss within ELASTIC_RTOL of the (2, 2) run's at
    the same step; each save's and restore's seconds apart from the
    steps'.

``--layers N`` cuts every model to N layers (zamba2 to a multiple of 6,
whisper N + N) and the bf16 runs to 2 steps: a short check of the
paths. The line before last lists the cards' names and power limits; the
last line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS's deterministic workspace, read when CUDA starts: (h)'s bitwise
# replay runs under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as CS  # noqa: E402  (the one-card script's helpers)
import torch_mesh_card as MC  # noqa: E402  (four-card helpers)
import torch_mesh_train_card as MT  # noqa: E402  (the mesh-train gates)

N_CARDS = MC.N_CARDS
HOME = MT.HOME
LOSS_RTOL = MT.LOSS_RTOL
ZAMBA = "zamba2-2.7b"
ZAMBA_F32_LAYERS = 12
ZAMBA_F32_MESHES = ((2, 1, 2), (1, 2, 2))
ZAMBA_BF16_MESH = (2, 1, 2)
ZAMBA_BF16_STEPS = 5
F32_SHAPE = (4, 512)
BF16_SHAPE = (4, 2048)
XLSTM = "xlstm-350m"
XLSTM_SHAPE = (4, 256)
WHISPER = "whisper-large-v3"
WHISPER_F32_LAYERS = 4
WHISPER_F32_MESHES = ((2, 2), (1, 4))
WHISPER_SHAPE = (4, 256)   # B x decoder tokens; 1500 encoder frames
WHISPER_BF16_STEPS = 3
QWEN = "qwen1.5-0.5b"
QWEN_SHAPE = (8, 512)
ELASTIC_SHAPE = (8, 2048)
ELASTIC_STEPS, ELASTIC_EVERY, ELASTIC_FAIL_AT = 20, 5, 13
ELASTIC_FROM, ELASTIC_MORE = 15, 5
ELASTIC_RTOL = 3e-2
log = CS.log
FAILED: list = []   # gates of a part not met; the script exits 1 at its end


def devices(n=N_CARDS):
    import torch
    return tuple(torch.device("cuda", i) for i in range(n))


def meshes_name(shape) -> str:
    return "x".join(map(str, shape))


def batch_of(cfg, shape, step=0) -> dict:
    """Step ``step`` of ``make_train_stream``'s batches on the host, a
    whisper batch with its frames."""
    import torch
    if cfg.family != "audio":
        return MT.stream_batch(cfg, shape, step)
    from repro_torch.models import model as MD
    b, s = shape
    return {k: v.cpu() for k, v in MD.make_dummy_batch(
        cfg, b, s, seed=CS.SEED + step, device="cpu").items()
            if isinstance(v, torch.Tensor)}


def counts_each(phase, n, want) -> None:
    """Every one of the first ``n`` cards' K5 / K5b launches since the
    last reset equal to ``want`` (one rank's), no other kernel."""
    from repro_torch.kernels import ops
    by = ops.rmsnorm_counts_by_card()
    other = {k: v for k, v in ops.launch_counts().items()
             if k != "rmsnorm" and v}
    log(phase, k5_k5b_by_card=json.dumps({f"cuda:{c}": list(v)
                                          for c, v in by.items()}),
        expected_each=json.dumps(list(want)), other=json.dumps(other))
    if want == (0, 0):
        ok = not by
    else:
        ok = sorted(by) == list(range(n)) and all(
            v == tuple(want) for v in by.values())
    if other or not ok:
        raise AssertionError(f"{phase}: K5 / K5b launches {by} {other}, "
                             f"expected {want} on each of {n} cards")


def one_card(cfg, params, batch, opt):
    """``accumulated_grads`` and one AdamW step on HOME: (loss, grads,
    params after, stats, (K5, K5b) launches)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    MC.sync_all()
    ops.reset_launch_counts()
    loss, g = ST.accumulated_grads(params, cfg, MT.on(batch, HOME))
    MC.sync_all()
    by = ops.rmsnorm_counts_by_card().get(0, (0, 0))
    p1, _, st = opt.apply(g, opt.init(params), params)
    return loss.item(), g, p1, st, tuple(by)


def _worst_leaf(got, want) -> float:
    """The largest leaf error of ``got`` against ``want``, relative to
    the leaf's norm."""
    from repro_torch import tree as T
    return max((a.float() - b.float()).norm().item()
               / max(b.float().norm().item(), 1e-30)
               for a, b in zip(T.leaves(got), T.leaves(want)))


def f32_gates(phase, cfg, batch, shapes, card_names) -> None:
    """The float32 gates of one mesh step at each of ``shapes`` against
    one card (module docstring). The one card computes the same function
    over the mesh's row partition — ``microbatch`` = the mesh's
    microbatches x its FSDP ranks, so each product sees the rows a rank
    sees —; beside it, the one card at the config's microbatch, and how
    far the two one-card runs lie apart (the model's own float32 noise
    under another row partition)."""
    import torch
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                          weight_decay=0.0))
    params = MD.init_params(cfg, seed=CS.SEED, device=HOME)
    b, s = batch["tokens"].shape
    refs = {}

    def ref(parts):
        if parts not in refs:
            t0 = time.perf_counter()
            c = cfg.replace(microbatch=parts)
            refs[parts] = one_card(c, params, batch, opt)
            loss, _, _, st, k5 = refs[parts]
            log(phase, one_card=HOME, microbatches=ST.microbatches(c, b),
                loss=f"{loss:.8f}", grad_norm=f"{st['grad_norm'].item():.8f}",
                k5_k5b=list(k5), seconds=f"{time.perf_counter() - t0:.2f}",
                layers=cfg.n_layers, batch=b, seq=s, remat=cfg.remat,
                card=f"'{card_names[0]}'")
        return refs[parts]

    own = ST.microbatches(cfg, b)
    base = ref(own)
    for shape in shapes:
        what = meshes_name(shape)
        n = 1
        for x in shape:
            n *= x
        mesh = DeviceMesh(shape, devices(n))
        mt = ST.MeshTrain(cfg, mesh)
        mb = ST.microbatches(cfg, b, mt.fsdp)
        loss1, g1, p1, st1, k5 = ref(mb * mt.fsdp)
        norm1, norm0 = (st1["grad_norm"].item(),
                        base[3]["grad_norm"].item())
        if base is not refs[mb * mt.fsdp]:
            log(phase, check="one_card_row_partition_witness",
                microbatches=f"{own}_vs_{mb * mt.fsdp}",
                loss_rel=f"{MT.rel(loss1, base[0]):.3e}",
                norm_rel=f"{MT.rel(norm1, norm0):.3e}",
                worst_leaf_rel=f"{_worst_leaf(g1, base[1]):.3e}")
        pr = mt.shard(params)
        sr = [opt.init(p) for p in pr]
        outs, wall = MT.mesh_once(mt, opt, pr, sr, batch)
        counts_each(f"{phase}_{what}", n,
                    tuple(c * mb // (mb * mt.fsdp) for c in k5))
        MT.metrics_equal(phase, what, outs)
        m = outs[0][2]
        lr_, nr_ = (MT.rel(m["loss"].item(), loss1),
                    MT.rel(m["grad_norm"].item(), norm1))
        g_mesh = mt.gather([o[3] for o in outs], HOME)
        log(phase, mesh=what, check="loss_and_norm_vs_one_card",
            microbatches=mb, loss=f"{m['loss'].item():.8f}",
            loss_rel_err=f"{lr_:.3e}",
            grad_norm=f"{m['grad_norm'].item():.8f}",
            norm_rel_err=f"{nr_:.3e}", tol=LOSS_RTOL,
            beside_config_microbatch=json.dumps({
                "loss_rel": f"{MT.rel(m['loss'].item(), base[0]):.3e}",
                "norm_rel": f"{MT.rel(m['grad_norm'].item(), norm0):.3e}",
                "worst_leaf_rel": f"{_worst_leaf(g_mesh, base[1]):.3e}"}),
            step_s=f"{wall:.2f}", whole_over_model=json.dumps(
                sorted(mt.whole)))
        fails = []
        if lr_ > LOSS_RTOL or nr_ > LOSS_RTOL:
            fails.append("loss or grad_norm off one card's")
        try:
            CS.grad_gate(phase, f"mesh_{what}", g_mesh, g1)
            p_mesh = mt.gather([o[0] for o in outs], HOME)
            MT.adamw_gate(phase, f"mesh_{what}", (g_mesh, p_mesh), (g1, p1))
        except AssertionError as e:
            fails.append(str(e))
        if fails:   # recorded; the part goes on for its other figures
            FAILED.append(f"{phase} {what}: {'; '.join(fails)}")
            log(phase, mesh=what, gate="FAILED", why=f"'{fails[0]}'")
        MT.replicas_gate(phase, f"{what}_grads", mt, [o[3] for o in outs])
        MT.replicas_gate(phase, f"{what}_params", mt, [o[0] for o in outs])
        again, _ = MT.mesh_once(mt, opt, pr, sr, batch)
        same = all(MT.same_bits(a[0], c[0]) and MT.same_bits(a[3], c[3])
                   and MT.same_bits(a[2], c[2]) for a, c in zip(outs, again))
        log(phase, mesh=what, check="same_mesh_twice_bitwise", equal=same)
        if not same:
            raise AssertionError(f"{phase} {what}: two runs differ")
        del outs, again, g_mesh, pr, sr
        mesh.close()
        torch.cuda.empty_cache()


def peak_one_card(cfg, batch, opt):
    """Peak GB on HOME of one train step of ``cfg`` there ("does not
    fit" where it runs out of memory)."""
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(0)
    try:
        params = MD.init_params(cfg, seed=CS.SEED, device=HOME)
        step = ST.build_train_step(cfg, opt)
        out = step(params, opt.init(params), MT.on(batch, HOME))
        MC.sync_all()
        peak = torch.cuda.max_memory_allocated(0) / 1e9
        del params, out
    except torch.OutOfMemoryError:
        peak = "does not fit"
    torch.cuda.empty_cache()
    return peak


def bf16_run(phase, cfg, shape, batches, card_names,
             one_card_gb="not measured"):
    """``len(batches)`` steps of ``build_train_step`` over a mesh of
    ``shape`` on the first cards, the shards made on their cards (the
    whole state never exists); then one more step profiled. Logs the
    figures; returns the per-step metrics."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamW, OptConfig
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=2, total_steps=20,
                          moment_dtype=cfg.optimizer_state_dtype))
    n = 1
    for x in shape:
        n *= x
    mesh = DeviceMesh(shape, devices(n))
    mt = ST.MeshTrain(cfg, mesh)
    for i in range(N_CARDS):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    pr = SH.init_params_sharded(cfg, mesh, seed=CS.SEED, specs=mt.specs)
    sr = [opt.init(p) for p in pr]
    MC.sync_all()
    log(phase, made_shards_s=f"{time.perf_counter() - t0:.1f}",
        memory_allocated_gb=json.dumps([
            round(torch.cuda.memory_allocated(i) / 1e9, 2)
            for i in range(n)]))
    step = ST.build_train_step(cfg, opt)
    metrics, walls = [], []
    b, s = batches[0]["tokens"].shape
    with H.use_mesh(mesh, train=True):
        ops.reset_launch_counts()
        for batch in batches:
            t0 = time.perf_counter()
            pr, sr, m = step(pr, sr, batch)
            m = {k: v.item() for k, v in m.items()}
            MC.sync_all()
            walls.append(time.perf_counter() - t0)
            metrics.append(m)
            log(phase, step=len(walls), loss=f"{m['loss']:.5f}",
                grad_norm=f"{m['grad_norm']:.4f}",
                wall_s=f"{walls[-1]:.3f}")
        by = ops.rmsnorm_counts_by_card()
        log(phase, k5_k5b_by_card=json.dumps({f"cuda:{c}": list(v)
                                              for c, v in by.items()}))
        if cfg.norm == "rmsnorm" and (sorted(by) != list(range(n)) or len(
                set(by.values())) != 1 or not all(min(v) for v in
                                                  by.values())):
            raise AssertionError(f"{phase}: K5 / K5b not launched alike on "
                                 f"every card: {by}")
        wall = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
        busy = MT.profiled(phase, lambda: step(pr, sr, batches[-1]), wall,
                           card_names)
    log(phase, arch=cfg.name, dtype=cfg.dtype, mesh=meshes_name(shape),
        layers=cfg.n_layers, remat=cfg.remat, batch=b, seq=s,
        microbatches=ST.microbatches(cfg, b, mt.fsdp),
        step_wall_ms_median=f"{wall * 1e3:.1f}",
        step_wall_ms_first=f"{walls[0] * 1e3:.1f}",
        device_ms_by_card=json.dumps({f"cuda:{i}": round(v, 1)
                                      for i, v in busy.items()}),
        tokens_per_s=f"{b * s / wall:.0f}",
        max_memory_allocated_gb=json.dumps([
            round(torch.cuda.max_memory_allocated(i) / 1e9, 2)
            for i in range(n)]),
        one_card_step_peak_gb=(one_card_gb if isinstance(one_card_gb, str)
                               else f"{one_card_gb:.2f}"),
        card=f"'{card_names[0]}'")
    del pr, sr
    mesh.close()
    torch.cuda.empty_cache()
    return metrics


# ---------------------------------------------------------------------------
# (d) - (g)
# ---------------------------------------------------------------------------

def zamba(layers, card_names) -> None:
    from repro_torch.optim import AdamW, OptConfig
    depth = (max(6, layers - layers % 6) if layers else ZAMBA_F32_LAYERS)
    cfg = CS.train_cfg(ZAMBA, dtype="float32", n_layers=depth)
    f32_gates("mesh_train_zamba2_f32", cfg, batch_of(cfg, F32_SHAPE),
              ZAMBA_F32_MESHES, card_names)
    cfg = CS.train_cfg(ZAMBA, **({"n_layers": depth} if layers else {}))
    steps = 2 if layers else ZAMBA_BF16_STEPS
    batches = [batch_of(cfg, BF16_SHAPE, i) for i in range(steps)]
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=2, total_steps=20,
                          moment_dtype=cfg.optimizer_state_dtype))
    one = peak_one_card(cfg, batches[0], opt)
    bf16_run("mesh_train_zamba2_bf16", cfg, ZAMBA_BF16_MESH, batches,
             card_names, one)


def xlstm(layers, card_names) -> None:
    cfg = CS.train_cfg(XLSTM, dtype="float32",
                       **({"n_layers": max(8, layers - layers % 8)}
                          if layers else {}))
    t0 = time.perf_counter()
    f32_gates("mesh_train_xlstm_f32", cfg, batch_of(cfg, XLSTM_SHAPE),
              ((2, 2),), card_names)
    log("mesh_train_xlstm_f32", seq=XLSTM_SHAPE[1],
        slstm_layers=cfg.n_layers // cfg.slstm_every,
        part_wall_s=f"{time.perf_counter() - t0:.1f}")


def whisper(layers, card_names) -> None:
    depth = layers or WHISPER_F32_LAYERS
    cfg = CS.train_cfg(WHISPER, dtype="float32", n_layers=depth,
                       n_encoder_layers=depth)
    f32_gates("mesh_train_whisper_f32", cfg, batch_of(cfg, WHISPER_SHAPE),
              WHISPER_F32_MESHES, card_names)
    cfg = CS.train_cfg(WHISPER, **({"n_layers": depth,
                                    "n_encoder_layers": depth}
                                   if layers else {}))
    steps = 2 if layers else WHISPER_BF16_STEPS
    bf16_run("mesh_train_whisper_bf16", cfg, (2, 2),
             [batch_of(cfg, WHISPER_SHAPE, i) for i in range(steps)],
             card_names)


def qwen_fallback(layers, card_names) -> None:
    cfg = CS.train_cfg(QWEN, dtype="float32", n_layers=layers or 24)
    f32_gates("mesh_train_qwen_1x3", cfg, batch_of(cfg, QWEN_SHAPE),
              ((1, 3),), card_names)


# ---------------------------------------------------------------------------
# (h) elastic restart
# ---------------------------------------------------------------------------

def _timed_saves(manager, seconds):
    """``manager.save`` timed into ``seconds``."""
    save = manager.save

    def timed(*a, **kw):
        t0 = time.perf_counter()
        save(*a, **kw)
        seconds.append(time.perf_counter() - t0)
    manager.save = timed
    return manager


def _like_on(whole_meta, dev):
    """Leaves of the whole shapes and dtypes on ``dev``, no storage: the
    ``like`` of a restore onto one card."""
    import torch
    from repro_torch import tree as T
    return T.tree_map(lambda t: torch.empty((), dtype=t.dtype,
                                            device=dev).expand(t.shape),
                      whole_meta)


def elastic(layers, card_names) -> None:
    import shutil
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import hints as H
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault_tolerance import RestartPolicy
    from repro_torch.distributed.mesh import DeviceMesh, PerRank
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    phase = "mesh_train_elastic"
    cfg = CS.train_cfg(QWEN, **({"n_layers": layers} if layers else {}))
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=2,
                          total_steps=ELASTIC_STEPS + ELASTIC_MORE,
                          moment_dtype=cfg.optimizer_state_dtype))
    step = ST.build_train_step(cfg, opt)
    data = {i: batch_of(cfg, ELASTIC_SHAPE, i)
            for i in range(ELASTIC_STEPS)}

    def placement(shape, devs):
        mesh = DeviceMesh(shape, devs)
        mt = ST.MeshTrain(cfg, mesh)
        return SH.Placement(mesh, {"params": mt.specs,
                                   "opt_state": mt.state_specs})

    def step_fn_of(place, losses, walls):
        def step_fn(st, batch):
            t0 = time.perf_counter()
            with H.use_mesh(place.mesh, train=True):
                p, s, m = step([x["params"] for x in st],
                               [x["opt_state"] for x in st], batch)
            losses[int(s[0]["step"])] = m["loss"].item()
            MC.sync_all()
            walls.append(time.perf_counter() - t0)
            return PerRank({"params": a, "opt_state": c}
                           for a, c in zip(p, s))
        return step_fn

    place = placement((2, 2), devices())
    mt = ST.MeshTrain(cfg, place.mesh)
    pr = SH.init_params_sharded(cfg, place.mesh, seed=CS.SEED,
                                specs=mt.specs)
    start = PerRank({"params": p, "opt_state": opt.init(p)} for p in pr)
    del pr
    root = Path(tempfile.mkdtemp(prefix="elastic-"))
    runs = {}
    try:
        with CS.deterministic():
            for name, fail in (("uninterrupted", None),
                               ("failed", ELASTIC_FAIL_AT)):
                losses, walls, saves = {}, [], []
                failed = []

                def inject(i, fail=fail, failed=failed):
                    if i == fail and not failed:
                        failed.append(i)
                        raise RuntimeError(f"node lost at step {i}")

                mgr = _timed_saves(CheckpointManager(str(root / name),
                                                     keep=3), saves)
                pol = RestartPolicy(mgr, checkpoint_every=ELASTIC_EVERY,
                                    placement=place)
                t0 = time.perf_counter()
                state, done = pol.run(
                    state=start, step_fn=step_fn_of(place, losses, walls),
                    data_at=data.__getitem__, n_steps=ELASTIC_STEPS,
                    inject_failure=inject if fail else None)
                runs[name] = (state, losses)
                log(phase, run=name, steps_done=done,
                    restarts=pol.restarts, steps_run=len(walls),
                    wall_s=f"{time.perf_counter() - t0:.1f}",
                    step_wall_ms_median=(
                        f"{statistics.median(walls) * 1e3:.1f}"),
                    saves=len(saves),
                    save_s=json.dumps([round(x, 2) for x in saves]),
                    losses=json.dumps({k: round(v, 5)
                                       for k, v in sorted(losses.items())}),
                    card=f"'{card_names[0]}'")
        (a, la), (b, _) = runs["uninterrupted"], runs["failed"]
        equal = all(MT.same_bits(x, y) for x, y in zip(a, b))
        log(phase, check="replay_after_failure_bitwise", equal=equal,
            fail_at=ELASTIC_FAIL_AT, steps=ELASTIC_STEPS)
        if not equal:
            raise AssertionError(f"{phase}: the replayed run's state is not "
                                 "the uninterrupted run's")
        del runs, a, b, start
        place.mesh.close()
        torch.cuda.empty_cache()
        # the step-15 checkpoint alone, linked into a directory of its own
        src = CheckpointManager(str(root / "uninterrupted"))
        only = root / f"step{ELASTIC_FROM}"
        only.mkdir()
        for suffix in ("", ".done"):
            p = Path(src._path(ELASTIC_FROM) + suffix)
            os.link(p, only / p.name)
        meta = MD.init_params(cfg, device="meta")
        whole_meta = {"params": meta, "opt_state": opt.init(meta)}
        for target in ((1, 2), "one card"):
            losses, walls = {}, []
            t0 = time.perf_counter()
            if target == "one card":
                got_step, st = CheckpointManager(str(only)).restore_latest(
                    _like_on(whole_meta, HOME))
                MC.sync_all()
                restore_s = time.perf_counter() - t0
                cstep = step
                for i in range(ELASTIC_FROM, ELASTIC_FROM + ELASTIC_MORE):
                    t1 = time.perf_counter()
                    try:
                        p, s, m = cstep(st["params"], st["opt_state"],
                                        MT.on(batch_of(cfg, ELASTIC_SHAPE,
                                                       i), HOME))
                    except torch.OutOfMemoryError:
                        # the same function in two microbatches
                        torch.cuda.empty_cache()
                        cstep = ST.build_train_step(
                            cfg.replace(microbatch=2), opt)
                        log(phase, target=target,
                            note="B 8 does not fit one card in one pass: "
                                 "microbatch 2")
                        p, s, m = cstep(st["params"], st["opt_state"],
                                        MT.on(batch_of(cfg, ELASTIC_SHAPE,
                                                       i), HOME))
                    st = {"params": p, "opt_state": s}
                    losses[int(s["step"])] = m["loss"].item()
                    walls.append(time.perf_counter() - t1)
            else:
                new = placement(target, devices(2))
                got_step, st = CheckpointManager(str(only)).restore_latest(
                    whole_meta, shardings=new)
                MC.sync_all()
                restore_s = time.perf_counter() - t0
                fn = step_fn_of(new, losses, walls)
                for i in range(ELASTIC_FROM, ELASTIC_FROM + ELASTIC_MORE):
                    st = fn(st, batch_of(cfg, ELASTIC_SHAPE, i))
                new.mesh.close()
            errs = {k: MT.rel(v, la[k]) for k, v in losses.items()
                    if k in la}
            worst = max(errs.values())
            log(phase, target=(target if isinstance(target, str)
                               else meshes_name(target)),
                restored_step=got_step, restore_s=f"{restore_s:.2f}",
                steps=len(walls),
                step_wall_ms_median=f"{statistics.median(walls) * 1e3:.1f}",
                losses=json.dumps({k: round(v, 5)
                                   for k, v in sorted(losses.items())}),
                reference_losses=json.dumps({k: round(la[k], 5)
                                             for k in sorted(errs)}),
                worst_rel_err=f"{worst:.3e}", tol=ELASTIC_RTOL)
            if got_step != ELASTIC_FROM or len(errs) != ELASTIC_MORE or (
                    worst > ELASTIC_RTOL):
                raise AssertionError(f"{phase} {target}: restored training "
                                     "off the (2, 2) run's losses")
            del st
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


PARTS = {"d": zamba, "e": xlstm, "f": whisper, "g": qwen_fallback,
         "h": elastic}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every model to this depth (0: full)")
    ap.add_argument("--parts", default="".join(PARTS),
                    help="which of the parts d-h to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_train_families_card: torch.cuda.is_available() "
              "is False; this run needs four NVIDIA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < N_CARDS:
        print(f"torch_mesh_train_families_card: needs {N_CARDS} CUDA "
              f"devices, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = MC.cards()
    for i, line in enumerate(names):
        log("mesh_train_families_device", card=f"cuda:{i}",
            name_power=f"'{line}'")
    _build.build_all(("rmsnorm",))
    log("mesh_train_families_device",
        build_s=f"{time.perf_counter() - t0:.1f}", torch=torch.__version__,
        cuda=torch.version.cuda, layers=args.layers or "full")
    for label in args.parts:
        t1 = time.perf_counter()
        PARTS[label](args.layers, names)
        log("mesh_train_families", part=label,
            seconds=f"{time.perf_counter() - t1:.1f}")
    log("mesh_train_families", seconds=f"{time.perf_counter() - t0:.1f}")
    if FAILED:
        print("gates not met: " + json.dumps(FAILED), file=sys.stderr)
        return 1
    print("\n".join(MC.cards()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
