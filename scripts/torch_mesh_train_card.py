#!/usr/bin/env python3
"""Training of the PyTorch/CUDA port over a (data, model) mesh of four
NVIDIA cards.

    python3 scripts/torch_mesh_train_card.py [--layers N]

It needs four CUDA devices of one host and exits non-zero with fewer (a
missing card is an error, never a skip). It builds the kernel of the
training path (K5 and its backward K5b, ``src/repro_torch/kernels/csrc/
rmsnorm.cu``) and runs ``launch.steps.build_train_step`` under
``hints.use_mesh(mesh, train=True)``, one line per result:

(a) float32 qwen1.5-0.5b at full width and depth (remat "full", random
    weights from the seed) at (2, 2), (4, 1) and (1, 4) over
    ``cuda:0..3``, on one batch of B 8 x S 512 from ``make_train_stream``:
    one mesh step against ``build_train_step`` on ``cuda:0`` with the
    same batch — loss and ``grad_norm`` within LOSS_RTOL, every
    reassembled gradient leaf within ``chip_smoke.py`` 14b's per-leaf
    gate (the worst leaf printed), and after the AdamW step every param
    off 14b's tolerance one whose gradient sits at float32 noise; the
    metrics the same bits on every rank; the same mesh step twice, the
    same bits; every rank's copy of a shard it shares equal to the
    others'; K5 / K5b launches on every card, each the one-card step's
    count; at (2, 2), ``cfg.microbatch = 2`` against 1 (14b's
    microbatch gate);
(b) bf16 qwen1.5-0.5b at (2, 2), B 8 x S 2048 (``chip_smoke.py`` 14c's
    B 4 on each data rank), its shards made on their cards: the step's
    wall, device ms per card from ``torch.profiler`` (its peer copies
    apart), the idle share, tokens/s, ``max_memory_allocated`` per card;
    then the wall again with the interpreter's thread switch interval cut
    to 0.1 ms (a diagnosis of the host's share, restored after);
(c) bf16 phi3-mini-3.8b, all 32 layers, at (2, 2), B 8 x S 2048, the
    shards made on their cards (the whole state never exists): 10 steps
    of the stream — the loss must fall —, the same figures as (b); then
    one step's loss and ``grad_norm`` against one card on the same batch
    (within BF16_RTOL), at the deepest cut of depth one card holds.

``--layers N`` cuts every model to N layers (a short check of the
path). The line before last lists the cards' names and power limits;
the last line is ``{"ok": true, "device": {...}}`` with ``count`` 4. It
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402  (the one-card script's helpers)
import torch_mesh_card as MC  # noqa: E402  (four-card helpers)

N_CARDS = MC.N_CARDS
F32_MESHES = ((2, 2), (4, 1), (1, 4))
F32_SHAPE = (8, 512)
BF16_MESH = (2, 2)
BF16_SHAPE = (8, 2048)
PHI3 = "phi3-mini-3.8b"
PHI3_STEPS = 10
PHI3_CUTS = (32, 16, 8)     # one card's depths to try, deepest first
# the CPU parity tests' loss tolerance (tests/_train_parity.py), here for
# the loss and the global norm of the float32 mesh against one card
LOSS_RTOL = 1e-6
# bf16: the mesh's loss and norm against one card's (sums in other orders)
BF16_RTOL = 3e-2
HOME = "cuda:0"    # the one card the mesh is held against
SWITCH_S = 1e-4    # (b)'s diagnosis: the interpreter's switch interval
ONE_CARD_14C = "9588 tokens/s, 35.06 GB (chip_smoke.py 14c, one card)"
log = CS.log


def devices():
    import torch
    return tuple(torch.device("cuda", i) for i in range(N_CARDS))


def stream_batch(cfg, shape, step=0) -> dict:
    """Step ``step`` of ``make_train_stream``'s batches, on the host."""
    import torch
    from repro_torch.data import make_train_stream
    b, s = shape
    st = make_train_stream(cfg, b, s, seed=CS.SEED)
    return {k: torch.from_numpy(v) for k, v in st.batch_at(step).items()}


def on(batch, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def k5_by_card(phase, want_fwd, want_bwd, steps=1) -> None:
    """Every card's K5 / K5b launches since the last reset equal to one
    rank's step count (x ``steps``), no other kernel launched."""
    from repro_torch.kernels import ops
    by = ops.rmsnorm_counts_by_card()
    other = {k: v for k, v in ops.launch_counts().items()
             if k != "rmsnorm" and v}
    want = (steps * want_fwd, steps * want_bwd)
    log(phase, k5_k5b_by_card=json.dumps({f"cuda:{c}": list(v)
                                          for c, v in by.items()}),
        expected_each=json.dumps(list(want)), other=json.dumps(other))
    if other or sorted(by) != list(range(N_CARDS)) or any(
            v != want for v in by.values()):
        raise AssertionError(f"{phase}: K5 / K5b launches {by} {other}, "
                             f"expected {want} on every card")


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def adamw_gate(phase, what, got, want) -> None:
    """After one AdamW step from the same state: every param element off
    14b's tolerance must be one whose gradient the two runs put apart by
    over 1% of it — Adam's first update is lr * g / (|g| + eps), ±lr for
    any |g| well above eps, so such an element's sign may flip."""
    from repro_torch import tree as T
    (g1, p1), (g2, p2) = want, got
    off = noisy = 0
    worst = 0.0
    for a, c, ga, gc in zip(T.leaves(p1), T.leaves(p2), T.leaves(g1),
                            T.leaves(g2)):
        dp = (a.float() - c.float()).abs()
        worst = max(worst, dp.max().item())
        bad = dp > CS.MB_ATOL + CS.MB_RTOL * a.float().abs()
        dg = (ga.float() - gc.float()).abs()
        off += int(bad.sum())
        noisy += int((bad & (dg > 0.01 * ga.float().abs())).sum())
    log(phase, check=f"{what}_params_after_adamw",
        max_abs_err=f"{worst:.3e}", off_tolerance=off,
        of_them_at_gradient_noise=noisy, rtol=CS.MB_RTOL, atol=CS.MB_ATOL)
    if off != noisy:
        raise AssertionError(f"{phase} {what}: {off - noisy} params off "
                             "with a gradient above its noise")


def replicas_gate(phase, what, mt, trees) -> int:
    """Every rank's copy of a shard held by several ranks is the same
    bits as the first holder's; returns the copies compared."""
    import torch
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as SH
    mesh, n = mt.mesh, 0
    per_rank = [T.paths(t) for t in trees]
    for i, (path, spec) in enumerate(SH.spec_leaves(mt.specs)):
        first = {}
        for r in range(mesh.size):
            key = SH.shard_key(spec, mesh, mesh.coords(r))
            t = per_rank[r][i][1]
            if key not in first:
                first[key] = t
                continue
            n += 1
            if not torch.equal(t, first[key].to(t.device)):
                raise AssertionError(f"{phase} {what}: rank {r}'s {path} "
                                     "differs from another holder's")
    log(phase, check=f"{what}_replicas_bitwise", shared_copies=n)
    return n


def same_bits(a, b) -> bool:
    import torch
    from repro_torch import tree as T
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a),
                                                  T.leaves(b)))


def mesh_once(mt, opt, pr, sr, batch):
    """One mesh step through :meth:`MeshTrain.step` (the train step's own
    per-rank work): per rank (params, opt state, metrics, gradients),
    its wall, with the launch counts reset before it."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    parts = ST.mesh_parts(mt, batch)
    MC.sync_all()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = mt.run(lambda r: mt.step(opt, pr[r], sr[r], parts[r], r))
    MC.sync_all()
    return outs, time.perf_counter() - t0


def metrics_equal(phase, what, outs) -> None:
    import torch
    for key in ("loss", "grad_norm", "lr"):
        vals = [o[2][key].cpu() for o in outs]
        if not all(torch.equal(v, vals[0]) for v in vals):
            raise AssertionError(f"{phase} {what}: {key} differs between "
                                 f"ranks: {vals}")
    log(phase, check=f"{what}_metrics_same_bits_every_rank", ok=True)


# ---------------------------------------------------------------------------
# (a) float32 qwen: the gates
# ---------------------------------------------------------------------------

def qwen_f32(layers) -> None:
    import torch
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamW, OptConfig
    phase = "mesh_train_f32"
    cfg = CS.train_cfg(dtype="float32", n_layers=layers or 24)
    norms = 2 * cfg.n_layers + 1
    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                          weight_decay=0.0))
    params = MD.init_params(cfg, seed=CS.SEED, device=HOME)
    batch = stream_batch(cfg, F32_SHAPE)
    t0 = time.perf_counter()
    loss1, g1 = ST.accumulated_grads(params, cfg, on(batch, HOME))
    p1, _, st1 = opt.apply(g1, opt.init(params), params)
    MC.sync_all()
    log(phase, one_card=HOME, loss=f"{loss1.item():.8f}",
        grad_norm=f"{st1['grad_norm'].item():.8f}",
        seconds=f"{time.perf_counter() - t0:.2f}", layers=cfg.n_layers,
        batch=F32_SHAPE[0], seq=F32_SHAPE[1], remat=cfg.remat)
    for shape in F32_MESHES:
        what = f"{shape[0]}x{shape[1]}"
        mesh = DeviceMesh(shape, devices())
        mt = ST.MeshTrain(cfg, mesh)
        pr = mt.shard(params)
        sr = [opt.init(p) for p in pr]
        outs, wall = mesh_once(mt, opt, pr, sr, batch)
        k5_by_card(f"{phase}_{what}", 2 * norms - 1, norms)
        metrics_equal(phase, what, outs)
        m = outs[0][2]
        lr_, nr_ = (rel(m["loss"].item(), loss1.item()),
                    rel(m["grad_norm"].item(), st1["grad_norm"].item()))
        log(phase, mesh=what, check="loss_and_norm_vs_one_card",
            loss=f"{m['loss'].item():.8f}", loss_rel_err=f"{lr_:.3e}",
            grad_norm=f"{m['grad_norm'].item():.8f}",
            norm_rel_err=f"{nr_:.3e}", tol=LOSS_RTOL,
            step_s=f"{wall:.2f}")
        if lr_ > LOSS_RTOL or nr_ > LOSS_RTOL:
            raise AssertionError(f"{phase} {what}: loss or grad_norm off "
                                 "one card's")
        g_mesh = mt.gather([o[3] for o in outs], HOME)
        CS.grad_gate(phase, f"mesh_{what}", g_mesh, g1)
        p_mesh = mt.gather([o[0] for o in outs], HOME)
        adamw_gate(phase, f"mesh_{what}", (g_mesh, p_mesh), (g1, p1))
        replicas_gate(phase, f"{what}_grads", mt, [o[3] for o in outs])
        replicas_gate(phase, f"{what}_params", mt, [o[0] for o in outs])
        again, _ = mesh_once(mt, opt, pr, sr, batch)
        same = all(same_bits(a[0], b[0]) and same_bits(a[3], b[3])
                   and same_bits(a[2], b[2]) for a, b in zip(outs, again))
        log(phase, mesh=what, check="same_mesh_twice_bitwise", equal=same)
        if not same:
            raise AssertionError(f"{phase} {what}: two runs differ")
        del again
        if shape == (2, 2):
            mt2 = ST.MeshTrain(cfg.replace(microbatch=2), mesh)
            outs2, _ = mesh_once(mt2, opt, pr, sr, batch)
            k5_by_card(f"{phase}_{what}_mb2", 2 * norms - 1, norms, steps=2)
            run = {1: outs, 2: outs2}
            CS._check_microbatch(f"{phase}_{what}", {
                k: (o[0][2]["loss"].item(),
                    mt.gather([x[3] for x in o], HOME),
                    mt.gather([x[0] for x in o], HOME))
                for k, o in run.items()})
            del outs2, run
        del outs, g_mesh, p_mesh, pr, sr
        mesh.close()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# (b), (c) bf16: figures
# ---------------------------------------------------------------------------

def profiled(phase, fn, wall_s, card_names) -> dict:
    """One more call of ``fn`` traced by ``torch.profiler`` (the cards'
    activity only): per card kernel ms, peer-copy ms (the reductions'
    cross-card copies) and other copies, launches, and the idle share
    against ``wall_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(CS.DEVICE_TRIES):
        MC.sync_all()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            MC.sync_all()
        per = {i: {"kernel_us": 0.0, "peer_us": 0.0, "copy_us": 0.0,
                   "launches": 0} for i in range(N_CARDS)}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            d = per.setdefault(e.device_index, {
                "kernel_us": 0.0, "peer_us": 0.0, "copy_us": 0.0,
                "launches": 0})
            name = e.name.lower()
            if "ptop" in name:
                d["peer_us"] += e.device_time
            elif "memcpy" in name or "memset" in name:
                d["copy_us"] += e.device_time
            else:
                d["kernel_us"] += e.device_time
                d["launches"] += 1
        if any(v["kernel_us"] for v in per.values()):
            break
    else:
        log(phase, profile="not measured (no device activity traced)")
        return {}
    out = {}
    for i in range(N_CARDS):
        v = per[i]
        busy = (v["kernel_us"] + v["peer_us"] + v["copy_us"]) / 1e3
        out[i] = busy
        log(phase, profile=f"cuda:{i}", step_wall_ms=f"{wall_s * 1e3:.1f}",
            kernel_ms=f"{v['kernel_us'] / 1e3:.1f}",
            peer_copy_ms=f"{v['peer_us'] / 1e3:.1f}",
            other_copy_ms=f"{v['copy_us'] / 1e3:.1f}",
            launches=v["launches"],
            idle_share=f"{max(0.0, 1 - busy / (wall_s * 1e3)):.3f}",
            card=f"'{card_names[i]}'")
    return out


def switch_walls(phase, fn, wall_s) -> None:
    """Walls of three more calls of ``fn`` with ``sys.setswitchinterval``
    at SWITCH_S, restored after: a thread woken for the interpreter lock
    (autograd's worker unpacking a checkpointed layer's saved tensors,
    a rank past a barrier) waits up to the interval while another runs
    Python."""
    default = sys.getswitchinterval()
    walls = []
    sys.setswitchinterval(SWITCH_S)
    try:
        for _ in range(3):
            MC.sync_all()
            t0 = time.perf_counter()
            fn()
            MC.sync_all()
            walls.append(time.perf_counter() - t0)
    finally:
        sys.setswitchinterval(default)
    log(phase, check="host_diagnosis",
        switch_interval_ms=f"{SWITCH_S * 1e3:g}",
        step_wall_ms=json.dumps([round(w * 1e3, 1) for w in walls]),
        at_default_ms=f"{wall_s * 1e3:.1f}",
        default_interval_ms=f"{default * 1e3:g}")


def peaks() -> list:
    import torch
    return [round(torch.cuda.max_memory_allocated(i) / 1e9, 2)
            for i in range(N_CARDS)]


def train_run(phase, cfg, opt, shape, batches, card_names, beside=None,
              diagnose=False):
    """``len(batches)`` steps of ``build_train_step`` over a mesh of
    ``shape``, the shards made on their cards; then one more step
    profiled; with ``diagnose``, three more at the interpreter's thread
    switch interval cut to SWITCH_S (how much of the wall is threads
    waiting for the interpreter lock). Returns (per-step metrics, step
    walls)."""
    import torch
    from repro_torch.distributed import hints as H
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    mesh = DeviceMesh(shape, devices())
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
            for i in range(N_CARDS)]))
    step = ST.build_train_step(cfg, opt)
    metrics, walls = [], []
    norms = 2 * cfg.n_layers + 1
    b, s = batches[0]["tokens"].shape
    mb = ST.microbatches(cfg, b, shape[0])
    with H.use_mesh(mesh, train=True):
        ops.reset_launch_counts()
        for batch in batches:
            t0 = time.perf_counter()
            pr, sr, m = step(pr, sr, batch)
            m = {k: v.item() for k, v in m.items()}   # waits for the step
            MC.sync_all()
            walls.append(time.perf_counter() - t0)
            metrics.append(m)
            log(phase, step=len(walls), loss=f"{m['loss']:.5f}",
                grad_norm=f"{m['grad_norm']:.4f}",
                wall_s=f"{walls[-1]:.3f}")
        k5_by_card(phase, 2 * norms - 1, norms, steps=mb * len(batches))
        wall = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
        busy = profiled(phase, lambda: step(pr, sr, batches[-1]), wall,
                        card_names)
        if diagnose:
            switch_walls(phase, lambda: step(pr, sr, batches[-1]), wall)
    log(phase, arch=cfg.name, dtype=cfg.dtype, mesh=f"{shape[0]}x{shape[1]}",
        layers=cfg.n_layers, remat=cfg.remat, batch=b, seq=s,
        microbatches=mb,
        step_wall_ms_median=f"{wall * 1e3:.1f}",
        step_wall_ms_first=f"{walls[0] * 1e3:.1f}",
        device_ms_by_card=json.dumps({f"cuda:{i}": round(v, 1)
                                      for i, v in busy.items()}),
        tokens_per_s=f"{b * s / wall:.0f}",
        max_memory_allocated_gb=json.dumps(peaks()),
        **({"beside": f"'{beside}'"} if beside else {}))
    del pr, sr
    mesh.close()
    torch.cuda.empty_cache()
    return metrics, walls


def qwen_bf16(layers, card_names) -> None:
    from repro_torch.optim import AdamW, OptConfig
    cfg = CS.train_cfg(**({"n_layers": layers} if layers else {}))
    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=2, total_steps=20,
                          moment_dtype=cfg.optimizer_state_dtype))
    batch = stream_batch(cfg, BF16_SHAPE)
    train_run("mesh_train_bf16", cfg, opt, BF16_MESH, [batch] * 4,
              card_names, beside=ONE_CARD_14C, diagnose=True)


def one_card_grads(cfg, mesh_shape, batch):
    """(loss, global norm) of the seed's sharded params gathered whole
    on ``cuda:0``: ``accumulated_grads`` there, the norm as AdamW sums
    it (one card holds params and gradients, not the moments)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.mesh import DeviceMesh
    from repro_torch.launch import steps as ST
    mesh = DeviceMesh(mesh_shape, devices())
    mt = ST.MeshTrain(cfg, mesh)
    pr = SH.init_params_sharded(cfg, mesh, seed=CS.SEED, specs=mt.specs)
    whole = mt.gather(pr, HOME)
    del pr
    mesh.close()
    torch.cuda.empty_cache()
    loss, g = ST.accumulated_grads(whole, cfg, on(batch, HOME))
    gsq = sum(x.float().square().sum() for x in T.leaves(g))
    return loss.item(), torch.sqrt(gsq).item()


def phi3(layers, card_names) -> None:
    import torch
    from repro_torch.optim import AdamW, OptConfig
    phase = "mesh_train_phi3"
    cfg = CS.train_cfg(PHI3, **({"n_layers": layers} if layers else {}))
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=2, total_steps=PHI3_STEPS,
                          moment_dtype=cfg.optimizer_state_dtype))
    batches = [stream_batch(cfg, BF16_SHAPE, i) for i in range(PHI3_STEPS)]
    metrics, _ = train_run(phase, cfg, opt, BF16_MESH, batches, card_names)
    losses = [m["loss"] for m in metrics]
    log(phase, check="loss_falls", losses=json.dumps(
        [round(x, 4) for x in losses]))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    first = metrics[0]
    for cut in ([cfg.n_layers] if layers else PHI3_CUTS):
        c = cfg.replace(n_layers=cut)
        try:
            if cut != cfg.n_layers:   # the mesh's first step at the cut
                m, _ = train_run(f"{phase}_cut{cut}", c, opt, BF16_MESH,
                                 batches[:1], card_names)
                first = m[0]
            loss, norm = one_card_grads(c, BF16_MESH, batches[0])
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            log(phase, one_card=f"{cut} layers do not fit cuda:0")
            continue
        lr_, nr_ = rel(first["loss"], loss), rel(first["grad_norm"], norm)
        log(phase, check="first_step_vs_one_card", layers=cut,
            mesh_loss=f"{first['loss']:.6f}", one_card_loss=f"{loss:.6f}",
            loss_rel_err=f"{lr_:.3e}",
            mesh_grad_norm=f"{first['grad_norm']:.6f}",
            one_card_grad_norm=f"{norm:.6f}", norm_rel_err=f"{nr_:.3e}",
            tol=BF16_RTOL, card=f"'{card_names[0]}'")
        if lr_ > BF16_RTOL or nr_ > BF16_RTOL:
            raise AssertionError(f"{phase}: the mesh's first step is off "
                                 "one card's")
        return
    raise AssertionError(f"{phase}: no cut fits one card")


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every model to this depth (0: full)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_train_card: torch.cuda.is_available() is False; "
              "this run needs four NVIDIA cards", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < N_CARDS:
        print(f"torch_mesh_train_card: needs {N_CARDS} CUDA devices, sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    names = MC.cards()
    for i, line in enumerate(names):
        log("mesh_train_device", card=f"cuda:{i}", name_power=f"'{line}'")
    _build.build_all(("rmsnorm",))
    log("mesh_train_device", build_s=f"{time.perf_counter() - t0:.1f}",
        torch=torch.__version__, cuda=torch.version.cuda,
        layers=args.layers or "full")
    for label, fn, fargs in (("a", qwen_f32, (args.layers,)),
                             ("b", qwen_bf16, (args.layers, names)),
                             ("c", phi3, (args.layers, names))):
        t1 = time.perf_counter()
        fn(*fargs)
        log("mesh_train", part=label,
            seconds=f"{time.perf_counter() - t1:.1f}")
    log("mesh_train", seconds=f"{time.perf_counter() - t0:.1f}")
    print("\n".join(MC.cards()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
