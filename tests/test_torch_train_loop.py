"""The training loop end to end on the CPU against the JAX reference:
``build_train_step`` (one step; microbatch 4 == 1), the reference's
"train, crash, restart, serve" story kept short, checkpoints read and
written across the two packages (bf16 leaves included), the
``launch.train`` launcher with a failure and ``--resume``, and
``launch.serve --ckpt-dir`` from a JAX-written checkpoint giving the
JAX launcher's greedy stream. Float32 smoke models, weights bridged
from ``jax.random.PRNGKey(0)``."""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import load_pytree as jload, save_pytree as jsave
from repro.configs import registry as jreg
from repro.data import make_train_stream as jstream
from repro.distributed.fault_tolerance import RestartPolicy as JPolicy
from repro.launch import serve as jserve
from repro.launch import steps as JST
from repro.models import model as JMD
from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro_torch import tree as T
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import registry as treg
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.launch import serve, steps as ST, train
from repro_torch.optim import AdamW, OptConfig

ARCH = "qwen1.5-0.5b"
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0)
# the reference test's own tolerance (tests/test_system.py)
RTOL, ATOL = 1e-4, 1e-5


def _setup(**kw):
    jcfg = jreg.get_smoke_config(ARCH).replace(dtype="float32", **kw)
    cfg = treg.get_smoke_config(ARCH).replace(dtype="float32", **kw)
    jp = JMD.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.device_get(jp), cfg,
                                          device="cpu")


def _batch(step, seed=0):
    b = jstream(jreg.get_smoke_config(ARCH), 8, 32, seed=seed).batch_at(step)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _close(port_tree, jax_tree, **tol):
    for (k, a), (_, b) in zip(T.paths(port_tree),
                              T.paths(jax.device_get(jax_tree))):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), err_msg=k,
                                   **tol)


def test_train_step_matches_jax_and_microbatch_4_equals_1():
    jcfg, cfg, jp, tp = _setup(remat="none")
    jb, tb = _batch(0, seed=1)
    jopt, opt = JAdamW(JOpt(**OPT)), AdamW(OptConfig(**OPT))
    jnew, jstate, jm = jax.jit(JST.build_train_step(jcfg, jopt))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in jb.items()})
    p1, s1, m1 = ST.build_train_step(cfg, opt)(tp, opt.init(tp), tb)
    assert abs(m1["loss"].item() - float(jm["loss"])) < 1e-5
    assert int(s1["step"]) == 1
    _close(p1, jnew, rtol=RTOL, atol=ATOL)
    _close(s1["mu"], jstate["mu"], rtol=1e-4, atol=1e-9)
    p4, _, m4 = ST.build_train_step(cfg.replace(microbatch=4), opt)(
        tp, opt.init(tp), tb)
    assert m4["loss"].item() == pytest.approx(m1["loss"].item(), rel=1e-5)
    for a, c in zip(T.leaves(p1), T.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert ST.microbatches(cfg.replace(microbatch=3), 8) == 2


def test_grad_compression_hook_runs_before_the_update():
    _, cfg, _, tp = _setup(remat="none")
    opt = AdamW(OptConfig(**OPT))
    seen = []

    def hook(grads, state):
        seen.append(T.leaves(grads)[0].dtype)
        return grads, state
    _, tb = _batch(0)
    ST.build_train_step(cfg, opt, grad_compression=hook)(tp, opt.init(tp), tb)
    assert seen == [torch.float32]


def test_story_train_crash_restart_serve(tmp_path):
    """The reference's story, short: 12 steps checkpointed every 4, a
    crash at step 6 replayed from step 4 — bitwise the uncrashed run
    inside the port, within the reference test's tolerance of the JAX
    run of the same story — then the port's engine serves the result."""
    jcfg, cfg, jp, tp = _setup(remat="none")
    jopt, opt = JAdamW(JOpt(**OPT)), AdamW(OptConfig(**OPT))
    jstep = jax.jit(JST.build_train_step(jcfg, jopt))
    tstep = ST.build_train_step(cfg, opt)

    def tdata(i):
        return _batch(i)[1]

    def jdata(i):
        return {k: jnp.asarray(v) for k, v in _batch(i)[0].items()}

    def trun(d, inject=None):
        pol = RestartPolicy(CheckpointManager(str(tmp_path / d), keep=2),
                            checkpoint_every=4)
        out, end = pol.run(
            state={"params": tp, "opt": opt.init(tp)},
            step_fn=lambda s, b: dict(zip(("params", "opt"), tstep(
                s["params"], s["opt"], b)[:2])),
            data_at=tdata, n_steps=12, inject_failure=inject)
        return out, end, pol.restarts

    crashed = []

    def inject(step):
        if step == 6 and not crashed:
            crashed.append(step)
            raise RuntimeError("preempted")

    want, _, _ = trun("ref")
    got, end, restarts = trun("b", inject)
    assert end == 12 and restarts == 1
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(want),
                                                 T.leaves(got)))
    jpol = JPolicy(JManager(str(tmp_path / "jax"), keep=2),
                   checkpoint_every=4)
    jgot, _ = jpol.run(
        state={"params": jp, "opt": jopt.init(jp)},
        step_fn=lambda s, b: dict(zip(("params", "opt"), jstep(
            s["params"], s["opt"], b)[:2])),
        data_at=jdata, n_steps=12)
    _close(got["params"], jgot["params"], rtol=RTOL, atol=ATOL)
    from repro_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(got["params"], cfg, EngineConfig(
        max_batch=2, max_seq_len=48, max_new_tokens=4), device="cpu")
    eng.submit(np.arange(8) % cfg.vocab_size)
    done = eng.run()
    assert len(done) == 1 and len(done[0].output) == 4


def test_checkpoints_cross_the_packages(tmp_path):
    """A JAX-written checkpoint (bf16 params, fp32 moments, the int32
    step) loads into the port bit for bit, and the port's file loads
    with the reference's ``load_pytree``; leaf names and digests are the
    reference's."""
    jcfg = jreg.get_smoke_config("deepseek-moe-16b")       # bf16, a list
    cfg = treg.get_smoke_config("deepseek-moe-16b")
    jp = JMD.init_params(jax.random.PRNGKey(1), jcfg)
    jstate = {"params": jp, "opt": JAdamW(JOpt()).init(jp)}
    jmgr = JManager(str(tmp_path / "jax"), keep=2)
    jmgr.save(3, jstate)
    like = {"params": params_from_jax(jax.device_get(jp), cfg, device="cpu")}
    like["opt"] = AdamW(OptConfig()).init(like["params"])
    step, got = CheckpointManager(str(tmp_path / "jax")).restore_latest(like)
    assert step == 3
    bf16 = 0
    for (k, a), (_, b) in zip(T.paths(got), T.paths(jax.device_get(jstate))):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            bf16 += 1
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), k
        else:
            assert np.array_equal(a.numpy(), b), k
    assert bf16 > 10
    path = str(tmp_path / "port.npz")
    dig = save_pytree(path, got, extra={"note": 1})
    back = jload(path, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                              np.asarray(b).reshape(-1).view(np.uint8))
    assert dig == jsave(str(tmp_path / "j.npz"), back)
    assert sorted(np.load(path).files) == sorted(
        np.load(str(tmp_path / "j.npz")).files)
    assert all(torch.equal(a, b) for a, b in zip(
        T.leaves(load_pytree(path, got)), T.leaves(got)))


def test_manager_keeps_k_and_skips_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for s in (1, 2, 3):
        mgr.save(s, T.tree_map(lambda t, s=s: t + s, tree), blocking=False)
    mgr.wait()
    assert mgr.steps() == [2, 3]
    with open(mgr._path(3), "wb") as f:
        f.write(b"not a zip")
    step, got = mgr.restore_latest(tree)
    assert step == 2 and torch.equal(got["w"], tree["w"] + 2)
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        tree) == (None, None)


def test_train_launcher_fails_restarts_and_resumes(tmp_path, capsys):
    def argv(steps, d, *extra):
        return ["--smoke", "--device", "cpu", "--steps", str(steps),
                "--batch", "2", "--seq", "16", "--ckpt-every", "4",
                "--log-every", "4", "--ckpt-dir", str(tmp_path / d), *extra]
    a = train.train(argv(8, "a"))
    b = train.train(argv(8, "b", "--inject-failure-at", "5"))
    assert b["restarts"] == 1 and b["step"] == 8
    assert all(torch.equal(x, y) for x, y in zip(T.leaves(a["state"]),
                                                 T.leaves(b["state"])))
    assert sorted(os.listdir(tmp_path / "a")) == [
        "step_00000004.npz", "step_00000004.npz.done",
        "step_00000008.npz", "step_00000008.npz.done"]
    c = train.train(argv(12, "a", "--resume"))
    assert "resumed from step 8" in capsys.readouterr().out
    assert sorted(c["losses"]) == list(range(8, 12))
    assert train.main(argv(1, "d")) == 0
    with pytest.raises(RuntimeError, match="cuda"):
        if not torch.cuda.is_available():
            train.train(["--smoke", "--steps", "1", "--ckpt-dir",
                         str(tmp_path / "e")])


def test_serve_from_a_jax_checkpoint_gives_the_jax_greedy_stream(
        tmp_path, capsys, monkeypatch):
    """Both launchers serve ``--ckpt-dir`` of one JAX-written checkpoint
    at float32 (each registry's smoke config patched to float32, for an
    exact greedy comparison): the same first stream."""
    f32 = {}
    for reg in (jreg, treg):
        orig = reg.get_smoke_config
        f32[reg] = orig
        monkeypatch.setattr(reg, "get_smoke_config",
                            lambda n, o=orig: o(n).replace(dtype="float32"))
    jcfg = jreg.get_smoke_config(ARCH)
    jp = JMD.init_params(jax.random.PRNGKey(9), jcfg)
    JManager(str(tmp_path)).save(5, {"params": jp,
                                     "opt": JAdamW(JOpt()).init(jp)})
    argv = ["--smoke", "--ckpt-dir", str(tmp_path), "--requests", "3",
            "--prompt-len", "9", "--max-new", "6", "--slots", "2",
            "--capacity", "32"]
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def stream(out):
        return [ln for ln in out.splitlines() if ln.startswith("sample")]
    assert "serving weights from checkpoint step 5" in got
    assert stream(got) == stream(want) and stream(got)


def test_prefill_and_serve_step_builders_greedy():
    """The reference's step-builder test: a prefill into a cache, then
    one greedy decode step whose token is the logits' argmax; the
    step's logits are ``decode_step``'s."""
    from repro_torch.models import model as MD
    _, cfg, _, tp = _setup()
    batch = MD.make_dummy_batch(cfg, 2, 8, "prefill", seed=1, device="cpu")
    logits, cache = ST.build_prefill_step(cfg, capacity=32)(tp, batch)
    assert logits.shape == (2, cfg.vocab_size)
    assert cache["k"].shape[2] == 32 and int(cache["len"]) == 8
    tok = torch.zeros((2, 1), dtype=torch.int32)
    want, _ = MD.decode_step(tp, cfg, tok, {k: v.clone()
                                           for k, v in cache.items()})
    nxt, got, cache = ST.build_serve_step(cfg)(tp, tok, cache)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0], got.argmax(-1).to(torch.int32))
    assert torch.equal(got, want) and int(cache["len"]) == 9
    with pytest.raises(ValueError, match="greedily"):
        ST.build_serve_step(cfg, sample="temperature")
