"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's placements and against runs on CPU devices:

- ``registry.cells()`` is the reference's 33 cells;
- for every cell on both production meshes, a device's bytes of each
  leaf as the placement that runs holds it equal those the reference's
  own ``PartitionSpec``\\ s imply on a ``jax.sharding.AbstractMesh``
  (params serve or train, optimizer state, batch, cache), but for
  stacked leaves, where the realization differs: in a serving cell a
  stacked vector, or a stacked leaf outside the recurrent sublayers (an
  MoE's shared MLP); in a train cell any stacked leaf
  (``tests/test_torch_sharding.py`` holds the port's copy of the
  reference's specs to the reference's);
- a serving MoE cell over a batch split over ``data`` sizes its expert
  buffers by the whole dispatch's capacity;
- a decode and a prefill cell's global trace equal the port's
  ``DispatchPricer`` for the same dispatch;
- on smoke configs at (2, 2), (2, 1, 2) and (1, 3), the meta rank run's
  collective bytes and counts equal a run of the same step on CPU
  devices, and qwen's decode at (1, 2) makes the closed-form count;
- one representative rank equals every rank, record for record;
- ``main([...])`` writes a record ``analysis.load_records`` reads.
"""
from __future__ import annotations

import json
import math
from functools import partial

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import sharding as JSH
from repro.models import model as JMD
from repro.optim import AdamW as JAdamW, OptConfig as JOpt
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core import costmodel as CM
from repro_torch.core import trace as T
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.roofline import analysis as A
from repro_torch.roofline import collective_bytes as CB
from _torch_threads import one_thread  # noqa: F401

PRODUCTION = ((16, 16), (2, 16, 16))
TIMING = ("rank_s", "trace_s")


def test_cells_are_the_reference_cells():
    assert registry.cells() == jreg.cells()
    assert len(registry.cells()) == 33


def test_mesh_builders():
    m = LM.make_production_mesh(devices=["meta"] * 256)
    assert m.shape == (16, 16) and m.axes == ("data", "model")
    p = LM.make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert p.shape == (2, 16, 16) and p.axes == ("pod", "data", "model")
    assert LM.make_mesh((2, 2), devices=["cpu"] * 4).size == 4
    assert LM.make_mesh((1, 3), ("data", "model"), ["cpu"] * 3).shape == (
        1, 3)
    with pytest.raises(ValueError, match="axes"):
        LM.make_mesh((2, 2), ("x", "y"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        LM.make_mesh((2, 2), devices=["cpu"] * 3)


def test_production_mesh_refuses_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="256 devices, but only 1"):
        LM.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LM.make_production_mesh()


# ---------------------------------------------------------------------------
# argument bytes against the reference's PartitionSpecs
# ---------------------------------------------------------------------------

def _ref_leaves(tree, shardings):
    """{path: local bytes} of the reference's leaves on an AbstractMesh."""
    out = {}
    flat = jax.tree_util.tree_leaves_with_path(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    for (path, leaf), sh in zip(flat, shs):
        names = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
        out[names] = math.prod(sh.shard_shape(leaf.shape)) \
            * leaf.dtype.itemsize
    return out


def reference_bytes(arch, shape_name, shape) -> dict:
    """{operand: {path: local bytes}} the reference's own shardings
    imply for a device of ``shape``."""
    axes = ("pod", "data", "model")[-len(shape):]
    amesh = AbstractMesh(shape, axes)
    cfg = jreg.get_config(arch)
    spec = JSHAPES[shape_name]
    saved = JSH.MOE_EXPERT_SHARD
    if cfg.moe_expert_shard:
        JSH.MOE_EXPERT_SHARD = cfg.moe_expert_shard
    try:
        p = jax.eval_shape(partial(JMD.init_params, cfg=cfg),
                           jax.random.PRNGKey(0))
        out = {"params": _ref_leaves(p, JSH.param_shardings(
            amesh, p, serve=spec.kind != "train"))}
        if spec.kind == "train":
            opt = JAdamW(JOpt(moment_dtype=cfg.optimizer_state_dtype))
            o = jax.eval_shape(opt.init, p)
            out["opt_state"] = _ref_leaves(o, JSH.opt_state_shardings(
                amesh, o))
        seq = 1 if spec.kind == "decode" else spec.seq_len
        b = JMD.batch_spec(cfg, spec.global_batch, seq, spec.kind)
        out["batch"] = _ref_leaves(b, JSH.batch_shardings(amesh, b))
        if spec.kind == "decode":
            c = JMD.cache_spec(cfg, spec.global_batch, spec.seq_len)
            out["cache"] = _ref_leaves(c, JSH.cache_shardings(amesh, c,
                                                              cfg))
    finally:
        JSH.MOE_EXPERT_SHARD = saved
    return out


def _ours(tree) -> dict:
    return {tuple(names): math.prod(leaf.shape) * leaf.element_size()
            for names, leaf in SH._walk(tree)}


# where the placement that runs may differ from the reference's rules:
# a stacked leaf takes the rules of one layer's shape. Serving splits
# the recurrent sublayers and their state as the reference does, so
# there only a stacked vector of theirs may differ (the reference reads
# it as a matrix); training still runs them whole over model.


def _may_differ(kind, operand, names, tree) -> bool:
    if operand not in ("params", "opt_state"):
        return False
    lead = next((SH.STACKS[n] for n in names if n in SH.STACKS), 0)
    if not lead:
        return False
    if kind == "train":
        return True
    vector = SH._lookup(tree, names).dim() - lead <= 1
    return vector or not any(n in SH.WHOLE_STACKS for n in names)


@pytest.mark.parametrize("shape", PRODUCTION,
                         ids=lambda s: "x".join(map(str, s)))
def test_argument_bytes_equal_reference_partition_specs(shape):
    differ = 0
    pairs = {"serve": 0, "train": 0}
    for arch, shape_name in registry.cells():
        spec = SHAPES[shape_name]
        cfg = registry.get_config(arch)
        saved = SH.MOE_EXPERT_SHARD
        if cfg.moe_expert_shard:
            SH.MOE_EXPERT_SHARD = cfg.moe_expert_shard
        try:
            cell = D.Cell(cfg, spec.kind, spec.global_batch, spec.seq_len,
                          shape)
            ref = reference_bytes(arch, shape_name, shape)
            # the placement that runs: every rank alike, leaf by leaf
            # the reference's but where the realization differs
            args = cell._arg_shapes(0)
            kind = "train" if spec.kind == "train" else "serve"
            before = differ
            for operand, leaves in ref.items():
                ours = _ours(args[operand])
                for names, b in leaves.items():
                    if names == ("len",):
                        continue
                    if ours[names] != b:
                        differ += 1
                        assert _may_differ(kind, operand, names,
                                           args[operand]), (
                            arch, shape_name, operand, names, ours[names], b)
            pairs[kind] += differ > before
            if arch in ("zamba2-2.7b", "xlstm-350m") and kind == "serve":
                # the recurrent families place the reference rules' bytes
                assert differ == before, (arch, shape_name)
            assert cell.argument_bytes()[0] == sum(D.storage_bytes(v)
                                                   for v in args.values())
        finally:
            SH.MOE_EXPERT_SHARD = saved
            cell.close()
    assert differ > 0     # the realization's differences are real
    # the cells that still differ: deepseek's and nemotron's prefill and
    # decode (stacked vectors, deepseek's shared MLP), and the train
    # cells of deepseek, nemotron, phi3, whisper and (on one pod)
    # internvl2
    assert pairs == {"serve": 4, "train": 4 + (shape == (16, 16))}


# ---------------------------------------------------------------------------
# the global trace against the cost model's pricer
# ---------------------------------------------------------------------------

def test_decode_and_prefill_trace_equal_the_pricer():
    cfg = registry.get_config("qwen1.5-0.5b")
    pricer = CM.DispatchPricer(cfg)
    dec = D.Cell(cfg, "decode", 8, 2048, (1, 1))
    got = [o for o in T.trace_ops(dec.step(), *dec.global_operands(),
                                  weights=dec.params)]
    want = [o.at(2048) for o in pricer.decode_ops_linear(8, 2048)]
    # the step's greedy pick is the one op the dispatch lacks
    assert [o.prim for o in got] == [o.prim for o in want] + ["argmax"]
    g, w = T.totals(got[:-1]), T.totals(want)
    for k in ("flops", "matmul_flops", "weight_bytes", "vector_ops"):
        assert getattr(g, k) == pytest.approx(getattr(w, k), rel=1e-9), k
    assert g.bytes == pytest.approx(w.bytes, rel=1e-9)
    dec.close()
    pre = D.Cell(cfg, "prefill", 1, 1024, (1, 1))
    g = pre.global_trace()
    w = T.totals(pricer.prefill_ops(1, 1024))
    for k in ("flops", "matmul_flops", "weight_bytes"):
        assert getattr(g, k) == getattr(w, k), k
    # the engine's dispatch picks its logits row by index (a gather),
    # the step takes the last row: 4 KB apart in 5.6 GB
    assert g.bytes == pytest.approx(w.bytes, rel=1e-6)
    pre.close()


# ---------------------------------------------------------------------------
# collectives: meta rank run against CPU devices
# ---------------------------------------------------------------------------

def _materialize(tree, gen):
    """A meta tree as CPU tensors: small normal floats, zero ints."""
    def one(t):
        if not isinstance(t, torch.Tensor) or not t.is_meta:
            return t
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.05).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    if isinstance(tree, dict):
        return {k: _materialize(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, gen) for v in tree)
    return one(tree)


def cpu_collectives(cfg, kind, batch, seq, shape) -> dict:
    """The same step on CPU devices named per rank: its recorded
    collectives."""
    n = math.prod(shape)
    cell = D.Cell(cfg, kind, batch, seq, shape, devices=["cpu"] * n,
                  every_rank=True)
    gen = torch.Generator().manual_seed(0)
    args = {r: _materialize(cell.rank_arguments(r), gen) for r in range(n)}
    if kind == "decode":
        for a in args.values():
            a["cache"]["len"] = torch.tensor(seq - 1, dtype=torch.int32)
    if kind == "train":
        cell.data = _materialize(cell.data, gen)
    with CB.recording(cell.mesh) as rec:
        if kind == "train":
            cell._train_run(args)
        else:
            cell._serve_run(args)
    cell.close()
    return rec


SMOKE_CASES = [("qwen1.5-0.5b", "decode", 4, 64), ("qwen1.5-0.5b",
                                                   "prefill", 4, 32),
               ("qwen1.5-0.5b", "train", 4, 32),
               ("deepseek-moe-16b", "train", 4, 32)]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2), (1, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_meta_rank_run_collectives_equal_cpu_devices(shape):
    for arch, kind, b, s in SMOKE_CASES:
        cfg = registry.get_smoke_config(arch).replace(dtype="float32")
        cell = D.Cell(cfg, kind, b, s, shape, every_rank=True)
        rec = cell.run(trace=False)
        cell.close()
        cpu = cpu_collectives(cfg, kind, b, s, shape)
        assert rec["collectives"] == cpu.report(), (arch, kind)
        # every rank's, not just the fullest
        assert cell.collectives.per_rank == cpu.per_rank, (arch, kind)
        if shape != (1, 3):
            assert rec["collectives"]["total_bytes"] > 0, (arch, kind)


def test_qwen_decode_collectives_closed_form():
    """Qwen's decode at (1, 2) gathers at four hint sites a layer — the
    attention's heads ahead of ``wo`` (row_input), its output columns
    (hidden), the MLP's units ahead of ``w_down`` and its output — plus
    the embedding's lookups and the logits: 4 L + 2 all-gathers."""
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    b, s = 4, 64
    cell = D.Cell(cfg, "decode", b, s, (1, 2))
    rec = cell.run(trace=False)
    cell.close()
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    assert rec["collectives"]["counts"] == {"all-gather": 4 * L + 2}
    e = torch.tensor([], dtype=torch.bfloat16).element_size()
    want = (L * b * (3 * d + f) * e       # the four per-layer gathers
            + 2 * b * d * e               # the embedding's two lookups
            + b * v * 4)                  # float32 logits
    assert rec["collectives"]["total_bytes"] == want


# ---------------------------------------------------------------------------
# one representative rank against every rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2), (1, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_representative_rank_equals_every_rank(shape):
    for arch, kind, b, s in SMOKE_CASES:
        cfg = registry.get_smoke_config(arch)
        recs = []
        for every in (False, True):
            cell = D.Cell(cfg, kind, b, s, shape, every_rank=every)
            rec = cell.run()
            cell.close()
            recs.append({k: v for k, v in rec.items() if k not in TIMING})
        assert recs[0] == recs[1], (arch, kind)


def test_main_writes_a_record_the_analysis_reads(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    assert D.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                   "--mesh", "single", "--out", str(out),
                   "--tag", "t"]) == 0
    printed = json.loads(capsys.readouterr().out)
    recs = A.load_records(str(out), mesh="single")
    assert len(recs) == 1 and recs[0] == printed
    rec = recs[0]
    assert rec["devices"] == 256 and rec["tag"] == "t" and rec["ok"]
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes", "peak_memory_in_bytes"}
    assert set(rec["trace"]) == {"flops", "matmul_flops", "vector_ops",
                                 "bytes", "weight_bytes"}
    assert rec["collectives"]["counts"] == {"all-gather": 98}
    c = A.analyze_file(str(out), mesh="single")[0]
    assert c["compute_s"] > 0 and c["memory_s"] > 0 and c["collective_s"] > 0
    assert c["peak_bytes_per_chip"] == rec["memory"]["peak_memory_in_bytes"]


def test_sequence_layout_gathers_the_kernels_partials():
    """Qwen's 4 KV heads do not divide 3: at (1, 3) a 96-position cache
    splits its positions, and each decode layer gathers K1's fp32
    partials (o, m, l) of every shard, at the kernel's launch plan."""
    from repro_torch.kernels import decode_attention as KD
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    b, c = 4, 96
    cell = D.Cell(cfg, "decode", b, c, (1, 3))
    assert cell.kv.layout == "seq"
    cell.run(trace=False)
    cell.close()
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    splits = KD.launch_plan(b, hkv, c // 3, None).splits
    n = 3 * splits
    rows = {(k, s): calls for k, s, _, calls in
            cell.collectives.breakdown(0, top=100)}
    g = cfg.n_heads // hkv
    assert rows[("all-gather", f"f32[{b},{hkv},{g},{n},{dh}]")] == \
        cfg.n_layers
    assert rows[("all-gather", f"f32[{b},{hkv},{g},{n}]")] == \
        2 * cfg.n_layers


@pytest.mark.parametrize("kind,batch,seq", [("decode", 8, 64),
                                            ("prefill", 4, 32)])
def test_serving_moe_capacity_is_the_whole_dispatchs(monkeypatch, kind,
                                                     batch, seq):
    """deepseek-moe-16b at (2, 2): each data replica routes its half of
    the batch, and every MoE layer sizes its expert buffers by
    ``_capacity`` of the whole dispatch's rows, numbering its slots after
    the lower replica's (an all-gather of the per-expert counts over
    data)."""
    from repro_torch.models import moe as M
    sizes = []
    capacity = M._capacity

    def recorded(n, cfg):
        sizes.append(n)
        return capacity(n, cfg)

    monkeypatch.setattr(M, "_capacity", recorded)
    cfg = registry.get_smoke_config("deepseek-moe-16b")
    cell = D.Cell(cfg, kind, batch, seq, (2, 2), every_rank=True)
    rec = cell.run(trace=False)
    cell.close()
    rows = batch * (1 if kind == "decode" else seq)
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    assert sizes == [rows] * (moe_layers * 4)
    e = cfg.n_experts
    counts = [k for k, s, _, _ in cell.collectives.breakdown(0, top=100)
              if s == f"s64[2,{e}]"]
    assert counts == ["all-gather"]
    assert rec["collectives"]["total_bytes"] > 0
