"""Training over a (data, model) mesh with the reference's two
activation placements, on the float32 smoke models on the CPU.

The logits stay split over ``model`` by vocabulary, as the reference's
``hints.logits`` pins them, through the vocab-parallel cross-entropy
(``collectives.vocab_nll``):

- the loss of one position against ``torch.logsumexp`` of the whole
  vocab, and each rank's gradient against its columns of the whole
  gradient;
- qwen (dense, tied), deepseek-moe-16b (MoE, routed slots dropping) and
  whisper (audio) at (1, 2), (2, 2) and (1, 4), and qwen's whole-vocab
  fallback at (1, 3) (256 does not divide 3): the loss and every
  gradient leaf within ``tests/_train_parity.py``'s tolerances of
  ``jax.value_and_grad`` of the reference, each model group's loss the
  same bits on every rank, and no tensor whose last dim is the whole
  vocab saved for backward on a rank where the vocab splits (at (1, 3)
  the whole logits are saved: the count sees them);
- the dry-run's metered peak of a qwen train cell falls, against the
  gathered logits, by at least the (model - 1) / model share of the
  logits a rank held whole.

``act_shard`` holds the residual stream split over ``model`` between
the sublayers, as the reference's ``hints.hidden(x, cfg.act_shard)``
pins it — d_model (``"dmodel"``: nemotron-4-340b, dbrx-132b and
internvl2-26b set it; qwen and whisper, whose encoder runs the decoder
block as the reference's does, with it set) or the positions
(``"seq"``): at (1, 2) and (2, 2) the loss and every rank's gradients
and new params are the same bits as the same mesh with ``"none"`` (each
part of a reduce-scatter is the all-reduce's, and every norm sees the
whole sum), within the tolerances of the reference, and each layer's
checkpoint saves the rank's part of its (residual, delta) inputs,
1 / model of the whole; the same bits in bf16 at (1, 2), where a norm's
gradient rounds once, as on one device.
Serving's split is ``test_torch_act_shard_serve.py``."""
from __future__ import annotations

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.distributed import collectives as C
from repro_torch.distributed import hints as H
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.optim import AdamW, OptConfig
from _mesh_parity import OPT, case, check, cpu_mesh, mesh_step, shape_id
from _torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("n", (2, 4))
def test_vocab_nll_is_the_whole_vocab_cross_entropy(n):
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(3, 5, 64, generator=gen) * 4
    labels = torch.randint(0, 64, (3, 5), generator=gen)
    g = torch.rand(3, 5, generator=gen)
    zw = z.clone().requires_grad_()
    want = torch.logsumexp(zw, -1) - zw.gather(-1, labels[..., None])[..., 0]
    (want * g).sum().backward()
    mesh = cpu_mesh((1, n))
    w = 64 // n

    def one(r):
        comm = C.Comm(mesh, r, mesh.current_call())
        zr = z[..., r * w:(r + 1) * w].clone().requires_grad_()
        nll = C.vocab_nll(zr, labels, "model", comm)
        (nll * g).sum().backward()
        return nll, zr.grad

    outs = mesh.run(one)
    mesh.close()
    for r, (nll, grad) in enumerate(outs):
        assert torch.equal(nll, outs[0][0])
        torch.testing.assert_close(nll, want.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grad, zw.grad[..., r * w:(r + 1) * w],
                                   rtol=1e-6, atol=1e-7)


def _step_counting_saves(cfg, params, batch, shape):
    """One mesh train step (``_mesh_parity.mesh_step``) whose ranks
    record the shape of every tensor their forward saves for backward:
    (placements, per rank (params, opt state, metrics, grads), per rank
    the saved shapes)."""
    mesh = cpu_mesh(shape)
    opt = AdamW(OptConfig(**OPT))
    mt = ST.MeshTrain(cfg, mesh)
    pr = mt.shard(params)
    sr = [opt.init(p) for p in pr]
    parts = ST.mesh_parts(mt, batch)

    def one(r):
        saved = []

        def pack(t):
            saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return mt.step(opt, pr[r], sr[r], parts[r], r), saved

    outs = mt.run(one)
    mesh.close()
    return mt, [o[0] for o in outs], [o[1] for o in outs]


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("qwen1.5-0.5b", "deepseek-moe-16b", "whisper-large-v3")
    for s in ((1, 2), (2, 2), (1, 4))] + [("qwen1.5-0.5b", (1, 3))],
    ids=shape_id)
def test_vocab_parallel_loss_matches_reference(arch, shape):
    cfg, params, batch, want = case(arch)
    mt, outs, saved = _step_counting_saves(cfg, params, batch, shape)
    check(mt, outs, want)     # the loss the same bits on every rank
    v = cfg.vocab_size
    split = v % shape[1] == 0
    head = (mt.specs["embed"]["table"] if cfg.tie_embeddings
            else mt.specs["head"])
    assert (head[0] is not None) == split
    for shapes in saved:
        whole = [s for s in shapes if s and s[-1] == v]
        if split:
            assert not whole, whole
            assert any(s and s[-1] == v // shape[1] for s in shapes)
        else:
            assert whole


def test_dryrun_peak_falls_by_the_split_logits_share(monkeypatch):
    """qwen1.5-0.5b at full width, 2 layers, B 4 x S 256 at (1, 4): the
    metered peak a device, the logits split against the gathered
    logits of the earlier path (``hints.logits`` gathering the vocab in
    training, the loss over the whole vocab)."""
    cfg = registry.get_config("qwen1.5-0.5b").replace(n_layers=2)
    b, s, shape = 4, 256, (1, 4)

    def peak():
        cell = D.Cell(cfg, "train", b, s, shape)
        rec = cell.run(trace=False)
        cell.close()
        return rec["memory"]["peak_memory_in_bytes"]

    split = peak()

    def gathered(x, vocab):
        comm = H._comm()
        if comm is not None and x.shape[-1] != vocab:
            return C.gather_from(x, x.dim() - 1, "model", comm)
        return x

    monkeypatch.setattr(H, "logits", gathered)
    whole = peak()
    logits = b * s * cfg.vocab_size * 4
    assert whole - split >= logits * (shape[1] - 1) // shape[1], (
        whole, split, logits)


SET = ("nemotron-4-340b", "dbrx-132b", "internvl2-26b")  # act_shard dmodel
CASES = [(a, "dmodel") for a in SET] + [
    ("qwen1.5-0.5b", "dmodel"), ("qwen1.5-0.5b", "seq"),
    ("whisper-large-v3", "dmodel")]
MESHES = ((1, 2), (2, 2))


def _dim(mode):
    return {"dmodel": -1, "seq": 1}[mode]


@pytest.mark.parametrize("shape", MESHES, ids=shape_id)
@pytest.mark.parametrize("arch,mode", CASES, ids=shape_id)
def test_train_split_stream_is_bitwise_none(monkeypatch, arch, mode,
                                            shape):
    cfg, params, batch, want = case(arch)
    assert (cfg.act_shard == mode) == (arch in SET)
    none_mt, none = mesh_step(cfg.replace(act_shard="none"), params, batch,
                              shape)
    saved = []
    checkpoint = MD.checkpoint

    def recorded(fn, *args, **kw):
        saved.append([a.shape for a in args if torch.is_tensor(a)])
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(MD, "checkpoint", recorded)
    mt, outs = mesh_step(cfg.replace(act_shard=mode), params, batch, shape)
    for a, b in zip(outs, none):
        for i in (0, 1, 3):       # params, optimizer state, gradients
            assert all(torch.equal(x, y) for x, y in zip(T.leaves(a[i]),
                                                         T.leaves(b[i])))
        assert all(torch.equal(a[2][k], b[2][k]) for k in b[2])
    check(mt, outs, want)
    d = _dim(mode)
    whole = (batch["tokens"].shape[1] + cfg.n_image_tokens
             if mode == "seq" else cfg.d_model)
    stacked = cfg.n_layers - MD.n_first_layers(cfg) + cfg.n_encoder_layers
    assert len(saved) == stacked * shape[0] * shape[1]
    assert all(s[d] * shape[1] == whole for ss in saved for s in ss)


@pytest.mark.parametrize("arch,mode", [
    ("qwen1.5-0.5b", "dmodel"), ("qwen1.5-0.5b", "seq"),
    ("nemotron-4-340b", "dmodel")], ids=shape_id)
def test_train_split_stream_is_bitwise_none_in_bf16(arch, mode):
    """The bf16 smoke models at (1, 2): a split RMSNorm's gradient is
    K5b's with the residual cotangent fused, rounded once as on one
    device (an add of the two after K5b would round twice), and a split
    LayerNorm's autograd's sum, as on one device."""
    cfg = registry.get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    params = MD.init_params(cfg, seed=0, device="cpu")
    batch = MD.make_dummy_batch(cfg, 4, 32, seed=0, device="cpu")
    _, none = mesh_step(cfg.replace(act_shard="none"), params, batch, (1, 2))
    _, outs = mesh_step(cfg.replace(act_shard=mode), params, batch, (1, 2))
    for a, b in zip(outs, none):
        for i in (0, 1, 3):
            assert all(torch.equal(x, y) for x, y in zip(T.leaves(a[i]),
                                                         T.leaves(b[i])))
        assert all(torch.equal(a[2][k], b[2][k]) for k in b[2])
