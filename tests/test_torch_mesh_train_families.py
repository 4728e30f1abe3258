"""The recurrent and audio families trained over a mesh against the JAX
reference, on the float32 smoke models (weights bridged from
``PRNGKey(3)``): ``build_train_step``'s mesh path over ``("cpu",) * n``
ranks gives the loss, the AdamW norm and, reassembled, every gradient
leaf of ``jax.value_and_grad`` of the reference's ``loss_fn`` —

- zamba2 (hybrid: its Mamba2 layers run whole on every model rank, the
  shared attention + MLP block's gradient summed over its uses, each
  use's FSDP gather reduce-scattering its own) at the reference's own
  test mesh (pod, data, model) = (2, 2, 2), at (2, 2) and at (1, 4);
- xlstm (mLSTM and sLSTM whole over ``model``) at (2, 2);
- whisper (the encoder stack under the train placements,
  cross-attention reading the encoder output through Megatron's *f*)
  at (2, 2).

Tolerance (``tests/_mesh_parity.py``): ``_train_parity.py``'s
GRAD_RTOL, GRAD_ATOL and LOSS_RTOL; the norm within LOSS_RTOL of the
one-device port's and GRAD_RTOL of the reference's."""
from __future__ import annotations

import pytest

from _mesh_parity import case, check, mesh_step, shape_id
from _torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("arch,shape", (
    ("zamba2-2.7b", (2, 2, 2)), ("zamba2-2.7b", (2, 2)),
    ("zamba2-2.7b", (1, 4)), ("xlstm-350m", (2, 2)),
    ("whisper-large-v3", (2, 2))), ids=shape_id)
def test_mesh_step_matches_reference(arch, shape):
    cfg, params, batch, want = case(arch)
    mt, outs = mesh_step(cfg, params, batch, shape)
    if cfg.family in ("ssm", "hybrid"):   # recurrent cells whole on model
        assert {"mamba", "mlstm", "slstm"} <= mt.whole
    if arch == "zamba2-2.7b" and shape[-1] > 1:
        assert any(e is not None and "model" in e for e in
                   mt.specs["mamba"]["mamba"]["in_proj"])
    if len(shape) == 3:
        assert mt.fsdp == 4 and mt.specs["shared"]["attn"]["wq"] == (
            ("pod", "data"), ("model",))
    check(mt, outs, want)
