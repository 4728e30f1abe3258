"""Carry a params pytree between the JAX reference and the port.

The JAX params (``repro.models.model.init_params``) travel as nested
dicts of numpy arrays (``jax.device_get``); the port keeps the same
nested keys and the leading ``L`` layer axis on stacked leaves, so each
leaf maps one to one; a list (an MoE config's leading dense
``first_layers``, unstacked) stays a list. Whisper's tree adds the
stacked encoder ``enc_layers`` (leading axis ``n_encoder_layers``),
``enc_norm``, and each decoder layer's ``ln_x`` and ``xattn``. An
xLSTM's ``mlstm`` leaves lead with (n_super, n_m_inner) and its
``slstm`` leaves with n_super; Zamba2's ``mamba`` leaves with
(n_groups, attn_every), and its one ``shared`` block is unstacked.
bfloat16 arrays (``ml_dtypes.bfloat16`` in numpy) are carried bit for
bit. A Python
bool leaf — the ``"__w4__"`` marker of a quantized projection
(``{"__w4__": True, "packed": (L, K//2, N) uint8, "scales": (L,
K//group, N) f32}``, ``examples/w4_mobile_decode.py``) — stays a bool
both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import (check_supported, n_first_layers,
                                      n_groups, xlstm_dims)


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable host copy that torch may wrap
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """Numpy params pytree of the JAX model -> port params on
    ``device``, same nested keys; stacked leaves keep their leading
    axis, ``n_layers - first_dense_layers`` long on an MoE config."""
    check_supported(cfg)
    dev = resolve_device(device)
    n_stack = cfg.n_layers - n_first_layers(cfg)
    # the leading axes of each stacked recurrent subtree
    lead = {}
    if cfg.family == "ssm":
        lead["mlstm"] = xlstm_dims(cfg)
        lead["slstm"] = xlstm_dims(cfg)[:1]
    if cfg.family == "hybrid":
        lead["mamba"] = (n_groups(cfg), cfg.attn_every)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v, f"{path}/{i}") for i, v in enumerate(node)]
        if isinstance(node, bool):
            return node
        t = _to_tensor(node, dev)
        if path.startswith("/layers/") and t.shape[0] != n_stack:
            raise ValueError(f"{path}: leading axis {t.shape[0]} != "
                             f"n_layers={cfg.n_layers} less "
                             f"{n_first_layers(cfg)} first dense layers")
        if path.startswith("/enc_layers/") \
                and t.shape[0] != cfg.n_encoder_layers:
            raise ValueError(f"{path}: leading axis {t.shape[0]} != "
                             f"n_encoder_layers={cfg.n_encoder_layers}")
        want = lead.get(path.split("/")[1])
        if want is not None and tuple(t.shape[:len(want)]) != want:
            raise ValueError(f"{path}: leading axes "
                             f"{tuple(t.shape[:len(want)])} != {want} "
                             f"for {cfg.name}")
        return t

    return conv(np_tree, "")


def params_to_numpy(tree: dict) -> dict:
    """Port params -> nested dict of numpy arrays (host copies).
    bfloat16 leaves come back as float32, which holds them exactly (the
    port's dependencies have no numpy bfloat16 type)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, bool):
        return tree
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
