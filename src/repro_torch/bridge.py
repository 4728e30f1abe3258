"""Carry a params pytree between the JAX reference and the port.

The JAX params (``repro.models.model.init_params``) travel as nested
dicts of numpy arrays (``jax.device_get``); the port keeps the same
nested keys and the leading ``L`` layer axis on stacked leaves, so each
leaf maps one to one. bfloat16 arrays (``ml_dtypes.bfloat16`` in numpy)
are carried bit for bit. A Python bool leaf — the ``"__w4__"`` marker of
a quantized projection (``{"__w4__": True, "packed": (L, K//2, N) uint8,
"scales": (L, K//group, N) f32}``, ``examples/w4_mobile_decode.py``) —
stays a bool both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import check_supported


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable host copy that torch may wrap
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """Numpy params pytree of the JAX model -> port params on
    ``device``, same nested keys, stacked leaves keep their ``L`` axis."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, bool):
            return node
        t = _to_tensor(node, dev)
        if path.startswith("/layers/") and t.shape[0] != cfg.n_layers:
            raise ValueError(f"{path}: leading axis {t.shape[0]} != "
                             f"n_layers={cfg.n_layers}")
        return t

    return conv(np_tree, "")


def params_to_numpy(tree: dict) -> dict:
    """Port params -> nested dict of numpy arrays (host copies).
    bfloat16 leaves come back as float32, which holds them exactly (the
    port's dependencies have no numpy bfloat16 type)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, bool):
        return tree
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
