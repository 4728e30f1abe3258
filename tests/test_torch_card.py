"""The hand-written CUDA kernels against their plain PyTorch versions on
the card. Marked ``cuda``; skips itself without CUDA. Imports no JAX, so
it also runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_kernels_match_plain_on_card(card, dtype, tol):
    g = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    x, w = rnd(8, 1024), rnd(1024)
    cases = [(ops.rmsnorm(x, w), ref.rmsnorm(x, w))]
    q, k, v = rnd(1, 200, 8, 64), rnd(1, 200, 2, 64), rnd(1, 200, 2, 64)
    cases.append((ops.flash_attention(q, k, v, window=64),
                  ref.flash_attention(q, k, v, window=64)))
    q, kc, vc = rnd(4, 1, 8, 64), rnd(4, 300, 2, 64), rnd(4, 300, 2, 64)
    ek, ev = rnd(4, 1, 2, 64), rnd(4, 1, 2, 64)
    lens = torch.tensor([300, 129, 1, 0], dtype=torch.int32, device=card)
    cases.append((
        ops.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev),
        ref.decode_attention(q, kc, vc, lens, extra_k=ek, extra_v=ev)))
    for got, want in cases:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
