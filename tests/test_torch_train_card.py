"""K5b (``add_rmsnorm_bwd``) against its plain version on the card, and
``ops.add_rmsnorm`` under autograd launching K5 then K5b. Marked
``cuda``; skips itself without CUDA. Imports no JAX, so it also runs on
a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_train_card.py
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as krn

F32, BF16 = torch.float32, torch.bfloat16
# float32 differs from the plain version in summation order only; a bf16
# output may sit a rounding (2^-8 relative) apart
TOL = {F32: dict(atol=1e-4, rtol=2e-5), BF16: dict(atol=5e-2, rtol=1e-2)}
# (x, a or None, h): every combination K5's forward instantiates
COMBOS = [(F32, F32, F32), (BF16, BF16, BF16), (F32, BF16, BF16),
          (F32, None, F32), (BF16, None, BF16), (F32, F32, BF16),
          (F32, BF16, F32), (F32, None, BF16)]


def _inputs(seed, shape, xdt, adt, hdt, device):
    g = torch.Generator().manual_seed(seed)
    x, a, gh, gs = (torch.randn(shape, generator=g) for _ in range(4))
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g)
    return {"x": x.to(device, xdt), "w": w.to(device, xdt),
            "a": None if adt is None else a.to(device, adt),
            "gh": gh.to(device, hdt), "gs": gs.to(device, xdt)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,adt,hdt", COMBOS,
                         ids=lambda d: str(d).removeprefix("torch."))
@pytest.mark.parametrize("shape", [(8, 64), (300, 1024), (5, 2560),
                                   (3, 8192)])
def test_k5b_matches_plain_on_card(card, xdt, adt, hdt, shape):
    t = _inputs(3, shape, xdt, adt, hdt, card)
    s, _ = ref.add_rmsnorm(t["x"], t["a"], t["w"])
    for gs in ((None,) if adt is None else (None, t["gs"])):
        got = krn.add_rmsnorm_bwd(s, t["w"], t["gh"], gs, add_dtype=adt)
        again = krn.add_rmsnorm_bwd(s, t["w"], t["gh"], gs, add_dtype=adt)
        want = ref.add_rmsnorm_bwd(s, t["w"], t["gh"], gs, add_dtype=adt)
        for g, a2, wnt in zip(got, again, want):
            assert (g is None) == (wnt is None)
            if g is not None:
                assert torch.equal(g, a2)          # deterministic
                torch.testing.assert_close(
                    g.float(), wnt.float(),
                    **TOL[BF16 if BF16 in (xdt, adt, hdt) else F32])


@pytest.mark.cuda
def test_autograd_on_card_runs_k5_and_k5b(card):
    t = _inputs(4, (64, 1024), BF16, BF16, BF16, card)
    x, a, w = (t[k].clone().requires_grad_() for k in ("x", "a", "w"))
    ops.reset_launch_counts()
    s, h = ops.add_rmsnorm(x, a, w)
    torch.autograd.backward([s, h], [t["gs"], t["gh"]])
    assert ops.launch_counts()["rmsnorm"] == 1
    assert ops.backward_launch_counts() == {"add_rmsnorm_bwd": 1}
    want = ref.add_rmsnorm_bwd(s.detach(), t["w"], t["gh"], t["gs"],
                               add_dtype=BF16)
    for g, wnt in zip((x.grad, a.grad, w.grad), want):
        torch.testing.assert_close(g.float(), wnt.float(), **TOL[BF16])
