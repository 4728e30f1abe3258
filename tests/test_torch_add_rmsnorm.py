"""K5 with the residual add fused (``ops.add_rmsnorm``) on the CPU: the
plain version against ``x + a`` and the JAX RMSNorm (Pallas interpret
mode and the model's function), its shape and dtype contract, and the
kernel's launch plan (pure Python), at small shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as krn

F32, BF16 = torch.float32, torch.bfloat16
# h against the JAX RMSNorm: float32 outputs differ in summation order
# only; a bf16 output may sit one rounding (2^-8 relative) apart
TOL = {F32: dict(atol=2e-5, rtol=2e-5), BF16: dict(atol=1e-2, rtol=1e-2)}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
# (x, a, h) dtypes: the bf16 serving path, the float32 gates, the W4 step
COMBOS = [(BF16, BF16, BF16), (F32, F32, F32), (F32, BF16, BF16)]


def _inputs(seed, shape, xdt, adt):
    rng = np.random.default_rng(seed)
    x, a = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    tx = torch.from_numpy(x).to(xdt)
    ta = None if adt is None else torch.from_numpy(a).to(adt)
    jx = jnp.asarray(x).astype(JDT[xdt])
    ja = None if adt is None else jnp.asarray(a).astype(JDT[adt])
    return tx, ta, torch.from_numpy(w).to(xdt), jx, ja, jnp.asarray(w)


@pytest.mark.parametrize("xdt,adt,hdt", COMBOS)
@pytest.mark.parametrize("shape", [(8, 64), (2, 3, 128)])
def test_add_rmsnorm_plain_matches_add_then_jax_rmsnorm(xdt, adt, hdt,
                                                        shape):
    """s is torch's own x + a; h is the JAX RMSNorm of that sum
    (Pallas interpret mode and the model's function), in ``hdt``."""
    x, a, w, jx, ja, jw = _inputs(0, shape, xdt, adt)
    s, h = ops.add_rmsnorm(x, a, w, out_dtype=hdt)
    assert torch.equal(s, x + a) and s.dtype == xdt
    assert h.dtype == hdt and h.shape == x.shape
    js = jx + ja
    np.testing.assert_allclose(s.float().numpy(),
                               np.asarray(js, np.float32), atol=0, rtol=0)
    for want in (jops.rmsnorm(js, jw.astype(js.dtype)),
                 jlayers.rmsnorm(js, jw)):
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(want, np.float32), **TOL[hdt])


@pytest.mark.parametrize("xdt,hdt", [(BF16, BF16), (F32, F32), (F32, BF16)])
def test_add_rmsnorm_without_a_is_rmsnorm(xdt, hdt):
    """a=None: s is x itself and h is ``ops.rmsnorm`` of x (cast once to
    ``hdt``), within tolerance of the JAX RMSNorm."""
    x, _, w, jx, _, jw = _inputs(1, (4, 5, 64), xdt, None)
    s, h = ops.add_rmsnorm(x, None, w, out_dtype=hdt)
    assert s is x and h.dtype == hdt
    assert torch.equal(h, ops.rmsnorm(x, w).to(hdt))
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(jops.rmsnorm(jx, jw.astype(
                                   jx.dtype)), np.float32), **TOL[hdt])


def test_add_rmsnorm_is_add_then_rmsnorm_bitwise_on_cpu():
    """The plain version's h is ``ops.rmsnorm`` of the rounded sum,
    bit for bit (the card's kernel is held to the same on the card)."""
    for xdt, adt, hdt in COMBOS:
        x, a, w, *_ = _inputs(2, (3, 96), xdt, adt)
        s, h = ops.add_rmsnorm(x, a, w, out_dtype=hdt)
        assert torch.equal(h, ops.rmsnorm(s, w).to(hdt))


def test_add_rmsnorm_refuses_what_the_kernel_refuses():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="w shape"):
        ops.add_rmsnorm(x, None, torch.ones(32))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.add_rmsnorm(torch.zeros((2, 60)), None, torch.ones(60))
    with pytest.raises(ValueError, match="at most 8192"):
        ops.add_rmsnorm(torch.zeros((1, 8200)), None, torch.ones(8200))
    with pytest.raises(ValueError, match="a shape"):
        ops.add_rmsnorm(x, torch.zeros((1, 64)), torch.ones(64))
    with pytest.raises(TypeError, match="not instantiated"):
        ops.add_rmsnorm(x.to(BF16), x, torch.ones(64, dtype=BF16))
    with pytest.raises(TypeError, match="not instantiated"):
        ops.add_rmsnorm(x, None, torch.ones(64, dtype=BF16))


def test_add_rmsnorm_wrapper_refuses_cpu_operands_before_building():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="cuda:0"):
        krn.add_rmsnorm(x, x, torch.ones(64))


@pytest.mark.parametrize("d", [8, 64, 128, 1024, 3072, 4096, 4104, 5000,
                               8184, 8192])
@pytest.mark.parametrize("elt", [2, 4])
def test_launch_plan_covers_the_row(d, elt):
    """K5's launch: whole warps, at most 1024 threads, one vector a
    thread where that covers the row and two beyond (float32 rows past
    d = 4096), and every 16-byte vector of the row owned by exactly one
    (thread, slot)."""
    threads, v = krn.launch_plan(d, elt)
    nvec = d * elt // 16
    assert v in krn.VECS and threads % 32 == 0 and 32 <= threads <= 1024
    assert v == (1 if nvec <= 1024 else 2)
    owned = [t + j * threads for t in range(threads) for j in range(v)
             if t + j * threads < nvec]
    assert sorted(owned) == list(range(nvec))


@pytest.mark.parametrize("field,err", [
    ("w_shape", ValueError), ("w_dtype", TypeError),
    ("out_dtype", TypeError), ("a_dtype", TypeError)])
def test_cached_contract_still_refuses_after_an_accepted_call(field, err):
    """The contract is checked once per (width, shapes, dtypes) key: a
    call that differs from an accepted one in any checked field is
    still refused."""
    x, w = torch.zeros((2, 64), dtype=BF16), torch.ones(64, dtype=BF16)
    ops.add_rmsnorm(x, x, w)
    bad = {"w_shape": (x, x, torch.ones(56, dtype=BF16), None),
           "w_dtype": (x, x, torch.ones(64), None),
           "out_dtype": (x, x, w, F32),
           "a_dtype": (x, x.float(), w, None)}[field]
    with pytest.raises(err):
        ops.add_rmsnorm(*bad[:3], out_dtype=bad[3])
