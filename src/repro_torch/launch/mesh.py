"""Production mesh builders.

Counterpart of ``repro/launch/mesh.py``. Functions, not module-level
constants: importing this module touches no device state.

Production target: a single pod is 16 x 16 = 256 devices over
``("data", "model")``; multi-pod adds a leading ``"pod"`` axis (2 x 16
x 16 = 512). Both return a :class:`~repro_torch.distributed.mesh.
DeviceMesh`. Its devices are the visible cards by default — too few
raise, as the reference does, and nothing falls back to the CPU — or
those the caller names: ``devices=["meta"] * 256`` builds the
placeholder pod the dry-run (:mod:`repro_torch.launch.dryrun`) runs its
ranks on, and ``["cuda:0"] * 4`` four shards on one card.

A :class:`DeviceMesh` fixes its axis names — the trailing names of
``("pod", "data", "model")`` — so :func:`make_mesh` takes only those,
where the reference's ``jax.make_mesh`` takes any.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import AXES, DeviceMesh, mesh_devices

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` pod, or the (2, 16, 16)
    ``("pod", "data", "model")`` pair of pods, over ``devices`` (the
    visible cards by default)."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD,
                     devices=devices)


def make_mesh(shape, axes=None, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` (tests, elastic re-meshing) over ``devices``
    (the visible cards by default). ``axes`` defaults to the trailing
    names of ``("pod", "data", "model")``, the only names a
    :class:`DeviceMesh` has; any other raises."""
    shape = tuple(int(x) for x in shape)
    want = AXES[-len(shape):] if 0 < len(shape) <= len(AXES) else None
    if axes is not None and tuple(axes) != want:
        raise ValueError(f"mesh axes {tuple(axes)!r} for shape {shape}: a "
                         f"DeviceMesh names its axes {want!r} (the trailing "
                         f"names of {AXES!r})")
    return DeviceMesh(shape, mesh_devices(shape, devices))
