"""Collective bytes and counts of a step over a :class:`~repro_torch.
distributed.mesh.DeviceMesh`, recorded where the mesh makes them.

Counterpart of ``repro/roofline/hlo.py``, which the port replaces: the
reference reads the collectives out of the compiled HLO text and walks
its while loops to multiply their trip counts through. The port has no
HLO — each rank runs its step eagerly, and every collective of a step
is a call of :meth:`DeviceMesh.all_gather`, :meth:`~DeviceMesh.
all_reduce` or :meth:`~DeviceMesh.reduce_scatter` (the autograd
collectives of :mod:`repro_torch.distributed.collectives`, forward and
backward, and the gathers of :mod:`repro_torch.distributed.hints`, over
``data`` too, all reach them). So :class:`CollectiveRecorder`, installed
on a mesh, counts each call as it happens: a loop is counted once an
iteration, with no trip count to read.

The schema is the reference's: per kind (``"all-gather"``,
``"all-reduce"``, ``"reduce-scatter"``) the bytes of each call's result
— the shard-local payload a device receives — and the number of calls,
for one device; a device is the fullest rank. A collective over a group
of one rank moves nothing and is not counted (XLA drops it too)."""
from __future__ import annotations

import contextlib
import threading

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter")

# torch dtype -> the HLO spelling the breakdown prints
_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.float64: "f64",
               torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def shape_text(t: torch.Tensor) -> str:
    """``t``'s dtype and shape as HLO writes a result: ``bf16[8,1024]``."""
    dt = _HLO_DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dt}[{','.join(str(n) for n in t.shape)}]"


class CollectiveRecorder:
    """Per rank, per (kind, result shape): calls and bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.per_rank: dict[int, dict] = {}

    def note(self, rank: int, kind: str, out: torch.Tensor) -> None:
        key = (kind, shape_text(out))
        nbytes = out.numel() * out.element_size()
        with self._lock:
            row = self.per_rank.setdefault(rank, {})
            n, b = row.get(key, (0, 0))
            row[key] = (n + 1, b + nbytes)

    def rank_report(self, rank: int) -> dict:
        """The reference's ``collective_bytes`` record of one rank:
        ``{"bytes": {kind: B}, "counts": {kind: n}, "total_bytes": B}``,
        kinds with no call left out."""
        by, ct = {}, {}
        for (kind, _), (n, b) in self.per_rank.get(rank, {}).items():
            by[kind] = by.get(kind, 0) + b
            ct[kind] = ct.get(kind, 0) + n
        return {"bytes": by, "counts": ct, "total_bytes": sum(by.values())}

    def fullest_rank(self) -> int:
        """The rank whose collectives moved the most bytes (the lowest
        such rank; 0 when none moved any)."""
        if not self.per_rank:
            return 0
        return max(sorted(self.per_rank),
                   key=lambda r: self.rank_report(r)["total_bytes"])

    def report(self) -> dict:
        """The record of a device: the fullest rank's."""
        return self.rank_report(self.fullest_rank())

    def breakdown(self, rank: int | None = None, top: int = 15) -> list:
        """The ``top`` (kind, result shape) of ``rank`` (the fullest by
        default) by bytes: ``[(kind, shape, bytes, calls)]``."""
        rank = self.fullest_rank() if rank is None else rank
        rows = [(k, s, b, n) for (k, s), (n, b) in
                self.per_rank.get(rank, {}).items()]
        return sorted(rows, key=lambda r: (-r[2], r[0], r[1]))[:top]


@contextlib.contextmanager
def recording(mesh):
    """A :class:`CollectiveRecorder` installed on ``mesh`` for the
    block's collectives (the one before restored after)."""
    prev, rec = mesh.recorder, CollectiveRecorder()
    mesh.recorder = rec
    try:
        yield rec
    finally:
        mesh.recorder = prev
