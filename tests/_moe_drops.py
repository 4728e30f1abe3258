"""Routed slots an MoE drops past its experts' capacity, per dispatch,
while a port engine runs — on one device or a mesh — for the tests that
hold a mesh's drops to one device's (``chip_smoke.py`` keeps its own
copy for the card).

:func:`counting_dispatch_drops` wraps ``moe.apply_moe`` and the
engine's ``_dispatch`` (the outputs are the unwrapped ones). On a mesh a
data replica's rows count at their places in the whole dispatch — the
capacity and slot offsets ``apply_moe`` takes — on the rank of model
index 0 of each replica where the rows split over ``data``, else on the
call's first rank (every rank of a replica, or of the mesh, computes the
same rows), so the counts add up as one device's."""
from __future__ import annotations

import contextlib
import threading

from repro_torch.distributed import hints as H
from repro_torch.models import moe as M
from repro_torch.serving import engine as E


def _counts_here() -> bool:
    mesh = H.current_mesh()
    if mesh is None:
        return True
    rank = mesh.rank()
    if H.data_ranks() > 1:
        return mesh.coords(rank)[-1] == 0
    return rank == min(mesh.current_call().ranks)


@contextlib.contextmanager
def counting_dispatch_drops():
    """{dispatch number: routed slots dropped}, the dispatch's MoE layers
    summed; a dict filled when the block exits."""
    parts: dict = {}
    out: dict = {}
    seq = [0]
    lock = threading.Lock()
    apply_moe, dispatch = M.apply_moe, E.ServingEngine._dispatch

    def counted(p, cfg, x):
        xf = x.reshape(-1, x.shape[-1])
        _, ids = M.route(p["router"], xf, cfg.moe_top_k)
        pos = (M.slot_positions(ids, cfg.n_experts)
               + H.slot_offsets(ids, cfg.n_experts))
        cap = M._capacity(xf.shape[0] * H.data_ranks(), cfg)
        if _counts_here():
            with lock:
                parts.setdefault(seq[0], []).append((pos >= cap).sum())
        return apply_moe(p, cfg, x)

    def tagged(self, kind, *args):
        seq[0] += 1
        return dispatch(self, kind, *args)

    M.apply_moe, E.ServingEngine._dispatch = counted, tagged
    try:
        yield out
    finally:
        M.apply_moe, E.ServingEngine._dispatch = apply_moe, dispatch
        out.update({i: sum(int(t.item()) for t in v)
                    for i, v in parts.items()})
