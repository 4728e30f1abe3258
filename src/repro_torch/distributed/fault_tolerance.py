"""Fault tolerance: straggler detection, supervised restart and elastic
re-meshing.

Counterpart of ``repro/distributed/fault_tolerance.py``'s
:class:`StragglerMonitor`, :class:`RestartPolicy` and :func:`remesh`:

- :class:`StragglerMonitor` — a per-step deadline from a running
  latency EMA; steps exceeding ``k * ema`` are recorded. The cluster
  (:mod:`repro_torch.serving.cluster`) keeps one per decode worker and
  can turn a breach into a drain — detection plus re-scheduling is the
  host-level mitigation, since one worker step has no per-device abort.
- :class:`RestartPolicy` — drives a training step function; on a
  failure it restores the newest valid checkpoint and replays from
  there. The data stream is a pure function of the step
  (:mod:`repro_torch.data`), so a replay on the same device — or the
  same mesh — sees the same batches and gives the same bits. Over a
  mesh its state is per-rank trees and it is given their
  :class:`~repro_torch.distributed.sharding.Placement`: each checkpoint
  is the whole-leaf file, each restore re-shards onto the mesh.
- :func:`remesh` — re-places a state on another mesh, by the train
  placements of that mesh: the elastic-scaling primitive. The elastic
  restart composes them, as the reference describes: after a lost node,
  ``manager.restore_latest(like, shardings=Placement(new_mesh,
  train_specs(...)))`` reads the newest checkpoint onto the smaller
  mesh (or one device: ``restore_latest(whole_like)``), and training
  goes on there. Reductions then sum in another order: the losses agree
  to the dtype's tolerance, not bit for bit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import sharding as SH


@dataclass
class StragglerMonitor:
    """EMA-deadline straggler detector (host level)."""
    factor: float = 3.0
    alpha: float = 0.2
    min_samples: int = 3
    ema_s: float = 0.0
    n: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record one step latency; True if it breached the deadline."""
        straggler = (self.n >= self.min_samples
                     and seconds > self.factor * self.ema_s)
        if straggler:
            self.events.append({"step": step, "seconds": seconds,
                                "deadline": self.factor * self.ema_s})
        else:  # stragglers don't poison the EMA
            self.ema_s = (seconds if self.n == 0
                          else (1 - self.alpha) * self.ema_s
                          + self.alpha * seconds)
            self.n += 1
        return straggler

    @property
    def deadline_s(self) -> float:
        return self.factor * self.ema_s if self.n >= self.min_samples \
            else float("inf")


def remesh(state, new_mesh, *, placement=None, specs_fn=SH.train_specs):
    """``state`` re-placed on ``new_mesh``: (per-rank trees, their
    :class:`~repro_torch.distributed.sharding.Placement`). ``state`` is
    a whole tree (any device), or per-rank trees placed by
    ``placement``, gathered whole on the host first. The new placement
    is ``specs_fn(whole tree, new_mesh)`` — the train placements, which
    fall back leaf by leaf where a dim does not divide, so any axis
    sizes take any family. The result gathers back to the same bits."""
    whole = state if placement is None else placement.gather(state, "cpu")
    new = SH.Placement(new_mesh, specs_fn(whole, new_mesh))
    return new.shard(whole), new


@dataclass
class RestartPolicy:
    """Supervised training loop: checkpoint every k steps, restore and
    replay on failure. ``blocking=False`` writes each checkpoint on the
    manager's background thread (the state is copied to the host before
    the next step either way; a restore joins the write first, and the
    caller joins the last with ``manager.wait()``). ``placement``: the
    state is per-rank trees placed so over a mesh — saved whole, restored
    onto the same placement."""
    manager: CheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 3
    restarts: int = 0
    log: list = field(default_factory=list)
    blocking: bool = True
    placement: object = None

    def run(self, *, state, step_fn, data_at, n_steps: int,
            start_step: int = 0, inject_failure=None):
        """Drive ``state = step_fn(state, batch)`` for ``n_steps``.

        ``data_at(step)`` must be deterministic (a seekable stream).
        ``inject_failure(step)`` raising is the test hook for a node
        loss. Returns (final_state, completed_step)."""
        step = start_step
        monitor = StragglerMonitor()
        while step < n_steps:
            try:
                if inject_failure is not None:
                    inject_failure(step)
                t0 = time.time()
                state = step_fn(state, data_at(step))
                monitor.observe(step, time.time() - t0)
                step += 1
                if step % self.checkpoint_every == 0 or step == n_steps:
                    self.manager.save(step, state, blocking=self.blocking,
                                      extra={"step": step},
                                      placement=self.placement)
            except Exception as e:  # noqa: BLE001 — fail-stop restart
                self.restarts += 1
                self.log.append({"step": step, "error": repr(e),
                                 "restart": self.restarts})
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                got_step, got = self.manager.restore_latest(
                    state, shardings=self.placement)
                if got is not None:
                    state, step = got, got_step
                else:  # no checkpoint yet: restart from scratch
                    step = start_step
        self.straggler_events = monitor.events
        return state, step
