"""Fault tolerance: straggler detection and supervised restart.

Counterpart of ``repro/distributed/fault_tolerance.py``'s
:class:`StragglerMonitor` and :class:`RestartPolicy`, copied (neither
has a framework dependency beyond the checkpoint manager):

- :class:`StragglerMonitor` — a per-step deadline from a running
  latency EMA; steps exceeding ``k * ema`` are recorded. The cluster
  (:mod:`repro_torch.serving.cluster`) keeps one per decode worker and
  can turn a breach into a drain — detection plus re-scheduling is the
  host-level mitigation, since one worker step has no per-device abort.
- :class:`RestartPolicy` — drives a training step function; on a
  failure it restores the newest valid checkpoint and replays from
  there. The data stream is a pure function of the step
  (:mod:`repro_torch.data`), so a replay on the same device sees the
  same batches.

The reference's ``remesh`` (re-placing a state on another device count)
comes with training over a mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint import CheckpointManager


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


@dataclass
class RestartPolicy:
    """Supervised training loop: checkpoint every k steps, restore and
    replay on failure. ``blocking=False`` writes each checkpoint on the
    manager's background thread (the state is copied to the host before
    the next step either way; a restore joins the write first, and the
    caller joins the last with ``manager.wait()``)."""
    manager: CheckpointManager
    checkpoint_every: int = 50
    max_restarts: int = 3
    restarts: int = 0
    log: list = field(default_factory=list)
    blocking: bool = True

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
                                      extra={"step": step})
            except Exception as e:  # noqa: BLE001 — fail-stop restart
                self.restarts += 1
                self.log.append({"step": step, "error": repr(e),
                                 "restart": self.restarts})
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                got_step, got = self.manager.restore_latest(state)
                if got is not None:
                    state, step = got, got_step
                else:  # no checkpoint yet: restart from scratch
                    step = start_step
        self.straggler_events = monitor.events
        return state, step
