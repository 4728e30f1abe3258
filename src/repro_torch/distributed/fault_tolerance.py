"""Fault tolerance: straggler detection.

Counterpart of ``repro/distributed/fault_tolerance.py``'s
:class:`StragglerMonitor`, copied (the class has no framework
dependency): a per-step deadline from a running latency EMA; steps
exceeding ``k * ema`` are recorded. The cluster
(:mod:`repro_torch.serving.cluster`) keeps one per decode worker and can
turn a breach into a drain — detection plus re-scheduling is the
host-level mitigation, since one worker step has no per-device abort.

The reference module's ``RestartPolicy`` and ``remesh`` restore and
re-shard a training state; they come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field


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
