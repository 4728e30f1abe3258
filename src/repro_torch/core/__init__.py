"""The paper's primary contribution: the PIM-AI architecture model and
the analytical LLM-inference hardware simulator, priced from the serving
engine's own dispatch functions.

Counterpart of ``repro/core/``:

- profiles:   Table-1 hardware profiles + PIM chip/DIMM/server
              composition (a copy: the module has no framework
              dependency)
- metrics:    TTFT / tokens-s / energy / QPS / EPQ / 3-yr TCO (a copy)
- trace:      op-stream tracer over ``meta`` tensors (a
              ``TorchDispatchMode`` records every aten op; the kernel
              wrappers of :mod:`repro_torch.kernels.ops` record their
              own ``cost()``), with two-point linear fits in the cache
              length
- costmodel:  the dispatch pricer over the engine's closures
              (``serving.engine.build_closures``) and the dispatch-log
              audit (``audit_engine`` / ``assert_no_drift``)
- simulator:  per-op time/energy roofline model over the traced op
              streams; ``serve`` replays blocking / chunked /
              speculative / mesh / cluster schedules, and the trace
              mirror runs the engine's own scheduler objects
- scenarios:  the paper's cloud + mobile evaluation setups

The simulator and the scenarios trace on ``meta`` tensors and run no
device work.
"""
from repro_torch.core.profiles import (  # noqa: F401
    HardwareProfile, TABLE1, PIM_AI_CHIP, PIM_AI_SERVER, A17_PRO,
    SNAPDRAGON_8_GEN3, DIMENSITY_9300, DGX_H100, pim_dimm, pim_engine,
    pim_server)
from repro_torch.core.simulator import LLMSimulator, SimConfig  # noqa: F401
from repro_torch.core.metrics import QueryMetrics, tco_3yr  # noqa: F401
from repro_torch.core.scenarios import run_cloud, run_mobile  # noqa: F401
