"""The paper's primary contribution, as far as the port has it: the
hardware profiles, the metrics and the static cost model over the
serving engine's own dispatch functions.

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

The simulator and the paper's scenarios are not ported yet.
"""
from repro_torch.core.profiles import (  # noqa: F401
    HardwareProfile, TABLE1, PIM_AI_CHIP, PIM_AI_SERVER, A17_PRO,
    SNAPDRAGON_8_GEN3, DIMENSITY_9300, DGX_H100, pim_dimm, pim_engine,
    pim_server)
from repro_torch.core.metrics import QueryMetrics, tco_3yr  # noqa: F401
