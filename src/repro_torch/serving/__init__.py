"""Serving layer of the port: KV-cache managers, schedulers, the engine,
the disaggregated cluster, workload traces and telemetry."""
from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    Request,
    ServingEngine,
    SlotPacket,
    build_closures,
    make_sampler,
    request_breakdowns,
)
from repro_torch.serving.cluster import (  # noqa: F401
    ClusterConfig,
    ClusterEngine,
    Worker,
)
from repro_torch.serving.kv_cache import (  # noqa: F401
    BlockAllocator,
    ContiguousCache,
    KVCacheManager,
    MeshContiguousCache,
    MeshPagedCache,
    PagedCache,
    PrefixIndex,
    contiguous_kv_bytes,
    kv_bytes_per_token,
    kv_partition_count,
    make_kv_cache,
    paged_resident_kv_bytes,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    SLO,
    BlockingScheduler,
    ChunkedScheduler,
    PrefillState,
    Scheduler,
    SLOScheduler,
    SpeculativeScheduler,
    make_scheduler,
    preempt_victim_key,
    slo_sort_key,
)
from repro_torch.serving.telemetry import (  # noqa: F401
    NULL_TELEMETRY,
    DispatchProfiler,
    MetricsRegistry,
    SpanTracer,
    Telemetry,
    join_coverage,
    merge_snapshots,
    validate_trace_events,
)
from repro_torch.serving.workload import (  # noqa: F401
    TenantSpec,
    Trace,
    TraceRequest,
    autoscale_decision,
    make_named_trace,
    make_trace,
    replay,
)
