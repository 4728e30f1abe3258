"""Serving layer of the port: KV-cache manager, scheduler, engine."""
from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    Request,
    ServingEngine,
    build_closures,
)
from repro_torch.serving.kv_cache import (  # noqa: F401
    ContiguousCache,
    KVCacheManager,
    contiguous_kv_bytes,
    make_kv_cache,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    BlockingScheduler,
    PrefillState,
    Scheduler,
    make_scheduler,
)
