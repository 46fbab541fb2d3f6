from .engine import (Engine, PagedEngine, SamplingParams, chunk_buckets_for,
                     chunk_plan, count_generated, sample)
from .prefix import PrefixCache
from .scheduler import (DEFAULT_BUCKETS, TERMINAL_OUTCOMES, DeviceGroup,
                        HyParRequestTracker, PageAllocator, Request,
                        RequestOutcome, RequestQueue, RequestResult,
                        ServeScheduler, SlotState)

__all__ = [
    "Engine", "PagedEngine", "SamplingParams", "sample", "count_generated",
    "chunk_plan", "chunk_buckets_for", "Request", "RequestResult",
    "RequestOutcome", "TERMINAL_OUTCOMES", "RequestQueue", "SlotState",
    "ServeScheduler", "PageAllocator", "PrefixCache", "DeviceGroup",
    "HyParRequestTracker", "DEFAULT_BUCKETS",
]
