from .engine import (PagedEngine, SamplingParams, chunk_buckets_for,
                     chunk_plan, sample)
from .prefix import PrefixCache
from .scheduler import (TERMINAL_OUTCOMES, DeviceGroup, HyParRequestTracker,
                        PageAllocator, Request, RequestOutcome, RequestQueue,
                        RequestResult, ServeScheduler, SlotState)

__all__ = [
    "PagedEngine", "SamplingParams", "sample", "chunk_plan",
    "chunk_buckets_for", "Request", "RequestResult", "RequestOutcome",
    "TERMINAL_OUTCOMES", "RequestQueue", "SlotState", "ServeScheduler",
    "PageAllocator", "PrefixCache", "DeviceGroup", "HyParRequestTracker",
]
