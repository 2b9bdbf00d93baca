"""Serving layer: continuous batching over Session with accuracy tiers.

>>> from repro_torch.session import Session
>>> eng = Session("qwen3-4b", device="cpu").serving_engine(slots=4, max_len=64)
>>> r = eng.submit(prompt, tier="premium", max_new_tokens=16)
>>> eng.run()
>>> r.result()
"""
from repro_torch.serving.engine import (Engine, Event, ModelRunner, TierStats,
                                        TransformerRunner)
from repro_torch.serving.kvcache import (PageAllocator, ServingError,
                                         SlotAllocator, gather_state,
                                         paged_layout, paged_pool_init,
                                         pages_for, scatter_chunk,
                                         scatter_token, write_state,
                                         zero_pages)
from repro_torch.serving.scheduler import (DEFAULT_TIERS, FakeClock,
                                           MonotonicClock, Request, Scheduler,
                                           TierSpec)

__all__ = [
    "DEFAULT_TIERS",
    "Engine",
    "Event",
    "FakeClock",
    "ModelRunner",
    "MonotonicClock",
    "PageAllocator",
    "Request",
    "Scheduler",
    "ServingError",
    "SlotAllocator",
    "TierSpec",
    "TierStats",
    "TransformerRunner",
    "gather_state",
    "paged_layout",
    "paged_pool_init",
    "pages_for",
    "scatter_chunk",
    "scatter_token",
    "write_state",
    "zero_pages",
]
