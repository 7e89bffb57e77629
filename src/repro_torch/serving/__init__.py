"""Greedy continuous-batching serving stack of the port.

* ``SamplingParams`` (``serving/sampling.py``): greedy decoding.
* ``Scheduler`` / ``FCFSScheduler`` (``serving/scheduler.py``): admission
  order; ``PreemptionPolicy`` / ``SwapPreemption`` /
  ``RecomputePreemption``: eviction when the pool runs dry.
* ``ContiguousCacheManager`` / ``PagedCacheManager`` / ``CacheConfig``
  (``serving/cache_manager.py``): the contiguous KV layout (a ring for a
  sliding-window config) and the paged one over ``PagePool``
  (``serving/paging.py``).
* ``Engine`` (``serving/engine.py``): the device-resident core, one
  decode step (a CUDA graph replay on the card) and one batched host
  readback per step.
* ``LLMEngine`` (``serving/api.py``): ``generate()`` over the engine.
"""

from repro_torch.serving.api import LLMEngine, RequestOutput
from repro_torch.serving.cache_manager import (CacheConfig,
                                              ContiguousCacheManager,
                                              PagedCacheManager)
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paging import PagePool
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (FCFSScheduler, PreemptionPolicy,
                                           RecomputePreemption, Scheduler,
                                           SwapPreemption, make_preemption)

__all__ = ["CacheConfig", "ContiguousCacheManager", "Engine",
           "FCFSScheduler", "LLMEngine", "PagePool", "PagedCacheManager",
           "PreemptionPolicy", "RecomputePreemption", "Request",
           "RequestOutput", "SamplingParams", "Scheduler", "SwapPreemption",
           "make_preemption"]
