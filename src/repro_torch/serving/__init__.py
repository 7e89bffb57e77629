"""Continuous-batching serving stack of the port.

* ``SamplingParams`` / ``sample_tokens`` (``serving/sampling.py``): greedy,
  temperature, top-k and top-p with a per-request seed, drawn inside the
  decode step.
* ``Scheduler`` / ``FCFSScheduler`` / ``PriorityScheduler`` /
  ``SJFScheduler`` (``serving/scheduler.py``): admission order;
  ``PreemptionPolicy`` / ``SwapPreemption`` / ``RecomputePreemption``:
  eviction when the pool runs dry.
* ``ContiguousCacheManager`` / ``PagedCacheManager`` / ``CacheConfig``
  (``serving/cache_manager.py``): the contiguous KV layout (a ring for a
  sliding-window config) and the paged one over ``PagePool``
  (``serving/paging.py``), with the radix prefix cache ``RadixCache``
  (``serving/radix.py``).
* ``Engine`` (``serving/engine.py``): the device-resident core, one
  decode step (a CUDA graph replay on the card) and one batched host
  readback per step.
* ``LLMEngine`` (``serving/api.py``): ``generate()`` and ``stream()``
  (``TokenEvent``s) over the engine, ``abort()``, per-request deadlines.
* ``ChaosInjector`` / ``InjectedDeviceFault`` (``serving/chaos.py``):
  step-indexed fault injection (device faults, page-pool exhaustion,
  corrupt readbacks, stalls, aborts) against the request lifecycle and
  the engine's crash recovery.
* ``SpecConfig`` / ``NGramDrafter`` / ``DraftModelDrafter``
  (``serving/spec/``): speculative decoding inside the captured step,
  greedy streams equal to target-only decoding's.
"""

from repro_torch.serving.api import LLMEngine, RequestOutput, TokenEvent
from repro_torch.serving.cache_manager import (CacheConfig,
                                              ContiguousCacheManager,
                                              PagedCacheManager)
from repro_torch.serving.chaos import ChaosInjector, InjectedDeviceFault
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paging import PagePool
from repro_torch.serving.radix import RadixCache
from repro_torch.serving.sampling import SamplingParams, sample_tokens
from repro_torch.serving.scheduler import (FCFSScheduler, PreemptionPolicy,
                                           PriorityScheduler,
                                           RecomputePreemption, Scheduler,
                                           SJFScheduler, SwapPreemption,
                                           make_preemption, make_scheduler)
from repro_torch.serving.spec import (DraftModelDrafter, Drafter,
                                      NGramDrafter, SpecConfig)

__all__ = ["CacheConfig", "ChaosInjector", "ContiguousCacheManager",
           "DraftModelDrafter", "Drafter", "Engine", "FCFSScheduler",
           "InjectedDeviceFault", "LLMEngine", "NGramDrafter", "PagePool",
           "PagedCacheManager", "PreemptionPolicy", "PriorityScheduler",
           "RadixCache", "RecomputePreemption", "Request", "RequestOutput",
           "SJFScheduler", "SamplingParams", "Scheduler", "SpecConfig",
           "SwapPreemption", "TokenEvent", "make_preemption",
           "make_scheduler", "sample_tokens"]
