"""Pluggable kernel-optimization search (the counterpart of
``repro.search``): the ``EvalResult`` type, a content-addressed evaluation
cache (thread-safe, optionally persistent, each unique genome
validated and profiled at most once), the tiered evaluator (screen ->
smoke test -> full suite, one oracle per suite, concurrent
``evaluate_many``) and interchangeable strategies (greedy chain, beam,
population) over the four agents.
"""

from repro_torch.search.cache import (EvalCache, code_version_salt,
                                      decode_result, encode_result)
from repro_torch.search.evaluator import EvalStats, TieredEvaluator
from repro_torch.search.orchestrator import (PAPER_KERNELS,
                                             SearchOrchestrator, optimize,
                                             optimize_all, reintegrate)
from repro_torch.search.strategies import (BeamSearch, GreedyChain,
                                           Population, SearchContext,
                                           SearchStrategy, resolve_strategy)
from repro_torch.search.types import (EvalResult, genome_digest, genome_key,
                                      suite_digest)

__all__ = [
    "BeamSearch", "EvalCache", "EvalResult", "EvalStats",
    "GreedyChain", "PAPER_KERNELS", "Population", "SearchContext",
    "SearchOrchestrator", "SearchStrategy", "TieredEvaluator",
    "code_version_salt", "decode_result", "encode_result", "genome_digest",
    "genome_key", "optimize", "optimize_all", "reintegrate",
    "resolve_strategy", "suite_digest",
]
