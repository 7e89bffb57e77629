"""Pluggable kernel-optimization search (the counterpart of
``repro.search``): the ``EvalResult`` type, a content-addressed evaluation
cache (thread-safe, optionally persistent, each unique genome
validated and profiled at most once), the tiered evaluator (screen ->
smoke test -> full suite, one oracle per suite, concurrent
``evaluate_many``) and interchangeable strategies (greedy chain, beam,
population) over the four agents.

Robustness (README, "Robust search"): ``EvalWorkerPool`` runs evaluations
in crash-isolated spawn-mode workers with deadlines, retries and genome
quarantine, one task at a time on the card; ``SearchJournal`` makes a
search resumable after ``kill -9``.
"""

from repro_torch.search.cache import (EvalCache, code_version_salt,
                                      decode_result, encode_result)
from repro_torch.search.evaluator import EvalStats, TieredEvaluator
from repro_torch.search.journal import JournalMismatch, SearchJournal
from repro_torch.search.orchestrator import (PAPER_KERNELS, SearchFailure,
                                             SearchOrchestrator, optimize,
                                             optimize_all, reintegrate)
from repro_torch.search.strategies import (BeamSearch, GreedyChain,
                                           Population, SearchContext,
                                           SearchStrategy, resolve_strategy)
from repro_torch.search.types import (EvalResult, genome_digest, genome_key,
                                      suite_digest)
from repro_torch.search.workers import EvalWorkerPool, Outcome

__all__ = [
    "BeamSearch", "EvalCache", "EvalResult", "EvalStats", "EvalWorkerPool",
    "GreedyChain", "JournalMismatch", "Outcome", "PAPER_KERNELS",
    "Population", "SearchContext", "SearchFailure", "SearchJournal",
    "SearchOrchestrator", "SearchStrategy", "TieredEvaluator",
    "code_version_salt", "decode_result", "encode_result", "genome_digest",
    "genome_key", "optimize", "optimize_all", "reintegrate",
    "resolve_strategy", "suite_digest",
]
