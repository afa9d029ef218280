"""False-negative-aware cache selection with stale indicators (Cohen,
Einziger, Scalosub, 2021): the scalar model, indicators, estimators and
policies (NumPy/Python, as in the reference) plus the batched torch
table builders (``repro_torch.core.batched``)."""
from repro_torch.core.model import (
    CacheView,
    exclusion_probabilities,
    hit_ratio_from_q,
    is_sufficiently_accurate,
    phi_hat,
    positive_indication_ratio,
    service_cost,
)
from repro_torch.core.policies import (
    cs_fna,
    cs_fno,
    ds_pgm,
    exhaustive,
    exhaustive_mask,
    expected_cost,
    hocs_fna,
    perfect_information,
    rho_vector,
)
from repro_torch.core.indicator import (
    CountingBloomFilter,
    StaleIndicatorPair,
    hash_indices,
    optimal_k,
    theoretical_fp,
)
from repro_torch.core.estimator import QEstimator, WindowedRatio

__all__ = [
    "CacheView", "exclusion_probabilities", "hit_ratio_from_q",
    "is_sufficiently_accurate", "phi_hat", "positive_indication_ratio",
    "service_cost", "cs_fna", "cs_fno", "ds_pgm", "exhaustive",
    "exhaustive_mask", "expected_cost", "hocs_fna", "perfect_information",
    "rho_vector", "CountingBloomFilter", "StaleIndicatorPair",
    "hash_indices", "optimal_k", "theoretical_fp", "QEstimator",
    "WindowedRatio",
]
