"""Evaluation criteria from §5 of the paper: accuracy and overall ratio
(a numpy-only copy of `repro/core/metrics.py`).

Both pair the i-th returned user (by true rank) with the i-th exact-answer
user, per Definition 3 ("Let u and u' be the i-th user in U_c and U_rr").
"""
from __future__ import annotations

import numpy as np


def _paired_true_ranks(result_idx: np.ndarray, exact_idx: np.ndarray,
                       true_ranks: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Sort both result sets by true rank and pair position-wise."""
    ours = np.sort(true_ranks[np.asarray(result_idx)])
    exact = np.sort(true_ranks[np.asarray(exact_idx)])
    return ours.astype(np.float64), exact.astype(np.float64)


def accuracy(result_idx: np.ndarray, exact_idx: np.ndarray,
             true_ranks: np.ndarray, c: float) -> float:
    """Accuracy = (1/k) Σ_i  I[ r(q,u_i,P) ≤ c · r(q,u'_i,P) ]   (§5)."""
    ours, exact = _paired_true_ranks(result_idx, exact_idx, true_ranks)
    return float(np.mean(ours <= c * exact))


def overall_ratio(result_idx: np.ndarray, exact_idx: np.ndarray,
                  true_ranks: np.ndarray) -> float:
    """Overall ratio = (1/k) Σ_i  r(q,u_i,P) / r(q,u'_i,P)   (§5). ≥ 1."""
    ours, exact = _paired_true_ranks(result_idx, exact_idx, true_ranks)
    return float(np.mean(ours / np.maximum(exact, 1.0)))
