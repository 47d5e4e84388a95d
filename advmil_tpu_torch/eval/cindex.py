"""Concordance index for right-censored survival data.

Matches the semantics of scikit-survival's ``concordance_index_censored`` as
vendored by the reference (reference eval/cindex.py:10-200), but computed with
fully vectorized numpy pair enumeration instead of per-event Python loops:

- a pair (i, j) is comparable iff e_i = 1 and (t_j > t_i, or t_j == t_i with
  e_j = 0);  two events at the same time are NOT comparable,
- concordant when the earlier-event sample has the strictly higher risk
  estimate; |risk_i - risk_j| <= tied_tol counts 0.5.

The top-level ``concordance_index`` dispatches on prediction shape exactly like
the reference (reference eval/cindex.py:31-40): one column -> Cox convention
(risk = -pred); multiple columns -> hazards -> survival -> risk = -sum(S).
"""
from __future__ import annotations

import numpy as np


class NoComparablePairException(ValueError):
    """Censored data contains no comparable pair."""


def _comparable_matrix(event: np.ndarray, time: np.ndarray) -> np.ndarray:
    # comparable[i, j]: event i happened and j outlived i (strictly later time,
    # or censored at exactly the same time)
    later = time[None, :] > time[:, None]
    same_t_censored = (time[None, :] == time[:, None]) & (~event[None, :])
    comp = event[:, None] & (later | same_t_censored)
    np.fill_diagonal(comp, False)
    return comp


def concordance_index_censored(event_indicator, event_time, estimate, tied_tol: float = 1e-8):
    """Returns (cindex, concordant, discordant, tied_risk, tied_time)."""
    event = np.asarray(event_indicator)
    time = np.asarray(event_time)
    est = np.asarray(estimate, dtype=np.float64)
    if event.ndim != 1 or time.ndim != 1 or est.ndim != 1:
        raise ValueError("event_indicator, event_time, estimate must be 1-D")
    if not np.issubdtype(event.dtype, np.bool_):
        raise ValueError("only boolean arrays are supported as class labels "
                         f"for survival analysis, got {event.dtype}")
    if len(time) < 2:
        raise ValueError("Need a minimum of two samples")
    if not event.any():
        raise ValueError("All samples are censored")

    comp = _comparable_matrix(event, time)
    n_comparable = int(comp.sum())
    if n_comparable == 0:
        raise NoComparablePairException(
            "Data has no comparable pairs, cannot estimate concordance index.")

    diff = est[:, None] - est[None, :]
    ties = (np.abs(diff) <= tied_tol) & comp
    # the event (row) must have the higher risk estimate to be concordant
    con = (diff > tied_tol) & comp

    tied_risk = int(ties.sum())
    concordant = int(con.sum())
    discordant = n_comparable - concordant - tied_risk
    # tied_time: comparable pairs sharing the same observed time
    tied_time = int((comp & (time[None, :] == time[:, None])).sum())

    numerator = concordant + 0.5 * tied_risk
    cindex = numerator / n_comparable
    return cindex, concordant, discordant, tied_risk, tied_time


def concordance_index(y_true, y_pred) -> float:
    """Dispatching C-index (reference eval/cindex.py:10-40).

    y_true: [n, 2] (time, event). y_pred: [n, 1] Cox/continuous prediction
    (higher = longer survival; risk = -pred), or [n, T] discrete hazards.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_pred.ndim == 1:
        y_pred = y_pred[:, None]
    t, e = y_true[:, 0], y_true[:, 1].astype(np.bool_)
    if y_pred.shape[1] == 1:
        return concordance_index_censored(e, t, -y_pred[:, 0], tied_tol=1e-8)[0]
    survival = np.cumprod(1.0 - y_pred, axis=1)
    risk = np.sum(survival, axis=1)
    return concordance_index_censored(e, t, -risk, tied_tol=1e-8)[0]
