"""Contraction-rate fits and the rank statistics behind the scaling laws.

One shared currency: a **per-round contraction rate** ``rate = 1 - ρ``
where ``ρ`` is the fitted per-round factor of the consensus-error
series ``e(t) ≈ C·ρ^t``.  The static prediction is the spectral gap
``1 - |λ₂(W)|`` (:func:`bluefog_tpu_torch.analysis.plan_rules.spectral_gap`);
the lab's whole point is putting a *measured* number next to it.

Everything here is pure numpy over small vectors — the sweep driver,
the sim-oracle differ, and the ``analysis`` lab rules all call the same
functions, so "measured", "simulated", and "model-checked" can never
drift apart through reimplementation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["fit_contraction", "fit_power_law", "predict_power_law",
           "spearman"]

#: Errors below this are float noise around exact consensus (the full
#: graph reaches machine agreement in one round); points past the first
#: such round would fit the noise floor, not the contraction.
NOISE_FLOOR = 1e-13


def fit_contraction(series: Sequence[Tuple[int, float]],
                    warmup: int = 2,
                    floor: float = NOISE_FLOOR) -> Dict[str, float]:
    """Least-squares fit of ``log e(t) = log C + t·log ρ``.

    ``series`` is ``(round, err)`` pairs (NaN/non-positive entries and
    the first ``warmup`` rounds are dropped; the series is truncated at
    the first point under ``floor`` — after that the signal is float
    dust; the float64 default is :data:`NOISE_FLOOR`, float32 probe
    traces pass a proportionally higher one).  Returns ``{"rho",
    "rate", "r2", "points"}``; with fewer than 3 usable points ``rho``
    falls back to 0 (treated as "converged faster than observable":
    rate 1), flagged by ``points``.
    """
    pts: List[Tuple[float, float]] = []
    for t, e in series:
        if t <= warmup or not math.isfinite(e) or e <= 0.0:
            continue
        if e < floor:
            break
        pts.append((float(t), math.log(e)))
    if len(pts) < 3:
        return {"rho": 0.0, "rate": 1.0, "r2": 0.0, "points": len(pts)}
    ts = np.array([t for t, _ in pts])
    ys = np.array([y for _, y in pts])
    slope, intercept = np.polyfit(ts, ys, 1)
    pred = slope * ts + intercept
    ss_res = float(np.sum((ys - pred) ** 2))
    ss_tot = float(np.sum((ys - ys.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    rho = float(min(max(math.exp(slope), 0.0), 1.0 - 1e-9))
    return {"rho": rho, "rate": 1.0 - rho, "r2": r2, "points": len(pts)}


def fit_power_law(ns: Sequence[float], rates: Sequence[float]
                  ) -> Dict[str, float]:
    """Per-topology scaling law ``log rate = a + b·log n`` over the
    measured sizes (the form every named topology's gap follows —
    ring ``Θ(n⁻²)``, mesh ``Θ(n⁻¹)``, exp2 ``Θ(1/log n)``, full
    ``Θ(1)``).  Rates are clamped away from 0 so a
    converged-in-one-round cell (rate 1) stays fittable."""
    ns = np.asarray(ns, dtype=np.float64)
    rates = np.clip(np.asarray(rates, dtype=np.float64), 1e-9, 1.0)
    if ns.size == 1:
        return {"a": float(np.log(rates[0])), "b": 0.0}
    b, a = np.polyfit(np.log(ns), np.log(rates), 1)
    return {"a": float(a), "b": float(b)}


def predict_power_law(fit: Dict[str, float], n: int) -> float:
    """Evaluate a :func:`fit_power_law` law at ``n``, clamped to
    (0, 1] — a contraction rate by definition."""
    rate = math.exp(fit["a"] + fit["b"] * math.log(max(2, int(n))))
    return float(min(max(rate, 1e-9), 1.0))


def _ranks(xs: Sequence[float]) -> np.ndarray:
    """Average ranks (ties share the mean rank), 1-based."""
    a = np.asarray(xs, dtype=np.float64)
    order = np.argsort(a, kind="stable")
    ranks = np.empty(a.size, dtype=np.float64)
    i = 0
    while i < a.size:
        j = i
        while j + 1 < a.size and a[order[j + 1]] == a[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson over average ranks — no scipy
    dependency; ties handled the standard way)."""
    if len(xs) != len(ys) or len(xs) < 2:
        return 0.0
    rx, ry = _ranks(xs), _ranks(ys)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return 0.0
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))
