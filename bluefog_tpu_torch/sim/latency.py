"""Trace-fitted per-edge latency: close the loop from real traces to
the sim's latency model (ROADMAP item 4).

The tracing subsystem already measures per-edge deposit→collect
latency on real fleets (``bluefog_tpu_torch.tracing.merge`` critical-path
reports carry ``stragglers.edge_latency`` as ``{"u->v": {"n",
"p50_us", "p99_us"}}``).  This module turns those two quantiles into
an **empirical quantile sampler** per edge — piecewise-linear inverse
CDF through the anchors

    (0.00, p50/2)  (0.50, p50)  (0.99, p99)  (1.00, p99)

so half the draws land below the measured median and the tail tops out
at the measured p99 (the head anchor at p50/2 keeps the support off
zero without inventing a tail below anything observed).  Crude, but it
is fitted to *measured* marginals instead of the uniform
``cfg.latency_s`` guess, and it keeps the campaign deterministic: the
sampler consumes exactly one ``rng.random()`` per draw, same as the
uniform path it replaces.

``load_trace_latency`` accepts either a critical-path report (the
``--critical-path`` output of ``python -m bluefog_tpu_torch.tracing``), the
``stragglers`` sub-object, or a bare ``edge_latency`` mapping, and
returns the ``SimConfig.latency_table`` rows (seconds, not µs).  A
``"*"`` row is synthesized from the pooled median of all edges so
edges the trace never saw still draw from measured scale.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence, Tuple

__all__ = ["EmpiricalLatency", "load_trace_latency"]


class EmpiricalLatency:
    """Per-edge inverse-CDF samplers built from latency_table rows.

    Rows are ``(edge_key, p50_s, p99_s)`` with edge_key ``"u->v"`` or
    ``"*"`` (the fallback for unlisted edges).  ``sample(u, v, rng)``
    draws one latency using one ``rng.random()`` call.
    """

    def __init__(self, table: Sequence[Tuple[str, float, float]]):
        self._anchors: Dict[str, Tuple[float, float, float]] = {}
        for key, p50, p99 in table:
            p50 = max(0.0, float(p50))
            p99 = max(p50, float(p99))
            self._anchors[str(key)] = (p50 / 2.0, p50, p99)
        if not self._anchors:
            raise ValueError("empty latency table")
        if "*" not in self._anchors:
            # pooled fallback: median of the per-edge anchors
            p50s = sorted(a[1] for a in self._anchors.values())
            p99s = sorted(a[2] for a in self._anchors.values())
            mid = len(p50s) // 2
            self._anchors["*"] = (p50s[mid] / 2.0, p50s[mid], p99s[mid])

    def __len__(self) -> int:
        return len([k for k in self._anchors if k != "*"])

    def quantile(self, u: int, v: int, q: float) -> float:
        """The fitted latency at quantile ``q`` for edge ``u->v``."""
        lo, p50, p99 = self._anchors.get(
            f"{int(u)}->{int(v)}", self._anchors["*"])
        q = min(1.0, max(0.0, float(q)))
        if q <= 0.5:
            return lo + (p50 - lo) * (q / 0.5)
        if q <= 0.99:
            return p50 + (p99 - p50) * ((q - 0.5) / 0.49)
        return p99

    def sample(self, u: int, v: int, rng) -> float:
        # exactly ONE rng.random() per draw — stream-compatible with
        # the rng.uniform() call this replaces, so arming the table
        # never shifts any other seeded stream in the campaign
        return self.quantile(u, v, rng.random())


def load_trace_latency(path: str) -> Tuple[Tuple[str, float, float], ...]:
    """Read a merged-trace critical-path report into latency_table
    rows ``((edge_key, p50_s, p99_s), ...)`` — µs in, seconds out."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    edges = doc
    for key in ("stragglers", "edge_latency"):
        if isinstance(edges, dict) and key in edges:
            edges = edges[key]
    if not isinstance(edges, dict) or not edges:
        raise ValueError(
            f"{path}: no edge_latency mapping found (want a "
            f"critical-path report or a bare edge->quantiles dict)")
    rows = []
    for edge, q in sorted(edges.items()):
        try:
            p50 = float(q["p50_us"]) / 1e6
            p99 = float(q["p99_us"]) / 1e6
        except (TypeError, KeyError, ValueError):
            raise ValueError(
                f"{path}: edge {edge!r} lacks p50_us/p99_us") from None
        rows.append((str(edge), p50, max(p50, p99)))
    return tuple(rows)
