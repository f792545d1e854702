"""Seeded arrival-process schedules for the open-loop load generator.

A schedule is a plain list of offsets (seconds from the run start) at
which requests *must* be sent — computed up front, before any request
fires, so a stalled server can never push the next arrival later
(that deferral is exactly the coordinated-omission bug the open loop
exists to avoid).

Two processes:

- ``fixed``: deterministic ``1/rate`` spacing — the constant offered
  load a capacity gate wants;
- ``poisson``: exponential inter-arrival gaps (``rng.expovariate``) —
  the memoryless bursty traffic real serving fleets see, and the same
  process the sim's traffic model replays on the virtual clock.

Both are seeded: the same ``(schedule, rate, duration, seed)`` tuple
yields the same offsets on every run and every host, which is what
makes load-test latency numbers comparable across commits.
"""

from __future__ import annotations

import os
import random
from typing import List

__all__ = [
    "arrival_times",
    "loadgen_rate_hz",
    "loadgen_schedule",
    "loadgen_seed",
    "loadgen_duration_s",
]


def loadgen_rate_hz() -> float:
    """``BFTPU_LOADGEN_RATE_HZ``: offered load per replica (default 100)."""
    try:
        v = float(os.environ.get("BFTPU_LOADGEN_RATE_HZ", "100"))
        return v if v > 0 else 100.0
    except ValueError:
        return 100.0


def loadgen_schedule() -> str:
    """``BFTPU_LOADGEN_SCHEDULE``: ``poisson`` (default) or ``fixed``."""
    v = os.environ.get("BFTPU_LOADGEN_SCHEDULE", "poisson")
    return v if v in ("poisson", "fixed") else "poisson"


def loadgen_seed() -> int:
    """``BFTPU_LOADGEN_SEED``: base seed for the arrival RNG (default 0)."""
    try:
        return int(os.environ.get("BFTPU_LOADGEN_SEED", "0"))
    except ValueError:
        return 0


def loadgen_duration_s() -> float:
    """``BFTPU_LOADGEN_DURATION_S``: run length in seconds (default 5)."""
    try:
        v = float(os.environ.get("BFTPU_LOADGEN_DURATION_S", "5"))
        return v if v > 0 else 5.0
    except ValueError:
        return 5.0


def arrival_times(schedule: str, rate_hz: float, duration_s: float,
                  seed: int = 0, stream: int = 0) -> List[float]:
    """Offsets (s from t=0) at which requests must be sent.

    ``stream`` decorrelates per-replica schedules drawn from one base
    seed — each replica gets an independent but reproducible process
    (the XOR constant keeps stream 0 distinct from seed+0 elsewhere).
    """
    rate = float(rate_hz)
    dur = float(duration_s)
    if rate <= 0 or dur <= 0:
        return []
    out: List[float] = []
    if schedule == "fixed":
        gap = 1.0 / rate
        t = gap  # first arrival one gap in, not a synchronized t=0 burst
        while t < dur:
            out.append(t)
            t += gap
        return out
    rng = random.Random((int(seed) ^ 0x10AD) + 0x9E37 * int(stream))
    t = rng.expovariate(rate)
    while t < dur:
        out.append(t)
        t += rng.expovariate(rate)
    return out
