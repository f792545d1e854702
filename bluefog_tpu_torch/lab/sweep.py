"""The sweep driver: measured scaling laws + the sim-as-oracle differ.

``run_sweep`` launches REAL island fleets (``islands.spawn`` over the
shm transport) for every (topology, N) cell, with the convergence probe
on, all ranks in barrier lockstep, and explicit ``GetRecvWeights``
weights — so the fleet iterates exactly ``x ← W x`` for the named
topology's mixing matrix ``W``, the same matrix the static spectral-gap
prediction and the simulator use.  Each cell yields a fitted per-round
contraction rate (:func:`bluefog_tpu_torch.lab.fit.fit_contraction` over the
per-round max of the probes' samples).

Every cell is then replayed through the deterministic fleet simulator
(:mod:`bluefog_tpu_torch.sim`) with the same topology/rounds/seed and
``trace_consensus`` on: the sim is the ORACLE.  A cell whose measured
rate diverges from the sim's fitted rate beyond ``tol`` is flagged —
that is the wire protocol, the combine path, or the simulator lying
about the same linear iterate, and exactly the regression this
artifact exists to catch.

The output is the versioned ``LAB_rNN.json`` artifact: cells, fitted
per-topology power laws, the measured-vs-gap Spearman rank
correlation, and the recommendation map ``lab.recommend`` serves.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.lab.fit import (NOISE_FLOOR, fit_contraction,
                                 fit_power_law, spearman)
from bluefog_tpu_torch.lab.recommend import (ARTIFACT_SCHEMA, REF_BYTES,
                                       build_topology, recommend)

__all__ = ["run_sweep", "sweep_cell", "sim_cell", "diff_cell",
           "provenance", "spectral_gap_of", "DEFAULT_TOPOLOGIES",
           "DEFAULT_SIZES", "DEFAULT_TOL", "ARTIFACT_VERSION"]

ARTIFACT_VERSION = "r01"

DEFAULT_TOPOLOGIES: Tuple[str, ...] = ("exp2", "ring", "star")
DEFAULT_SIZES: Tuple[int, ...] = (4, 8, 16)
DEFAULT_ROUNDS = 25
DEFAULT_PAYLOAD_BYTES = 1024

#: Max |rate_measured - rate_sim| before a cell is flagged divergent.
#: The sim replay runs lockstep (SimConfig.lockstep), the same
#: synchronous ``x ← Wx`` iterate as the barriered sweep fleet, so the
#: two fitted rates agree to float noise on a healthy runtime; the
#: band absorbs float32-vs-float64 and finite-series fit jitter, while
#: protocol regressions (lost deposits, mis-weighted combines) shift
#: rates far beyond it.
DEFAULT_TOL = 0.15


def provenance() -> Dict[str, str]:
    """Who/where/when stamp for versioned artifacts (lab + bench):
    git sha (``+dirty`` when the tree is modified), UTC date, host."""
    sha = "unknown"
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10).stdout.strip() \
            or "unknown"
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10).stdout.strip()
        if sha != "unknown" and dirty:
            sha += "+dirty"
    except (OSError, subprocess.SubprocessError):
        pass
    return {
        "git_sha": sha,
        "date": datetime.datetime.now(
            datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
        "host": socket.gethostname(),
    }


def spectral_gap_of(topo_name: str, n: int) -> float:
    """Static prediction ``1 - |λ₂(W)]`` for a named corpus topology."""
    from bluefog_tpu_torch import topology_util as tu

    W = tu.GetWeightMatrix(build_topology(topo_name, n))
    mags = np.sort(np.abs(np.linalg.eigvals(W)))[::-1]
    return float(1.0 - mags[1])


def _max_per_round(samples: Sequence[Tuple[int, float]]
                   ) -> List[Tuple[int, float]]:
    """Aggregate per-rank ``(round, err)`` samples to the per-round max
    over ranks — the fleet-level consensus-error envelope both the
    measured and the simulated fits run on."""
    per: Dict[int, float] = {}
    for t, e in samples:
        if e == e:  # drop the NaN first-round sample
            per[t] = max(per.get(t, 0.0), e)
    return sorted(per.items())


def _sweep_worker(rank: int, size: int, topo_name: str, rounds: int,
                  elems: int, seed: int):
    """One sweep rank: lockstep push-sum over the named topology with
    the convergence probe on.  Pure numpy on the island's host
    window.  Runs inside ``islands.spawn`` (auto-init'ed)."""
    import numpy as np

    from bluefog_tpu_torch import islands
    from bluefog_tpu_torch import topology_util as tu
    from bluefog_tpu_torch.lab.recommend import build_topology as _build

    topo = _build(topo_name, size)
    islands.set_topology(topo)
    # explicit W weights: win_update's default is uniform
    # 1/(in_deg+1), NOT the graph weights — the sweep must iterate the
    # same (possibly Metropolis-Hastings) W the gap and the sim use
    sw, nw = tu.GetRecvWeights(topo, rank)
    # initial value = my rank in every element, the sim's exact initial
    # condition — the probe's per-round samples then track the same
    # scalar iterate the oracle computes
    x = np.full(elems, float(rank), dtype=np.float32)
    islands.win_create(x, "lab")
    for _ in range(rounds):
        islands.win_put(islands.win_sync("lab"), "lab")
        islands.barrier()
        islands.win_update("lab", self_weight=sw, neighbor_weights=nw)
        islands.barrier()
    hist = islands.win_conv_history("lab")
    islands.win_free("lab")
    return hist


def sweep_cell(topo_name: str, n: int, rounds: int = DEFAULT_ROUNDS,
               payload_bytes: int = DEFAULT_PAYLOAD_BYTES,
               seed: int = 0, timeout: float = 600.0) -> Dict[str, object]:
    """Measure one (topology, N) cell on a real spawned fleet."""
    from bluefog_tpu_torch import islands

    elems = max(1, int(payload_bytes) // 4)  # float32 payload
    prev = os.environ.get("BFTPU_LAB_PROBE")
    os.environ["BFTPU_LAB_PROBE"] = "1"
    try:
        per_rank = islands.spawn(
            _sweep_worker, n, job=f"lab_{topo_name}_{n}_{seed}",
            timeout=timeout,
            args=(topo_name, rounds, elems, seed))
    finally:
        if prev is None:
            os.environ.pop("BFTPU_LAB_PROBE", None)
        else:
            os.environ["BFTPU_LAB_PROBE"] = prev
    samples = [s for hist in per_rank for s in hist]
    series = _max_per_round(samples)
    # float32 fleet: truncate the fit where the trace hits float32
    # noise (~1e-6 of the initial spread) instead of the float64 floor
    peak = max((e for _, e in series), default=0.0)
    fit = fit_contraction(series,
                          floor=max(NOISE_FLOOR, peak * 1e-5))
    return {
        "topology": topo_name,
        "n": int(n),
        "payload_bytes": int(payload_bytes),
        "rounds": int(rounds),
        "seed": int(seed),
        "rate": fit["rate"],
        "rho": fit["rho"],
        "r2": fit["r2"],
        "points": fit["points"],
        "gap": spectral_gap_of(topo_name, n),
        "series": [[int(t), float(e)] for t, e in series],
    }


def sim_cell(topo_name: str, n: int, rounds: int = DEFAULT_ROUNDS,
             seed: int = 0) -> Dict[str, object]:
    """Replay one cell through the deterministic simulator (the
    oracle): same topology, rounds, seed; no faults; lockstep (the
    barriered fleet's synchronous iterate); consensus tracing on.
    ``consensus_tol`` is effectively disabled — a short sweep cell is
    nowhere near the quiesce tolerance, and the invariants that must
    hold (mass, ledger) are checked regardless."""
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    cfg = SimConfig(ranks=int(n), rounds=int(rounds), quiesce_rounds=0,
                    seed=int(seed), topology=topo_name, faults=(),
                    adaptive=False, consensus_tol=1e9,
                    trace_consensus=True, lockstep=True)
    res = run_campaign(cfg)
    series = _max_per_round([(t, e) for t, _, e in res.consensus_trace])
    fit = fit_contraction(series)
    return {
        "sim_ok": bool(res.ok),
        "sim_digest": res.digest[:16],
        "sim_rate": fit["rate"],
        "sim_rho": fit["rho"],
        "sim_r2": fit["r2"],
        "sim_points": fit["points"],
    }


def diff_cell(cell: Dict[str, object], tol: float = DEFAULT_TOL
              ) -> Dict[str, object]:
    """Oracle verdict for one measured+simulated cell record."""
    abs_diff = abs(float(cell["rate"]) - float(cell["sim_rate"]))
    return {
        "abs_diff": abs_diff,
        "diverged": bool(abs_diff > tol or not cell.get("sim_ok", False)),
    }


def run_sweep(topologies: Sequence[str] = DEFAULT_TOPOLOGIES,
              sizes: Sequence[int] = DEFAULT_SIZES,
              rounds: int = DEFAULT_ROUNDS,
              payload_bytes: int = DEFAULT_PAYLOAD_BYTES,
              seed: int = 0,
              tol: float = DEFAULT_TOL,
              out_path: Optional[str] = None,
              timeout: float = 600.0,
              log=print) -> dict:
    """The full campaign: measure every cell, oracle-diff it, fit the
    per-topology power laws, and assemble the versioned artifact."""
    cells: List[Dict[str, object]] = []
    for topo in topologies:
        for n in sizes:
            log(f"lab sweep: {topo} x {n} ({rounds} rounds, "
                f"{payload_bytes} B payload)")
            cell = sweep_cell(topo, n, rounds=rounds,
                              payload_bytes=payload_bytes, seed=seed,
                              timeout=timeout)
            cell.update(sim_cell(topo, n, rounds=rounds, seed=seed))
            cell.update(diff_cell(cell, tol=tol))
            log(f"  measured rate {cell['rate']:.4f} "
                f"(gap {cell['gap']:.4f}, sim {cell['sim_rate']:.4f}, "
                f"diff {cell['abs_diff']:.4f}"
                f"{', DIVERGED' if cell['diverged'] else ''})")
            cells.append(cell)
    fits = {
        topo: fit_power_law(
            [c["n"] for c in cells if c["topology"] == topo],
            [c["rate"] for c in cells if c["topology"] == topo])
        for topo in topologies
    }
    corr = spearman([c["gap"] for c in cells],
                    [c["rate"] for c in cells])
    art = {
        "schema": ARTIFACT_SCHEMA,
        "version": ARTIFACT_VERSION,
        "provenance": provenance(),
        "params": {"topologies": list(topologies),
                   "sizes": [int(s) for s in sizes],
                   "rounds": int(rounds),
                   "payload_bytes": int(payload_bytes),
                   "seed": int(seed), "tol": float(tol)},
        "cells": cells,
        "fits": fits,
        "spearman_rate_vs_gap": corr,
        "oracle_clean": all(not c["diverged"] for c in cells),
    }
    # recommendation map over the measured grid plus the reference
    # payload — frozen into the artifact so the analysis lab rules can
    # model-check stored-vs-recomputed consistency
    recs: Dict[str, Dict[str, object]] = {}
    for n in sizes:
        for pb in sorted({int(payload_bytes), REF_BYTES}):
            recs[f"{int(n)}:{pb}"] = recommend(n, pb, artifact=art)
    art["recommended"] = recs
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(art, f, indent=2, sort_keys=True)
            f.write("\n")
        log(f"lab sweep: wrote {out_path} "
            f"(spearman {corr:.3f}, oracle "
            f"{'clean' if art['oracle_clean'] else 'DIVERGED'})")
    return art
