"""Topology recommendation backed by the lab's measured scaling laws.

``recommend(n, payload_bytes)`` answers the deployment question the
static spectral-gap table cannot: the fastest-mixing topology is NOT
the cheapest once payload cost enters — full mixes in one round but
every rank pays ``n-1`` payload sends, while exp2 pays ``log2 n`` for
a ``1/log n`` gap.  The recommender scores each named topology by

    ``score = rate / (1 + payload_bytes * degree / REF_BYTES)``

where ``rate`` is the **measured** per-round contraction rate when the
frozen artifact has a cell at exactly this ``n``, and the per-topology
power-law fit (:func:`bluefog_tpu_torch.lab.fit.predict_power_law`) otherwise
— measurements outrank extrapolation, extrapolation outranks nothing.
``degree`` is the topology's max in-degree at ``n`` (the per-round
payload multiplier), so the denominator is the relative round cost.

Everything is deterministic over a frozen artifact: same artifact, same
``(n, payload_bytes)`` → same answer, which is what the analysis lab
rules model-check and what lets ``BFTPU_LAB_AUTO_TOPOLOGY=1`` be an
opt-in islands default rather than a science experiment.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.lab.fit import predict_power_law

__all__ = ["TOPOLOGIES", "build_topology", "topology_degree",
           "load_artifact", "default_artifact_path", "recommend",
           "ARTIFACT_SCHEMA", "REF_BYTES"]

#: Artifact schema id stamped into LAB_rNN.json (bumped on layout change).
ARTIFACT_SCHEMA = "bftpu-lab/1"

#: Payload normalizer in the score denominator: at 1 MiB payload a
#: degree-1 edge doubles the round cost relative to mixing alone.
REF_BYTES = 1 << 20

#: Named corpus the lab sweeps, fits, and recommends over — the same
#: labels as ``analysis.plan_rules.CORPUS_TOPOLOGIES`` (kept local so
#: island workers never import the analysis package).
TOPOLOGIES = {
    "exp2": tu.ExponentialTwoGraph,
    "sym_exp4": tu.SymmetricExponentialGraph,
    "ring": tu.RingGraph,
    "ring_uni": lambda n: tu.RingGraph(n, connect_style=1),
    "star": tu.StarGraph,
    "mesh2d": tu.MeshGrid2DGraph,
    "full": tu.FullyConnectedGraph,
}


def build_topology(name: str, size: int) -> tu.DiGraph:
    """Construct named corpus topology ``name`` at ``size`` ranks."""
    try:
        builder = TOPOLOGIES[name]
    except KeyError:
        raise ValueError(f"unknown lab topology {name!r}; "
                         f"known: {sorted(TOPOLOGIES)}") from None
    return builder(size)


def topology_degree(name: str, size: int) -> int:
    """Max in-degree (excluding self) at ``size`` — the worst-case
    per-round payload multiplier the score charges for."""
    topo = build_topology(name, size)
    return max(
        sum(1 for s in topo.predecessors(r) if s != r)
        for r in topo.nodes
    )


def default_artifact_path() -> str:
    """``BFTPU_LAB_ARTIFACT`` if set, else the frozen package-data
    artifact shipped with the repo."""
    env = os.environ.get("BFTPU_LAB_ARTIFACT")
    if env:
        return env
    return os.path.join(os.path.dirname(__file__), "data", "LAB_r01.json")


def load_artifact(path: Optional[str] = None) -> dict:
    """Load and sanity-check a lab artifact (sweep output)."""
    path = path or default_artifact_path()
    with open(path) as f:
        art = json.load(f)
    if art.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(f"{path}: schema {art.get('schema')!r} != "
                         f"{ARTIFACT_SCHEMA!r}")
    if not art.get("cells"):
        raise ValueError(f"{path}: no sweep cells")
    return art


def _rate_for(art: dict, name: str, n: int) -> Optional[Dict[str, object]]:
    """Measured-first rate lookup: an exact-``n`` cell wins; otherwise
    evaluate the topology's fitted power law; None if the artifact has
    neither (topology not in this sweep)."""
    measured = [c for c in art.get("cells", ())
                if c["topology"] == name and int(c["n"]) == int(n)]
    if measured:
        # multiple payloads at the same n: the rate is payload-invariant
        # (it is a property of W), so any cell serves; take the mean.
        rate = sum(float(c["rate"]) for c in measured) / len(measured)
        return {"rate": rate, "source": "measured"}
    fit = art.get("fits", {}).get(name)
    if fit is not None:
        return {"rate": predict_power_law(fit, n), "source": "fitted"}
    return None


def recommend(n: int, payload_bytes: int = REF_BYTES,
              artifact: Optional[dict] = None) -> Dict[str, object]:
    """Pick the corpus topology maximizing measured-rate-per-round-cost
    for an ``n``-rank fleet moving ``payload_bytes`` per edge per round.

    Returns ``{"topology", "rate", "degree", "score", "source"}``.
    Deterministic: scores are pure arithmetic over the (frozen)
    artifact; ties break on topology name.
    """
    n = int(n)
    if n < 2:
        raise ValueError("recommend() needs n >= 2")
    payload_bytes = max(0, int(payload_bytes))
    art = artifact if artifact is not None else load_artifact()
    best: Optional[Dict[str, object]] = None
    for name in sorted(TOPOLOGIES):
        got = _rate_for(art, name, n)
        if got is None:
            continue
        deg = topology_degree(name, n)
        score = float(got["rate"]) / (1.0 + payload_bytes * deg / REF_BYTES)
        cand = {"topology": name, "rate": float(got["rate"]),
                "degree": deg, "score": score, "source": got["source"]}
        if best is None or score > best["score"]:
            best = cand
    if best is None:
        raise ValueError("artifact has no usable cells or fits")
    return best
