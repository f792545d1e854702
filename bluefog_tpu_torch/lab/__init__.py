"""bluefog_tpu_torch.lab — the convergence observatory.

The paper's claims are *rates*: push-sum gossip contracts consensus
error at ``|λ₂(W)|`` per round, so topology choice is a measurable
trade of mixing speed against per-round payload cost.  This package
closes the loop between that theory and the running fleet:

- **probe** (:mod:`.probe`) — per-rank, per-round debiased
  consensus-error observable, streamed off-path into telemetry and the
  v3 status page (``CONV`` column in ``bftpu-top``) under
  ``BFTPU_LAB_PROBE=1``;
- **fit** (:mod:`.fit`) — the shared contraction/power-law fits and
  rank statistics every consumer uses;
- **sweep** (:mod:`.sweep`, ``python -m bluefog_tpu_torch.lab sweep``) —
  launch real fleets over named topologies × N, fit measured per-round
  contraction rates, diff each cell against the deterministic simulator
  as an oracle, and emit the versioned ``LAB_rNN.json`` artifact;
- **recommend** (:mod:`.recommend`) — ``lab.recommend(n,
  payload_bytes)`` over the frozen artifact's measured scaling laws;
  ``BFTPU_LAB_AUTO_TOPOLOGY=1`` makes it the islands launch default.

Model-checked by the ``lab`` rule family in
:mod:`bluefog_tpu_torch.analysis.lab_rules`; knobs documented in
docs/OBSERVABILITY.md.
"""

from bluefog_tpu_torch.lab.probe import (  # noqa: F401
    ConvergenceProbe,
    DEFAULT_SAMPLE_CAP,
    probe_enabled,
)
from bluefog_tpu_torch.lab.fit import (  # noqa: F401
    fit_contraction,
    fit_power_law,
    predict_power_law,
    spearman,
)
from bluefog_tpu_torch.lab.recommend import (  # noqa: F401
    ARTIFACT_SCHEMA,
    REF_BYTES,
    TOPOLOGIES,
    build_topology,
    default_artifact_path,
    load_artifact,
    recommend,
    topology_degree,
)

__all__ = [
    "ConvergenceProbe",
    "DEFAULT_SAMPLE_CAP",
    "probe_enabled",
    "fit_contraction",
    "fit_power_law",
    "predict_power_law",
    "spearman",
    "ARTIFACT_SCHEMA",
    "REF_BYTES",
    "TOPOLOGIES",
    "build_topology",
    "default_artifact_path",
    "load_artifact",
    "recommend",
    "topology_degree",
]
