"""Static verifier for the gossip runtime (counterpart of
``bluefog_tpu/analysis``).

One shared currency (:class:`~bluefog_tpu_torch.analysis.engine.Finding`)
and these rule families:

- **trace** (:mod:`.trace_rules`) — distributed-trace buffers: per-rank
  span nesting, cross-rank flow-endpoint resolution, and clock blocks
  within the min-RTT estimator's own error bound (the family behind
  ``python -m bluefog_tpu_torch.tracing --check``);
- **sim** (:mod:`.sim_rules`) — the deterministic fleet simulator as a
  verifier: pinned-seed fault campaigns over the real protocol state
  machines finish clean (mass conserved, ledger balanced, consensus at
  quiesce), the same seed replays bit-identically, and a seeded
  invariant bug shrinks to its minimal schedule;
- **partition** (:mod:`.partition_rules`) — the quorum module's
  strict-majority arithmetic is pinned, pinned-seed partition campaigns
  orphan exactly the minority and merge it back, and the seeded
  ``split_brain`` bug is caught and shrinks to the partition alone;
- **serve** (:mod:`.serve_rules`) — pinned serve campaigns publish
  strictly monotone versions with replicas converging to the committed
  head, the publish fence follows the quorum arithmetic, and a
  double-buffer interleaving model returns only committed bytes;
- **distrib** (:mod:`.distrib_rules`) — the snapshot distribution
  plane's fan-out tree stays connected, acyclic and degree-capped under
  kill/re-parent sequences, deltas compose to the full snapshot, and
  pinned distribution campaigns keep its invariants silent;
- **monitor** (:mod:`.monitor_rules`) — the fleet monitor's sim twin:
  every seeded runtime fault raises exactly its alert, the clean twins
  raise none with the digest unchanged, and a sustained breach
  coalesces into one window;
- **slo** (:mod:`.slo_rules`) — pinned Poisson-load campaigns serve
  every request within the SLO or excuse it with an overlapping fault
  window, the seeded traffic bugs are caught, and the trace-fitted
  latency sampler honors its anchors;
- **lab** (:mod:`.lab_rules`) — the convergence observatory's frozen
  sweep artifact: schema, refittable fits, scaling laws, rank
  correlation with spectral gaps, sim-oracle cells and the stored
  recommendation map.

The reference's other families (plan, hlo, protocol, resilience,
telemetry, adaptive, progress, wire, introspect, transport, conformance,
interleave), its fixture corpus and its CLI are not in this package yet.
"""

from bluefog_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Report,
    Rule,
    Registry,
    Severity,
    registry,
)

# importing the family modules populates ``registry``
from bluefog_tpu_torch.analysis import (  # noqa: F401
    distrib_rules,
    lab_rules,
    monitor_rules,
    partition_rules,
    serve_rules,
    sim_rules,
    slo_rules,
    trace_rules,
)

__all__ = [
    "Finding",
    "Report",
    "Rule",
    "Registry",
    "Severity",
    "registry",
    "run",
]


def run(families=None, verbose: bool = False) -> Report:
    """Run the registered rules (all families by default); see
    :meth:`Registry.run`."""
    return registry.run(families=families, verbose=verbose)
