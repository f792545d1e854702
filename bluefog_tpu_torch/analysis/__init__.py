"""Static verifier for the gossip runtime (counterpart of
``bluefog_tpu/analysis``).

One shared currency (:class:`~bluefog_tpu_torch.analysis.engine.Finding`)
and one rule family so far:

- **trace** (:mod:`.trace_rules`) — distributed-trace buffers: per-rank
  span nesting, cross-rank flow-endpoint resolution, and clock blocks
  within the min-RTT estimator's own error bound (the family behind
  ``python -m bluefog_tpu_torch.tracing --check``).

The reference's other families (plan, protocol, resilience, telemetry,
adaptive, progress, wire, serve, ...) are not in this package yet.
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
from bluefog_tpu_torch.analysis import trace_rules  # noqa: F401

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
