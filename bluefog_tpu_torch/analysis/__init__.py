"""Static verifier for the gossip runtime (counterpart of
``bluefog_tpu/analysis``).

One shared currency (:class:`~bluefog_tpu_torch.analysis.engine.Finding`),
three consumers (CLI, pytest, the card's smoke run), and these rule
families — the reference's, with its ``hlo`` family as ``collective``:

- **plan** (:mod:`.plan_rules`) — every named topology x size 2..64:
  shift classes are permutations, classes cover the edge set exactly,
  the mixing matrix is doubly stochastic, the spectral gap is positive;
- **collective** (:mod:`.collective_rules`, :mod:`.collective_corpus`) —
  the collective-count contract of the torch path: each gossip program
  runs under :class:`~bluefog_tpu_torch.common.collective_inspect.
  CollectiveInventory`, which files every aten op that mixes the rank
  axis under the reference's HLO opcode; budgets, no full-axis
  all-gather, no replicated large buffer (on the card unless
  :func:`.collective_corpus.set_device` says otherwise);
- **protocol** (:mod:`.seqlock_model`, :mod:`.epoch_rules`) — exhaustive
  interleaving check of the shm-mailbox seqlock/collect/barrier at small
  bounds, plus the window-op epoch-ordering lint;
- **resilience** (:mod:`.resilience_rules`) — healed survivor topologies
  stay doubly stochastic and mixing, degraded rows conserve mass, and the
  force-drain of a dead writer's slot loses no committed deposit;
- **telemetry** (:mod:`.telemetry_rules`) — snapshot schema, counter
  monotonicity, the mailbox-ledger conservation identity, and the env-var
  lint over ``bluefog_tpu_torch/`` (every BFTPU_*/BLUEFOG_* knob
  documented in README.md or docs/*.md);
- **trace** (:mod:`.trace_rules`) — distributed-trace buffers: span
  nesting, flow-endpoint resolution, clock blocks within the estimator's
  error bound;
- **adaptive** (:mod:`.adaptive_rules`) — demoted topologies stay doubly
  stochastic and mixing, restores round-trip, no demote/promote cycle
  shorter than the hysteresis floor;
- **progress** (:mod:`.progress_rules`) — the async progress engine's
  submit/step/quiesce/resume interleavings, handle lifecycle and fusion
  contract;
- **wire** (:mod:`.wire_rules`) — chunk-stream commit integrity, credit
  window liveness, residual conservation, writer death vs drain, TCP/shm
  spec parity;
- **introspect** (:mod:`.introspect_rules`) — status pages, holder words
  and the blame feed;
- **sim**, **partition**, **serve**, **distrib**, **monitor**, **slo**,
  **lab** — the campaign families over the fleet simulator, the serving
  plane, the monitor and the convergence observatory's frozen artifact;
- **transport** (:mod:`.transport_spec`) — the executable window/mailbox
  spec table, ``ReferenceTransport`` and the capability lint over the
  port's own sources;
- **conformance** (:mod:`.conformance`) — native shm, fallback shm,
  chunked and legacy TCP and ``SimTransport`` driven through pinned-seed
  op schedules against the reference model, ddmin-shrunk on divergence;
- **interleave** (:mod:`.interleave`) — the unified interleaving explorer
  with its vector-clock race check;
- the **fixture corpus** (:mod:`.fixtures`) — seeded bugs proving every
  rule fires.

Run ``python -m bluefog_tpu_torch.analysis`` for the CLI.  Importing this
package registers every rule and touches no device; only *running* the
collective family does.
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
    adaptive_rules,
    collective_corpus,
    collective_rules,
    conformance,
    distrib_rules,
    epoch_rules,
    fixtures,
    interleave,
    introspect_rules,
    lab_rules,
    monitor_rules,
    partition_rules,
    plan_rules,
    progress_rules,
    resilience_rules,
    seqlock_model,
    serve_rules,
    sim_rules,
    slo_rules,
    telemetry_rules,
    trace_rules,
    transport_spec,
    wire_rules,
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
