"""Failure detection, topology healing, and degraded-step gossip.

The whole point of decentralized gossip (BlueFog, arXiv:2111.04287) is
that there is no single coordinator to lose — this subsystem makes the
island runtime live up to that: a heartbeat **failure detector**
piggybacked on the job segment (shm: per-rank epoch-stamped liveness
words; tcp: coordinator-mediated leases), **topology healing** that
re-derives a doubly-stochastic survivor topology and recompiles the
shift-class plan when ranks die, **degraded-step semantics** (deadlines
with retry/backoff; mass-conserving weight renormalization on neighbor
loss, so push-sum stays correct), **adaptive topology** (a three-state
gray-failure machine over per-edge deadline misses that demotes a
straggler to one anchor edge — and promotes it back — without ever
declaring it dead; adaptive.py), and a **fault-injection harness**
for the chaos e2e tests.

Push-sum-style algorithms are provably robust on time-varying directed
graphs (Nedić & Olshevsky) — the math already tolerates lost neighbors;
these modules make the runtime tolerate them too.  See
docs/RESILIENCE.md for the full contract.
"""

from bluefog_tpu_torch.resilience.adaptive import (
    AdaptivePolicy,
    adaptive_enabled,
    edge_deadline_factor,
    edge_deadline_floor_s,
)
from bluefog_tpu_torch.resilience.detector import (
    EDGE_ALIVE,
    EDGE_DEAD,
    EDGE_SUSPECT,
    EdgeHealth,
    FailureDetector,
    PeerTimeoutError,
    demote_floor_s,
    failure_timeout_s,
    heartbeat_interval_s,
    promote_clean,
    suspect_misses,
)
from bluefog_tpu_torch.resilience.degraded import (
    DeadlineExceeded,
    op_deadline_s,
    renormalize_weights,
    with_deadline,
)
from bluefog_tpu_torch.resilience.healing import (
    HealedTopology,
    demote_topology,
    grow_topology,
    heal_topology,
    healed_weight_matrix,
)
from bluefog_tpu_torch.resilience.join import (
    JoinGrant,
    MembershipBoard,
    epoch_job,
    join_poll_s,
    join_timeout_s,
)
from bluefog_tpu_torch.resilience.quorum import (
    OrphanedError,
    majority_floor,
    quorum_enabled,
    quorum_met,
    quorum_mode,
)

__all__ = [
    "FailureDetector",
    "PeerTimeoutError",
    "failure_timeout_s",
    "heartbeat_interval_s",
    "EdgeHealth",
    "EDGE_ALIVE",
    "EDGE_SUSPECT",
    "EDGE_DEAD",
    "suspect_misses",
    "promote_clean",
    "demote_floor_s",
    "AdaptivePolicy",
    "adaptive_enabled",
    "edge_deadline_floor_s",
    "edge_deadline_factor",
    "DeadlineExceeded",
    "op_deadline_s",
    "renormalize_weights",
    "with_deadline",
    "HealedTopology",
    "demote_topology",
    "grow_topology",
    "heal_topology",
    "healed_weight_matrix",
    "JoinGrant",
    "MembershipBoard",
    "epoch_job",
    "join_poll_s",
    "join_timeout_s",
    "OrphanedError",
    "quorum_mode",
    "quorum_enabled",
    "quorum_met",
    "majority_floor",
]
