"""bluefog_tpu_torch.serve — live weight publication to inference replicas.

The read side of "a system that serves while it trains" (ROADMAP item
5, docs/SERVING.md): a gossip-training island *publishes* consistent
versioned weight snapshots — the debiased push-sum estimate, fenced at
an epoch boundary and quorum-gated so an ORPHAN minority can never
publish — into a double-buffered seqlock'd snapshot region; a fleet of
inference replica processes *subscribes* and hot-swaps with zero
downtime.

- :mod:`bluefog_tpu_torch.serve.snapshot` — the region: the double-buffer
  publish protocol, the seqlock + crc read protocol, and the
  mid-publish death matrix.
- :mod:`bluefog_tpu_torch.serve.replica` — the subscriber: atomic-flip
  hot-swap, bounded full-jitter retry, and the
  ``BFTPU_SERVE_MAX_LAG`` staleness policy.
- :mod:`bluefog_tpu_torch.serve.loadgen` — the open-loop load generator
  (Poisson / fixed-rate arrivals, coordinated-omission-safe latency)
  and the ``BFTPU_SERVE_SLO_MS`` / ``BFTPU_SERVE_SLO_STALENESS``
  violation-window monitor.
- ``python -m bluefog_tpu_torch.serve`` — one replica process (what
  ``bftpu-run --serve-replicas K`` spawns K of).

The publisher entry point lives with the training loop:
``islands.serve_publish(name)``.

Counterpart of ``bluefog_tpu/serve``: the region's layout is the JAX
package's, so either package reads what the other publishes, and the
replica installs each snapshot on a torch device (the card by default).
"""

from bluefog_tpu_torch.serve.replica import (
    REPLICA_RANK_BASE,
    Replica,
    ShmSource,
    StaleSnapshotError,
    full_jitter,
    serve_max_lag,
    serve_stale_policy,
)
from bluefog_tpu_torch.serve.loadgen import (
    LoadGenerator,
    LoadReport,
    SLOMonitor,
    serve_slo_ms,
    serve_slo_staleness,
)
from bluefog_tpu_torch.serve.snapshot import (
    SERVE_SCHEMA,
    SnapshotRegion,
    SnapshotUnavailable,
    TornSnapshotError,
    read_committed,
    region_path,
)

__all__ = [
    "SERVE_SCHEMA",
    "SnapshotRegion",
    "SnapshotUnavailable",
    "TornSnapshotError",
    "read_committed",
    "region_path",
    "REPLICA_RANK_BASE",
    "Replica",
    "ShmSource",
    "StaleSnapshotError",
    "full_jitter",
    "serve_max_lag",
    "serve_stale_policy",
    "LoadGenerator",
    "LoadReport",
    "SLOMonitor",
    "serve_slo_ms",
    "serve_slo_staleness",
]
