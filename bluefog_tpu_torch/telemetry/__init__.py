"""bluefog_tpu_torch.telemetry — cross-rank metrics, counters, and event journal.

A copy of ``bluefog_tpu/telemetry`` with its imports pointed at the port:
always-on, lock-light counters / gauges / fixed-bucket histograms plus a
per-rank JSONL event journal, beside the chrome-trace spans of
:mod:`bluefog_tpu_torch.timeline`.  The port feeds it where the reference
does: ``train.steps`` (the train step), ``optim.steps{optimizer, comm}``
and the win-put optimizer's ``optim.gossip_rounds``, and
``win_ops.total{op}`` through :func:`note_op` from every window op.

Enable with ``BFTPU_TELEMETRY=1`` (or ``=<dir>`` to choose where the
per-rank snapshot and journal files land; default ``bftpu_telemetry`` in
the temporary directory).  When the variable is unset, ``get_registry()``
returns a shared ``NullRegistry`` whose metric handles are no-ops, so an
instrumented call site costs one attribute load and a falsy branch.

Merge per-rank snapshots with ``python -m bluefog_tpu_torch.telemetry``
(JSON and Prometheus text exposition), or programmatically via
:func:`merge_snapshots` / :func:`merge_job_snapshots`.

Its modules use only the standard library.
"""

from bluefog_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS_S,
    SERVE_LATENCY_BUCKETS_S,
    LEDGER_COLLECTED,
    LEDGER_DEPOSITS,
    LEDGER_DRAINED,
    LEDGER_PENDING,
    SNAPSHOT_SCHEMA,
    Counter,
    Gauge,
    Histogram,
    NullRegistry,
    Registry,
    add_op_listener,
    get_registry,
    journal_max_bytes,
    journal_paths,
    note_op,
    read_journal,
    remove_op_listener,
    reset,
    telemetry_dir,
)
from bluefog_tpu_torch.telemetry.merge import (
    MERGED_SCHEMA,
    find_snapshots,
    ledger_balance,
    load_snapshot,
    merge_job_snapshots,
    merge_snapshots,
    to_prometheus,
)

__all__ = [
    "SNAPSHOT_SCHEMA",
    "MERGED_SCHEMA",
    "DEFAULT_LATENCY_BUCKETS_S",
    "SERVE_LATENCY_BUCKETS_S",
    "LEDGER_DEPOSITS",
    "LEDGER_COLLECTED",
    "LEDGER_DRAINED",
    "LEDGER_PENDING",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "NullRegistry",
    "get_registry",
    "reset",
    "telemetry_dir",
    "read_journal",
    "journal_paths",
    "journal_max_bytes",
    "note_op",
    "add_op_listener",
    "remove_op_listener",
    "find_snapshots",
    "load_snapshot",
    "merge_snapshots",
    "merge_job_snapshots",
    "ledger_balance",
    "to_prometheus",
]
