"""bluefog_tpu_torch.tracing — cross-rank distributed tracing for gossip.

What :mod:`bluefog_tpu_torch.telemetry` (aggregate counters/histograms) cannot
answer — *which* deposit a collect consumed, *which* rank lengthened a
round — this package does, with four pieces:

* **Context propagation**: a u64 ``(round, op_id, origin_rank)`` word
  (:func:`pack_ctx`) rides both transports — an 8-byte sidecar word per
  shm mailbox slot, a header field in the TCP frame — so the producing
  span on one rank and the consuming span on another share an identity.
* **Clock alignment**: a min-RTT offset estimator
  (:class:`~bluefog_tpu_torch.tracing.clock.ClockEstimator`) over the TCP
  coordinator path, re-sampled per heartbeat; same-host shm ranks share
  ``CLOCK_MONOTONIC`` and keep offset 0.
* **Merge CLI**: ``python -m bluefog_tpu_torch.tracing`` stitches per-rank
  buffers (+ telemetry journals) into one Chrome trace with flow arrows
  along gossip edges; ``--critical-path`` extracts each round's longest
  causal chain and a straggler-attribution report.
* **Flight recorder**: a SIGKILL-durable mmap ring of recent spans per
  rank, dumped on SIGTERM / fatal errors / ``PeerTimeoutError`` and
  recovered post-mortem by the spawner for killed ranks.

Enable with ``BFTPU_TRACING=1`` (or ``=<dir>``); unset means
:func:`get_tracer` returns a shared no-op ``NullTracer``.  See
docs/OBSERVABILITY.md.  Stdlib-only: importable without jax, numpy, or
the native library.
"""

from bluefog_tpu_torch.tracing.clock import ClockEstimator
from bluefog_tpu_torch.tracing.merge import (
    MERGED_TRACE_SCHEMA,
    critical_path,
    find_flights,
    find_traces,
    flow_index,
    load_flight,
    load_trace,
    merge_traces,
)
from bluefog_tpu_torch.tracing.tracer import (
    FLIGHT_SCHEMA,
    TRACE_SCHEMA,
    FlightRing,
    NullTracer,
    Tracer,
    convert_flight_rings,
    get_tracer,
    pack_ctx,
    read_flight_ring,
    reset,
    tracing_dir,
    unpack_ctx,
)

__all__ = [
    "TRACE_SCHEMA",
    "FLIGHT_SCHEMA",
    "MERGED_TRACE_SCHEMA",
    "ClockEstimator",
    "FlightRing",
    "Tracer",
    "NullTracer",
    "get_tracer",
    "reset",
    "tracing_dir",
    "pack_ctx",
    "unpack_ctx",
    "read_flight_ring",
    "convert_flight_rings",
    "find_traces",
    "find_flights",
    "load_trace",
    "load_flight",
    "merge_traces",
    "flow_index",
    "critical_path",
]
