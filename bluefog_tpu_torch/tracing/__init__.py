"""bluefog_tpu_torch.tracing — cross-rank distributed tracing for gossip.

Counterpart of ``bluefog_tpu/tracing``: the per-rank tracer and the clock
estimator, copied with their imports pointed at this package.

* **Context propagation**: a u64 ``(round, op_id, origin_rank)`` word
  (:func:`pack_ctx`) rides both transports — an 8-byte sidecar word per
  shm mailbox slot, a header field in the TCP frame — so the producing
  span on one rank and the consuming span on another share an identity.
* **Clock alignment**: a min-RTT offset estimator
  (:class:`~bluefog_tpu_torch.tracing.clock.ClockEstimator`) over the TCP
  coordinator path; same-host shm ranks share ``CLOCK_MONOTONIC``.
* **Flight recorder**: a SIGKILL-durable mmap ring of recent spans per
  rank, dumped on SIGTERM / fatal errors / ``PeerTimeoutError``.

The per-rank buffers use the reference's schema, so the reference's merge
CLI (``python -m bluefog_tpu.tracing``) reads them; this package does not
carry the merge step yet.

Enable with ``BFTPU_TRACING=1`` (or ``=<dir>``); unset means
:func:`get_tracer` returns a shared no-op ``NullTracer``.  Stdlib-only.
"""

from bluefog_tpu_torch.tracing.clock import ClockEstimator
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
]
