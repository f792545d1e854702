"""bluefog_tpu_torch.serve.loadgen — open-loop load generation for the
serving fleet.

The serve plane (hot-swap, distribution trees) is wired
end to end but was never *load-measured*; this package closes the loop:
a deterministic arrival-process generator fires ``serve_step`` requests against K live replicas on independent
timers and records per-request latency into the telemetry journal.

The load generator is **open-loop**: the send timestamp of every request is
fixed in advance by the arrival schedule, never by the completion of
the previous request.  A closed-loop generator that waits for each
response before issuing the next silently throttles offered load
whenever the server stalls — a 2 s hot-swap pause shows up as *one*
slow request instead of the hundreds that would have arrived in those
2 s.  That measurement bug has a name — **coordinated omission** — and
charging queueing delay to latency (``done_ts - send_ts``, not
``done_ts - start_ts``) is the fix.

- :mod:`bluefog_tpu_torch.serve.loadgen.arrivals` — seeded Poisson and
  fixed-rate arrival schedules.
- :mod:`bluefog_tpu_torch.serve.loadgen.driver` — the open-loop load generator:
  one timer thread per replica, per-request journal records.
- :mod:`bluefog_tpu_torch.serve.loadgen.slo` — the SLO monitor:
  ``BFTPU_SERVE_SLO_MS`` / ``BFTPU_SERVE_SLO_STALENESS`` objectives,
  gap-closed violation windows journaled for cause attribution.
"""

from bluefog_tpu_torch.serve.loadgen.arrivals import (
    arrival_times,
    loadgen_duration_s,
    loadgen_rate_hz,
    loadgen_schedule,
    loadgen_seed,
)
from bluefog_tpu_torch.serve.loadgen.driver import LoadGenerator, LoadReport
from bluefog_tpu_torch.serve.loadgen.slo import (
    SLOMonitor,
    serve_slo_ms,
    serve_slo_staleness,
)

__all__ = [
    "arrival_times",
    "loadgen_rate_hz",
    "loadgen_schedule",
    "loadgen_seed",
    "loadgen_duration_s",
    "LoadGenerator",
    "LoadReport",
    "SLOMonitor",
    "serve_slo_ms",
    "serve_slo_staleness",
]
