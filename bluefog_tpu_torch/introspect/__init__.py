"""Live introspection plane: status pages, lock-holder attribution, and
the ``bftpu-top`` fleet view.

Three pieces (docs/OBSERVABILITY.md "Live introspection"):

- :class:`StatusPage` — a per-rank seqlock'd mmap struct each island
  rank republishes once per window op (step, epoch, last op, edge
  health, mass-ledger totals); readers never block writers.
- The mutex **holder board**
  (:class:`bluefog_tpu_torch.native.shm_native.HolderBoard`) — an acquire-time
  holder word per job mutex, so mutex waits attribute to the rank that
  actually holds the lock instead of the window owner.
- ``bftpu-top`` (``python -m bluefog_tpu_torch.introspect --job JOB``, or
  ``bftpu-run --attach JOB top``) — attaches through the status pages +
  the launcher control socket and renders a refreshing fleet view, with
  ``trace on|off`` verbs that flip ``BFTPU_TRACING`` in running ranks.
"""

from bluefog_tpu_torch.introspect.statuspage import (  # noqa: F401
    EDGE_STATE_NAMES,
    MAX_EDGES,
    PAGE_BYTES,
    STATUS_SCHEMA,
    TRACE_DEFAULT,
    TRACE_OFF,
    TRACE_ON,
    StatusPage,
    TornPageError,
    TraceControl,
    collect,
    find_status_pages,
    publish_trace_control,
    read_fleet,
    read_status_page,
    read_trace_control,
    status_page_path,
)
from bluefog_tpu_torch.native.shm_native import (  # noqa: F401
    HolderBoard,
    statuspage_enabled,
)
