"""Live introspection plane: per-rank status pages and lock-holder
attribution (counterpart of ``bluefog_tpu/introspect``).

- :class:`StatusPage` — a per-rank seqlock'd mmap struct each island
  rank republishes once per window op (step, epoch, last op, edge
  health, mass-ledger totals); readers never block writers.
- The mutex **holder board**
  (:class:`bluefog_tpu_torch.native.shm_native.HolderBoard`) — an
  acquire-time holder word per job mutex, so mutex waits attribute to the
  rank that actually holds the lock.

The pages use the reference's layout, so the reference's ``bftpu-top``
reader (``python -m bluefog_tpu.introspect``) reads a fleet of this
package's islands; this package does not carry that reader yet.
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
