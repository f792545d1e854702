"""bluefog_tpu_torch.progress — the per-rank background progress engine.

Counterpart of ``bluefog_tpu/progress``.  Upstream BlueFog hides every
one-sided window op behind a C++ background communication thread with
tensor fusion; that overlap is what lets asynchronous decentralized SGD
beat the synchronous baseline in wall clock.  Here each island rank owns
ONE :class:`~bluefog_tpu_torch.progress.engine.ProgressEngine` — a
dedicated worker thread draining a bounded op queue — and
``islands.win_put_async`` / ``win_accumulate_async`` / ``win_update_async``
return a :class:`~bluefog_tpu_torch.progress.handles.WinHandle` future
instead of blocking the training step.

The engine:

- **fuses** consecutive same-window deposits (``BFTPU_PROGRESS_FUSION_MB``
  caps the coalesced bytes; per-window submission order is preserved);
- **stages** payloads on the worker thread through
  :mod:`~bluefog_tpu_torch.progress.staging`: a CPU tensor as a zero-copy
  view (counted by ``progress.staging_bytes_saved``), a CUDA tensor
  through a pinned host buffer on a side stream
  (``progress.staging_d2h_bytes``);
- **prefetches** in-edge mailboxes while idle so the caller's next
  collect runs over cache-warm pages;
- **quiesces and requeues** across membership-epoch switches: the
  in-flight op completes, queued ops survive the segment rebind and
  re-execute against the new epoch's windows — no committed mass is lost.

``BFTPU_PROGRESS=0`` disables the engine entirely: the async API then
executes synchronously at the call site and returns already-completed
handles, with no extra thread.

The engine is transport-agnostic: it executes ops through a small
backend object (:class:`bluefog_tpu_torch.islands._ProgressBackend` in
production, a fake in the unit tests), so this package never imports
:mod:`bluefog_tpu_torch.islands`.
"""

from __future__ import annotations

import os

from bluefog_tpu_torch.progress import staging
from bluefog_tpu_torch.progress.engine import (KINDS, MAX_REQUEUES, Op,
                                         ProgressEngine)
from bluefog_tpu_torch.progress.handles import WinHandle, completed

__all__ = [
    "KINDS",
    "Op",
    "ProgressEngine",
    "WinHandle",
    "completed",
    "enabled",
    "queue_depth",
    "fusion_bytes",
    "staging",
]

#: default bound on queued (not yet executing) ops before submit blocks
DEFAULT_QUEUE_DEPTH = 256
#: default cap on bytes coalesced into one fused deposit batch (8 MiB)
DEFAULT_FUSION_MB = 8.0


def enabled() -> bool:
    """Whether the background engine is on (``BFTPU_PROGRESS``, default
    on; ``0``/``false``/``off`` disable it)."""
    return os.environ.get("BFTPU_PROGRESS", "1").lower() not in (
        "0", "false", "off")


def queue_depth() -> int:
    """Submission-queue bound (``BFTPU_PROGRESS_QUEUE_DEPTH``)."""
    try:
        return max(1, int(os.environ.get("BFTPU_PROGRESS_QUEUE_DEPTH",
                                         DEFAULT_QUEUE_DEPTH)))
    except ValueError:
        return DEFAULT_QUEUE_DEPTH


def fusion_bytes() -> int:
    """Fused-batch byte cap (``BFTPU_PROGRESS_FUSION_MB``; 0 disables
    fusion — every batch is a single op)."""
    try:
        mb = float(os.environ.get("BFTPU_PROGRESS_FUSION_MB",
                                  DEFAULT_FUSION_MB))
    except ValueError:
        mb = DEFAULT_FUSION_MB
    return max(0, int(mb * 1024 * 1024))
