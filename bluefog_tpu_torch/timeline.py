"""Timeline: named activity spans and a Chrome-trace file.

Counterpart of ``bluefog_tpu/timeline.py``.  Spans wrap op dispatch on the
calling thread and are emitted two ways at once:

- ``torch.profiler.record_function("bluefog/<name>")``, so the spans show
  in a ``torch.profiler`` trace beside the card's kernels;
- a Chrome-tracing JSON file (``{"traceEvents": [...]}``) when
  ``BLUEFOG_TIMELINE=<path>`` is set, written by :class:`TimelineWriter`
  at exit (or on SIGTERM, or on :meth:`TimelineWriter.flush`).  As in the
  reference, the writer prefers the native C++ writer
  (``native/timeline.cc``, built at first use); where the native library
  cannot be built it logs the compiler's complaint and writes through its
  buffered pure-Python route.  ``TimelineWriter.route`` says which
  (``"native"`` or ``"python"``).

``timeline_start_activity`` / ``timeline_end_activity`` open and close a
custom span by name.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import threading
import time
from typing import Optional

import torch

from bluefog_tpu_torch.common.logging_util import logger

__all__ = [
    "timeline_start_activity",
    "timeline_end_activity",
    "timeline_context",
    "TimelineWriter",
]


class TimelineWriter:
    """Chrome-tracing JSON writer of span (``"ph": "X"``) and counter
    (``"ph": "C"``) events: the native writer, or events buffered in memory
    and written as one JSON document by :meth:`flush`.  Thread-safe."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._events = []
        self._counter_events = []
        self._t0 = time.perf_counter_ns()
        self._native = None
        try:
            from bluefog_tpu_torch.native import timeline_native

            self._native = timeline_native.NativeTimelineWriter(path)
        except (RuntimeError, OSError) as e:
            logger.warning("native timeline writer unavailable, writing "
                           "through the Python route: %s", e)
        self.route = "python" if self._native is None else "native"
        atexit.register(self.flush)
        self._install_sigterm()

    def _install_sigterm(self) -> None:
        # atexit does not run under SIGTERM's default disposition: flush
        # first, then hand the signal to the handler installed before
        try:
            prev = signal.getsignal(signal.SIGTERM)
        except (ValueError, TypeError):  # pragma: no cover - odd runtimes
            return

        def _on_term(signum, frame):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - dying anyway
                pass
            if callable(prev):
                prev(signum, frame)
            else:
                try:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                except (ValueError, TypeError):
                    pass
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, TypeError):
            # not the main thread: atexit still covers a normal exit
            pass

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def now_us(self) -> float:
        """Current time on this writer's clock (µs since it was made), so
        other layers (telemetry's counter samples) share the spans' clock."""
        return self._now_us()

    def record_counter(self, name: str, ts_us: float, value: float) -> None:
        """One chrome-trace counter sample (``"ph": "C"``)."""
        if self._native is not None:
            self._native.counter(name, ts_us, value)
            return
        with self._lock:
            self._counter_events.append({"name": name, "ph": "C", "ts": ts_us,
                                         "pid": os.getpid(), "args": {"value": value}})

    def record(self, name: str, start_us: float, dur_us: float, tid: int = 0) -> None:
        if self._native is not None:
            self._native.record(name, start_us, dur_us, tid)
            return
        with self._lock:
            self._events.append({"name": name, "ph": "X", "ts": start_us, "dur": dur_us,
                                 "pid": os.getpid(), "tid": tid})

    def flush(self) -> None:
        if self._native is not None:
            self._native.flush()
            return
        with self._lock:
            if not self._events and not self._counter_events:
                return
            try:
                with open(self.path, "w") as f:
                    json.dump({"traceEvents": self._events + self._counter_events}, f)
            except OSError as e:  # pragma: no cover
                logger.warning("timeline flush failed: %s", e)


_writer: Optional[TimelineWriter] = None
_open_spans = {}


def _get_writer() -> Optional[TimelineWriter]:
    global _writer
    if _writer is None:
        path = os.environ.get("BLUEFOG_TIMELINE")
        if path:
            _writer = TimelineWriter(path)
    return _writer


def timeline_start_activity(name: str, category: str = "custom") -> bool:
    """Open a named span; True when a timeline file is being written."""
    w = _get_writer()
    _open_spans[(name, category)] = time.perf_counter_ns()
    return w is not None


def timeline_end_activity(name: str, category: str = "custom") -> bool:
    """Close a span opened by :func:`timeline_start_activity`; it is
    recorded as ``"<category>/<name>"``."""
    start = _open_spans.pop((name, category), None)
    w = _get_writer()
    if start is None:
        return False
    if w is not None:
        t0_us = (start - w._t0) / 1e3
        dur_us = (time.perf_counter_ns() - start) / 1e3
        w.record(f"{category}/{name}", t0_us, dur_us)
    return w is not None


@contextlib.contextmanager
def timeline_context(name: str):
    """Span around an op dispatch, also a ``torch.profiler`` range named
    ``bluefog/<name>``.  The span is recorded with the calling thread's id
    as its chrome-trace tid."""
    start = time.perf_counter_ns()
    with torch.profiler.record_function(f"bluefog/{name}"):
        yield
    w = _get_writer()
    if w is not None:
        t0_us = (start - w._t0) / 1e3
        dur_us = (time.perf_counter_ns() - start) / 1e3
        w.record(name, t0_us, dur_us, tid=threading.get_ident() & 0x7FFFFFFF)
