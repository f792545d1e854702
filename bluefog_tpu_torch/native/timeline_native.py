"""ctypes wrapper over the native timeline writer (timeline.cc)."""

from __future__ import annotations

from bluefog_tpu_torch.native import get_lib


class NativeTimelineWriter:
    """Thread-safe chrome-trace writer with a C++ background flush thread
    (sibling of the reference's ``TimelineWriter`` [U]).

    Raises RuntimeError if the native library cannot be built; the caller
    (``bluefog_tpu_torch.timeline``) then writes through its pure-Python
    route and says so (``TimelineWriter.route``).
    """

    def __init__(self, path: str):
        lib = get_lib()
        self._lib = lib
        self._h = lib.bf_timeline_create(path.encode())
        if not self._h:
            raise RuntimeError(f"could not create native timeline at {path!r}")

    def record(self, name: str, start_us: float, dur_us: float, tid: int = 0):
        self._lib.bf_timeline_record(
            self._h, name.encode(), float(start_us), float(dur_us), int(tid)
        )

    def counter(self, name: str, ts_us: float, value: float):
        self._lib.bf_timeline_counter(
            self._h, name.encode(), float(ts_us), float(value)
        )

    def flush(self):
        self._lib.bf_timeline_flush(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._lib.bf_timeline_destroy(h)
            except Exception:
                pass
            self._h = None
