"""ctypes wrapper over the native data-loading pipeline (data_loader.cc).

Worker threads in C++ fill a bounded ring of host buffers ahead of the
training loop, so batch production overlaps device compute — the
TPU-native sibling of the reference's torch-DataLoader worker processes
[U].  Two access styles:

- ``next()``: returns an owned numpy copy (simple, always safe).
- ``next_view()``: context manager yielding a zero-copy numpy view of the
  ring buffer; the buffer returns to the pool on exit, so the view must
  not escape (device_put/np.array it first).

Batch content is a pure function of ``(seed, batch_index)``; with
``workers=1`` batches arrive in index order, with more the order is
unspecified (the reference's DataLoader semantics).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.native import get_lib

__all__ = ["NativeDataLoader"]


class NativeDataLoader:
    def __init__(
        self,
        batch_shape: Sequence[int],
        dtype=np.float32,
        *,
        depth: int = 4,
        workers: int = 2,
        seed: int = 0,
        path: Optional[str] = None,
    ):
        lib = get_lib()
        self._lib = lib
        self.batch_shape = tuple(int(s) for s in batch_shape)
        self.dtype = np.dtype(dtype)
        self._nbytes = int(np.prod(self.batch_shape)) * self.dtype.itemsize
        self._h = lib.bf_loader_create(
            self._nbytes, int(depth), int(workers),
            1 if path else 0, int(seed),
            path.encode() if path else None,
        )
        if not self._h:
            raise RuntimeError(
                "could not create native loader (bad args or unreadable path)"
            )

    @contextlib.contextmanager
    def next_view(self) -> Iterator[np.ndarray]:
        ptr = self._lib.bf_loader_next(self._h)
        if not ptr:
            raise RuntimeError("loader was shut down")
        try:
            raw = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(self._nbytes,),
            )
            yield raw.view(self.dtype).reshape(self.batch_shape)
        finally:
            self._lib.bf_loader_release(self._h, ptr)

    def next(self) -> np.ndarray:
        with self.next_view() as v:
            return v.copy()

    def stats(self) -> Tuple[int, int, int]:
        """(produced, consumed, stalls) — stalls counts consumer waits."""
        out = (ctypes.c_uint64 * 3)()
        self._lib.bf_loader_stats(self._h, out)
        return int(out[0]), int(out[1]), int(out[2])

    def close(self) -> None:
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.bf_loader_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
