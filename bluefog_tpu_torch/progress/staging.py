"""Device→host staging for the island win ops.

Every island win op stages its payload to host numpy before touching the
shm wire.  Counterpart of ``bluefog_tpu/progress/staging.py``, rewritten for
torch tensors:

- **CPU tensors** need no copy at all: ``t.detach().numpy()`` is a view of
  the tensor's own storage.  Staged on the progress worker thread
  (``worker_scope``) the view is counted in the
  ``progress.staging_bytes_saved`` telemetry counter, as the reference
  counts its dlpack views; synchronous callers take the same view
  uncounted, which is what the reference's ``tensor.detach().cpu().numpy()``
  does for a CPU tensor.
- **CUDA tensors** have no host view.  They go through a pinned host
  buffer, cached per window (``key``) and per size, on a side stream of
  the staging thread's own:

  1. at submit, :func:`snapshot` records an event on the caller's current
     stream (after a device ``clone`` of a lone tensor, so the caller may
     update the original in place at once);
  2. the staging thread's side stream waits for that event and copies the
     snapshot into the pinned buffer;
  3. it synchronizes the side stream before the deposit reads the buffer.

  So the copy neither waits behind compute that the caller queues later
  nor blocks the caller's stream; the ``progress.staging_d2h_bytes``
  counter measures what took this path.

The contract that replaces the reference's "do not donate" rule: what is
handed to the worker must be a snapshot.  Torch parameters are updated in
place by the next ``optimizer.step()``, so the async ops snapshot a CUDA
tensor at submit (:func:`snapshot`), and a CPU tensor handed to an async
op must not be modified until its handle resolves.

numpy has no bfloat16, so a ``torch.bfloat16`` tensor's host form is an
ndarray of :data:`BF16`: the same two bytes a value, in the layout the JAX
package's ``ml_dtypes.bfloat16`` arrays use, so windows and snapshot
regions of either package hold the same bytes (:func:`host_view` /
:func:`tensor_view` convert without a copy).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.telemetry import registry as _telemetry

#: the host dtype of a ``torch.bfloat16`` tensor's bytes (see above)
BF16 = np.dtype([("bfloat16", "<u2")])

_tls = threading.local()
_lock = threading.Lock()
# (key, device index, dtype, numel) -> pinned host tensor
_pinned: Dict[Tuple, object] = {}


def host_view(t) -> np.ndarray:
    """A CPU tensor's storage as an ndarray, without a copy (bf16 as
    :data:`BF16`)."""
    import torch

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def tensor_view(arr: np.ndarray):
    """An ndarray as a CPU tensor sharing its memory (:data:`BF16` as
    ``torch.bfloat16``)."""
    import torch

    if arr.dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def in_worker() -> bool:
    """Whether the current thread is inside a progress-worker scope."""
    return bool(getattr(_tls, "active", False))


@contextlib.contextmanager
def worker_scope():
    """Mark the current thread as a progress worker: staging a CPU tensor
    inside the scope is counted as a zero-copy view."""
    prev = getattr(_tls, "active", False)
    _tls.active = True
    try:
        yield
    finally:
        _tls.active = prev


class DeviceSnapshot:
    """A device tensor frozen at submit: ``tensor`` (a private copy, or a
    tensor nobody else writes) and ``event``, recorded on the submitting
    stream after the tensor's producer."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event

    @property
    def shape(self):
        return tuple(self.tensor.shape)


def _is_torch(x) -> bool:
    mod = type(x).__module__
    return mod.startswith("torch") and hasattr(x, "detach")


def snapshot(tensor, fresh: bool = False):
    """Freeze ``tensor`` for a later stage on another thread.  A CUDA
    tensor is cloned on the device (unless ``fresh``: the caller built it
    and will not write it, e.g. a ``torch.cat`` pack) and an event is
    recorded after it; anything else is returned as it is."""
    if not (_is_torch(tensor) and tensor.is_cuda):
        return tensor
    import torch

    t = tensor.detach()
    if not fresh:
        t = t.clone()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return DeviceSnapshot(t, ev)


def _side_stream(device):
    import torch

    streams = getattr(_tls, "streams", None)
    if streams is None:
        streams = _tls.streams = {}
    idx = device.index if device.index is not None else torch.cuda.current_device()
    s = streams.get(idx)
    if s is None:
        s = streams[idx] = torch.cuda.Stream(device=idx)
    return s


def _pinned_buffer(key, t):
    import torch

    k = (key, t.device.index, t.dtype, t.numel())
    with _lock:
        buf = _pinned.get(k)
        if buf is None:
            buf = _pinned[k] = torch.empty(t.numel(), dtype=t.dtype,
                                           pin_memory=True)
    return buf


def _stage_cuda(t, event, key) -> np.ndarray:
    import torch

    if event is None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
    side = _side_stream(t.device)
    buf = _pinned_buffer(key, t)
    with torch.cuda.stream(side):
        side.wait_event(event)
        t.record_stream(side)
        buf.copy_(t.reshape(-1), non_blocking=True)
    side.synchronize()
    reg = _telemetry.get_registry()
    if reg.enabled:
        reg.counter("progress.staging_d2h_bytes").add(int(t.numel() * t.element_size()))
    return host_view(buf).reshape(tuple(t.shape))


def release(key: Optional[str] = None) -> None:
    """Drop the cached pinned buffers of window ``key`` (its own and those
    under ``key#...``; all when None)."""
    with _lock:
        for k in [k for k in _pinned if key is None or k[0] == key
                  or str(k[0]).startswith(f"{key}#")]:
            del _pinned[k]


def to_device(arr: np.ndarray, device):
    """``arr`` as a tensor on CUDA ``device``: copied on the staging
    thread's side stream, which is synchronized before return, so the
    tensor is ready on any stream of the caller's.  The tensor is recorded
    on the caller's current stream: its block was allocated on the side
    stream, and without the record the next ``to_device`` could take the
    block back and overwrite it while the caller's reads of it (a
    parameter ``copy_`` queued behind compute) have not run yet."""
    import torch

    side = _side_stream(device)
    with torch.cuda.stream(side):
        t = tensor_view(arr if arr.flags.writeable else arr.copy()).to(device)
    side.synchronize()
    t.record_stream(torch.cuda.current_stream(t.device))
    return t


def stage(tensor, key: Optional[str] = None) -> np.ndarray:
    """Host ndarray for ``tensor``: a view of a CPU tensor's storage (counted
    when staged on the worker thread), the pinned-buffer copy of a CUDA
    tensor or :class:`DeviceSnapshot`, ``np.asarray`` of anything else."""
    if isinstance(tensor, np.ndarray):
        return tensor
    if isinstance(tensor, DeviceSnapshot):
        return _stage_cuda(tensor.tensor, tensor.event, key)
    if _is_torch(tensor):
        t = tensor.detach()
        if t.is_cuda:
            return _stage_cuda(t, None, key)
        v = host_view(t)
        if in_worker():
            reg = _telemetry.get_registry()
            if reg.enabled:
                reg.counter("progress.staging_bytes_saved").add(int(v.nbytes))
        return v
    return np.asarray(tensor)
