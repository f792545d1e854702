"""One-sided window ops: the mailbox emulation on the rank-major backend.

Counterpart of ``bluefog_tpu/windows.py``, with its names and semantics.
The reference gives every rank one buffer per in-neighbor per named window,
so concurrent writers never collide: a ``win_put`` deposits into the
writer's own slot at each destination, and ``win_update`` combines the
slots locally.  Here every buffer is a rank-major tensor on one device:

- ``win_create(name)`` allocates ``mail[size, max_in_degree, ...]``: rank
  d's slot k holds the last deposit from its k-th in-neighbor (ascending
  rank order), beside the exposed tensor ``self_tensor[size, ...]``, the
  deposit counts ``versions[size, max_in_degree]`` and the push-sum
  scalars ``p_self[size]`` and ``p_mail[size, max_in_degree]``.
- ``win_put`` / ``win_accumulate`` / ``win_get`` move values by the shift
  classes of the window's topology: per class one gather of the senders'
  rows and one indexed write into the receivers' slots (within a class
  every receiver has one distinct source, so the writes never collide).
- ``win_update`` is the local weighted combine.

As in the JAX package, the realized schedule is the synchronous one
(staleness 0), so ``win_mutex`` is a no-op.  With associated p on
(``turn_on_win_ops_with_associated_p``) a scalar p rides along with every
deposit and is combined the same way, for push-sum on directed graphs
(debias by x / p).

Tensors that leave this module are never written again: every op that
changes the exposure or p binds a fresh tensor (``win_put`` stores a copy
of its input), and ``win_associated_p`` returns a copy.  The mailbox never
leaves the module and is updated in place.  A fused window's ``win_update``
returns views into the new exposure; pass ``clone=True`` for copies.

Every public op publishes ``(op, name)`` through
:func:`bluefog_tpu_torch.telemetry.note_op` (the ``win_ops.total``
counter, and the listeners such as :func:`record_win_ops`), and the ops
that move data run inside a timeline span, as in the reference.

``win_put_async`` / ``win_accumulate_async`` / ``win_update_async`` give
the island runtime's async surface (:mod:`bluefog_tpu_torch.islands`):
the emulation has no background wire, so they run at the call site and
return an already resolved :class:`~bluefog_tpu_torch.progress.WinHandle`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bluefog_tpu_torch import ops
from bluefog_tpu_torch import progress as _progress
from bluefog_tpu_torch.common.logging_util import logger
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.core.plan import CommPlan
from bluefog_tpu_torch.telemetry import registry as _telemetry
from bluefog_tpu_torch.timeline import timeline_context

__all__ = [
    "win_create",
    "win_free",
    "win_put",
    "win_put_nonblocking",
    "win_get",
    "win_get_nonblocking",
    "win_accumulate",
    "win_accumulate_nonblocking",
    "win_put_async",
    "win_accumulate_async",
    "win_update_async",
    "win_update",
    "win_put_update",
    "win_update_then_collect",
    "win_wait",
    "win_poll",
    "win_mutex",
    "get_win_version",
    "win_associated_p",
    "win_set_exposed",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
    "record_win_ops",
    "note_win_op",
    "degraded_update_weights",
]

WeightsArg = Union[None, Sequence[Dict[int, float]]]

# record_win_ops' target; None = recording off.  The events come from the
# telemetry op stream (telemetry.note_op), as in the reference.
_OP_LOG: Optional[List[Tuple[str, str]]] = None


def _op_log_listener(op: str, name: str) -> None:
    log = _OP_LOG
    if log is not None:
        log.append((op, name))


@contextlib.contextmanager
def record_win_ops():
    """Record ``(op, window_name)`` for every public window op in the block
    and yield the live list (the trace the epoch-ordering lint reads).  It
    listens on the telemetry op stream (:func:`note_win_op`).  Nested
    recorders share the outer list; ``win_free(None)`` logs the name
    ``"*"``."""
    global _OP_LOG
    prev = _OP_LOG
    log = [] if prev is None else prev
    _OP_LOG = log
    if prev is None:
        _telemetry.add_op_listener(_op_log_listener)
    try:
        yield log
    finally:
        _OP_LOG = prev
        if prev is None:
            _telemetry.remove_op_listener(_op_log_listener)


def note_win_op(op: str, name: Optional[str]) -> None:
    """Publish one window op on the telemetry op stream."""
    _telemetry.note_op(op, name)


def _spanned(op: str):
    """Run the decorated window op inside the timeline span ``op``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with timeline_context(op):
                return fn(*args, **kwargs)
        return inner
    return wrap


class _Window:
    """Per-name window state."""

    def __init__(self, name: str, tensor: torch.Tensor, plan: CommPlan, zero_init: bool):
        self.name = name
        self.plan = plan
        self.shape = tuple(tensor.shape)  # rank-major [size, ...]
        self.dtype = tensor.dtype
        n, dev = plan.size, tensor.device
        maxd = max(plan.max_in_degree, 1)
        self.self_tensor = tensor
        if zero_init:
            self.mail = torch.zeros((n, maxd) + self.shape[1:], dtype=self.dtype, device=dev)
        else:
            # each slot starts as the rank's own tensor, so an update before
            # any put averages identical values
            self.mail = tensor.unsqueeze(1).expand((n, maxd) + self.shape[1:]).clone()
        self.versions = torch.zeros((n, maxd), dtype=torch.int32, device=dev)
        self.p_self = torch.ones(n, dtype=torch.float32, device=dev)
        # the p mailbox follows the tensor mailbox: empty, or the initial p = 1
        self.p_mail = (torch.zeros if zero_init else torch.ones)(
            (n, maxd), dtype=torch.float32, device=dev)


def _ctx():
    return basics.context()


def _win(name: str) -> _Window:
    w = _ctx().windows.get(name)
    if w is None:
        raise KeyError(f"no window named {name!r}; call win_create first")
    return w


def _class_scales(plan: CommPlan, weights: WeightsArg, side: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class scale and active-edge mask, both ``[num_classes, size]``.

    side='send': ``scales[c, s]`` is the weight rank s applies to what it
    sends in class c (the reference's ``dst_weights``).  side='recv':
    ``scales[c, d]`` is the weight rank d applies to what it receives in
    class c (``src_weights``).  A weights sequence also *selects* the
    edges: an edge not listed does not transfer at all, ``active[c, d] =
    0`` at its receiver d."""
    C = len(plan.classes)
    scales = np.ones((C, plan.size), dtype=np.float32)
    active = np.ones((C, plan.size), dtype=np.float32)
    if weights is None:
        return scales, active
    if len(weights) != plan.size:
        raise ValueError(f"weights must be a length-{plan.size} sequence of dicts")
    for c, cls in enumerate(plan.classes):
        for s, d in cls.perm:
            listed = d in weights[s] if side == "send" else s in weights[d]
            if not listed:
                active[c, d] = 0.0
                scales[c, s if side == "send" else d] = 0.0
            elif side == "send":
                scales[c, s] = float(weights[s][d])
            else:
                scales[c, d] = float(weights[d][s])
    return scales, active


@functools.lru_cache(maxsize=256)
def _on_device(data: bytes, shape: Tuple[int, ...], dtype: str, device: torch.device):
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).reshape(shape).copy()).to(device)


def _dev(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``, uploaded once per distinct value (the cached
    tensor is shared by every caller, so nothing writes to it)."""
    a = np.ascontiguousarray(a)
    return _on_device(a.tobytes(), a.shape, a.dtype.str, device)


def _routes(plan: CommPlan, scales: np.ndarray, active: np.ndarray, device):
    """Per class that delivers anything: (receivers, their slots, their
    sources, the sources' send scales [f32]) as device tensors."""
    out = []
    for c, cls in enumerate(plan.classes):
        dst = np.nonzero(np.asarray(cls.recv_mask, bool) & (active[c] > 0))[0]
        if dst.size == 0:
            continue
        src = np.asarray(cls.sources(), np.int64)[dst]
        slot = np.asarray(cls.slot_index, np.int64)[dst]
        out.append((_dev(dst.astype(np.int64), device), _dev(slot, device),
                    _dev(src, device), _dev(scales[c, src].astype(np.float32), device)))
    return out


def _exchange_body(plan: CommPlan, accumulate: bool, with_p: bool, x, mail, ver,
                   p_self, p_mail, scales: np.ndarray, active: np.ndarray):
    """Deposit the scaled rows of ``x`` into the receivers' slots, in place
    on ``mail``, ``ver`` and ``p_mail``, which it returns.  Per class: the
    senders' rows are gathered, scaled in the window's weight dtype and
    rounded to the window dtype before they cross; each receiving rank d
    where ``recv_mask[d]`` and ``active[c, d]`` writes (or adds) its row into
    slot ``cls.slot_index[d]`` and bumps that slot's version; with
    associated p, ``p_self * scale`` moves the same way."""
    wdt = ops._weight_dtype(x)
    bshape = (-1,) + (1,) * (x.dim() - 1)
    for dst, slot, src, scale in _routes(plan, scales, active, x.device):
        payload = (x.index_select(0, src).to(wdt) * scale.to(wdt).view(bshape)).to(x.dtype)
        if accumulate:
            payload = mail[dst, slot] + payload
        mail[dst, slot] = payload
        ver[dst, slot] = ver[dst, slot] + 1
        if with_p:
            p_recvd = p_self.index_select(0, src) * scale
            if accumulate:
                p_recvd = p_mail[dst, slot] + p_recvd
            p_mail[dst, slot] = p_recvd
    return mail, ver, p_mail


def _exchange(win: _Window, x, scales, active, accumulate: bool) -> None:
    _exchange_body(win.plan, accumulate, _ctx().win_associated_p_enabled, x, win.mail,
                   win.versions, win.p_self, win.p_mail, scales, active)


# --------------------------------------------------------------------------
# Fused (pytree) windows
# --------------------------------------------------------------------------


class _FusionMeta:
    """Pack/unpack metadata of a fused window: a whole tree of rank-major
    tensors rides one packed ``[size, total]`` window, so each gossip round
    is one exchange instead of one per leaf."""

    __slots__ = ("spec", "shapes", "sizes")

    def __init__(self, spec, shapes, sizes):
        self.spec = spec
        self.shapes = shapes
        self.sizes = sizes


def _as_tensor(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(_ctx().device)


def _is_tree(x) -> bool:
    """A dict, or a list / tuple holding tensors; a nested list of numbers
    spells an array."""
    if isinstance(x, dict):
        return True
    return isinstance(x, (list, tuple)) and any(
        isinstance(l, torch.Tensor) or _is_tree(l) for l in x)


def _fusion_split(tensor):
    """(meta, packed private copy) for a tree input; (None, private copy)
    for a bare tensor."""
    if not _is_tree(tensor):
        return None, _as_tensor(tensor).clone()
    leaves, spec = ops.tree_flatten(tensor)
    if not leaves:
        raise ValueError("win_create: empty pytree")
    n = _ctx().size
    leaves = [_as_tensor(l) for l in leaves]
    dts = {l.dtype for l in leaves}
    if len(dts) > 1:
        raise ValueError(
            f"fused windows need a uniform leaf dtype, got {sorted(map(str, dts))}; "
            "create one window per dtype group (cf. DistributedWinPutOptimizer)")
    bad = [tuple(l.shape) for l in leaves if l.dim() == 0 or l.shape[0] != n]
    if bad:
        raise ValueError(f"every fused-window leaf must be rank-major with leading dim "
                         f"{n}; offending leaf shapes: {bad[:4]}")
    shapes = [tuple(l.shape[1:]) for l in leaves]
    meta = _FusionMeta(spec, shapes, [int(np.prod(s, dtype=np.int64)) for s in shapes])
    return meta, _pack_leaves(meta, leaves, n)


def _pack_leaves(meta: _FusionMeta, leaves, n: int, dtype=None) -> torch.Tensor:
    """The one place the packed layout is defined (a fresh tensor)."""
    return torch.cat([l.to(dtype or l.dtype).reshape(n, -1) for l in leaves], dim=1)


def _unpack_leaves(meta: _FusionMeta, packed: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Inverse of :func:`_pack_leaves` (views into ``packed``)."""
    out, off = [], 0
    for s, sz in zip(meta.shapes, meta.sizes):
        out.append(packed[:, off:off + sz].reshape((n,) + s))
        off += sz
    return out


def _check_fused_leaves(meta: _FusionMeta, leaves, n: int) -> None:
    bad = [(tuple(l.shape), (n,) + tuple(exp)) for l, exp in zip(leaves, meta.shapes)
           if tuple(l.shape) != (n,) + tuple(exp)]
    if bad:
        # same-size leaves of another shape would pack without error and
        # unpack as silently corrupted data
        raise ValueError(f"leaf shapes do not match the window's: {bad[:4]}")


def _exposure(win: _Window, name: str, tensor) -> torch.Tensor:
    """A private copy of ``tensor`` in the window's dtype and layout (packed
    when ``name`` is a fused window)."""
    meta = _ctx().win_fusion.get(name)
    if meta is None:
        t = _as_tensor(tensor).to(dtype=win.dtype, copy=True)
    else:
        if not _is_tree(tensor):
            raise ValueError(f"window {name!r} is fused: pass the tree it was created from")
        leaves, spec = ops.tree_flatten(tensor)
        if spec != meta.spec:
            raise ValueError(f"pytree structure does not match the window's: {spec} vs "
                             f"{meta.spec}")
        leaves = [_as_tensor(l) for l in leaves]
        _check_fused_leaves(meta, leaves, win.shape[0])
        t = _pack_leaves(meta, leaves, win.shape[0], dtype=win.dtype)
    if tuple(t.shape) != win.shape:
        raise ValueError(f"shape {tuple(t.shape)} != window shape {win.shape}")
    return t


def _result(name: str, combined: torch.Tensor, clone: bool):
    meta = _ctx().win_fusion.get(name)
    if meta is None:
        return combined.clone() if clone else combined
    leaves = _unpack_leaves(meta, combined, combined.shape[0])
    if clone:
        leaves = [l.clone() for l in leaves]
    return ops.tree_unflatten(meta.spec, leaves)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def win_create(tensor, name: str, zero_init: bool = False) -> bool:
    """Create a named window from a rank-major tensor, or from a whole tree
    of them, fused into one packed window (every later op on ``name`` then
    takes and returns the same tree).  The window keeps a copy, on the
    context's device, and snapshots the installed topology.  False if the
    name exists already."""
    note_win_op("win_create", name)
    ctx = _ctx()
    meta, t = _fusion_split(tensor)
    if t.dim() == 0 or t.shape[0] != ctx.size:
        raise ValueError(f"win_create expects rank-major tensor with leading dim {ctx.size}")
    if name in ctx.windows:
        return False
    ctx.windows[name] = _Window(name, t, ctx.plan, zero_init)
    if meta is not None:
        ctx.win_fusion[name] = meta
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window, or all when ``name`` is None."""
    note_win_op("win_free", name)
    ctx = _ctx()
    if name is None:
        ctx.windows.clear()
        ctx.win_fusion.clear()
        return True
    ctx.win_fusion.pop(name, None)
    return ctx.windows.pop(name, None) is not None


@_spanned("win_put")
def win_put(tensor, name: str, dst_weights: WeightsArg = None) -> bool:
    """Deposit the (optionally dst-scaled) values into this rank's slot at
    each out-neighbor; only at the ranks listed in ``dst_weights`` when
    given.  The put value also becomes the window's exposed tensor."""
    note_win_op("win_put", name)
    win = _win(name)
    scales, active = _class_scales(win.plan, dst_weights, side="send")
    win.self_tensor = _exposure(win, name, tensor)
    _exchange(win, win.self_tensor, scales, active, accumulate=False)
    return True


def win_put_nonblocking(tensor, name: str, dst_weights: WeightsArg = None) -> ops.Handle:
    win_put(tensor, name, dst_weights)
    return ops.Handle(device=_ctx().device)


@_spanned("win_accumulate")
def win_accumulate(tensor, name: str, dst_weights: WeightsArg = None) -> bool:
    """Like :func:`win_put`, but adds into the destination slot."""
    note_win_op("win_accumulate", name)
    win = _win(name)
    scales, active = _class_scales(win.plan, dst_weights, side="send")
    win.self_tensor = _exposure(win, name, tensor)
    _exchange(win, win.self_tensor, scales, active, accumulate=True)
    return True


def win_accumulate_nonblocking(tensor, name: str, dst_weights: WeightsArg = None) -> ops.Handle:
    win_accumulate(tensor, name, dst_weights)
    return ops.Handle(device=_ctx().device)


def win_put_async(tensor, name: str, dst_weights: WeightsArg = None):
    """API parity with :func:`bluefog_tpu_torch.islands.win_put_async`: the
    rank-major emulation has no background wire, so the op executes at the
    call site and the returned
    :class:`~bluefog_tpu_torch.progress.handles.WinHandle` is already
    resolved — programs written against the async surface run unchanged
    here.  ``tensor`` may be a zero-argument callable."""
    t = tensor() if callable(tensor) else tensor
    return _progress.completed(win_put(t, name, dst_weights))


def win_accumulate_async(tensor, name: str, dst_weights: WeightsArg = None):
    """See :func:`win_put_async` — completed-handle parity wrapper."""
    t = tensor() if callable(tensor) else tensor
    return _progress.completed(win_accumulate(t, name, dst_weights))


def win_update_async(name: str, self_weight=None,
                     neighbor_weights: WeightsArg = None, reset: bool = False):
    """See :func:`win_put_async`; the handle's ``result()`` is the combined
    tensor (``clone`` semantics, matching the island engine)."""
    return _progress.completed(win_update(
        name, self_weight=self_weight, neighbor_weights=neighbor_weights,
        reset=reset, clone=True))


@_spanned("win_get")
def win_get(name: str, src_weights: WeightsArg = None) -> bool:
    """Pull the in-neighbors' exposed tensors into my slots, optionally
    scaled by the receiver (``src_weights``)."""
    note_win_op("win_get", name)
    win = _win(name)
    # a get of s's exposure by d is a put of it to d scaled by d's weight:
    # within a class each (s, d) is unique, so the sender applies it
    send, _ = _class_scales(win.plan, None, side="send")
    recv, active = _class_scales(win.plan, src_weights, side="recv")
    for c, cls in enumerate(win.plan.classes):
        for s, d in cls.perm:
            send[c, s] = recv[c, d]
    _exchange(win, win.self_tensor, send, active, accumulate=False)
    return True


def win_get_nonblocking(name: str, src_weights: WeightsArg = None) -> ops.Handle:
    win_get(name, src_weights)
    return ops.Handle(device=_ctx().device)


def _reset_mailbox(win: _Window) -> None:
    win.mail.zero_()
    win.p_mail.zero_()


def _update_weights(win: _Window, self_weight, neighbor_weights):
    """Combine weights on the host: matrix ``[size, maxd]`` and self vector
    ``[size]`` (default uniform 1/(in_degree+1); explicit neighbor weights
    imply self = 1 - their sum)."""
    plan = win.plan
    size = plan.size
    maxd = max(plan.max_in_degree, 1)
    wmat = np.zeros((size, maxd), dtype=np.float32)
    swvec = np.zeros((size,), dtype=np.float32)
    for d in range(size):
        nbrs = plan.in_neighbors[d]
        if neighbor_weights is not None:
            for k, s in enumerate(nbrs):
                wmat[d, k] = float(neighbor_weights[d].get(s, 0.0))
        else:
            for k in range(len(nbrs)):
                wmat[d, k] = 1.0 / (len(nbrs) + 1)
        if self_weight is None:
            swvec[d] = (1.0 - wmat[d].sum() if neighbor_weights is not None
                        else 1.0 / (len(nbrs) + 1))
        elif np.isscalar(self_weight):
            swvec[d] = float(self_weight)
        else:
            swvec[d] = float(self_weight[d])
    return wmat, swvec


def degraded_update_weights(plan: CommPlan, dead):
    """Per-rank ``(self_weights, neighbor_weights)`` for :func:`win_update`
    with the ranks in ``dead`` cut out of the combine: each survivor drops
    its dead in-neighbors and adds their plan weight to its own self
    weight, so every row total is kept.  Dead ranks' rows are left as they
    are."""
    dead = set(int(r) for r in dead)
    W = plan.mixing_matrix()
    self_w: List[float] = []
    neighbor_w: List[Dict[int, float]] = []
    for d in range(plan.size):
        sw = float(W[d, d])
        nw = {}
        for s in plan.in_neighbors[d]:
            if d not in dead and s in dead:
                sw += float(W[d, s])
            else:
                nw[s] = float(W[d, s])
        self_w.append(sw)
        neighbor_w.append(nw)
    return self_w, neighbor_w


def _combine(self_tensor, mail, p_self, p_mail, wmat, swvec, *, wdt, with_p):
    """Local weighted combine: ``sw * self + sum_k w_k * mail_k`` in ``wdt``,
    and the same for p in f32 when ``with_p``.  ``wmat`` and ``swvec`` are
    f32 device tensors."""
    size, maxd = wmat.shape
    extra = (1,) * (self_tensor.dim() - 1)
    w = wmat.to(wdt).view((size, maxd) + extra)
    sw = swvec.to(wdt).view((size,) + extra)
    combined = sw * self_tensor.to(wdt) + (w * mail.to(wdt)).sum(dim=1)
    new_p = swvec * p_self + (wmat * p_mail).sum(dim=1) if with_p else p_self
    return combined.to(self_tensor.dtype), new_p


def _apply_update(win: _Window, x, self_weight, neighbor_weights, reset: bool):
    ctx = _ctx()
    wmat, swvec = _update_weights(win, self_weight, neighbor_weights)
    with_p = ctx.win_associated_p_enabled
    combined, p_self = _combine(x, win.mail, win.p_self, win.p_mail,
                                _dev(wmat, x.device), _dev(swvec, x.device),
                                wdt=ops._weight_dtype(x), with_p=with_p)
    win.self_tensor = combined
    if with_p:
        win.p_self = p_self
    if reset:
        _reset_mailbox(win)
    return combined


@_spanned("win_update")
def win_update(name: str, self_weight: Optional[Union[float, Sequence[float]]] = None,
               neighbor_weights: WeightsArg = None, reset: bool = False,
               clone: bool = False):
    """Combine the exposed tensor with the mailbox slots and store the
    result as the new exposed tensor, which is returned (a copy with
    ``clone``).  Default weights: uniform 1/(in_degree+1).  ``reset``
    empties the mailbox (and p's) after reading it: the accumulate
    idiom."""
    note_win_op("win_update", name)
    win = _win(name)
    combined = _apply_update(win, win.self_tensor, self_weight, neighbor_weights, reset)
    return _result(name, combined, clone)


@_spanned("win_put_update")
def win_put_update(tensor, name: str, dst_weights: WeightsArg = None, *,
                   self_weight: Optional[Union[float, Sequence[float]]] = None,
                   neighbor_weights: WeightsArg = None, accumulate: bool = False,
                   reset: bool = False):
    """``win_put`` (or ``win_accumulate``) then ``win_update``, as one call:
    the same result as the two in sequence, returned like ``win_update``'s.
    Not a reference API; the hot path of :class:`DistributedWinPutOptimizer`."""
    note_win_op("win_put_update", name)
    win = _win(name)
    scales, active = _class_scales(win.plan, dst_weights, side="send")
    x = _exposure(win, name, tensor)
    _exchange(win, x, scales, active, accumulate=accumulate)
    combined = _apply_update(win, x, self_weight, neighbor_weights, reset)
    return _result(name, combined, clone=False)


def win_update_then_collect(name: str, require_mutex: bool = False):
    """Collect-style update: self weight 1, every neighbor slot weight 1,
    then reset (the push-sum accumulate-and-drain idiom).  ``require_mutex``
    has no effect: under the synchronous emulation no writer can
    interleave."""
    if require_mutex:
        logger.debug("win_update_then_collect(require_mutex=True): no-op under the "
                     "synchronous emulation")
    note_win_op("win_update_then_collect", name)
    win = _win(name)
    ones = [{s: 1.0 for s in win.plan.in_neighbors[d]} for d in range(win.plan.size)]
    return win_update(name, self_weight=1.0, neighbor_weights=ones, reset=True)


def win_wait(handle: ops.Handle) -> bool:
    handle.wait()
    return True


def win_poll(handle: ops.Handle) -> bool:
    return handle.poll()


@contextlib.contextmanager
def win_mutex(name: str, for_self: bool = False, ranks: Optional[List[int]] = None):
    """No-op, kept for the reference's API: the emulation is synchronous,
    so slot access is never concurrent."""
    del name, for_self, ranks
    yield


def get_win_version(name: str) -> List[Dict[int, int]]:
    """Per rank ``{in_neighbor: deposit count}``."""
    win = _win(name)
    ver = win.versions.cpu().numpy()
    return [{s: int(ver[d, k]) for k, s in enumerate(win.plan.in_neighbors[d])}
            for d in range(win.plan.size)]


def win_associated_p(name: str) -> torch.Tensor:
    """The push-sum scalar p of every rank (a copy)."""
    return _win(name).p_self.clone()


def win_set_exposed(name: str, tensor, associated_p=None) -> None:
    """Overwrite the exposed tensor (a copy of ``tensor``), and p when
    given, without a put: the push-sum debias-and-restart idiom (store
    x / p as the new x and reset p to 1)."""
    note_win_op("win_set_exposed", name)
    win = _win(name)
    win.self_tensor = _exposure(win, name, tensor)
    if associated_p is not None:
        p = torch.as_tensor(associated_p, dtype=torch.float32, device=win.p_self.device)
        win.p_self = p.expand(win.p_self.shape).clone()


def turn_on_win_ops_with_associated_p() -> None:
    _ctx().win_associated_p_enabled = True


def turn_off_win_ops_with_associated_p() -> None:
    _ctx().win_associated_p_enabled = False
