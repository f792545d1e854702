"""Per-rank convergence probe: debiased consensus error as an observable.

The probe turns the quantity the BlueFog paper's convergence story is
*about* — how fast the fleet's debiased push-sum estimates agree — into
a per-round, per-rank number cheap enough to stream always-on into the
telemetry registry and the seqlock'd status page.

**Definition.**  After round ``t``'s combine, rank ``r`` holds the
debiased estimate ``z_t = x_t / p_t``.  The probe reports

    ``e_r(t) = || S(z_t) - S(z_{t-1}) ||_inf``

where ``S`` is a fixed subsample of at most ``sample_cap`` elements,
taken as a handful of contiguous chunks spread across the tensor (NOT
one element per stride: a whole-buffer strided gather touches a
different cache line per element — ~100 µs of DRAM misses per round on
a 4 MB payload, which alone busted the < 2% overhead gate; contiguous
chunks read the same element count through a handful of
hardware-prefetched streamed regions).  For
linear gossip ``x_{t+1} = W x_t`` the successive difference is
``(W - I)`` applied to the disagreement component, so ``e_r(t)``
contracts at the same asymptotic per-round rate ``|λ₂(W)|`` as the
true consensus error ``||z_t - z̄||`` — but unlike the true error it
needs NO global knowledge: one subtraction over a bounded sample of
rank-local state.

**Cost model.**  The probe tick always runs cache-COLD: the combine it
follows just streamed the whole payload through the core, evicting
numpy's code pages along with the data, so the FIRST entry into each
distinct numpy call path costs ~10 µs on the bench box (the identical
call repeated immediately costs ~2 µs).  Per-round exact math (gather,
subtract, two reductions = four cold entries) therefore has a ~40 µs
floor no micro-optimization can cross.  The probe instead gathers one
row per round (a single cold ``take``) into a small block and defers
the subtract/reductions to one VECTORIZED flush every ``flush_every``
rounds — every round still gets its exact ``e_r(t)``, just computed up
to ``flush_every - 1`` rounds late.  That batching is what keeps the
probe inside the < 2% ``lab_probe_overhead_pct`` bench gate.

Pure numpy, no torch, no transport: the same class drives the islands
hot path (gated off-path like tracing/statuspage), the fake-clock unit
tests, and the sweep driver's fits.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ConvergenceProbe", "probe_enabled", "DEFAULT_SAMPLE_CAP",
           "DEFAULT_FLUSH_EVERY"]

#: Upper bound on the elements one observation touches; overridable via
#: ``BFTPU_LAB_SAMPLE`` (documented in docs/OBSERVABILITY.md).
DEFAULT_SAMPLE_CAP = 1024

#: Rounds batched per flush on the islands hot path (``BFTPU_LAB_FLUSH``).
#: The class default is 1 (exact, compute-on-observe) — only the
#: islands tick opts into batching, via :func:`flush_every_env`.
DEFAULT_FLUSH_EVERY = 8

#: History entries kept per probe (a sweep cell runs tens of rounds;
#: a week-long training job must not grow without bound).
_HISTORY_CAP = 4096

#: Elements per contiguous sample chunk.  The sample is
#: ``sample_cap // _CHUNK_ELEMS`` such chunks spread evenly, so the
#: per-round DRAM-region count is bounded by chunks, not elements —
#: and within a chunk the hardware prefetcher streams the sequential
#: lines, so longer-but-fewer chunks beat many short ones.
_CHUNK_ELEMS = 256


def probe_enabled() -> bool:
    """Whether ``BFTPU_LAB_PROBE`` asks for the probe (off by default —
    the PR-4/PR-9 off-path convention: observability is opt-in and its
    disabled cost is one env-cached boolean)."""
    return os.environ.get("BFTPU_LAB_PROBE", "0").lower() in (
        "1", "true", "yes", "on")


def _sample_cap() -> int:
    try:
        cap = int(os.environ.get("BFTPU_LAB_SAMPLE", DEFAULT_SAMPLE_CAP))
    except ValueError:
        cap = DEFAULT_SAMPLE_CAP
    return max(1, cap)


def flush_every_env() -> int:
    """``BFTPU_LAB_FLUSH`` (default :data:`DEFAULT_FLUSH_EVERY`) — the
    hot-path batching factor the islands tick constructs probes with."""
    try:
        k = int(os.environ.get("BFTPU_LAB_FLUSH", DEFAULT_FLUSH_EVERY))
    except ValueError:
        k = DEFAULT_FLUSH_EVERY
    return max(1, k)


class ConvergenceProbe:
    """One window's convergence observable on one rank.

    ``observe`` is the per-round entry point: feed it the post-combine
    tensor and the associated push-sum weight.  With the default
    ``flush_every=1`` it returns the current consensus-error sample
    (NaN until two rounds have been seen — a difference needs a
    predecessor).  With ``flush_every=K > 1`` it returns the most
    recently COMPUTED sample, up to ``K-1`` rounds behind; every
    round's exact value still lands in ``history`` (and
    ``last_err``/``last_round``) at the next flush — call
    :meth:`flush_pending` to force the stragglers out before reading.
    """

    def __init__(self, sample_cap: Optional[int] = None,
                 flush_every: int = 1):
        self.sample_cap = int(sample_cap if sample_cap is not None
                              else _sample_cap())
        self.flush_every = max(1, int(flush_every))
        self.rounds = 0            # observes seen
        self.last_err = float("nan")
        self.last_round = 0        # round of the last COMPUTED err
        #: ``(round, err)`` pairs, oldest first, capped at _HISTORY_CAP.
        self.history: List[Tuple[int, float]] = []
        # hot-path state, (re)built on first observe / shape change
        self._idx: Optional[np.ndarray] = None
        self._idx_size = -1
        self._dtype: Optional[np.dtype] = None
        self._bf16 = False
        self._block: Optional[np.ndarray] = None  # (K+1, n) sample rows
        self._diff: Optional[np.ndarray] = None   # (K, n) flush scratch
        self._ps: Optional[np.ndarray] = None     # (K,) debias weights
        self._pos = 0              # pending (unflushed) rows in _block
        self._any_p = False        # any pending row needs dividing
        self._prev_valid = False   # _block[0] holds round rounds-_pos

    def _rebuild(self, flat: np.ndarray) -> None:
        if flat.size <= self.sample_cap:
            self._idx = None  # small tensor: observe every element
            n = flat.size
        else:
            chunk = min(_CHUNK_ELEMS, self.sample_cap)
            nchunks = max(1, self.sample_cap // chunk)
            span = flat.size // nchunks
            starts = np.arange(nchunks, dtype=np.int64) * span
            idx = (starts[:, None]
                   + np.arange(chunk, dtype=np.int64)[None, :]).ravel()
            self._idx = idx[idx < flat.size]
            n = self._idx.size
        # work in the tensor's own float dtype: the subtraction of two
        # nearby same-dtype values is exact (Sterbenz), so a float64
        # round-trip would cost a cast dispatch per round and buy no
        # precision the floor-truncated fits could see
        dt = flat.dtype if flat.dtype.kind == "f" else np.dtype(np.float64)
        # a bf16 island window holds its values in the two-byte layout of
        # progress.staging.BF16 (a one-field structured dtype): decode the
        # gathered bits, never cast the struct (numpy would read the raw
        # bit patterns as numbers)
        self._bf16 = flat.dtype.names == ("bfloat16",)
        k = self.flush_every
        self._idx_size = flat.size
        self._dtype = flat.dtype
        self._block = np.empty((k + 1, n), dtype=dt)
        self._diff = np.empty((k, n), dtype=dt)
        self._ps = np.ones(k, dtype=np.float64)
        self._pos = 0
        self._any_p = False
        self._prev_valid = False

    def _flush(self) -> None:
        k = self._pos
        if k == 0:
            return
        blk = self._block
        if self._any_p:
            # debias in place: rows stay debiased, so the carried-over
            # predecessor row is always already divided
            np.divide(blk[1:k + 1], self._ps[:k, None], out=blk[1:k + 1])
            self._ps[:k] = 1.0
            self._any_p = False
        d = np.subtract(blk[1:k + 1], blk[:k], out=self._diff[:k])
        hi = d.max(axis=1)
        lo = d.min(axis=1)
        base = self.rounds - k
        hist = self.history
        for i in range(k):
            if i == 0 and not self._prev_valid:
                err = float("nan")  # a difference needs a predecessor
            else:
                err = float(max(hi[i], -lo[i]))
            self.last_err = err
            self.last_round = base + i + 1
            if len(hist) < _HISTORY_CAP:
                hist.append((self.last_round, err))
        np.copyto(blk[0], blk[k])
        self._pos = 0
        self._prev_valid = True

    def flush_pending(self) -> None:
        """Compute any rounds still sitting in the block (reads of
        ``history``/``last_err`` want the stragglers out first)."""
        self._flush()

    def observe(self, tensor: np.ndarray, p: float = 1.0) -> float:
        """Record round ``t``'s debiased sample; return the latest
        computed ``e`` (this round's, when ``flush_every == 1``).

        Every numpy entry here costs ~10 µs in situ (see the module
        docstring's cost model), so the per-round body is ONE gather
        plus plain-python bookkeeping; the math happens in
        :meth:`_flush`.
        """
        if isinstance(tensor, np.ndarray) and tensor.ndim == 1:
            flat = tensor
        else:
            flat = np.asarray(tensor).ravel()
        if self._idx_size != flat.size or self._dtype != flat.dtype:
            if self._pos:
                self._flush()  # don't drop rounds pending under the old shape
            self._rebuild(flat)
        row = self._block[self._pos + 1]
        if self._bf16:
            bits = flat.view(np.uint16)
            if self._idx is not None:
                bits = bits.take(self._idx)
            np.copyto(row, (bits.astype(np.uint32) << 16).view(np.float32))
        elif self._idx is None:
            np.copyto(row, flat, casting="unsafe")
        elif row.dtype == flat.dtype:
            np.take(flat, self._idx, out=row, mode="clip")
        else:  # non-float tensor: gather then cast (rare, cold path)
            np.copyto(row, flat.take(self._idx), casting="unsafe")
        if p > 0.0 and p != 1.0:
            self._ps[self._pos] = p
            self._any_p = True
        self.rounds += 1
        self._pos += 1
        if self._pos >= self.flush_every:
            self._flush()
        return self.last_err
