"""Ring attention: sequence-parallel exact attention over ``n`` sequence
shards (counterpart of ``bluefog_tpu/parallel/ring_attention.py``).

The algorithm is the reference's, the public blockwise ring attention (Liu
et al., arXiv:2310.01889): each rank holds one sequence block of Q, K and
V; K/V blocks move one rank along the ring a step while each rank folds
its queries' attention over the block it holds, by the online-softmax
recurrence (:func:`ring_attention`) or by one flash-attention call a hop
whose outputs merge by the logsumexp rule (:func:`ring_flash_attention`).

**The rank-major layout.**  On one device the ``n`` shards are ``n``
virtual ranks on a leading axis, as on every path of the port:

- the model runs once on the folded batch, ``ids [n*B, T_local]``, rank
  ``r``'s rows at ``r*B ... (r+1)*B - 1`` (:func:`shard_sequence` makes it
  from ``[B, T]``, :func:`gather_sequence` undoes it: the counterparts of
  ``shard_map``'s ``P(None, axis)`` in and out specs; :func:`shard_inputs`
  stripes first if asked and gives the positions, :func:`gather_outputs`
  puts outputs back into sequence order);
- an ``attention_fn`` receives ``q, k, v: [n*B, T_local, H, D]``, views
  them as ``[n, B, T_local, H, D]`` and does the hops along axis 0:
  ``lax.ppermute`` from rank ``i`` to ``i + 1`` becomes reading, at step
  ``s``, the block of rank ``j = (idx - s) mod n``, and ``lax.axis_index``
  the host integer ``idx``;
- positions are ``[n*B, T_local]``, each rank's rows with their shard's
  global positions (``LlamaLM``'s rotary embedding takes them per row);
- parameters are one copy, as the reference's replicated ``in_specs=P()``.

Every rank's offsets are host integers, so the flash kernels need no
device-side offsets, and the ranks of a hop that share ``(q_start,
k_start, causal)`` run in one launch (:func:`hop_launches`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from bluefog_tpu_torch.parallel._util import resolve_axis_size

__all__ = [
    "ring_attention",
    "ring_flash_attention",
    "make_ring_attention_fn",
    "hop_launches",
    "stripe_blocks",
    "unstripe_blocks",
    "striped_positions",
    "shard_sequence",
    "gather_sequence",
    "shard_inputs",
    "gather_outputs",
]


def stripe_blocks(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Permute a global sequence so contiguous shard ``r`` of the result
    holds global positions ``r, r+n, r+2n, ...``: the *striped* layout.

    Striping balances causal ring attention across devices: with
    contiguous blocks, hop ``s`` is fully masked on ranks ``idx < s``; striped,
    every hop is a near-triangular half-load on every rank (striped
    attention, arXiv:2311.09431).  Apply before sharding; undo with
    :func:`unstripe_blocks`."""
    t = x.shape[axis]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by {n}")
    x = x.movedim(axis, 0)
    x = x.reshape(t // n, n, *x.shape[1:]).transpose(0, 1).reshape(t, *x.shape[1:])
    return x.movedim(0, axis)


def unstripe_blocks(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe_blocks`."""
    t = x.shape[axis]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by {n}")
    x = x.movedim(axis, 0)
    x = x.reshape(n, t // n, *x.shape[1:]).transpose(0, 1).reshape(t, *x.shape[1:])
    return x.movedim(0, axis)


def striped_positions(t_local: int, n: int, device=None) -> torch.Tensor:
    """Global positions of every rank's striped shard, ``[n, T_local]``:
    row ``r`` is ``i*n + r``.  The reference returns one device's row
    (it reads ``idx`` from the axis); with no axis name, all rows."""
    i = torch.arange(t_local, device=device)
    return i[None, :] * n + torch.arange(n, device=device)[:, None]


def shard_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, T, ...]`` -> ``[n*B, T/n, ...]``: sequence block ``r`` becomes
    rank ``r``'s rows (the rank-major form of sharding axis 1)."""
    b, t = x.shape[:2]
    if t % n:
        raise ValueError(f"sequence length {t} not divisible by {n}")
    x = x.reshape(b, n, t // n, *x.shape[2:]).transpose(0, 1)
    return x.reshape(n * b, t // n, *x.shape[3:])


def gather_sequence(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`shard_sequence`: ``[n*B, T_local, ...]`` ->
    ``[B, n*T_local, ...]``."""
    rows, tl = x.shape[:2]
    if rows % n:
        raise ValueError(f"{rows} rows not divisible by {n} ranks")
    x = x.reshape(n, rows // n, tl, *x.shape[2:]).transpose(0, 1)
    return x.reshape(rows // n, n * tl, *x.shape[3:])


def shard_inputs(x: torch.Tensor, n: int,
                 striped: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-major inputs of a sequence-parallel model from a global
    batch ``x [B, T, ...]`` (ids, or q/k/v): ``(x [n*B, T/n, ...],
    positions [n*B, T/n])``, striped first when ``striped``
    (:func:`stripe_blocks`), each row with its shard's global positions
    (``r*T_local + i``, or :func:`striped_positions`), on ``x``'s device."""
    b, t = x.shape[:2]
    shards = shard_sequence(stripe_blocks(x, n) if striped else x, n)
    tl = t // n
    pos = (striped_positions(tl, n, x.device) if striped
           else torch.arange(t, device=x.device).view(n, tl))
    return shards, pos.repeat_interleave(b, dim=0)


def gather_outputs(x: torch.Tensor, n: int, striped: bool = False) -> torch.Tensor:
    """Inverse of :func:`shard_inputs`' first output: ``[n*B, T_local,
    ...]`` -> ``[B, n*T_local, ...]`` in sequence order."""
    x = gather_sequence(x, n)
    return unstripe_blocks(x, n) if striped else x


def _check_striped(striped, causal, tq, tk):
    if striped and causal and tq != tk:
        raise ValueError(
            f"striped causal ring attention needs equal q/k shard lengths "
            f"(got {tq} vs {tk}); the striped layout has no contiguous-"
            f"block fallback")


def _ranks(x: torch.Tensor, start: int, count: int, n: int) -> torch.Tensor:
    """Ranks ``start, start+1, ... (mod n)``, ``count`` of them, of ``x [n, ...]``."""
    start %= n
    if start + count <= n:
        return x[start:start + count]
    return torch.cat([x[start:], x[:start + count - n]])


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_size: int, *,
                   causal: bool = True, striped: bool = False) -> torch.Tensor:
    """Exact blockwise attention across ``axis_size`` sequence shards, in
    plain torch (no kernel): the dense f32 online-softmax ring.

    q: ``[n*B, Tq, H, D]``, k and v: ``[n*B, Tk, H, D]``, rank-major (the
    :func:`stripe_blocks` layout when ``striped``).  Returns ``[n*B, Tq,
    H, D]`` in q's dtype.  The causal masks are the reference's: striped,
    the key stripe ``j`` is visible up to and including the diagonal iff
    ``j <= idx``; contiguous square shards, the diagonal at step 0, hop
    ``s`` fully visible on ranks ``idx >= s`` and fully masked on the rest;
    ``Tq != Tk``, masks on global positions ``idx*Tq + i`` and ``j*Tk +
    i``.  A fully masked block leaves a rank's state as it was."""
    n = resolve_axis_size(axis_size, q.shape[0])
    rows, tq, h, d = q.shape
    tk = k.shape[1]
    b = rows // n
    _check_striped(striped, causal, tq, tk)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float().reshape(n, b, tq, h, d)
    kf = k.float().reshape(n, b, tk, h, d)
    vf = v.float().reshape(n, b, tk, h, d)
    m = torch.full((n, b, h, tq), -math.inf, device=dev)
    l = torch.zeros(n, b, h, tq, device=dev)
    o = torch.zeros(n, b, h, tq, d, device=dev)
    iq, ik = torch.arange(tq, device=dev), torch.arange(tk, device=dev)
    tri, tri_strict = ik[None, :] <= iq[:, None], ik[None, :] < iq[:, None]
    idx = torch.arange(n, device=dev)
    for step in range(n):
        kb, vb = torch.roll(kf, step, 0), torch.roll(vf, step, 0)  # rank idx: block j
        j = (idx - step) % n
        if causal and tq == tk and step == 0:
            valid = tri.expand(n, tq, tk)
        elif causal and tq == tk:
            # striped: j <= idx iff idx >= step; contiguous: the same ranks
            # see the whole block and the others none of it
            seen = idx >= step
            if striped:
                valid = torch.where(seen[:, None, None], tri, tri_strict)
            else:
                valid = seen[:, None, None].expand(n, tq, tk)
        elif causal:
            gq = idx[:, None] * tq + iq  # [n, Tq] global query positions
            gk = j[:, None] * tk + ik  # [n, Tk] global key positions
            valid = gk[:, None, :] <= gq[:, :, None]
        else:
            valid = torch.ones(n, tq, tk, dtype=torch.bool, device=dev)
        scores = torch.einsum("nbqhd,nbkhd->nbhqk", qf, kb) * scale
        scores = scores.masked_fill(~valid[:, None, None], -math.inf)
        # the running max only shifts the exponents (the result does not
        # depend on it), so it carries no gradient; rows that have seen
        # nothing keep -inf and shift by 0
        with torch.no_grad():
            m_new = torch.maximum(m, scores.amax(-1))
            shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.exp(m - shift)
        p = torch.exp(scores - shift[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("nbhqk,nbkhd->nbhqd", p, vb)
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]  # [n, B, H, Tq, D]
    return out.permute(0, 1, 3, 2, 4).reshape(rows, tq, h, d).to(q.dtype)


class Hop(NamedTuple):
    """One flash launch of a ring step: the ranks it serves (a consecutive
    range), their key blocks' offsets and the mask."""
    ranks: range
    q_start: int
    k_start: int
    causal: bool


def hop_launches(step: int, n: int, tq: int, tk: int, *, causal: bool,
                 striped: bool) -> List[Hop]:
    """The flash launches of ring step ``step``: the ranks of the step that
    share ``(q_start, k_start, causal)`` in one launch.

    - contiguous causal square shards: step 0 is one diagonal launch
      ``(0, 0, causal)`` over all ranks; step ``s`` one non-causal launch
      over ranks ``idx >= s``, and ranks ``idx < s`` (fully masked) launch
      nothing: skipping is exact, since the reference's masked sentinel
      (o = 0, lse = -1e30) merges with weight 0;
    - striped: step 0 one launch (delta 0); step ``s`` a delta-0 launch over
      ranks ``idx >= s`` and a delta-1 launch (``k_start = 1``) over ranks
      ``idx < s``;
    - not causal: one launch over all ranks (offsets mask nothing);
    - causal with ``Tq != Tk``: one launch a rank, ``q_start = idx*Tq``,
      ``k_start = j*Tk``.

    These are the kernel route's launches; under ``impl="xla"`` the same
    groups run the blockwise route, which launches nothing.
    """
    if causal and tq == tk:
        if step == 0:
            return [Hop(range(n), 0, 0, True)]
        if striped:
            return [Hop(range(step, n), 0, 0, True), Hop(range(step), 0, 1, True)]
        return [Hop(range(step, n), 0, 0, False)]
    if not causal:
        return [Hop(range(n), 0, 0, False)]
    return [Hop(range(i, i + 1), i * tq, ((i - step) % n) * tk, True) for i in range(n)]


def _assemble(n: int, old, pieces) -> torch.Tensor:
    """``[n, ...]`` from ``pieces`` ``[(ranks, tensor [len(ranks), ...])]``
    and, for the ranks no piece covers, the rows of ``old``."""
    parts, at = [], 0
    for ranks, t in sorted(pieces, key=lambda p: p[0].start):
        if ranks.start > at:
            parts.append(old[at:ranks.start])
        parts.append(t)
        at = ranks.stop
    if at < n:
        parts.append(old[at:])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_size: int,
                         *, causal: bool = True, striped: bool = False, block_q=None,
                         block_k=None, interpret=None, impl: str = "auto") -> torch.Tensor:
    """Ring attention with the flash kernels as the hop compute: same
    semantics and layout as :func:`ring_attention`, each hop one
    :func:`bluefog_tpu_torch.kernels.flash_attention_with_lse` call a
    group of ranks (:func:`hop_launches`), the hops merged by the
    logsumexp rule in f32.  Differentiable end to end: the merge's lse
    cotangent reaches the kernels' backward.  On CUDA tensors every hop
    launches the CUDA kernels; on CPU tensors their plain versions run.

    ``impl``, ``block_q``, ``block_k`` and ``interpret`` reach every hop's
    :func:`~bluefog_tpu_torch.kernels.flash_attention_with_lse`, as in the
    reference: ``impl="xla"`` runs each hop group by the blockwise route
    (plain torch, no kernel launch; a hop with a key offset 0 or 1 ahead,
    the diagonal and the striped hops, takes its triangular branch),
    ``"auto"`` / ``"pallas"`` / ``"cuda"`` the kernels, which skip
    invisible tiles themselves."""
    from bluefog_tpu_torch.kernels import flash_attention_with_lse

    n = resolve_axis_size(axis_size, q.shape[0])
    rows, tq, h, d = q.shape
    tk = k.shape[1]
    b = rows // n
    _check_striped(striped, causal, tq, tk)
    q4, k4, v4 = (x.reshape(n, b, *x.shape[1:]) for x in (q, k, v))

    o = lse = None  # [n, B, H, Tq, D] and [n, B, H, Tq], f32
    for step in range(n):
        pieces_o, pieces_lse = [], []
        for hop in hop_launches(step, n, tq, tk, causal=causal, striped=striped):
            r, c = hop.ranks, len(hop.ranks)
            # ranks r hold the key blocks of ranks r - step
            qkv = (q4[r.start:r.stop], _ranks(k4, r.start - step, c, n),
                   _ranks(v4, r.start - step, c, n))
            o_s, lse_s = flash_attention_with_lse(
                *(x.reshape(c * b, *x.shape[2:]) for x in qkv),
                q_start=hop.q_start, k_start=hop.k_start, causal=hop.causal,
                block_q=block_q, block_k=block_k, interpret=interpret, impl=impl)
            o_s = o_s.float().permute(0, 2, 1, 3).reshape(c, b, h, tq, d)
            lse_s = lse_s.reshape(c, b, h, tq)
            if o is not None:
                o_old, lse_old = o[r.start:r.stop], lse[r.start:r.stop]
                m = torch.maximum(lse_old, lse_s)
                w_old, w_new = torch.exp(lse_old - m), torch.exp(lse_s - m)
                denom = w_old + w_new  # >= 1 (2 for rows that see nothing)
                o_s = (w_old[..., None] * o_old + w_new[..., None] * o_s) / denom[..., None]
                lse_s = m + torch.log(denom)
            pieces_o.append((r, o_s))
            pieces_lse.append((r, lse_s))
        o, lse = _assemble(n, o, pieces_o), _assemble(n, lse, pieces_lse)
    return o.permute(0, 1, 3, 2, 4).reshape(rows, tq, h, d).to(q.dtype)


def make_ring_attention_fn(axis_size: int, causal: bool = True, *, flash: bool = False,
                           striped: bool = False, **flash_kwargs) -> Callable:
    """``attention_fn`` for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`:
    sequence-parallel ring attention in the decoder blocks (``flash=True``
    runs the flash kernels a hop; ``striped=True`` the :func:`stripe_blocks`
    layout, paired with :func:`striped_positions`)."""
    if flash:
        return functools.partial(ring_flash_attention, axis_size=axis_size, causal=causal,
                                 striped=striped, **flash_kwargs)
    return functools.partial(ring_attention, axis_size=axis_size, causal=causal,
                             striped=striped)
