"""Shared helpers for the parallel strategies (counterpart of
``bluefog_tpu/parallel/_util.py``).

Only :func:`resolve_axis_size` has a counterpart here.  The reference's
``vma_full`` and ``pvary`` give constants and replicated values the
varying-manual-axes type that ``shard_map`` checks; the rank-major form
runs no ``shard_map`` and types nothing, so they have none.
"""

from __future__ import annotations


def resolve_axis_size(axis_size, rows: int) -> int:
    """The ring size ``axis_size``, checked against the rank-major leading
    dim ``rows`` (``n x B`` rows: rank ``r``'s batch at ``r*B ... (r+1)*B
    - 1``).

    Under ``shard_map`` the reference reads the bound axis size and fails
    on a stale argument; here the ranks are rows of one tensor, so a size
    that does not divide the rows would silently mix ranks.  ``None``
    (the reference's "no caller claim", allowed only inside a trace) is an
    error: there is no axis to read it from."""
    if axis_size is None:
        raise ValueError("the rank-major form needs the ring size: pass axis_size")
    if isinstance(axis_size, bool) or not isinstance(axis_size, int) or axis_size < 1:
        raise ValueError(f"axis_size must be a positive int, got {axis_size!r}")
    if rows % axis_size:
        raise ValueError(f"axis_size={axis_size} does not divide the rank-major leading "
                         f"dim {rows} (n x B rows)")
    return axis_size
