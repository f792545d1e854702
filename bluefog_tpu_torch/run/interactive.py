"""Interactive/notebook support — sibling of the reference's ``ibfrun``
(counterpart of ``bluefog_tpu/run/interactive.py``).

One process holds every rank, so a notebook needs no worker daemons: it
only has to initialize the context.  ``setup_interactive`` does that on the
card, or on the device the caller names (``device="cpu"`` for a notebook
without one).  For the multi-process island runtime see
:mod:`bluefog_tpu_torch.run.interactive_islands`.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["setup_interactive"]


def setup_interactive(simulate_ranks: Optional[int] = None, device=None,
                      **init_kwargs):
    """Initialize bluefog_tpu_torch for interactive use and return the
    context.

    ``simulate_ranks``: the number of virtual ranks (the reference's
    n-device virtual mesh); they live on ``device``, the card unless the
    caller asks for another (``device="cpu"``).  ``init_kwargs`` go to
    :func:`bluefog_tpu_torch.init` (``topology``, ``local_size``; ``size``
    in place of ``simulate_ranks``).
    """
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.core import basics

    if simulate_ranks:
        init_kwargs.setdefault("size", int(simulate_ranks))
    if "size" not in init_kwargs:
        raise ValueError("setup_interactive needs simulate_ranks=N (or "
                         "size=N): one process holds every rank")
    bf.init(device=device, **init_kwargs)
    return basics.context()
