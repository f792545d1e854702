"""Transport capability records.

Every window transport (native shm, fallback shm, TCP, routed, sim)
declares ONE :class:`TransportCaps` record as a ``CAPS`` class attribute.
The record is the *only* thing a call site may branch on when it adapts
to a backend: the progress engine's fusion decision, islands' scaled
deposits, the wire-dtype selection, resume paths, and the routed tier
split all key off declared capabilities, never off transport class
identity (``analysis/transport_spec.py`` lints both sides — that each
declaration is honest against the class's actual surface, and that call
sites only probe capabilities).

The two ``future_*`` fields name the tiers ROADMAP item 1 adds next
(device-resident windows, an in-mesh collective transport); they exist
now so the lint and the capability matrix in ``docs/ANALYSIS.md`` do not
need a schema change when those tiers land.

This module imports nothing heavy (no numpy, no transports) so every
transport can import it without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["TransportCaps", "CAP_FIELDS", "meet"]


@dataclasses.dataclass(frozen=True)
class TransportCaps:
    """What one window transport can do, as data.

    ``name`` identifies the tier (for reports); every other field is a
    boolean capability a call site may probe.
    """

    name: str
    #: ``write(..., accumulate=True)`` folds into the destination slot
    #: on the receiver side (push-sum deposits need no read-modify-write
    #: round trip at the caller).
    fused_accumulate: bool
    #: ``write(..., scale=w)`` applies the gossip weight inside the
    #: deposit pass (``supports_scale``); otherwise callers pre-multiply.
    fused_scale: bool
    #: ``combine()``/``update_fused()`` exist: read-side fused
    #: multiply-accumulate sweeps without per-slot temporaries.
    fused_combine: bool
    #: ``read(collect=True)`` drains without copying the payload (marker
    #: drain or buffer swap), so collect cost is O(1) + one consume.
    zero_copy_collect: bool
    #: deposits stream as per-chunk seqlocked (or credit-windowed)
    #: frames that overlap with readers; implies the ascending-commit
    #: and commit-fence rules of the chunk protocol apply.
    chunked_streaming: bool
    #: payloads may ride the wire quantized (``BFTPU_WIRE_DTYPE``) with
    #: an error-feedback residual keeping mass conservation exact.
    wire_quantization: bool
    #: a broken connection can resume a session and replay idempotent
    #: ops (and re-send uncommitted chunk streams) without double
    #: counting.
    resume: bool
    #: future tier (ROADMAP item 1): window memory is device-resident.
    device_resident: bool = False
    #: future tier: deposits ride an in-mesh collective, not a mailbox.
    in_mesh_collective: bool = False


#: The boolean capability fields, in declaration order (the lint and the
#: docs capability matrix iterate this — one source of truth).
CAP_FIELDS: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(TransportCaps) if f.name != "name")


def meet(a: TransportCaps, b: TransportCaps, name: str) -> TransportCaps:
    """Capability AND — what a composite transport (e.g. routed, which
    splits traffic between an shm leg and a TCP leg) may honestly claim:
    only what BOTH legs provide, since a caller cannot know which leg a
    given edge takes."""
    return TransportCaps(
        name=name,
        **{f: getattr(a, f) and getattr(b, f) for f in CAP_FIELDS},
    )
