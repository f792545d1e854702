"""Environment-variable configuration, mirroring the reference's env surface.

The reference has no config files — behaviour is driven by ``BLUEFOG_*`` env
vars (SURVEY.md §5.6: ``BLUEFOG_LOG_LEVEL``, ``BLUEFOG_TIMELINE``,
``BLUEFOG_FUSION_THRESHOLD``, ``BLUEFOG_CYCLE_TIME``).  We keep the same
names.  Fusion/cycle knobs are accepted-but-inert: XLA fuses and schedules
collectives itself, so they exist only so reference-era launch scripts do
not break (a warning is logged when they are set to non-defaults).  The
*capability* the fusion buffer provided — one exchange for many tensors —
is an explicit API here instead of a byte threshold: pass a pytree to
``win_create`` (one packed window) or use the fused optimizer modes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    log_level: str = "warn"
    timeline_path: Optional[str] = None
    # Inert-on-TPU knobs kept for launch-script parity (see module docstring).
    fusion_threshold: int = 64 * 1024 * 1024
    cycle_time_ms: float = 0.0
    # Window-op staleness bound (steps a rank may run ahead before the
    # mailbox exchange synchronizes); ours, not the reference's.
    win_staleness_bound: int = 1

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            log_level=os.environ.get("BLUEFOG_LOG_LEVEL", "warn").lower(),
            timeline_path=os.environ.get("BLUEFOG_TIMELINE") or None,
            fusion_threshold=_env_int("BLUEFOG_FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=float(os.environ.get("BLUEFOG_CYCLE_TIME", "0") or 0),
            win_staleness_bound=_env_int("BLUEFOG_WIN_STALENESS_BOUND", 1),
        )
