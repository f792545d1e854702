"""Always-on fleet monitor: scrape, retain, alert, attribute.

The monitoring layer on top of the observability planes the repo
already has (docs/OBSERVABILITY.md "Fleet monitor"):

* :mod:`~bluefog_tpu_torch.monitor.scraper` — a passive daemon polling every
  rank's seqlock'd status page on a ``BFTPU_MON_SCRAPE_S`` cadence,
  never perturbing the run (same guarantee as ``bftpu-top``);
* :mod:`~bluefog_tpu_torch.monitor.store` — mmap'd ring-buffer time series
  with raw → 10× → 100× downsampling tiers, attachable post-mortem,
  exported as Prometheus text or JSON;
* :mod:`~bluefog_tpu_torch.monitor.rules` — declarative alert rules compiled
  from the standing invariants the analysis corpus names, folded into
  gap-closed alert windows and journaled as ``alert`` events;
* :mod:`~bluefog_tpu_torch.monitor.tail` — a rotation-safe incremental
  journal tailer (survives the ``BFTPU_JOURNAL_MAX_MB`` ``.1`` flip);
* :mod:`~bluefog_tpu_torch.monitor.report` — incident attribution joining
  every alert window to the cause events inside it.

The same rule engine runs against the virtual clock inside
``SimConfig(monitor=True)``, where "seeded bug ⇒ matching alert" and
"clean campaign ⇒ zero alerts" are standing, bit-identical invariants
(``analysis --family monitor``).
"""

from bluefog_tpu_torch.monitor.rules import (  # noqa: F401
    ALERT_STATE_FIRING,
    ALERT_STATE_NONE,
    ALERT_STATE_OK,
    AlertEngine,
    AlertRule,
    default_rules,
    load_rules,
)
from bluefog_tpu_torch.monitor.scraper import (  # noqa: F401
    MONITOR_RANK,
    FleetSampler,
    MonitorDaemon,
    scrape_interval,
)
from bluefog_tpu_torch.monitor.store import MonitorStore  # noqa: F401
from bluefog_tpu_torch.monitor.tail import JournalTailer  # noqa: F401
from bluefog_tpu_torch.monitor.report import (  # noqa: F401
    MON_CAUSE_KINDS,
    format_report,
    monitor_report,
)

__all__ = [
    "AlertEngine",
    "AlertRule",
    "default_rules",
    "load_rules",
    "ALERT_STATE_NONE",
    "ALERT_STATE_OK",
    "ALERT_STATE_FIRING",
    "FleetSampler",
    "MonitorDaemon",
    "MONITOR_RANK",
    "scrape_interval",
    "MonitorStore",
    "JournalTailer",
    "MON_CAUSE_KINDS",
    "monitor_report",
    "format_report",
]
