"""Registered collective rules: run the hot gossip programs under the
collective inventory and lint them (counterpart of
``bluefog_tpu/analysis/hlo_corpus.py``).

The pure rule objects live in
:mod:`bluefog_tpu_torch.analysis.collective_rules`; this module binds them
to a corpus that really runs — ``neighbor_allreduce_plan`` over each named
topology at n=8, plus the window exchange — under a
:class:`~bluefog_tpu_torch.common.collective_inspect.CollectiveInventory`,
with the reference's subjects and budgets.

The programs run on the card (``cuda``) unless :func:`set_device` (the
CLI's ``--device``) asks for another device; the family reports an error,
not a pass, when the card is asked for and absent.
"""

from __future__ import annotations

import contextlib

from bluefog_tpu_torch.analysis.engine import Finding, Report, registry
from bluefog_tpu_torch.analysis.collective_rules import (
    CollectiveBudget,
    NoFullAxisAllGather,
    NoReplicatedLargeBuffer,
    check_program,
)

SIZE = 8

#: topology label -> (constructor, expected number of shift classes at n=8)
GOSSIP_CORPUS = {
    "exp2": ("ExponentialTwoGraph", 3),
    "ring": ("RingGraph", 2),
    "ring_uni": (None, 1),  # built inline (connect_style=1)
    "full": ("FullyConnectedGraph", 7),
}

# any single collective result bigger than this on the n=8 toy shapes
# means a buffer got replicated across the axis
MAX_RESULT_BYTES = 1 << 20

_device = ["cuda"]


def set_device(device: str) -> None:
    """The device the corpus programs run on (default ``cuda``)."""
    _device[0] = str(device)


def get_device() -> str:
    return _device[0]


@contextlib.contextmanager
def on_device(device: str):
    """Run the family on ``device`` inside the block."""
    before = get_device()
    set_device(device)
    try:
        yield
    finally:
        set_device(before)


def _gossip_inventory(topo, device):
    """(inventory, #shift classes) of one rank-major
    neighbor_allreduce_plan."""
    import torch

    from bluefog_tpu_torch import ops
    from bluefog_tpu_torch.common.collective_inspect import CollectiveInventory
    from bluefog_tpu_torch.core.plan import compile_plan

    plan = compile_plan(topo)
    x = torch.zeros((SIZE, 4), device=device)
    with CollectiveInventory(SIZE) as inv:
        ops.neighbor_allreduce_plan(x, plan)
    return inv, len(plan.classes)


def check_gossip_corpus(report: Report, device: str = None) -> None:
    from bluefog_tpu_torch import topology_util as tu

    device = device or get_device()
    for label in GOSSIP_CORPUS:
        if label == "ring_uni":
            topo = tu.RingGraph(SIZE, connect_style=1)
        else:
            topo = getattr(tu, GOSSIP_CORPUS[label][0])(SIZE)
        inv, nclasses = _gossip_inventory(topo, device)
        expect = GOSSIP_CORPUS[label][1]
        subject = f"neighbor_allreduce/{label}@{SIZE}"
        if nclasses != expect:
            report.add(Finding(
                "collective.gossip-contract", subject,
                f"plan compiled to {nclasses} shift classes (expected "
                f"{expect})"))
        rules = [
            CollectiveBudget({"collective-permute": nclasses},
                             subject=subject),
            NoFullAxisAllGather(axis_size=SIZE, subject=subject),
            NoReplicatedLargeBuffer(MAX_RESULT_BYTES, subject=subject),
        ]
        report.subjects_checked += 1
        report.extend(check_program(inv, rules))


def check_window_exchange(report: Report, device: str = None) -> None:
    import numpy as np
    import torch

    from bluefog_tpu_torch import topology_util as tu
    from bluefog_tpu_torch.common.collective_inspect import CollectiveInventory
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.windows import _exchange_body

    device = device or get_device()
    plan = compile_plan(tu.ExponentialTwoGraph(SIZE))
    nclasses = len(plan.classes)
    maxd = plan.max_in_degree
    x = torch.zeros((SIZE, 4), dtype=torch.float32, device=device)
    mail = torch.zeros((SIZE, maxd, 4), dtype=torch.float32, device=device)
    ver = torch.zeros((SIZE, maxd), dtype=torch.int32, device=device)
    p_self = torch.ones((SIZE,), dtype=torch.float32, device=device)
    p_mail = torch.ones((SIZE, maxd), dtype=torch.float32, device=device)
    scales = np.ones((nclasses, SIZE), np.float32)
    active = np.ones((nclasses, SIZE), np.float32)
    with CollectiveInventory(SIZE) as inv:
        _exchange_body(plan, False, False, x, mail, ver, p_self, p_mail,
                       scales, active)
    subject = f"win_exchange/exp2@{SIZE}"
    rules = [
        CollectiveBudget({"collective-permute": nclasses}, subject=subject),
        NoFullAxisAllGather(axis_size=SIZE, subject=subject),
        NoReplicatedLargeBuffer(MAX_RESULT_BYTES, subject=subject),
    ]
    report.subjects_checked += 1
    report.extend(check_program(inv, rules))


def _on_device(report: Report, body) -> None:
    import torch

    device = get_device()
    if device.startswith("cuda") and not torch.cuda.is_available():
        report.add(Finding(
            "collective.environment", "devices",
            f"the collective family runs on {device!r} and no CUDA device "
            "is visible; run it with --device cpu to check on the host"))
        return
    body(report, device)


@registry.rule("collective.gossip-contract", "collective",
               "neighbor_allreduce runs one rank-axis gather per shift "
               "class, no gathers of the whole axis, no replicated buffers")
def _run_gossip(report: Report) -> None:
    _on_device(report, check_gossip_corpus)


@registry.rule("collective.window-exchange", "collective",
               "the window exchange moves data only via one rank-axis "
               "gather per shift class")
def _run_window(report: Report) -> None:
    _on_device(report, check_window_exchange)
