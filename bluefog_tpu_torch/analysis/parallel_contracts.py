"""The parallel layers' collective-count contracts, run under the collective
inventory (twins of six cases of the reference's ``tests/test_hlo_contract.py``).

The reference compiles each program at n=8 on its CPU mesh and counts the
collective opcodes of the post-partitioner HLO.  Here each program runs
eagerly on the rank-major backend under a
:class:`~bluefog_tpu_torch.common.collective_inspect.CollectiveInventory`,
on the reference's shapes, and is held to the reference's pinned counts:

=================  ==============================================  ============================
contract           reference (``test_hlo_contract.py``)            here
=================  ==============================================  ============================
``zero_packed``    1 all-gather, 1 reduce-scatter, <= 2            the same
                   all-reduces, no all-to-all, no permute
``tp_block``       1 all-reduce                                    the same
``pp_fwd_bwd``     2 permutes (one a ``scan`` body, forward and    one a tick forward and one
                   backward), 1 all-reduce                         a tick backward (see below),
                                                                   1 all-reduce
``ep_fwd_bwd``     3 all-to-alls, 1 all-reduce                     the same
``fsdp_scan``      no all-gather carries the 6-layer axis, >= 1    the same
                   permute
``ring``           2(n-1) permutes forward, 4(n-1) forward +       the same, dense and flash
                   backward, nothing else
=================  ==============================================  ============================

The reference counts the ops of a ``scan`` body once, statically; the
inventory counts every execution.  The pipeline's loop runs ``ticks =
num_microbatches + n - 1`` ticks, each streaming the stages once forward;
the backward streams the cotangents back once a tick but for the last,
whose shifted stream feeds nothing.  So ``pp_fwd_bwd`` expects ``ticks``
+ ``ticks - 1`` permutes: the reference's two a tick.  The rings unroll in
Python on both sides, so their counts compare directly.

Where a reference program differentiates ``sum(f(x))``, the forward value
of the loss is dead code in its compiled gradient; here the program is
``f`` and its vector-Jacobian product with the loss's cotangent, so the
inventory holds exactly what the reference's HLO holds.

:func:`run_contract` runs one by name on any device and returns a row of
what it recorded; :data:`CONTRACTS` lists the names.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from bluefog_tpu_torch.analysis.collective_rules import (
    CollectiveBudget,
    NoFullAxisAllGather,
    check_program,
)
from bluefog_tpu_torch.common.collective_inspect import CollectiveInventory

__all__ = ["CONTRACTS", "REFERENCE_COUNTS", "run_contract", "pp_ticks"]

SIZE = 8

#: the counts pinned in the reference's test text, by contract (the
#: pipeline's a ``scan`` body, restated a tick by :func:`_pp_fwd_bwd`)
REFERENCE_COUNTS: Dict[str, Dict[str, int]] = {
    "zero_packed": {"all-gather": 1, "reduce-scatter": 1, "all-to-all": 0,
                    "collective-permute": 0},
    "tp_block": {"all-reduce": 1},
    "pp_fwd_bwd": {"collective-permute": 2, "all-reduce": 1},
    "ep_fwd_bwd": {"all-to-all": 3, "all-reduce": 1},
    "ring_fwd": {"collective-permute": 2 * (SIZE - 1)},
    "ring_fwd_bwd": {"collective-permute": 4 * (SIZE - 1)},
}

#: at most this many all-reduces in the ZeRO step (the scalar loss mean)
ZERO_MAX_ALLREDUCE = 2
#: the FSDP case's scan-stacked depth: no all-gather may carry it
FSDP_LAYERS = 6


def pp_ticks(num_microbatches: int, stages: int) -> int:
    """The pipeline's tick count, ``num_microbatches + stages - 1``."""
    return num_microbatches + stages - 1


def _vjp(inv: CollectiveInventory, fn: Callable, wrt, cotangent: Callable):
    """Run ``fn`` and its vector-Jacobian product with respect to ``wrt``
    under ``inv``; ``cotangent(out)`` is the loss's cotangent of ``out``
    (a tuple for a tuple of outputs)."""
    with inv:
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        cot = cotangent(out)
        cots = cot if isinstance(cot, tuple) else (cot,)
        torch.autograd.grad(outs, wrt, cots)
    return out


def _zero_packed(device) -> Dict:
    from bluefog_tpu_torch.parallel.zero import make_zero_gossip_train_step

    def apply_fn(p, x):
        return torch.tanh(x @ p["w"]) @ p["v"]

    def loss_fn(out, y):
        return ((out - y) ** 2).mean()

    init_fn, step_fn, _ = make_zero_gossip_train_step(
        apply_fn, loss_fn, (1, SIZE), None, learning_rate=0.1, compute_dtype=torch.float32)
    state = init_fn({"w": torch.zeros(16, 32, device=device),
                     "v": torch.zeros(32, 8, device=device)})
    batch = torch.zeros(1, SIZE, 4, 16, device=device)
    labels = torch.zeros(1, SIZE, 4, 8, device=device)
    inv = CollectiveInventory(SIZE)
    with inv:
        step_fn(state, batch, labels)
    counts = dict(inv.counts())
    findings = CollectiveBudget(REFERENCE_COUNTS["zero_packed"], exact=False).check(inv)
    for op in ("all-gather", "reduce-scatter"):
        if counts.get(op, 0) != 1:
            findings.append(f"{counts.get(op, 0)} x {op}, expected exactly 1")
    if counts.get("all-reduce", 0) > ZERO_MAX_ALLREDUCE:
        findings.append(f"{counts['all-reduce']} x all-reduce, budget {ZERO_MAX_ALLREDUCE}")
    return {"inv": inv, "expected": {"all-gather": 1, "reduce-scatter": 1,
                                     "all-reduce": f"<= {ZERO_MAX_ALLREDUCE}"},
            "findings": [str(f) for f in findings]}


def _tp_block(device) -> Dict:
    from bluefog_tpu_torch.parallel import tensor_parallel as tp

    x = torch.ones(4, 16, device=device)
    k1 = torch.ones(SIZE, 16, 32 // SIZE, device=device, requires_grad=True)
    k2 = torch.ones(SIZE, 32 // SIZE, 16, device=device, requires_grad=True)

    def fn():
        h = tp.column_parallel_dense(tp.copy_to_tp_region(x, SIZE), k1)
        return tp.row_parallel_dense(torch.tanh(h), k2)

    inv = CollectiveInventory(SIZE)
    _vjp(inv, fn, (k1, k2), lambda y: 2 * y)  # loss = sum(y ** 2)
    want = REFERENCE_COUNTS["tp_block"]
    return {"inv": inv, "expected": want,
            "findings": [str(f) for f in CollectiveBudget(want).check(inv)]}


def _pp_fwd_bwd(device) -> Dict:
    from bluefog_tpu_torch.parallel import pipeline as pp

    params = torch.ones(SIZE, 16, 16, device=device, requires_grad=True)
    x = torch.ones(SIZE, 4, 16, device=device)

    def fn():
        return pp.pipeline_apply(lambda p, a: torch.tanh(a @ p), params, x,
                                 num_microbatches=SIZE)

    inv = CollectiveInventory(SIZE)
    _vjp(inv, fn, (params,), lambda y: 2 * y)  # loss = sum(y ** 2)
    ticks = pp_ticks(SIZE, SIZE)
    want = {"collective-permute": ticks + (ticks - 1), "all-reduce": 1}
    return {"inv": inv, "expected": want, "ticks": ticks,
            "findings": [str(f) for f in CollectiveBudget(want).check(inv)]}


def _ep_fwd_bwd(device) -> Dict:
    from bluefog_tpu_torch.parallel import expert as ep

    d, f, e = 16, 32, SIZE  # one expert a rank
    p = ep.init_moe_params(d, f, e, seed=1, device=device)
    params = {"router": p["router"].requires_grad_(),
              "wi": p["wi"].reshape((SIZE, e // SIZE) + p["wi"].shape[1:]).requires_grad_(),
              "wo": p["wo"].reshape((SIZE, e // SIZE) + p["wo"].shape[1:]).requires_grad_()}
    x = torch.ones(SIZE, 4, d, device=device)

    def fn():
        return ep.switch_moe(x, params, capacity_factor=float(e))

    inv = CollectiveInventory(SIZE)
    # loss = sum(y ** 2) + aux
    _vjp(inv, fn, tuple(params.values()), lambda o: (2 * o[0], torch.ones_like(o[1])))
    want = REFERENCE_COUNTS["ep_fwd_bwd"]
    return {"inv": inv, "expected": want,
            "findings": [str(f) for f in CollectiveBudget(want).check(inv)]}


def _fsdp_scan(device) -> Dict:
    from bluefog_tpu_torch import topology_util
    from bluefog_tpu_torch.core.plan import compile_plan
    from bluefog_tpu_torch.models.transformer import LlamaLM
    from bluefog_tpu_torch.parallel import zero
    from bluefog_tpu_torch.training import make_lm_loss_fns

    machines, local = 2, 4
    gen = torch.Generator(device=device).manual_seed(0)
    lm = LlamaLM(vocab_size=96, hidden_size=32, num_layers=FSDP_LAYERS, num_heads=4, dff=64,
                 remat=True, scan_layers=True, dtype=torch.float32, head_chunks=4,
                 spmd_vocab=True, act_constraint=zero.fsdp_act_constraint(),
                 onehot_constraint=zero.fsdp_onehot_constraint(),
                 weight_constraint=zero.fsdp_param_io_constraint(),
                 device=device, generator=gen)
    apply_fn, loss_fn = make_lm_loss_fns(lm)
    init_fn, step_fn, _ = zero.make_fsdp_gossip_train_step(
        apply_fn, loss_fn, (machines, local),
        compile_plan(topology_util.RingGraph(machines)), learning_rate=0.1)
    state = init_fn({k: v.detach() for k, v in lm.named_parameters()})
    ids = torch.ones(machines, local * 2, 16, dtype=torch.long, device=device)
    inv = CollectiveInventory(SIZE, machines=machines)
    with inv:
        step_fn(state, ids, ids)
    findings = [str(f) for f in check_program(
        inv, [NoFullAxisAllGather(axis_size=FSDP_LAYERS, subject="fsdp_gossip_step")])]
    permutes = inv.counts().get("collective-permute", 0)
    if permutes < 1:
        findings.append(f"gossip combine lost its permutes: {dict(inv.counts())}")
    return {"inv": inv, "expected": {"collective-permute": ">= 1",
                                     "all-gather": f"none with the {FSDP_LAYERS}-layer axis"},
            "findings": findings}


def _ring(device, flash: bool, backward: bool) -> Dict:
    from bluefog_tpu_torch.parallel import ring_attention as ra

    n = SIZE
    t, h, d = n * 16, 2, 8
    q, k, v = (torch.ones(n, t // n, h, d, device=device, requires_grad=True)
               for _ in range(3))
    ring = ra.ring_flash_attention if flash else ra.ring_attention

    def fn():
        return ring(q, k, v, n, causal=True, striped=True)

    inv = CollectiveInventory(n)
    if backward:  # loss = sum(sin(out))
        _vjp(inv, fn, (q, k, v), torch.cos)
    else:
        with inv:
            fn()
    want = REFERENCE_COUNTS["ring_fwd_bwd" if backward else "ring_fwd"]
    return {"inv": inv, "expected": want,
            "findings": [str(f) for f in CollectiveBudget(want).check(inv)]}


_PROGRAMS: Dict[str, Callable] = {
    "zero_packed": _zero_packed,
    "tp_block": _tp_block,
    "pp_fwd_bwd": _pp_fwd_bwd,
    "ep_fwd_bwd": _ep_fwd_bwd,
    "fsdp_scan": _fsdp_scan,
    "ring_fwd": lambda dev: _ring(dev, False, False),
    "ring_fwd_bwd": lambda dev: _ring(dev, False, True),
    "flash_ring_fwd": lambda dev: _ring(dev, True, False),
    "flash_ring_fwd_bwd": lambda dev: _ring(dev, True, True),
}

#: every contract's name, in the reference test file's order
CONTRACTS: List[str] = list(_PROGRAMS)


def run_contract(name: str, device="cpu") -> Dict:
    """Run contract ``name`` on ``device``: ``{"name", "counts", "expected",
    "findings", "inv"}``; an empty ``findings`` list is a pass."""
    row = _PROGRAMS[name](torch.device(device))
    row["name"] = name
    row["counts"] = dict(row["inv"].counts())
    return row
