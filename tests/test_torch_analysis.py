"""Port twin of ``tests/test_analysis.py``: plan rules, protocol models,
the epoch lint, the fixture corpus and the CLI gate of
``bluefog_tpu_torch.analysis``, each case beside the reference's answer on
the same subject where one exists (the JAX package on the CPU).

The reference's live epoch trace runs its window ops on a JAX mesh; here
the same sequence runs on the port's rank-major windows (8 ranks, local
size 2) on the CPU.  The CLI's collective family (the reference's hlo
family) runs on the card by default; the CLI cases pass ``--device cpu``
where they run it.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from bluefog_tpu import topology_util as ref_tu
from bluefog_tpu.analysis import epoch_rules as ref_epoch
from bluefog_tpu.analysis import fixtures as ref_fixtures
from bluefog_tpu.analysis import plan_rules as ref_plan_rules
from bluefog_tpu.analysis import seqlock_model as ref_seqlock
from bluefog_tpu.core.plan import compile_plan as ref_compile_plan

from bluefog_tpu_torch import topology_util as tu
from bluefog_tpu_torch.analysis import (
    Severity,
    epoch_rules,
    fixtures,
    plan_rules,
    registry,
    seqlock_model,
)
from bluefog_tpu_torch.core.plan import compile_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _findings(fs):
    """Findings as dicts, the package name normalised: the env and
    capability lints name the files they read, which are the port's."""
    return [{k: str(v).replace("bluefog_tpu_torch", "bluefog_tpu")
             for k, v in dataclasses.asdict(f).items()} for f in fs]


# ---------------------------------------------------------------------------
# plan family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(plan_rules.CORPUS_TOPOLOGIES))
@pytest.mark.parametrize("n", [2, 5, 8, 16, 63])
def test_seed_plans_pass_all_plan_rules(name, n):
    topo = plan_rules.CORPUS_TOPOLOGIES[name](n)
    plan = compile_plan(topo)
    report = plan_rules.check_plan(plan, topo, f"{name}@{n}")
    assert report.ok, report.summary() + "\n" + "\n".join(
        str(f) for f in report.findings)
    ref_topo = ref_plan_rules.CORPUS_TOPOLOGIES[name](n)
    ref = ref_plan_rules.check_plan(ref_compile_plan(ref_topo), ref_topo, f"{name}@{n}")
    assert report.to_dict() == ref.to_dict()


def test_spectral_gap_matches_eig_by_hand():
    # ring@4 with uniform 1/3 weights: W = circulant(1/3,1/3,0,1/3),
    # eigvals {1, 1/3, -1/3, 1/3} -> gap = 2/3
    plan = compile_plan(tu.RingGraph(4))
    gap = plan_rules.spectral_gap(plan.mixing_matrix())
    assert abs(gap - 2.0 / 3.0) < 1e-9
    assert gap == ref_plan_rules.spectral_gap(
        ref_compile_plan(ref_tu.RingGraph(4)).mixing_matrix())


def test_dynamic_one_peer_steps_are_single_class():
    report = registry.run(families=["plan"])
    assert report.ok, "\n".join(str(f) for f in report.errors())
    # the corpus metric must be present and positive for every family
    gaps = {k: v for k, v in report.metrics.items()
            if k.startswith("plan.min_spectral_gap/")}
    assert set(gaps) == {
        f"plan.min_spectral_gap/{fam}" for fam in plan_rules.CORPUS_TOPOLOGIES}
    assert all(v > 0 for v in gaps.values()), gaps


def test_mixing_matrix_row_sum_rule_fires_on_tamper():
    findings = fixtures.run_fixture("plan-tampered-weights")
    assert findings and all(f.rule == "plan.mixing-stochastic"
                            for f in findings)
    assert _findings(findings) == _findings(
        ref_fixtures.run_fixture("plan-tampered-weights"))


# ---------------------------------------------------------------------------
# protocol family: the models accept the real protocol, reject seeded bugs
# ---------------------------------------------------------------------------


def test_real_seqlock_has_no_torn_reads():
    for n_writers, deposits in ((1, 2), (2, 1), (2, 2)):
        m = seqlock_model.seqlock_model(n_writers=n_writers,
                                        deposits=deposits)
        assert seqlock_model.explore(m) == []


def test_seqlock_model_matches_native_spec():
    """The model's writer program is asserted against the PORT's
    shm_native.SEQLOCK_WRITER_STEPS at build time — the constants of the
    mailbox the port runs — and those equal the reference's."""
    from bluefog_tpu.native import shm_native as ref_shm
    from bluefog_tpu_torch.native import shm_native

    assert seqlock_model.SEQLOCK_WRITER_STEPS is shm_native.SEQLOCK_WRITER_STEPS
    assert shm_native.SEQLOCK_WRITER_STEPS == ref_shm.SEQLOCK_WRITER_STEPS
    seqlock_model.seqlock_model(1, 1)  # assertion lives in the model constructor


@pytest.mark.parametrize("fixture", [
    "seqlock-skip-odd-phase",
    "seqlock-publish-before-payload",
    "seqlock-no-writer-lock",
])
def test_broken_seqlock_variants_produce_torn_reads(fixture):
    findings = fixtures.run_fixture(fixture)
    assert findings and any("torn read" in f.message for f in findings)
    assert _findings(findings) == _findings(ref_fixtures.run_fixture(fixture))


def test_collect_conserves_mass_and_split_variant_loses_it():
    assert seqlock_model.explore(seqlock_model.collect_model(3)) == []
    bad = seqlock_model.explore(
        seqlock_model.collect_model(2, atomic_collect=False))
    assert bad and any("lost deposit" in v for v in bad)
    assert bad == ref_seqlock.explore(
        ref_seqlock.collect_model(2, atomic_collect=False))


def test_barrier_never_deadlocks_and_bugged_order_does():
    assert seqlock_model.explore(seqlock_model.barrier_model(3, 2)) == []
    bad = seqlock_model.explore(
        seqlock_model.barrier_model(2, 2, reset_before_release=False))
    assert bad and any("deadlock" in v for v in bad)
    assert bad == ref_seqlock.explore(
        ref_seqlock.barrier_model(2, 2, reset_before_release=False))


# ---------------------------------------------------------------------------
# epoch family
# ---------------------------------------------------------------------------


def test_canonical_window_traces_pass():
    assert epoch_rules.CANONICAL_TRACES == ref_epoch.CANONICAL_TRACES
    for label, trace in epoch_rules.CANONICAL_TRACES.items():
        findings = epoch_rules.check_trace(trace, subject=label)
        assert findings == [], (label, [str(f) for f in findings])


def test_use_after_free_and_get_clobber_fire():
    for name in ("epoch-use-after-free", "epoch-get-clobbers-put"):
        findings = fixtures.run_fixture(name)
        assert findings and findings[0].severity == Severity.ERROR, name
        assert _findings(findings) == _findings(ref_fixtures.run_fixture(name))


def test_put_after_accumulate_warns():
    trace = [("win_create", "w"), ("win_accumulate", "w"), ("win_put", "w"),
             ("win_update", "w")]
    findings = epoch_rules.check_trace(trace)
    assert len(findings) == 1
    assert findings[0].severity == Severity.WARNING
    assert "discards the accumulated" in findings[0].message
    assert _findings(findings) == _findings(ref_epoch.check_trace(trace))


def test_recorded_live_trace_passes_epoch_lint():
    """End-to-end: record a REAL win-op session via windows.record_win_ops
    on the port's windows and lint the trace — the runtime's own idiom
    must satisfy the rules it is checked against."""
    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import windows

    bf.init(tu.ExponentialTwoGraph(8), size=8, local_size=2, device="cpu")
    try:
        x = torch.zeros((8, 4))
        with windows.record_win_ops() as trace:
            bf.win_create(x, "lint_me")
            bf.win_accumulate(x, "lint_me")
            bf.win_update_then_collect("lint_me")
            bf.win_put(x, "lint_me")
            bf.win_update("lint_me")
            bf.win_free("lint_me")
        assert ("win_create", "lint_me") in trace
        assert epoch_rules.check_trace(trace, "live-session") == []
    finally:
        bf.win_free()
        bf.shutdown()


# ---------------------------------------------------------------------------
# fixture corpus + CLI gate
# ---------------------------------------------------------------------------

#: the reference's hlo fixtures are the port's collective fixtures
_FIXTURE_NAMES = {"hlo-injected-all-gather": "collective-injected-all-gather",
                  "hlo-replicated-large-buffer": "collective-replicated-large-buffer"}


def test_fixture_corpus_is_the_reference_corpus():
    assert list(fixtures.FIXTURES) == [
        _FIXTURE_NAMES.get(n, n) for n in ref_fixtures.FIXTURES]


@pytest.mark.parametrize("name", list(fixtures.FIXTURES))
def test_every_fixture_fires_as_the_reference_fixture(name):
    """Every seeded bug is caught; outside the collective pair (whose
    program is a torch inventory, not HLO text) with the reference's
    findings, rule for rule and message for message."""
    findings = fixtures.run_fixture(name)
    assert findings, f"seeded bug never caught: {name}"
    ref_name = {v: k for k, v in _FIXTURE_NAMES.items()}.get(name)
    if ref_name is None:
        assert _findings(findings) == _findings(ref_fixtures.run_fixture(name))
    else:
        got = sorted({f.rule.replace("collective.", "hlo.") for f in findings})
        want = sorted({f.rule for f in ref_fixtures.run_fixture(ref_name)})
        assert got == want


def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=400, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_gate_passes_on_seed_corpus():
    """The CI gate: CLI exits 0 over the default (non-collective) corpus,
    with every family's seconds, and imports no JAX."""
    proc = _run_cli("--no-hlo", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    payload = json.loads(proc.stdout)
    assert payload["ok"] and payload["subjects_checked"] > 400
    assert "collective" not in payload["family_seconds"]
    assert set(payload["family_seconds"]) == set(registry.families()) - {"collective"}


def test_cli_collective_family_on_the_cpu():
    """--family collective with --device cpu runs the corpus here; the
    default device is the card, which a host without one lacks: an error, not a
    pass."""
    proc = _run_cli("--family", "collective", "--device", "cpu", "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert json.loads(proc.stdout)["subjects_checked"] == 5
    import torch

    if not torch.cuda.is_available():
        proc = _run_cli("--family", "collective")
        assert proc.returncode == 1 and "collective.environment" in proc.stdout


def test_cli_exits_nonzero_on_seeded_bug():
    proc = _run_cli("--fixture", "plan-dropped-edge")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "plan.edge-cover" in proc.stdout


def test_cli_self_test_catches_every_seeded_bug():
    proc = _run_cli("--self-test")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "self-test OK" in proc.stdout


def test_cli_changed_only_maps_the_ports_sources():
    proc = _run_cli("--changed-only", "bluefog_tpu_torch/native/wire_codec.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "families ['transport', 'wire']" in proc.stdout
