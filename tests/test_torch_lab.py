"""Port twin of ``tests/test_lab.py``: the same cases against
``bluefog_tpu_torch.lab`` (the np=4 e2e stays slow, as in the reference;
the family case runs the port's fixture corpus, and also seeds its three
lab corruptions inline against both packages), then the
cross-package cases: the port's ``ConvergenceProbe`` gives the
reference's trail on fixed push-sum sequences (f64, f32, push-sum
weights, batched flushes, sample caps, and a bf16 island window's
two-byte layout against ml_dtypes), the fits agree, ``recommend`` agrees
over the frozen artifact's whole map and beyond it, the sweep's sim
oracle agrees, and ``BFTPU_LAB_AUTO_TOPOLOGY`` picks the reference's
launch topology.

Convergence observatory (docs/OBSERVABILITY.md "Convergence
observatory").

Unit level: the probe's exact per-round consensus-error values on a
fake-clock 4-rank ring (pinned against the hand-computed ``(W-I)W^t``
iterates), batched-flush equivalence, debiasing, sample-cap and
shape-change behavior; the contraction/power-law/Spearman fits; the
recommender's determinism over the frozen ``LAB_r01.json``; the sim
oracle's digest stability under consensus tracing; and the ``lab``
analysis family with its seeded-bug fixtures.

E2E level (np=4, slow): a live ring fleet with the probe, status page,
and telemetry on — the status-page CONV word must converge
monotonically post-warmup and every sampled value must match the
telemetry journal's ``conv`` trail, which in turn must match the
workers' own probe histories.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.introspect import statuspage as sp
from bluefog_tpu_torch.lab.fit import (fit_contraction, fit_power_law,
                                 predict_power_law, spearman)
from bluefog_tpu_torch.lab.probe import ConvergenceProbe
from bluefog_tpu_torch.native import shm_native

# ---------------------------------------------------------------------------
# probe: exact pinned values on the synchronous 4-rank ring
# ---------------------------------------------------------------------------

#: Ring-4 mixing matrix (uniform 1/3 self+neighbors), |lambda_2| = 1/3.
_W_RING4 = np.array([[1, 1, 0, 1], [1, 1, 1, 0],
                     [0, 1, 1, 1], [1, 0, 1, 1]], dtype=np.float64) / 3.0


def test_probe_pins_ring4_iterates_exactly():
    """Drive the x <- Wx iterate by hand (the fake clock: no transport,
    no processes) and pin every rank's probe output against the closed
    form: e_r(t) = |((W - I) W^{t-1} x0)_r|, geometric at rate 1/3."""
    x = np.array([0.0, 1.0, 2.0, 3.0])
    probes = [ConvergenceProbe() for _ in range(4)]
    errs = []
    for _ in range(4):
        errs.append([probes[r].observe(np.array([x[r]])) for r in range(4)])
        x = _W_RING4 @ x
    assert all(math.isnan(e) for e in errs[0]), \
        "round 1 has no predecessor: all ranks must report NaN"
    assert errs[1] == pytest.approx([4 / 3, 0.0, 0.0, 4 / 3], abs=1e-15)
    assert errs[2] == pytest.approx([0.0, 4 / 9, 4 / 9, 0.0], abs=1e-15)
    assert errs[3] == pytest.approx([4 / 27, 0.0, 0.0, 4 / 27], abs=1e-15)


def test_probe_fit_recovers_ring4_contraction():
    """An asymmetric initial vector (no zero errors) fitted over 20
    rounds must recover rho = |lambda_2| = 1/3 to float precision."""
    x = np.array([0.0, 1.0, 3.0, 7.0])
    probe = ConvergenceProbe()
    for _ in range(20):
        probe.observe(np.array([x[0]]))
        x = _W_RING4 @ x
    fit = fit_contraction(probe.history)
    assert fit["points"] >= 10
    # the per-rank series mixes the lambda = +1/3 and -1/3 modes, so a
    # finite-series fit lands within ~1% of the asymptote, not on it
    assert fit["rho"] == pytest.approx(1 / 3, rel=0.05)
    assert fit["rate"] == pytest.approx(2 / 3, rel=0.05)
    assert fit["r2"] > 0.97


def test_probe_batched_flush_matches_exact():
    """flush_every=K defers the math, not the answer: identical
    (round, err) history as the exact per-round probe."""
    rng = np.random.default_rng(11)
    seq = [rng.normal(size=500) for _ in range(17)]
    exact = ConvergenceProbe(sample_cap=64, flush_every=1)
    batched = ConvergenceProbe(sample_cap=64, flush_every=8)
    for s in seq:
        exact.observe(s)
        batched.observe(s)
    batched.flush_pending()  # 17 = 2*8 + 1 straggler
    assert len(batched.history) == len(exact.history) == len(seq)
    for (tb, eb), (te, ee) in zip(batched.history, exact.history):
        assert tb == te
        assert eb == pytest.approx(ee, rel=1e-12) or (
            math.isnan(eb) and math.isnan(ee))
    assert batched.last_round == exact.last_round == len(seq)


def test_probe_debias_divides_by_push_sum_weight():
    a = ConvergenceProbe()
    b = ConvergenceProbe()
    x, y = np.array([2.0, 4.0]), np.array([3.0, 9.0])
    a.observe(x, p=2.0)
    b.observe(x / 2.0)
    assert a.observe(y, p=3.0) == pytest.approx(b.observe(y / 3.0))


def test_probe_sample_cap_and_shape_change():
    probe = ConvergenceProbe(sample_cap=8)
    big = np.arange(100, dtype=np.float64)
    assert math.isnan(probe.observe(big))
    assert probe.observe(big + 0.5) == pytest.approx(0.5)
    # shape change rebuilds the sample: no predecessor again
    assert math.isnan(probe.observe(np.arange(50, dtype=np.float64)))
    # negative-side deviations count toward the inf-norm
    q = ConvergenceProbe()
    q.observe(np.array([1.0, -2.0]))
    assert q.observe(np.array([0.0, -8.0])) == pytest.approx(6.0)


def test_probe_non_float_tensor_uses_cold_cast_path():
    probe = ConvergenceProbe(sample_cap=4)
    probe.observe(np.arange(10))
    assert probe.observe(np.arange(10) * 2) == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# fits: contraction, power law, Spearman
# ---------------------------------------------------------------------------


def test_fit_contraction_recovers_geometric_series():
    rho = 0.42
    series = [(t, 3.0 * rho ** t) for t in range(1, 15)]
    fit = fit_contraction(series)
    assert fit["rho"] == pytest.approx(rho, rel=1e-9)
    assert fit["r2"] == pytest.approx(1.0)


def test_fit_contraction_underdetermined_falls_back_to_rate_one():
    fit = fit_contraction([(1, 0.5), (2, 0.1)])
    assert (fit["rho"], fit["rate"], fit["points"]) == (0.0, 1.0, 0)
    # NaN / zero / sub-floor points are dropped, not fitted
    fit = fit_contraction([(3, float("nan")), (4, 0.0), (5, 1e-20)])
    assert fit["points"] == 0 and fit["rate"] == 1.0


def test_power_law_roundtrip():
    a, b = -0.7, -1.3
    ns = [4, 8, 16, 32]
    rates = [math.exp(a + b * math.log(n)) for n in ns]
    fit = fit_power_law(ns, rates)
    assert fit["a"] == pytest.approx(a, rel=1e-9)
    assert fit["b"] == pytest.approx(b, rel=1e-9)
    for n in (6, 64):
        assert predict_power_law(fit, n) == pytest.approx(
            math.exp(a + b * math.log(n)), rel=1e-9)


def test_spearman_rank_correlation():
    assert spearman([1, 2, 3, 4], [10, 20, 30, 40]) == pytest.approx(1.0)
    assert spearman([1, 2, 3, 4], [4, 3, 2, 1]) == pytest.approx(-1.0)
    assert spearman([1, 2], []) == 0.0
    assert spearman([1, 1, 1], [1, 2, 3]) == 0.0  # degenerate: no variance


# ---------------------------------------------------------------------------
# status page v3: the convergence word
# ---------------------------------------------------------------------------


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(shm_native, "_FALLBACK_DIR", str(tmp_path))
    return tmp_path


def test_status_page_conv_roundtrip(shm_dir):
    page = sp.StatusPage("cv", 0)
    try:
        page.publish(nranks=4, step=3, epoch=0, op_id=3,
                     conv_err=0.125, conv_round=7)
        got = sp.read_status_page(sp.status_page_path("cv", 0))
        assert got["conv"] == {"err": 0.125, "round": 7}
        # defaults: probe off
        page.publish(nranks=4, step=4, epoch=0, op_id=4)
        got = sp.read_status_page(sp.status_page_path("cv", 0))
        assert got["conv"]["round"] == -1
        # a NaN first-round sample sanitizes to -1.0 (strict JSON)
        page.publish(nranks=4, step=5, epoch=0, op_id=5,
                     conv_err=float("nan"), conv_round=1)
        got = sp.read_status_page(sp.status_page_path("cv", 0))
        assert got["conv"] == {"err": -1.0, "round": 1}
    finally:
        page.close(unlink=True)


# ---------------------------------------------------------------------------
# recommender: deterministic over the frozen artifact
# ---------------------------------------------------------------------------


def test_recommend_matches_frozen_artifact_map():
    from bluefog_tpu_torch.lab.recommend import load_artifact, recommend

    art = load_artifact()
    assert art["recommended"], "frozen artifact carries no recommendations"
    for key, stored in art["recommended"].items():
        n, pb = (int(v) for v in key.split(":"))
        got = recommend(n, pb, artifact=art)
        assert got["topology"] == stored["topology"], key
        assert got["source"] == stored["source"], key
        assert got["degree"] == stored["degree"], key
        assert got["score"] == pytest.approx(stored["score"]), key
        assert got == recommend(n, pb, artifact=art), \
            "recommend() must be deterministic call-to-call"


def test_recommend_rejects_degenerate_inputs():
    from bluefog_tpu_torch.lab.recommend import load_artifact, recommend

    with pytest.raises(ValueError):
        recommend(1)
    with pytest.raises(ValueError):
        recommend(0, artifact=load_artifact())


# ---------------------------------------------------------------------------
# sim oracle: consensus tracing is observation, not perturbation
# ---------------------------------------------------------------------------


def test_sim_digest_unchanged_by_consensus_trace():
    from bluefog_tpu_torch.sim.campaign import SimConfig, run_campaign

    base = dict(ranks=4, rounds=12, quiesce_rounds=0, seed=3,
                topology="ring", faults=(), adaptive=False,
                consensus_tol=1e9, lockstep=True)
    off = run_campaign(SimConfig(trace_consensus=False, **base))
    on = run_campaign(SimConfig(trace_consensus=True, **base))
    assert off.digest == on.digest, \
        "tracing the consensus error must not perturb the campaign"
    assert not off.consensus_trace
    assert on.consensus_trace
    series = sorted({t for t, _, _ in on.consensus_trace})
    assert len(series) >= 10


def test_sweep_oracle_fit_matches_ring4_gap():
    """The lockstep sim replay of a ring-4 cell must fit the analytic
    contraction: rate = 1 - |lambda_2| = 2/3 (the fit tolerates the
    finite series, hence the loose band)."""
    from bluefog_tpu_torch.lab.sweep import sim_cell, spectral_gap_of

    got = sim_cell("ring", 4, rounds=20, seed=0)
    assert got["sim_ok"]
    gap = spectral_gap_of("ring", 4)
    assert gap == pytest.approx(2 / 3, rel=1e-9)
    assert got["sim_rate"] == pytest.approx(gap, abs=0.1)


# ---------------------------------------------------------------------------
# analysis family + fixtures
# ---------------------------------------------------------------------------


def _seeded_lab_corruptions(lab_rules, TOPOLOGIES, art):
    """The reference fixture corpus's three lab bugs
    (``lab-corrupted-fit``, ``lab-tampered-rate``,
    ``lab-recommendation-contradicts-corpus``), applied to copies of
    ``art`` and checked by ``lab_rules``."""
    import copy

    out = {}
    a = copy.deepcopy(art)
    topo = sorted(a["fits"])[0]
    a["fits"][topo]["b"] = 0.5  # rates grow ~ n^0.5: impossible
    out["lab-corrupted-fit"] = lab_rules.check_fit_monotonicity(
        a, f"LAB[{topo}-growing-law]")
    a = copy.deepcopy(art)
    cell = a["cells"][0]
    cell["rate"] = min(1.0, float(cell["rate"]) * 0.5 + 0.25)
    out["lab-tampered-rate"] = lab_rules.check_cell_refit(a, "LAB[tampered-rate]")
    a = copy.deepcopy(art)
    key = sorted(a["recommended"])[0]
    stored = a["recommended"][key]
    stored["topology"] = next(t for t in sorted(TOPOLOGIES)
                              if t != stored["topology"])
    out["lab-recommendation-contradicts-corpus"] = \
        lab_rules.check_recommendation_consistency(a, "LAB[swapped-recommendation]")
    return out


def test_lab_rule_family_and_seeded_corruptions():
    from bluefog_tpu_torch import analysis
    from bluefog_tpu_torch.analysis import lab_rules
    from bluefog_tpu_torch.lab.recommend import TOPOLOGIES, load_artifact

    report = analysis.run(families=["lab"])
    assert report.ok, [str(f) for f in report.findings[:10]]
    for name, findings in _seeded_lab_corruptions(lab_rules, TOPOLOGIES,
                                                  load_artifact()).items():
        assert findings, f"seeded bug {name} was not caught"


def test_lab_rule_family_and_fixtures():
    from bluefog_tpu_torch import analysis
    from bluefog_tpu_torch.analysis import fixtures as afx

    report = analysis.run(families=["lab"])
    assert report.ok, [str(f) for f in report.findings[:10]]
    for name in ("lab-corrupted-fit", "lab-tampered-rate",
                 "lab-recommendation-contradicts-corpus"):
        findings = afx.run_fixture(name)
        assert findings, f"seeded bug {name} was not caught"


def test_frozen_artifact_passes_checks():
    from bluefog_tpu_torch.analysis.lab_rules import Severity, check_artifact
    from bluefog_tpu_torch.lab.recommend import load_artifact

    art = load_artifact()
    errors = [f for f in check_artifact(art)
              if f.severity == Severity.ERROR]
    assert not errors, [str(f) for f in errors]


# ---------------------------------------------------------------------------
# np=4 e2e: live fleet — status-page CONV vs telemetry journal vs probes
# ---------------------------------------------------------------------------


def _worker_lab_e2e(rank, size):
    """Lockstep ring-4 push of an asymmetric scalar iterate (no zero
    errors: every round's envelope strictly contracts at 1/3) with the
    probe, status page, and telemetry journal all on."""
    from bluefog_tpu_torch import topology_util as tu

    topo = tu.RingGraph(size)
    islands.set_topology(topo)
    sw, nw = tu.GetRecvWeights(topo, rank)
    x0 = [0.0, 1.0, 3.0, 7.0][rank]
    x = np.full(64, x0, dtype=np.float64)
    islands.win_create(x, "cv")
    for _ in range(30):
        islands.win_put(islands.win_sync("cv"), "cv")
        islands.barrier()
        islands.win_update("cv", self_weight=sw, neighbor_weights=nw)
        islands.barrier()
        time.sleep(0.005)  # give the attached page poller sampling room
    hist = islands.win_conv_history("cv")
    islands.win_free("cv")
    return (rank, hist)


def _poll_conv_pages(job, nranks, out, stop_evt):
    while not stop_evt.is_set():
        for r in range(nranks):
            try:
                got = sp.read_status_page(sp.status_page_path(job, r))
            except (OSError, ValueError, sp.TornPageError):
                continue
            conv = got.get("conv", {})
            if conv.get("round", -1) > 0:
                out.append((r, conv["round"], conv["err"]))
        time.sleep(0.02)


@pytest.mark.slow
def test_lab_probe_e2e_statuspage_matches_journal_np4(
        monkeypatch, tmp_path):
    job = f"lab{os.getpid()}"
    monkeypatch.setenv("BFTPU_LAB_PROBE", "1")
    monkeypatch.setenv("BFTPU_LAB_FLUSH", "4")
    monkeypatch.setenv("BFTPU_STATUSPAGE", "1")
    monkeypatch.setenv("BFTPU_TELEMETRY", str(tmp_path))
    samples, stop_evt = [], threading.Event()
    poller = threading.Thread(
        target=_poll_conv_pages, args=(job, 4, samples, stop_evt),
        daemon=True)
    poller.start()
    try:
        res = islands.spawn(_worker_lab_e2e, 4, job=job, timeout=240.0)
    finally:
        stop_evt.set()
        poller.join(timeout=30)
        shm_native.unlink_all(job, ["cv"])

    # (1) every rank's probe history: 30 rounds, NaN first, then the
    # fleet envelope max_r e_r(t) decreases monotonically post-warmup
    hists = dict(res)
    assert set(hists) == {0, 1, 2, 3}
    envelope = {}
    for rank, hist in hists.items():
        assert [t for t, _ in hist] == list(range(1, 31))
        assert math.isnan(hist[0][1])
        for t, e in hist[1:]:
            assert e >= 0.0
            envelope[t] = max(envelope.get(t, 0.0), e)
    env = [envelope[t] for t in sorted(envelope)]
    assert len(env) == 29
    for prev, cur in zip(env[2:], env[3:]):
        assert cur <= prev + 1e-12, \
            f"fleet consensus-error envelope not monotone: {env}"
    assert env[-1] < env[2] * 1e-3, "envelope never actually contracted"

    # (2) the telemetry journal's conv trail IS the probe history
    import glob

    from bluefog_tpu_torch.telemetry.registry import read_journal

    trails = {r: [] for r in range(4)}
    files = sorted(glob.glob(os.path.join(str(tmp_path), "*.events.jsonl*")))
    assert files, "the workers journaled nothing"
    for p in files:
        events, bad = read_journal(p)
        assert bad == 0, p
        for e in events:
            if e.get("event") == "conv":
                trails[int(e["rank"])].append((e["round"], e["err"]))
    for rank in range(4):
        trail = sorted(trails[rank])
        expect = [(t, e) for t, e in hists[rank][1:]]  # NaN never journaled
        assert [t for t, _ in trail] == [t for t, _ in expect], rank
        for (tj, ej), (th, eh) in zip(trail, expect):
            assert ej == pytest.approx(eh, rel=1e-9), (rank, tj)

    # (3) every status-page CONV sample the poller caught matches that
    # rank's journaled value for the same round
    assert samples, "the poller never saw a live CONV word"
    by_rank = {r: dict(h) for r, h in hists.items()}
    for rank, rnd, err in samples:
        assert rnd in by_rank[rank], (rank, rnd)
        want = by_rank[rank][rnd]
        if math.isnan(want):
            assert err == -1.0
        else:
            assert err == pytest.approx(want, rel=1e-6), (rank, rnd)



# ---------------------------------------------------------------------------
# cross-package: the JAX package's lab is the reference
# ---------------------------------------------------------------------------

import importlib  # noqa: E402

import ml_dtypes  # noqa: E402

from bluefog_tpu.analysis import lab_rules as ref_lab_rules  # noqa: E402
from bluefog_tpu.lab import fit as ref_fit  # noqa: E402
from bluefog_tpu.lab import probe as ref_probe  # noqa: E402
from bluefog_tpu_torch.lab import fit as port_fit  # noqa: E402
from bluefog_tpu_torch.lab import probe as port_probe  # noqa: E402
# each package's lab re-exports a function of the module's own name
ref_recommend = importlib.import_module("bluefog_tpu.lab.recommend")
port_recommend = importlib.import_module("bluefog_tpu_torch.lab.recommend")
from bluefog_tpu_torch.progress import staging  # noqa: E402


def _pushsum_sequence(seed, n, rounds, dtype):
    """A fixed push-sum sequence of one rank: the tensor after each
    combine and its weight p, contracting toward a common value."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 10.0
    target = rng.normal()
    p = 1.0
    out = []
    for t in range(rounds):
        mix = 0.6 + 0.3 * rng.random()
        x = mix * x + (1 - mix) * target * p + rng.normal(size=n) * 1e-3 * 0.7 ** t
        p = 0.5 + rng.random()
        out.append((x.astype(dtype), p))
    return out


def _trail(mod, seq, use_p, **kw):
    pr = mod.ConvergenceProbe(**kw)
    got = [pr.observe(x, p if use_p else 1.0) for x, p in seq]
    pr.flush_pending()
    return got, pr.history, (pr.rounds, pr.last_round, pr.last_err)


def _same_floats(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (math.isnan(x) and math.isnan(y)) or x == y, (x, y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kw", [{}, {"flush_every": 8}, {"flush_every": 3},
                                {"sample_cap": 300, "flush_every": 4},
                                {"sample_cap": 5000}])
@pytest.mark.parametrize("use_p", [False, True])
def test_probe_trail_matches_reference(dtype, kw, use_p):
    seq = _pushsum_sequence(7, 4096, 30, dtype)
    a = _trail(ref_probe, seq, use_p, **kw)
    b = _trail(port_probe, seq, use_p, **kw)
    _same_floats(a[0], b[0])
    assert [t for t, _ in a[1]] == [t for t, _ in b[1]]
    _same_floats([e for _, e in a[1]], [e for _, e in b[1]])
    assert a[2][:2] == b[2][:2]


@pytest.mark.parametrize("kw", [{}, {"flush_every": 8}, {"sample_cap": 300}])
def test_probe_reads_a_bf16_window_as_the_reference_reads_ml_dtypes(kw):
    """A bf16 island window holds the two-byte layout of
    ``staging.BF16``; the probe decodes it, and its trail equals the
    reference's over the same values as an ml_dtypes bfloat16 array."""
    seq = _pushsum_sequence(3, 2048, 20, np.float32)
    ref_seq = [(x.astype(ml_dtypes.bfloat16), p) for x, p in seq]
    port_seq = [(np.ascontiguousarray(rx.view(np.uint16)).view(staging.BF16), p)
                for rx, p in ref_seq]
    a = _trail(ref_probe, ref_seq, True, **kw)
    b = _trail(port_probe, port_seq, True, **kw)
    _same_floats(a[0], b[0])
    _same_floats([e for _, e in a[1]], [e for _, e in b[1]])
    assert any(e > 0 for _, e in b[1][1:])


def test_fits_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        rate = float(rng.uniform(0.05, 0.9))
        t = np.arange(1, 40)
        errs = list((1 - rate) ** t * float(rng.uniform(0.5, 5))
                    * np.exp(rng.normal(size=t.size) * 0.05))
        series = list(zip(t.tolist(), errs))
        assert port_fit.fit_contraction(series) == ref_fit.fit_contraction(series)
        ns = [4, 8, 16, 32, 64]
        rates = [float(rng.uniform(0.1, 0.9)) * n ** -0.7 for n in ns]
        law = ref_fit.fit_power_law(ns, rates)
        assert port_fit.fit_power_law(ns, rates) == law
        assert port_fit.predict_power_law(law, 128) == ref_fit.predict_power_law(law, 128)
        xs, ys = rng.normal(size=12).tolist(), rng.normal(size=12).tolist()
        assert port_fit.spearman(xs, ys) == ref_fit.spearman(xs, ys)


def test_recommend_matches_reference_over_the_frozen_map_and_beyond():
    """The frozen artifact is byte-equal in both packages, and
    ``recommend`` gives the reference's answer at every key of its map
    and on a grid of sizes and payloads around it."""
    with open(port_recommend.default_artifact_path(), "rb") as f, \
            open(ref_recommend.default_artifact_path(), "rb") as g:
        assert f.read() == g.read()
    art = port_recommend.load_artifact()
    keys = [tuple(int(v) for v in k.split(":")) for k in art["recommended"]]
    grid = [(n, pb) for n in (2, 3, 5, 8, 12, 16, 24, 33, 64, 100, 256)
            for pb in (1, 1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 28)]
    for n, pb in keys + grid:
        assert port_recommend.recommend(n, pb) == ref_recommend.recommend(n, pb), (n, pb)
    for name in sorted(port_recommend.TOPOLOGIES):
        for n in (4, 9, 16):
            assert port_recommend.topology_degree(name, n) \
                == ref_recommend.topology_degree(name, n)


def test_frozen_artifact_checks_and_seeded_corruptions_match_reference():
    from bluefog_tpu_torch.analysis import lab_rules as port_lab_rules

    art = port_recommend.load_artifact()

    def rows(findings):
        return [(f.rule, f.subject, f.message, f.severity) for f in findings]

    assert rows(port_lab_rules.check_artifact(art)) \
        == rows(ref_lab_rules.check_artifact(ref_recommend.load_artifact()))
    a = _seeded_lab_corruptions(port_lab_rules, port_recommend.TOPOLOGIES, art)
    b = _seeded_lab_corruptions(ref_lab_rules, ref_recommend.TOPOLOGIES,
                                ref_recommend.load_artifact())
    assert {k: rows(v) for k, v in a.items()} == {k: rows(v) for k, v in b.items()}


def test_sweep_sim_cell_matches_reference():
    from bluefog_tpu.lab import sweep as ref_sweep
    from bluefog_tpu_torch.lab import sweep as port_sweep

    for topo, n in (("ring", 4), ("exp2", 8), ("star", 5)):
        assert port_sweep.sim_cell(topo, n, rounds=20, seed=0) \
            == ref_sweep.sim_cell(topo, n, rounds=20, seed=0)
        assert port_sweep.spectral_gap_of(topo, n) == ref_sweep.spectral_gap_of(topo, n)


def test_auto_topology_matches_reference(monkeypatch):
    """``BFTPU_LAB_AUTO_TOPOLOGY=1``: the launch topology is the lab's
    recommendation, the reference's edge for edge; a bad payload falls
    back to exp2 in both."""
    from bluefog_tpu import islands as ref_islands

    monkeypatch.setenv("BFTPU_LAB_AUTO_TOPOLOGY", "1")
    for payload in ("1", "1048576", "268435456", "not-a-number"):
        monkeypatch.setenv("BFTPU_LAB_PAYLOAD_BYTES", payload)
        for n in (1, 2, 4, 8, 16, 33):
            got = islands._default_topology(n)
            want = ref_islands._default_topology(n)
            assert list(got.nodes) == list(want.nodes)
            assert got.edges(data=True) == list(want.edges(data=True)), (payload, n)


def test_sweep_cell_on_live_islands_matches_reference():
    """One sweep cell on a live 4-island fleet (lockstep push-sum with the
    probe on) through each package: the same per-round series, so the
    same measured rate, and the same verdict against the sim oracle."""
    from bluefog_tpu.lab import sweep as ref_sweep
    from bluefog_tpu_torch.lab import sweep as port_sweep

    ref = ref_sweep.sweep_cell("ring", 4, rounds=20, seed=5)
    port = port_sweep.sweep_cell("ring", 4, rounds=20, seed=5)
    assert port == ref
    sim = port_sweep.sim_cell("ring", 4, rounds=20, seed=5)
    assert port_sweep.diff_cell({**port, **sim}) == ref_sweep.diff_cell({**ref, **sim})
