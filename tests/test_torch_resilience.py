"""``resilience/`` of bluefog_tpu_torch against the JAX package: healing,
join, quorum, degraded steps, the adaptive edge-health machine and the
failure detector run the same scripts on the same graphs and the same
virtual clock, and give equal edge sets, weights, mixing matrices, plans
and state transitions.  The port's ``DiGraph`` stands where the reference
uses ``networkx.DiGraph``, so its connectivity and relabeling helpers are
held against networkx too."""

import networkx as nx
import numpy as np
import pytest

from bluefog_tpu import topology_util as jtu
from bluefog_tpu.resilience import adaptive as jadaptive
from bluefog_tpu.resilience import degraded as jdegraded
from bluefog_tpu.resilience import detector as jdetector
from bluefog_tpu.resilience import healing as jhealing
from bluefog_tpu.resilience import join as jjoin
from bluefog_tpu.resilience import quorum as jquorum
from bluefog_tpu.sim.clock import FakeClock as JFakeClock
from bluefog_tpu_torch import topology_util as ttu
from bluefog_tpu_torch.resilience import adaptive as tadaptive
from bluefog_tpu_torch.resilience import degraded as tdegraded
from bluefog_tpu_torch.resilience import detector as tdetector
from bluefog_tpu_torch.resilience import healing as thealing
from bluefog_tpu_torch.resilience import join as tjoin
from bluefog_tpu_torch.resilience import quorum as tquorum
from bluefog_tpu_torch.sim.clock import FakeClock as TFakeClock

GRAPHS = [("ExponentialTwoGraph", 8), ("RingGraph", 6), ("StarGraph", 5),
          ("MeshGrid2DGraph", 9), ("FullyConnectedGraph", 4),
          ("SymmetricExponentialGraph", 8)]


def _graph_record(G):
    edges = [(int(u), int(v), float(d.get("weight", float("nan"))))
             for u, v, d in G.edges(data=True)]
    return list(G.nodes), edges, dict(G.graph)


def _healed_record(h):
    return (h.survivors, h.dead, h.to_local, h.to_global, h.reconnected,
            h.joined, h.demoted, _graph_record(h.topology))


def _plans_equal(a, b):
    assert a.size == b.size and a.self_weights == b.self_weights
    assert a.in_neighbors == b.in_neighbors and a.out_neighbors == b.out_neighbors
    assert len(a.classes) == len(b.classes)
    for ca, cb in zip(a.classes, b.classes):
        assert ca.perm == cb.perm and ca.recv_weights == cb.recv_weights
        assert ca.recv_mask == cb.recv_mask and ca.send_mask == cb.send_mask


def _random_digraphs(n_graphs=40, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = int(rng.integers(1, 9))
        p = float(rng.uniform(0.05, 0.6))
        edges = [(u, v) for u in range(n) for v in range(n)
                 if u != v and rng.random() < p]
        yield n, edges


@pytest.mark.parametrize("seed", [0, 1])
def test_digraph_connectivity_and_relabel_match_networkx(seed):
    for n, edges in _random_digraphs(seed=seed):
        g, h = ttu.DiGraph(), nx.DiGraph()
        g.add_nodes_from(range(n))
        h.add_nodes_from(range(n))
        for u, v in edges:
            g.add_edge(u, v, weight=u + 0.5 * v)
            h.add_edge(u, v, weight=u + 0.5 * v)
        assert ttu.is_strongly_connected(g) == nx.is_strongly_connected(h)
        keep = list(range(0, n, 2))
        assert (ttu.is_strongly_connected(g.subgraph(keep))
                == nx.is_strongly_connected(h.subgraph(keep))) if keep else True
        mapping = {v: (v * 3 + 1) % (n + 5) for v in range(n)}
        if len(set(mapping.values())) == n:
            gr, hr = ttu.relabel_nodes(g, mapping), nx.relabel_nodes(h, mapping, copy=True)
            assert list(gr.nodes) == list(hr.nodes)
            assert gr.edges(data=True) == list(hr.edges(data=True))
        if edges:
            u, v = edges[0]
            g.remove_edge(u, v)
            h.remove_edge(u, v)
            assert not g.has_edge(u, v) and g.has_edge(*edges[-1]) == h.has_edge(*edges[-1])
            assert list(g.edges) == list(h.edges) and g.number_of_edges() == h.number_of_edges()
    with pytest.raises(ValueError):
        ttu.is_strongly_connected(ttu.DiGraph())
    with pytest.raises(nx.NetworkXPointlessConcept):
        nx.is_strongly_connected(nx.DiGraph())


@pytest.mark.parametrize("seed", [0, 1])
def test_relabel_nodes_copy_keyword_matches_networkx(seed):
    """``relabel_nodes(G, m, copy=True)``, the spelling the simulator's
    fleet uses when it grants a join, against networkx: nodes, edges and
    edge attributes in order, partial mappings included; ``copy=False``
    is refused rather than half-supported."""
    for n, edges in _random_digraphs(seed=seed):
        g, h = ttu.DiGraph(), nx.DiGraph()
        g.add_nodes_from(range(n))
        h.add_nodes_from(range(n))
        for u, v in edges:
            g.add_edge(u, v, weight=u + 0.5 * v, tag=(u, v))
            h.add_edge(u, v, weight=u + 0.5 * v, tag=(u, v))
        g.graph["weighted"] = h.graph["weighted"] = True
        for mapping in ({v: (v * 3 + 1) % (n + 5) for v in range(n)},
                        {v: n + 10 + v for v in range(0, n, 2)},
                        {v: n - 1 - v for v in range(n)}):
            if len(set(mapping.get(v, v) for v in range(n))) != n:
                continue
            gr = ttu.relabel_nodes(g, mapping, copy=True)
            hr = nx.relabel_nodes(h, mapping, copy=True)
            assert list(gr.nodes) == list(hr.nodes)
            assert gr.edges(data=True) == list(hr.edges(data=True))
            assert dict(gr.graph) == dict(hr.graph)
            assert list(g.nodes) == list(range(n))  # the source is untouched
    with pytest.raises(ValueError, match="copy=True"):
        ttu.relabel_nodes(ttu.DiGraph(), {}, copy=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_digraph_copy_matches_networkx(seed):
    """``G.copy()``, which the adaptive fixtures use to add an edge to a
    demoted topology, against networkx: the same nodes, edges, attributes
    and graph dict in order, and a copy that shares nothing mutable with
    its source."""
    for n, edges in _random_digraphs(seed=seed):
        g, h = ttu.DiGraph(), nx.DiGraph()
        g.add_nodes_from(range(n))
        h.add_nodes_from(range(n))
        for u, v in edges:
            g.add_edge(u, v, weight=u + 0.5 * v)
            h.add_edge(u, v, weight=u + 0.5 * v)
        g.graph["demoted_from"] = h.graph["demoted_from"] = (1,)
        gc, hc = g.copy(), h.copy()
        assert list(gc.nodes) == list(hc.nodes)
        assert gc.edges(data=True) == list(hc.edges(data=True))
        assert dict(gc.graph) == dict(hc.graph)
        gc.add_edge(0, n + 1)
        gc.graph["x"] = 1
        if edges:
            u, v = edges[0]
            gc[u][v]["weight"] = -1.0
            assert g[u][v]["weight"] == u + 0.5 * v
        assert n + 1 not in g and "x" not in g.graph


@pytest.mark.parametrize("graph,n", GRAPHS)
def test_heal_grow_demote_match_reference(graph, n):
    tg, jg = getattr(ttu, graph)(n), getattr(jtu, graph)(n)
    cases = [("heal", (n - 1,)), ("heal", (0,)), ("heal", tuple(range(1, n, 2))),
             ("heal", tuple(range(n - 1))), ("grow", (n, n + 1)), ("grow", (n,)),
             ("demote", (1,)), ("demote", (0, n - 1))]
    for op, ranks in cases:
        fn_t = getattr(thealing, f"{op}_topology")
        fn_j = getattr(jhealing, f"{op}_topology")
        got, want = fn_t(tg, ranks), fn_j(jg, ranks)
        assert _healed_record(got) == _healed_record(want), (op, ranks)
        _plans_equal(got.plan, want.plan)
        np.testing.assert_array_equal(thealing.healed_weight_matrix(got),
                                      jhealing.healed_weight_matrix(want))
        assert got.local_in_neighbors(got.to_global[0]) == want.local_in_neighbors(
            want.to_global[0])
    # a heal of a grown topology (the join-after-heal path)
    h_t = thealing.heal_topology(tg, [1])
    h_j = jhealing.heal_topology(jg, [1])
    g_t = thealing.grow_topology(h_t.topology, [h_t.size])
    g_j = jhealing.grow_topology(h_j.topology, [h_j.size])
    assert _healed_record(g_t) == _healed_record(g_j)


def test_healed_topology_corpus():
    """Every named topology x sizes 4..16 x dead-rank sets: the healed
    survivor plan is doubly stochastic, mixing (positive spectral gap),
    covers the healed edge set, and fully excises the dead; the port's
    corpus report equals the reference's."""
    from bluefog_tpu.analysis import resilience_rules as jrules
    from bluefog_tpu.analysis.engine import Report as JReport
    from bluefog_tpu_torch.analysis import resilience_rules
    from bluefog_tpu_torch.analysis.engine import Report

    report, ref = Report(), JReport()
    subjects = 0
    for (label, healed), (jlabel, jhealed) in zip(resilience_rules.iter_healed_corpus(),
                                                 jrules.iter_healed_corpus()):
        assert label == jlabel
        resilience_rules.check_healed(healed, label, report)
        jrules.check_healed(jhealed, jlabel, ref)
        row, col = healed.plan.stochasticity_error()
        assert row < 1e-9 and col < 1e-9, (label, row, col)
        assert set(healed.survivors).isdisjoint(healed.dead), label
        subjects += 1
    assert report.ok, report.summary() + "\n" + "\n".join(
        str(f) for f in report.findings[:10])
    assert subjects > 300  # 7 topologies x 13 sizes x 3-4 dead sets
    assert report.to_dict() == ref.to_dict()


def test_heal_star_center_death_reconnects():
    """Killing the star's center disconnects every survivor pair — the
    healing must add the ring and still come out doubly stochastic."""
    from bluefog_tpu_torch.analysis import plan_rules

    healed = thealing.heal_topology(ttu.StarGraph(8), dead=[0])
    assert healed.reconnected
    assert healed.survivors == tuple(range(1, 8))
    row, col = healed.plan.stochasticity_error()
    assert row < 1e-12 and col < 1e-12
    _, gap = plan_rules.check_spectral_gap(healed.plan, "star-headless")
    assert gap > 0


def test_heal_errors_match_reference():
    for bad in ([9], list(range(4))):
        with pytest.raises(ValueError) as et:
            thealing.heal_topology(ttu.RingGraph(4), bad)
        with pytest.raises(ValueError) as ej:
            jhealing.heal_topology(jtu.RingGraph(4), bad)
        assert str(et.value) == str(ej.value)


def test_join_record_graph_and_epoch_job_match_reference():
    grown_t = thealing.grow_topology(ttu.ExponentialTwoGraph(4), [4])
    grown_j = jhealing.grow_topology(jtu.ExponentialTwoGraph(4), [4])
    for grown in (grown_t, grown_j):
        rec = {"members": list(range(5)), "joined": [4],
               "edges": [[u, v] for u, v in grown.topology.edges]}
        assert _graph_record(tjoin.record_graph(rec)) == _graph_record(jjoin.record_graph(rec))
    rec["reweight"] = True
    rec["demoted"] = [2]
    assert _graph_record(tjoin.record_graph(rec)) == _graph_record(jjoin.record_graph(rec))
    assert tjoin.epoch_job("j", 3) == jjoin.epoch_job("j", 3)
    assert tjoin.epoch_job("j", 0) == jjoin.epoch_job("j", 0)


@pytest.mark.parametrize("mode", ["majority", "off", "strict"])
def test_quorum_and_degraded_match_reference(mode, monkeypatch):
    monkeypatch.setenv("BFTPU_QUORUM", mode)
    assert tquorum.quorum_mode() == jquorum.quorum_mode()
    assert tquorum.quorum_enabled() == jquorum.quorum_enabled()
    for total in range(1, 10):
        assert tquorum.majority_floor(total) == jquorum.majority_floor(total)
        for live in range(total + 1):
            assert tquorum.quorum_met(live, total) == jquorum.quorum_met(live, total)
    sw, nw = 0.25, {1: 0.25, 2: 0.5}
    for lost in ([], [1], [1, 2]):
        assert (tdegraded.renormalize_weights(sw, dict(nw), lost)
                == jdegraded.renormalize_weights(sw, dict(nw), lost))


def _edge_health_script(mod, clock_cls):
    clk = clock_cls()
    eh = mod.EdgeHealth(misses=3, clean=4, floor_s=1.0, clock=clk.now)
    states = []
    rng = np.random.default_rng(3)
    for _ in range(400):
        peer = int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.45:
            states.append(eh.note_miss(peer))
        elif r < 0.9:
            states.append(eh.note_clean(peer))
        elif r < 0.95:
            states.append(eh.absolve(peer))
        elif r < 0.97:
            states.append(eh.note_dead(peer))
        clk.advance(float(rng.uniform(0.0, 0.3)))
    return states, eh.transitions(), sorted(eh.suspects())


def _policy_script(mod, health_mod, clock_cls):
    clk = clock_cls()
    pol = mod.AdaptivePolicy(floor_s=0.05, factor=4, min_obs=4,
                             health=health_mod.EdgeHealth(misses=2, clean=3,
                                                          floor_s=0.5, clock=clk.now),
                             clock=clk.now)
    out = []
    rng = np.random.default_rng(5)
    for i in range(300):
        peer = int(rng.integers(1, 4))
        r = rng.random()
        if r < 0.5:
            out.append(("fresh", pol.note_fresh(peer, float(rng.uniform(0.001, 0.02)))))
        elif r < 0.8:
            out.append(("stale", pol.note_stale(peer, age_s=float(rng.uniform(0.0, 0.5)))))
        else:
            out.append(("acq", pol.note_acquire(peer, float(rng.uniform(0.0, 0.3)))))
        out.append(("deadline", pol.gap_deadline_s()))
        if i % 50 == 0:
            pol.note_epoch_change([peer])
        out.append(("floor", pol.epoch_floor_open(peer)))
        clk.advance(float(rng.uniform(0.0, 0.1)))
    return out, pol.gap_misses, pol.acquire_misses, pol.health.transitions()


def test_edge_health_and_policy_transitions_match_reference():
    assert (_edge_health_script(tdetector, TFakeClock)
            == _edge_health_script(jdetector, JFakeClock))
    assert (_policy_script(tadaptive, tdetector, TFakeClock)
            == _policy_script(jadaptive, jdetector, JFakeClock))
    assert (tdetector.EDGE_ALIVE, tdetector.EDGE_SUSPECT, tdetector.EDGE_DEAD) == (
        jdetector.EDGE_ALIVE, jdetector.EDGE_SUSPECT, jdetector.EDGE_DEAD)


class _FakeJob:
    """Duck-typed transport: controllable per-rank liveness stamps."""

    def __init__(self):
        self.stamps = {}
        self.beats = 0

    def heartbeat(self):
        self.beats += 1

    def liveness(self, rank):
        return self.stamps.get(rank, 0.0)


def _detector_script(mod, clock_cls):
    clk = clock_cls(100.0)
    job = _FakeJob()
    det = mod.FailureDetector(job, rank=0, nranks=4, timeout=1.0, interval=0.1,
                              clock=clk)
    seen = []
    job.stamps = {1: 100.0, 2: 100.0, 3: 100.0}
    for step in range(40):
        clk.advance(0.1)
        for r in (1, 2):
            job.stamps[r] = clk.now()
        if step < 5:
            job.stamps[3] = clk.now()
        if step == 30:
            det.declare_dead(1)
        seen.append(sorted(det.dead_ranks()))
    det.stop()
    return seen


def test_failure_detector_verdicts_match_reference():
    assert _detector_script(tdetector, TFakeClock) == _detector_script(jdetector, JFakeClock)
