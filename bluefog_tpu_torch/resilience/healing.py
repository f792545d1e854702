"""Topology healing: rebuild a valid gossip topology over the survivors.

Given a dead-rank set, the healing rule is:

1. take the subgraph INDUCED by the survivors (every edge whose two
   endpoints both survived);
2. SYMMETRIZE it (add the reverse of every surviving edge) — directed
   topologies like the one-directional exponential graph lose in/out
   balance when ranks are excised, and only a symmetric neighbor
   relation admits a doubly-stochastic Metropolis–Hastings weighting;
3. if the result is not strongly connected (or has isolated survivors),
   add a ring over the sorted survivors — gossip averaging needs a
   positive spectral gap, which needs connectivity;
4. relabel the sorted survivors to 0..m-1 (``compile_plan`` requires
   contiguous node ids) and keep the local↔global maps;
5. re-weight with Metropolis–Hastings
   (``w_uv = 1/(1 + max(deg(u), deg(v)))``), which on a symmetric graph
   yields a DOUBLY stochastic mixing matrix — the property that makes
   plain gossip averaging converge to the true average on the survivor
   set — and recompile the shift-class plan.

The healed plan drives both the SPMD emulation (windows.py) and the
analysis rules; the island runtime applies the same membership change
in place via degraded weights (see resilience/degraded.py) without
reallocating its shm segments.

:func:`grow_topology` is the inverse direction — elastic scale-OUT.
Joining ranks are spliced into the sorted-member ring (their two ring
neighbors are the attachment edges), the grown graph is symmetrized
and MH re-weighted exactly like a healed one, and the recompiled
plan's ``stochasticity_error`` pins the grown W doubly stochastic
before any rank gossips under it.  Both directions return the same
:class:`HealedTopology` record, so shrink/grow/shrink sequences
compose: ``grown.topology`` (global-rank node labels restored via
``to_global``) feeds straight back into the next membership change.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np

from bluefog_tpu_torch import topology_util
from bluefog_tpu_torch.core.plan import CommPlan, compile_plan

__all__ = [
    "HealedTopology",
    "heal_topology",
    "grow_topology",
    "demote_topology",
    "healed_weight_matrix",
]

# doubly-stochastic residual above which a grown plan is rejected
# outright (float-epsilon scale; a symmetric MH-weighted graph lands
# orders of magnitude below this)
_STOCHASTICITY_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class HealedTopology:
    """A survivor topology with its plan and local↔global rank maps."""

    survivors: Tuple[int, ...]   # sorted global ranks still alive
    dead: Tuple[int, ...]        # sorted global ranks excised
    topology: topology_util.DiGraph  # relabeled 0..m-1, MH-weighted
    plan: CommPlan               # compiled over the relabeled topology
    to_local: Dict[int, int]     # global rank -> local node id
    to_global: Tuple[int, ...]   # local node id -> global rank
    reconnected: bool            # ring edges were added for connectivity
    joined: Tuple[int, ...] = () # sorted global ranks spliced in (grow)
    demoted: Tuple[int, ...] = () # sorted global ranks degree-capped

    @property
    def size(self) -> int:
        return len(self.survivors)

    def local_in_neighbors(self, global_rank: int) -> Tuple[int, ...]:
        """Global ranks of ``global_rank``'s in-neighbors in the healed
        topology."""
        v = self.to_local[global_rank]
        return tuple(sorted(self.to_global[u]
                            for u in self.topology.predecessors(v)))


def _symmetrized_induced(topo: topology_util.DiGraph,
                         survivors: Iterable[int]) -> topology_util.DiGraph:
    keep = set(survivors)
    G = topology_util.DiGraph()
    G.add_nodes_from(sorted(keep))
    for u, v in topo.edges:
        if u == v or u not in keep or v not in keep:
            continue
        G.add_edge(u, v)
        G.add_edge(v, u)
    return G


def heal_topology(topo: topology_util.DiGraph, dead: Iterable[int]) -> HealedTopology:
    """Excise ``dead`` from ``topo`` and return a connected, MH-weighted,
    doubly-stochastic survivor topology with a freshly compiled plan.

    Raises ValueError if every rank is dead or ``dead`` contains ranks
    not in the topology.
    """
    nodes = set(int(n) for n in topo.nodes)
    dead_set = set(int(r) for r in dead)
    if not dead_set <= nodes:
        raise ValueError(
            f"dead ranks {sorted(dead_set - nodes)} not in topology")
    survivors = tuple(sorted(nodes - dead_set))
    if not survivors:
        raise ValueError("no survivors: every rank is dead")

    G = _symmetrized_induced(topo, survivors)
    reconnected = False
    m = len(survivors)
    if m > 1 and not topology_util.is_strongly_connected(G):
        # restore connectivity (and a positive spectral gap) with a
        # bidirectional ring over the sorted survivors
        reconnected = True
        for i in range(m):
            u, v = survivors[i], survivors[(i + 1) % m]
            if u != v:
                G.add_edge(u, v)
                G.add_edge(v, u)

    to_global = survivors
    to_local = {g: i for i, g in enumerate(survivors)}
    H = topology_util.relabel_nodes(G, to_local)
    topology_util.MetropolisHastingsWeights(H)
    H.graph["healed_from"] = tuple(sorted(dead_set))

    plan = compile_plan(H)
    return HealedTopology(
        survivors=survivors,
        dead=tuple(sorted(dead_set)),
        topology=H,
        plan=plan,
        to_local=to_local,
        to_global=to_global,
        reconnected=reconnected,
    )


def grow_topology(topo: topology_util.DiGraph,
                  joiners: Iterable[int]) -> HealedTopology:
    """Splice ``joiners`` (fresh global ranks) into ``topo`` and return
    a connected, MH-weighted, doubly-stochastic grown topology with a
    freshly compiled plan — :func:`heal_topology`'s twin for elastic
    scale-out.

    The attachment rule is deterministic (every member computes the
    same grown graph from the same membership view, no consensus round
    needed — the grow-side mirror of the monotone-dead-set argument):
    each joiner is connected bidirectionally to its two neighbors in
    the sorted circular order of the grown member set, i.e. spliced
    into the member ring.  Existing edges are kept (symmetrized), so
    the incumbents' gossip locality is preserved and only the splice
    points gain degree.

    Raises ValueError for an empty joiner set or a joiner already in
    the topology, and RuntimeError if the grown plan's
    ``stochasticity_error`` is not float-epsilon doubly stochastic
    (cannot happen for a symmetric MH-weighted graph; the check pins
    the contract before any rank gossips under the grown W).
    """
    nodes = set(int(n) for n in topo.nodes)
    join_set = set(int(r) for r in joiners)
    if not join_set:
        raise ValueError("no joiners: grow_topology needs >= 1 new rank")
    if join_set & nodes:
        raise ValueError(
            f"joiners {sorted(join_set & nodes)} already in topology "
            "(a restarted rank must rejoin under a FRESH global rank)")

    members = tuple(sorted(nodes | join_set))
    G = _symmetrized_induced(topo, nodes)
    G.add_nodes_from(sorted(join_set))
    m = len(members)
    for j in sorted(join_set):
        i = members.index(j)
        for nb in (members[i - 1], members[(i + 1) % m]):
            if nb != j:
                G.add_edge(j, nb)
                G.add_edge(nb, j)

    reconnected = False
    if m > 1 and not topology_util.is_strongly_connected(G):
        # splicing joiners cannot disconnect incumbents, but the OLD
        # graph may already have been disconnected — same ring repair
        # as heal_topology
        reconnected = True
        for i in range(m):
            u, v = members[i], members[(i + 1) % m]
            if u != v:
                G.add_edge(u, v)
                G.add_edge(v, u)

    to_global = members
    to_local = {g: i for i, g in enumerate(members)}
    H = topology_util.relabel_nodes(G, to_local)
    topology_util.MetropolisHastingsWeights(H)
    H.graph["grown_from"] = tuple(sorted(join_set))

    plan = compile_plan(H)
    row_err, col_err = plan.stochasticity_error()
    if max(row_err, col_err) > _STOCHASTICITY_TOL:
        raise RuntimeError(
            f"grown plan not doubly stochastic: row={row_err:.3e} "
            f"col={col_err:.3e} (tol {_STOCHASTICITY_TOL:.0e})")
    return HealedTopology(
        survivors=members,
        dead=(),
        topology=H,
        plan=plan,
        to_local=to_local,
        to_global=to_global,
        reconnected=reconnected,
        joined=tuple(sorted(join_set)),
    )


def demote_topology(topo: topology_util.DiGraph,
                    stragglers: Iterable[int]) -> HealedTopology:
    """Cap each straggler's gossip degree to ONE edge without excising
    it — the gray-failure middle ground between full membership and
    death.  Every member (stragglers included) stays in the view; a
    straggler keeps exactly one bidirectional **anchor** edge to its
    lowest-id healthy neighbor (or, if every neighbor is itself a
    straggler, to the lowest healthy member), so it still receives and
    contributes mass — just without sitting on anyone else's critical
    path.  The healthy core is re-symmetrized, ring-repaired if the
    straggler was a cut vertex, Metropolis–Hastings re-weighted, and
    recompiled — the exact pipeline heal/grow run, so the demoted W is
    doubly stochastic with a positive spectral gap by the same
    construction.

    Deterministic from (topo, stragglers): every member computes the
    same demoted graph from the same inputs, so the epoch record any
    observer commits is the one every other observer would have
    committed.

    Raises ValueError for an empty straggler set, stragglers outside
    the topology, or fewer than one healthy member.
    """
    nodes = set(int(n) for n in topo.nodes)
    strag = set(int(r) for r in stragglers)
    if not strag:
        raise ValueError("no stragglers: demote_topology needs >= 1 rank")
    if not strag <= nodes:
        raise ValueError(
            f"straggler(s) {sorted(strag - nodes)} not in topology")
    healthy = sorted(nodes - strag)
    if not healthy:
        raise ValueError("every member is a straggler: nothing to "
                         "anchor to (heal or wait instead)")
    members = tuple(sorted(nodes))

    G = _symmetrized_induced(topo, members)
    G.add_nodes_from(members)  # isolated members survive symmetrization
    for s in sorted(strag):
        nbrs = sorted(set(G.successors(s)))
        anchors = [u for u in nbrs if u not in strag]
        anchor = anchors[0] if anchors else healthy[0]
        for u in nbrs:
            if u != anchor:
                G.remove_edge(s, u)
                G.remove_edge(u, s)
        if anchor != s and not G.has_edge(s, anchor):
            G.add_edge(s, anchor)
            G.add_edge(anchor, s)

    # the straggler may have been a cut vertex of the healthy core:
    # ring-repair over the HEALTHY members only (a ring through a
    # straggler would re-raise its degree past the cap)
    reconnected = False
    m = len(healthy)
    if m > 1 and not topology_util.is_strongly_connected(G.subgraph(healthy)):
        reconnected = True
        for i in range(m):
            u, v = healthy[i], healthy[(i + 1) % m]
            if u != v:
                G.add_edge(u, v)
                G.add_edge(v, u)

    to_global = members
    to_local = {g: i for i, g in enumerate(members)}
    H = topology_util.relabel_nodes(G, to_local)
    topology_util.MetropolisHastingsWeights(H)
    H.graph["demoted_from"] = tuple(sorted(strag))

    plan = compile_plan(H)
    row_err, col_err = plan.stochasticity_error()
    if max(row_err, col_err) > _STOCHASTICITY_TOL:
        raise RuntimeError(
            f"demoted plan not doubly stochastic: row={row_err:.3e} "
            f"col={col_err:.3e} (tol {_STOCHASTICITY_TOL:.0e})")
    return HealedTopology(
        survivors=members,
        dead=(),
        topology=H,
        plan=plan,
        to_local=to_local,
        to_global=to_global,
        reconnected=reconnected,
        demoted=tuple(sorted(strag)),
    )


def healed_weight_matrix(healed: HealedTopology) -> np.ndarray:
    """The healed mixing matrix W (m × m, local ids): row- AND
    column-stochastic by construction (symmetric graph + MH weights)."""
    return healed.plan.mixing_matrix()
