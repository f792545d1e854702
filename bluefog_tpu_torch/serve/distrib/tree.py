"""The fan-out tree: pure placement/repair math, model-checkable.

Subscriber slots organize into a bounded-degree distribution tree so
one publisher feeds R replicas with O(fanout) sockets and O(log R)
relay depth (the serve-path analog of the exponential-2 gossip graph:
sparse edges, logarithmic diameter).  Parent ``-1`` is the publisher.

The canonical placement is the array heap shape: slot ``k``'s parent
is the publisher for ``k < fanout`` and slot ``k // fanout - 1``
otherwise, which gives every interior slot at most ``fanout`` children
and depth ``floor(log_fanout(k)) + 1``.

Repair is greedy re-attachment: an orphaned slot re-parents to the
shallowest live slot with spare capacity that is not inside its own
subtree (cycles are structurally impossible that way), falling back to
the publisher as root of last resort — the publisher accepts the
orphan even above its own fanout, because a reachable-but-hot root
beats an unreachable subtree.

Everything here is side-effect free over plain ints/dicts: the sim's
distribution-tree model and ``analysis/distrib_rules.py`` exhaust
kill/re-parent sequences against these exact functions, and the
production coordinator (:mod:`.feed`) calls the same code — one
algorithm, three consumers.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

__all__ = [
    "PUBLISHER",
    "parent_of",
    "depth_of",
    "tree_depth",
    "children_of",
    "subtree_of",
    "choose_parent",
    "reassign",
    "tree_valid",
]

#: the parent id meaning "fed directly by the publisher"
PUBLISHER = -1


def parent_of(k: int, fanout: int) -> int:
    """Canonical (pre-fault) parent of slot ``k``: heap shape."""
    f = max(1, int(fanout))
    return PUBLISHER if k < f else (k // f) - 1


def depth_of(k: int, parents: Dict[int, int]) -> int:
    """Hops from slot ``k`` to the publisher (1 = fed directly).
    Returns -1 on a cycle or a dangling parent (invalid tree)."""
    seen = set()
    d, cur = 0, k
    while cur != PUBLISHER:
        if cur in seen or cur not in parents:
            return -1
        seen.add(cur)
        d, cur = d + 1, parents[cur]
    return d


def tree_depth(parents: Dict[int, int]) -> int:
    """Max depth over all slots (0 for an empty tree, -1 if any slot
    is cyclic/dangling)."""
    depths = [depth_of(k, parents) for k in parents]
    if any(d < 0 for d in depths):
        return -1
    return max(depths, default=0)


def children_of(parents: Dict[int, int]) -> Dict[int, List[int]]:
    """Parent -> sorted children (``PUBLISHER`` key = publisher-fed)."""
    out: Dict[int, List[int]] = {}
    for k in sorted(parents):
        out.setdefault(parents[k], []).append(k)
    return out


def subtree_of(k: int, parents: Dict[int, int]) -> set:
    """``k`` plus every slot that (transitively) feeds from it."""
    kids = children_of(parents)
    out, frontier = {k}, [k]
    while frontier:
        nxt = []
        for p in frontier:
            for c in kids.get(p, ()):
                if c not in out:
                    out.add(c)
                    nxt.append(c)
        frontier = nxt
    return out


def choose_parent(k: int, parents: Dict[int, int], fanout: int,
                  dead: Iterable[int] = (), *,
                  degree_cap: bool = True) -> int:
    """Greedy repair/join placement for slot ``k``.

    Candidates are live slots outside ``k``'s own subtree, preferred
    shallowest-first (then lowest id) while they have fewer than
    ``fanout`` children; the publisher is the root of last resort and
    is chosen even when its direct-feed count already hit ``fanout``.
    ``degree_cap=False`` is the seeded-fixture knob (the
    ``distrib-degree-overflow`` bug): it picks the shallowest live
    slot regardless of load, which the tree-validity invariant must
    catch."""
    deadset = set(dead)
    avoid = subtree_of(k, parents) if k in parents else {k}
    kids = children_of(parents)
    cands = []
    for c in sorted(parents):
        if c in deadset or c in avoid:
            continue
        load = len([x for x in kids.get(c, ())
                    if x not in deadset and x not in avoid])
        d = depth_of(c, parents)
        if d < 0:
            continue
        if degree_cap and load >= max(1, int(fanout)):
            continue
        cands.append((d, c))
    if not cands:
        return PUBLISHER
    if degree_cap:
        # publisher stays preferred while it has direct-feed capacity
        pub_load = len([x for x in kids.get(PUBLISHER, ())
                        if x not in deadset and x not in avoid])
        if pub_load < max(1, int(fanout)):
            return PUBLISHER
    return min(cands)[1]


def reassign(parents: Dict[int, int], dead: int, fanout: int, *,
             degree_cap: bool = True) -> Dict[int, int]:
    """New parent map after slot ``dead`` dies: ``dead`` leaves the
    tree and each of its direct children re-parents greedily (their
    own subtrees ride along unchanged)."""
    out = {k: p for k, p in parents.items() if k != dead}
    orphans = sorted(k for k, p in parents.items()
                     if p == dead and k != dead)
    for k in orphans:
        out[k] = choose_parent(k, out, fanout, dead=(dead,),
                               degree_cap=degree_cap)
    return out


def tree_valid(parents: Dict[int, int], fanout: int,
               root_cap: Optional[int] = None) -> Optional[str]:
    """The standing tree invariant: ``None`` when the map is a
    connected, acyclic, degree-capped tree rooted at the publisher;
    otherwise a description of the violation.

    Every slot must reach ``PUBLISHER`` (connected + acyclic in one
    walk), and no slot may feed more than ``fanout`` children.  The
    publisher's own degree is capped only when ``root_cap`` is given —
    it is the root of last resort, allowed to run hot after repair."""
    f = max(1, int(fanout))
    for k in sorted(parents):
        if parents[k] == k:
            return f"slot {k} is its own parent"
        if depth_of(k, parents) < 0:
            return (f"slot {k} cannot reach the publisher "
                    f"(cycle or dangling parent in {parents})")
    for p, kids in sorted(children_of(parents).items()):
        if p == PUBLISHER:
            if root_cap is not None and len(kids) > root_cap:
                return (f"publisher feeds {len(kids)} slots "
                        f"> cap {root_cap}")
            continue
        if len(kids) > f:
            return (f"slot {p} feeds {len(kids)} children "
                    f"> fanout {f}: {kids}")
    return None
