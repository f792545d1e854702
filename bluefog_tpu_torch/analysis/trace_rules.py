"""Rule family 7: distributed-trace buffers, flows, and clocks.

The tracing layer (:mod:`bluefog_tpu_torch.tracing`) is the next artifact
worth verifying: a span buffer whose spans interleave without nesting
means two timing contexts raced on one rank (the merge would draw
overlapping boxes on one track and the critical-path walk would pick
nonsense predecessors), a consume whose ``(origin, op_id)`` identity no
producer ever emitted means a trace-context word was corrupted (or a
stale slot was re-consumed past the ``_trace_seen`` guard), and a clock
block that violates the min-RTT estimator's own arithmetic means the
offset applied at merge time is not the one the estimator produced.
Three laws:

- **nesting** — per rank, spans are properly nested or disjoint: for
  any two spans A, B either A contains B, B contains A, or they do not
  overlap (spans all come from paired ``begin``/``end`` on one control
  thread, so partial overlap is structurally impossible unless a token
  was dropped or reused);
- **flow endpoints** — every ``consume`` entry's flow identity resolves
  to an ``emit`` on the buffer of its claimed origin rank, and every
  ``emit``'s destination is a rank that exists in the corpus;
- **clock bounds** — each buffer's clock block obeys the estimator's
  identity (``err_s == best_rtt_s / 2``, both non-negative, a nonzero
  offset implies at least one sample), and no resolved flow completes
  before its producer *began* by more than the two endpoints' combined
  error bound (causality survives alignment).

The registered rules drive a synthetic in-memory 2-rank corpus (no
files, no processes); the ``check_*`` helpers are pure and are what the
fixtures and the merge CLI's ``--check`` call directly.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from bluefog_tpu_torch.tracing.merge import _aligned_spans, flow_index

from bluefog_tpu_torch.analysis.engine import Finding, Report, Severity, registry

__all__ = [
    "check_span_nesting",
    "check_flow_endpoints",
    "check_clock_offsets",
    "check_trace_corpus",
]

#: err_s is rtt/2 by construction; allow fp slop plus rounding in the
#: JSON round-trip.
_CLOCK_IDENTITY_TOL_S = 1e-9


# ---------------------------------------------------------------------------
# span nesting
# ---------------------------------------------------------------------------


def check_span_nesting(trace: Dict, label: str = "trace") -> List[Finding]:
    """Per-rank spans must be properly nested or disjoint.

    Sweep in start order with a stack of open intervals: a span that
    starts inside the top of stack but ends after it PARTIALLY overlaps
    — the broken-token signature."""
    out: List[Finding] = []
    spans = [s for s in trace.get("spans", ())
             if s.get("ph") != "i" and "t0" in s and "t1" in s]
    spans.sort(key=lambda s: (s["t0"], -s["t1"]))
    stack: List[Dict] = []
    for s in spans:
        while stack and stack[-1]["t1"] <= s["t0"]:
            stack.pop()
        if stack and s["t1"] > stack[-1]["t1"]:
            top = stack[-1]
            out.append(Finding(
                "trace.span-nesting", label,
                f"span {s.get('name')!r} [{s['t0']}, {s['t1']}] partially "
                f"overlaps {top.get('name')!r} [{top['t0']}, {top['t1']}] "
                "on one rank — begin/end tokens crossed (a span token was "
                "dropped, reused, or ended out of order)"))
            continue
        stack.append(s)
    return out


# ---------------------------------------------------------------------------
# flow endpoints
# ---------------------------------------------------------------------------


def check_flow_endpoints(traces: Sequence[Dict], label: str = "corpus"
                         ) -> List[Finding]:
    """Every consume resolves to an emit; every emit targets a known
    rank.  A corpus missing some rank's buffer (it died before writing)
    legitimately has dangling flows — those demote to warnings; a
    dangling flow whose ORIGIN buffer is present is an error (the
    context word was corrupted in the mailbox or mis-unpacked)."""
    out: List[Finding] = []
    spans, _ = _aligned_spans(traces)
    producers, flows = flow_index(spans)
    ranks = {int(t.get("rank", -1)) for t in traces}
    for fl in flows:
        if fl["producer"] is not None:
            continue
        ident = f"({fl['origin']}:{fl['op_id']})"
        if fl["origin"] in ranks:
            out.append(Finding(
                "trace.flow-endpoints", label,
                f"rank {fl['dst']} consumed flow {ident} but rank "
                f"{fl['origin']}'s buffer (present in the corpus) never "
                "emitted it — the trace-context word was corrupted in "
                "the mailbox or unpacked wrong"))
        else:
            out.append(Finding(
                "trace.flow-endpoints", label,
                f"rank {fl['dst']} consumed flow {ident} from rank "
                f"{fl['origin']}, whose buffer is missing from the "
                "corpus (rank died before writing?)",
                severity=Severity.WARNING))
    for s in spans:
        for e in s["emit"]:
            dst = int(e.get("dst", -1))
            if dst not in ranks:
                out.append(Finding(
                    "trace.flow-endpoints", label,
                    f"rank {s['rank']} emitted op {e.get('op_id')} to "
                    f"rank {dst}, which is not in the corpus "
                    f"(ranks {sorted(ranks)})",
                    severity=Severity.WARNING))
    return out


# ---------------------------------------------------------------------------
# clock offsets
# ---------------------------------------------------------------------------


def check_clock_offsets(traces: Sequence[Dict], label: str = "corpus"
                        ) -> List[Finding]:
    """Per-buffer estimator arithmetic + corpus-level causality."""
    out: List[Finding] = []
    for t in traces:
        r = t.get("rank", "?")
        clk = t.get("clock") or {}
        err = float(clk.get("err_s", 0.0))
        rtt = clk.get("best_rtt_s")
        samples = int(clk.get("samples", 0))
        offset = float(clk.get("offset_s", 0.0))
        if err < 0:
            out.append(Finding(
                "trace.clock-offsets", f"{label} rank {r}",
                f"clock err_s is negative ({err:g}) — rtt/2 cannot be"))
        if rtt is not None and abs(err - float(rtt) / 2.0) > \
                _CLOCK_IDENTITY_TOL_S:
            out.append(Finding(
                "trace.clock-offsets", f"{label} rank {r}",
                f"clock err_s={err:g} is not best_rtt_s/2={float(rtt)/2:g}"
                " — the offset in this buffer did not come from the "
                "min-RTT estimator"))
        if offset != 0.0 and samples < 1:
            out.append(Finding(
                "trace.clock-offsets", f"{label} rank {r}",
                f"nonzero clock offset ({offset:g}s) with zero samples — "
                "an offset was applied that no probe ever measured"))
    # causality: a resolved flow's consumer cannot COMPLETE before its
    # producer BEGAN by more than the two endpoints' combined error
    # bound.  (Producer END is not a bound: on an acked transport the
    # deposit lands remotely before the ack closes the producer span,
    # so consumers legitimately finish first.)
    spans, _ = _aligned_spans(traces)
    _, flows = flow_index(spans)
    for fl in flows:
        p, c = fl["producer"], fl["consumer"]
        if p is None:
            continue
        slack_us = p["err_us"] + c["err_us"] + 1.0
        lag_us = p["t0_us"] - c["t1_us"]
        if lag_us > slack_us:
            out.append(Finding(
                "trace.clock-offsets", label,
                f"flow ({fl['origin']}:{fl['op_id']}) "
                f"{p['rank']}->{c['rank']} completes {lag_us:.1f}us "
                f"BEFORE its producer began (allowed clock slack "
                f"{slack_us:.1f}us) — the applied offsets exceed the "
                "estimator's error bound"))
    return out


def check_trace_corpus(traces: Sequence[Dict]) -> List[Finding]:
    """Everything the merge CLI's ``--check`` verifies: per-buffer span
    nesting + corpus-wide flow resolution and clock bounds."""
    out: List[Finding] = []
    for t in traces:
        out.extend(check_span_nesting(
            t, label=f"rank {t.get('rank', '?')}"))
    out.extend(check_flow_endpoints(traces))
    out.extend(check_clock_offsets(traces))
    return out


# ---------------------------------------------------------------------------
# registered rules: synthetic in-memory 2-rank gossip corpus
# ---------------------------------------------------------------------------


def _synthetic_traces() -> List[Dict]:
    """Two ranks, two rounds of put→update with resolved flows, nested
    timeline sub-spans, and clock blocks straight off the estimator."""
    from bluefog_tpu_torch.tracing.tracer import TRACE_SCHEMA

    def clock(offset: float, rtt: float, samples: int) -> Dict:
        return {"offset_s": offset, "err_s": rtt / 2.0,
                "best_rtt_s": rtt if samples else None,
                "samples": samples}

    us = 1000  # ns per µs keeps the numbers readable

    def buf(rank: int, peer: int, base: int, clk: Dict) -> Dict:
        spans = []
        for rnd in range(2):
            t = base + rnd * 100 * us
            op = rnd + 1
            spans.append({"name": "win_put", "win": "w", "round": rnd,
                          "t0": t, "t1": t + 30 * us,
                          "emit": [{"dst": peer, "op_id": op}]})
            spans.append({"name": "win_update", "win": "w", "round": rnd,
                          "t0": t + 40 * us, "t1": t + 90 * us,
                          "consume": [{"src": peer, "origin": peer,
                                       "op_id": op, "round": rnd}]})
        return {"schema": TRACE_SCHEMA, "job": "synthetic", "rank": rank,
                "nranks": 2, "rounds": 2, "clock": clk,
                "anchor": {"wall_s": 0.0, "mono_ns": base},
                "dropped": 0, "spans": spans}

    return [buf(0, 1, 10 * us, clock(0.0, 0.0, 0)),
            buf(1, 0, 12 * us, clock(2e-6, 8e-6, 3))]


@registry.rule("trace.span-nesting", family="trace",
               doc="per-rank spans are properly nested or disjoint")
def _rule_span_nesting(report: Report) -> None:
    for t in _synthetic_traces():
        report.subjects_checked += 1
        report.extend(check_span_nesting(
            t, label=f"synthetic rank {t['rank']}"))


@registry.rule("trace.flow-endpoints", family="trace",
               doc="every consumed flow resolves to an emit on its "
                   "origin rank's buffer")
def _rule_flow_endpoints(report: Report) -> None:
    report.subjects_checked += 1
    report.extend(check_flow_endpoints(_synthetic_traces(),
                                       label="synthetic 2-rank corpus"))


@registry.rule("trace.clock-offsets", family="trace",
               doc="clock blocks obey the min-RTT estimator identity and "
                   "aligned flows stay causal within the error bound")
def _rule_clock_offsets(report: Report) -> None:
    report.subjects_checked += 1
    report.extend(check_clock_offsets(_synthetic_traces(),
                                      label="synthetic 2-rank corpus"))
