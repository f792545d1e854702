"""Rule family 12: the convergence observatory's measured artifacts.

The lab's claims are only useful if they are *checkable*: a sweep
artifact (``LAB_rNN.json``, :mod:`bluefog_tpu_torch.lab.sweep`) asserts
measured contraction rates, fitted scaling laws, a rate-vs-gap rank
correlation, sim-oracle agreement, and a recommendation map — every
one of which can silently rot (a re-run with a broken combine path, a
hand-edited artifact, a recommender change that contradicts the frozen
corpus).  These rules re-derive each claim from the artifact's own raw
data:

- **schema** — the artifact is structurally what ``lab.recommend``
  will deserialize: schema id, version, provenance stamp, per-cell
  fields in range (rates/rhos in [0, 1], r² ≤ 1, gaps in (0, 1]);
- **refit** — each cell's stored (rho, rate) matches re-fitting the
  cell's own stored series with the shared fit code;
- **fit-monotonicity** — no fitted scaling law claims rates that GROW
  with fleet size (every corpus topology's gap is non-increasing in
  ``n``), and each law reproduces the measured cells it was fit from;
- **rate-vs-gap** — the measured rates rank-correlate with the static
  spectral-gap predictions (Spearman ≥ 0.8: the paper's ordering,
  observed), and the stored correlation matches recomputation;
- **oracle** — every cell's sim diff is within the artifact's own
  tolerance and no cell is flagged divergent;
- **recommendation-consistency** — every stored recommendation equals
  ``lab.recommend`` recomputed over the same artifact (determinism:
  the opt-in islands default must match the frozen corpus).

Check helpers are pure over a loaded artifact dict (tests and
``python -m bluefog_tpu_torch.lab check`` call them directly); the
registered rules bind them to the frozen package artifact.
"""

from __future__ import annotations

import re
from typing import List, Optional

from bluefog_tpu_torch.analysis.engine import Finding, Report, Severity, registry

__all__ = [
    "check_artifact_schema",
    "check_cell_refit",
    "check_fit_monotonicity",
    "check_rate_vs_gap",
    "check_oracle_clean",
    "check_recommendation_consistency",
    "check_artifact",
    "MIN_SPEARMAN",
]

#: Acceptance floor for the measured-vs-predicted rank correlation.
MIN_SPEARMAN = 0.8

_CELL_FIELDS = ("topology", "n", "payload_bytes", "rounds", "seed",
                "rate", "rho", "r2", "points", "gap", "series",
                "sim_ok", "sim_rate", "sim_rho", "abs_diff", "diverged")

_PROVENANCE_FIELDS = ("git_sha", "date", "host")


def _cell_label(c: dict) -> str:
    return f"{c.get('topology', '?')}@{c.get('n', '?')}"


def check_artifact_schema(art: dict, label: str = "artifact"
                          ) -> List[Finding]:
    """Structural contract of a lab artifact."""
    from bluefog_tpu_torch.lab.recommend import ARTIFACT_SCHEMA, TOPOLOGIES

    out: List[Finding] = []

    def bad(subject: str, msg: str) -> None:
        out.append(Finding(rule="lab.artifact-schema",
                           subject=subject, message=msg))

    if art.get("schema") != ARTIFACT_SCHEMA:
        bad(label, f"schema {art.get('schema')!r} != {ARTIFACT_SCHEMA!r}")
    if not re.fullmatch(r"r\d{2,}", str(art.get("version", ""))):
        bad(label, f"version {art.get('version')!r} is not rNN")
    prov = art.get("provenance") or {}
    for k in _PROVENANCE_FIELDS:
        if not prov.get(k):
            bad(label, f"provenance missing {k!r}")
    cells = art.get("cells") or []
    if not cells:
        bad(label, "no sweep cells")
    for c in cells:
        sub = f"{label}:{_cell_label(c)}"
        missing = [k for k in _CELL_FIELDS if k not in c]
        if missing:
            bad(sub, f"cell missing fields {missing}")
            continue
        if c["topology"] not in TOPOLOGIES:
            bad(sub, f"unknown topology {c['topology']!r}")
        if not (0.0 <= float(c["rate"]) <= 1.0):
            bad(sub, f"rate {c['rate']} outside [0, 1]")
        if not (0.0 <= float(c["rho"]) <= 1.0):
            bad(sub, f"rho {c['rho']} outside [0, 1]")
        if float(c["r2"]) > 1.0 + 1e-9:
            bad(sub, f"r2 {c['r2']} > 1")
        if not (0.0 < float(c["gap"]) <= 1.0 + 1e-9):
            bad(sub, f"spectral gap {c['gap']} outside (0, 1]")
        if int(c["n"]) < 2:
            bad(sub, f"n {c['n']} < 2")
    for topo, fit in (art.get("fits") or {}).items():
        if not all(k in fit for k in ("a", "b")):
            bad(f"{label}:fit[{topo}]", f"fit missing a/b: {fit}")
    return out


def check_cell_refit(art: dict, label: str = "artifact",
                     tol: float = 1e-9) -> List[Finding]:
    """Each cell's stored fit must match re-fitting its stored series
    with the shared fit code — the artifact carries its own raw data
    precisely so a tampered headline number is catchable."""
    from bluefog_tpu_torch.lab.fit import NOISE_FLOOR, fit_contraction

    out: List[Finding] = []
    for c in art.get("cells") or []:
        series = [(int(t), float(e)) for t, e in c.get("series") or []]
        if not series:
            out.append(Finding(
                rule="lab.cell-refit", subject=f"{label}:{_cell_label(c)}",
                message="cell has no stored series to refit"))
            continue
        peak = max((e for _, e in series), default=0.0)
        fit = fit_contraction(series,
                              floor=max(NOISE_FLOOR, peak * 1e-5))
        for k in ("rho", "rate"):
            if abs(fit[k] - float(c[k])) > tol:
                out.append(Finding(
                    rule="lab.cell-refit",
                    subject=f"{label}:{_cell_label(c)}",
                    message=f"stored {k} {c[k]:.6g} != refit "
                            f"{fit[k]:.6g} from the cell's own series"))
    return out


def check_fit_monotonicity(art: dict, label: str = "artifact",
                           grow_tol: float = 0.05,
                           refit_tol: float = 1e-9) -> List[Finding]:
    """Scaling laws must not claim contraction rates growing with n
    (every corpus topology's gap is non-increasing in fleet size), and
    each stored law must match re-fitting the measured cells."""
    from bluefog_tpu_torch.lab.fit import fit_power_law

    out: List[Finding] = []
    cells = art.get("cells") or []
    for topo, fit in sorted((art.get("fits") or {}).items()):
        sub = f"{label}:fit[{topo}]"
        b = float(fit.get("b", 0.0))
        if b > grow_tol:
            out.append(Finding(
                rule="lab.fit-monotonicity", subject=sub,
                message=f"law exponent b={b:.4f} claims rates GROWING "
                        f"with n (tolerance {grow_tol})"))
        mine = [c for c in cells if c["topology"] == topo]
        if not mine:
            out.append(Finding(
                rule="lab.fit-monotonicity", subject=sub,
                message="fit has no measured cells backing it"))
            continue
        refit = fit_power_law([c["n"] for c in mine],
                              [c["rate"] for c in mine])
        if (abs(refit["a"] - float(fit.get("a", 0.0))) > refit_tol
                or abs(refit["b"] - b) > refit_tol):
            out.append(Finding(
                rule="lab.fit-monotonicity", subject=sub,
                message=f"stored law (a={fit.get('a'):.6g}, b={b:.6g}) "
                        f"!= refit (a={refit['a']:.6g}, "
                        f"b={refit['b']:.6g}) from the measured cells"))
    return out


def check_rate_vs_gap(art: dict, label: str = "artifact",
                      min_corr: float = MIN_SPEARMAN) -> List[Finding]:
    """Measured rates must rank-correlate with the spectral-gap
    predictions, and the stored correlation must be honest."""
    from bluefog_tpu_torch.lab.fit import spearman

    out: List[Finding] = []
    cells = art.get("cells") or []
    if len(cells) < 3:
        return [Finding(rule="lab.rate-vs-gap", subject=label,
                        message=f"only {len(cells)} cells — too few to "
                                f"rank-correlate")]
    corr = spearman([float(c["gap"]) for c in cells],
                    [float(c["rate"]) for c in cells])
    stored = art.get("spearman_rate_vs_gap")
    if stored is None or abs(float(stored) - corr) > 1e-9:
        out.append(Finding(
            rule="lab.rate-vs-gap", subject=label,
            message=f"stored spearman {stored!r} != recomputed "
                    f"{corr:.4f}"))
    if corr < min_corr:
        out.append(Finding(
            rule="lab.rate-vs-gap", subject=label,
            message=f"measured rates vs spectral gaps: spearman "
                    f"{corr:.3f} < {min_corr} — the fleet does not "
                    f"reproduce the predicted topology ordering"))
    return out


def check_oracle_clean(art: dict, label: str = "artifact"
                       ) -> List[Finding]:
    """Every cell must agree with its sim replay within the artifact's
    own tolerance, with the sim run itself invariant-clean."""
    out: List[Finding] = []
    tol = float((art.get("params") or {}).get("tol", 0.0) or 0.0)
    for c in art.get("cells") or []:
        sub = f"{label}:{_cell_label(c)}"
        if not c.get("sim_ok", False):
            out.append(Finding(
                rule="lab.oracle", subject=sub,
                message="sim replay violated fleet invariants"))
        if c.get("diverged"):
            out.append(Finding(
                rule="lab.oracle", subject=sub,
                message=f"measured rate {c.get('rate'):.4f} vs sim "
                        f"{c.get('sim_rate'):.4f}: |diff| "
                        f"{c.get('abs_diff'):.4f} > tol {tol}"))
        elif tol and abs(float(c["rate"]) - float(c["sim_rate"])) > tol:
            out.append(Finding(
                rule="lab.oracle", subject=sub,
                message=f"cell not flagged but |rate - sim_rate| = "
                        f"{abs(float(c['rate']) - float(c['sim_rate'])):.4f}"
                        f" > tol {tol}"))
    if not art.get("oracle_clean", False) and not out:
        out.append(Finding(
            rule="lab.oracle", subject=label,
            message="oracle_clean is false but no cell is divergent"))
    return out


def check_recommendation_consistency(art: dict, label: str = "artifact"
                                     ) -> List[Finding]:
    """Every stored recommendation must equal ``lab.recommend``
    recomputed over this same artifact — the determinism contract
    behind using it as an islands launch default."""
    from bluefog_tpu_torch.lab.recommend import recommend

    out: List[Finding] = []
    recs = art.get("recommended") or {}
    if not recs:
        return [Finding(rule="lab.recommendation-consistency",
                        subject=label,
                        message="artifact stores no recommendation map")]
    for key, stored in sorted(recs.items()):
        try:
            n_s, pb_s = key.split(":")
            fresh = recommend(int(n_s), int(pb_s), artifact=art)
        except (ValueError, KeyError) as e:
            out.append(Finding(
                rule="lab.recommendation-consistency",
                subject=f"{label}:{key}",
                message=f"recompute failed: {e}"))
            continue
        if fresh["topology"] != stored.get("topology"):
            out.append(Finding(
                rule="lab.recommendation-consistency",
                subject=f"{label}:{key}",
                message=f"stored recommendation "
                        f"{stored.get('topology')!r} contradicts the "
                        f"measured corpus (recompute: "
                        f"{fresh['topology']!r})"))
        elif abs(float(stored.get("score", -1.0)) - fresh["score"]) > 1e-9:
            out.append(Finding(
                rule="lab.recommendation-consistency",
                subject=f"{label}:{key}",
                message=f"stored score {stored.get('score')} != "
                        f"recomputed {fresh['score']:.6g}"))
    return out


def check_artifact(art: dict, label: str = "artifact") -> List[Finding]:
    """All lab checks over one loaded artifact (what ``python -m
    bluefog_tpu_torch.lab check`` and the registered rules run)."""
    out = check_artifact_schema(art, label)
    if any(f.severity == Severity.ERROR for f in out):
        # structurally broken: the semantic checks would only cascade
        return out
    out += check_cell_refit(art, label)
    out += check_fit_monotonicity(art, label)
    out += check_rate_vs_gap(art, label)
    out += check_oracle_clean(art, label)
    out += check_recommendation_consistency(art, label)
    return out


# ---------------------------------------------------------------------------
# registered rules over the frozen package artifact
# ---------------------------------------------------------------------------


def _frozen_artifact() -> Optional[dict]:
    from bluefog_tpu_torch.lab.recommend import load_artifact

    try:
        return load_artifact()
    except (OSError, ValueError):
        return None


def _run_over_frozen(report: Report, check, rule_name: str) -> None:
    from bluefog_tpu_torch.lab.recommend import default_artifact_path

    art = _frozen_artifact()
    if art is None:
        report.add(Finding(
            rule=rule_name, subject=default_artifact_path(),
            message="frozen lab artifact missing or unreadable",
            severity=Severity.ERROR))
        return
    report.subjects_checked += len(art.get("cells") or ())
    report.extend(check(art, label="LAB_" + str(art.get("version"))))


@registry.rule("lab.artifact-schema", "lab",
               "frozen sweep artifact is structurally valid")
def rule_artifact_schema(report: Report) -> None:
    _run_over_frozen(report, check_artifact_schema, "lab.artifact-schema")


@registry.rule("lab.cell-refit", "lab",
               "stored cell fits match refitting their own series")
def rule_cell_refit(report: Report) -> None:
    _run_over_frozen(report, check_cell_refit, "lab.cell-refit")


@registry.rule("lab.fit-monotonicity", "lab",
               "scaling laws honest and non-increasing in fleet size")
def rule_fit_monotonicity(report: Report) -> None:
    _run_over_frozen(report, check_fit_monotonicity,
                     "lab.fit-monotonicity")


@registry.rule("lab.rate-vs-gap", "lab",
               "measured rates rank-correlate with spectral gaps")
def rule_rate_vs_gap(report: Report) -> None:
    art = _frozen_artifact()
    if art is not None:
        corr = art.get("spearman_rate_vs_gap")
        if isinstance(corr, (int, float)):
            report.metric("lab.spearman_rate_vs_gap", float(corr))
    _run_over_frozen(report, check_rate_vs_gap, "lab.rate-vs-gap")


@registry.rule("lab.oracle", "lab",
               "every sweep cell agrees with its sim replay")
def rule_oracle(report: Report) -> None:
    _run_over_frozen(report, check_oracle_clean, "lab.oracle")


@registry.rule("lab.recommendation-consistency", "lab",
               "stored recommendations match recomputation")
def rule_recommendation_consistency(report: Report) -> None:
    _run_over_frozen(report, check_recommendation_consistency,
                     "lab.recommendation-consistency")
