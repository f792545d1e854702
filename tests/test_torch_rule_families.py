"""The rule families of ``bluefog_tpu_torch.analysis`` against the JAX
package's: the same rules register under the same names, families and
docs, and a run of each family gives the reference's report — findings,
metrics and subjects checked.  The campaign families (sim, monitor,
partition, slo, serve, distrib, lab) came with the simulator; the rest
(plan, protocol, resilience, telemetry, adaptive, epoch, progress, wire,
introspect, transport, conformance, interleave) with the analysis plane.
Where a rule reads source paths (the env-var lint of the telemetry family
and the capability lint of the transport family), it reads the port's own
tree, so the comparison normalises the package name in findings, and the
telemetry family's count of referenced env vars (a metric and its subjects)
is the port's own count, not the reference's.  The reference's hlo family
is the port's collective family (tests/test_torch_analysis_collective.py).

Also the port's import rule over the whole package and chip_smoke.py: no
module imports jax, jaxlib, flax, optax, networkx, cloudpickle, ml_dtypes or
the JAX package."""

import ast
import glob
import json
import os

import pytest

from bluefog_tpu import analysis as ref_analysis
from bluefog_tpu_torch import analysis as port_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("sim", "monitor", "partition", "slo", "serve", "distrib", "lab",
            "plan", "protocol", "resilience", "telemetry", "adaptive", "epoch",
            "progress", "wire", "introspect", "transport", "conformance",
            "interleave")
#: families whose rules register under another family in both packages
#: (the epoch lint's rules run in the protocol family)
EMPTY = ("epoch",)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "networkx", "cloudpickle",
             "ml_dtypes", "bluefog_tpu")


def _rules(registry, family):
    return [(r.name, r.family, r.doc.replace("bluefog_tpu_torch", "bluefog_tpu"))
            for r in registry.select([family])]


def _normalised(report: dict, family: str) -> dict:
    out = json.loads(json.dumps(report).replace("bluefog_tpu_torch", "bluefog_tpu"))
    if family == "telemetry":
        n = out["metrics"].pop("telemetry.env_vars_referenced")
        out["subjects_checked"] -= int(n)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_family_registers_the_reference_rules(family):
    got = _rules(port_analysis.registry, family)
    assert got == _rules(ref_analysis.registry, family)
    assert bool(got) == (family not in EMPTY)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_report_matches_reference(family):
    port = port_analysis.run(families=[family]).to_dict()
    ref = ref_analysis.run(families=[family]).to_dict()
    assert _normalised(port, family) == _normalised(ref, family)
    assert port["ok"], port["findings"][:5]


def test_every_family_is_registered():
    """The reference's families, with hlo as collective."""
    assert set(port_analysis.registry.families()) == (
        set(ref_analysis.registry.families()) - {"hlo"} | {"collective"})


def _port_modules():
    """Every module of the package (run/ and common/ among them) and
    chip_smoke.py."""
    pkg = os.path.join(REPO, "bluefog_tpu_torch")
    files = sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True))
    return [f for f in files if "_build" not in f] + [os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", _port_modules(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_module_imports_nothing_forbidden(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
