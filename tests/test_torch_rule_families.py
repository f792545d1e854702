"""The campaign rule families of ``bluefog_tpu_torch.analysis`` (sim,
monitor, partition, slo, serve, distrib, lab) against the JAX package's:
the same rules register under the same names, families and docs, and a
run of each family gives the reference's report — findings, metrics and
subjects checked.  Also the port's import rule over the simulator, the
monitor, the lab and the analysis package: none of their modules imports
jax, flax, optax, networkx, cloudpickle, ml_dtypes or the JAX package."""

import ast
import glob
import os

import pytest

from bluefog_tpu import analysis as ref_analysis
from bluefog_tpu_torch import analysis as port_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("sim", "monitor", "partition", "slo", "serve", "distrib", "lab")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "networkx", "cloudpickle",
             "ml_dtypes", "bluefog_tpu")


def _rules(registry, family):
    return [(r.name, r.family, r.doc.replace("bluefog_tpu_torch", "bluefog_tpu"))
            for r in registry.select([family])]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_registers_the_reference_rules(family):
    got = _rules(port_analysis.registry, family)
    assert got and got == _rules(ref_analysis.registry, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_report_matches_reference(family):
    port = port_analysis.run(families=[family]).to_dict()
    ref = ref_analysis.run(families=[family]).to_dict()
    assert port == ref
    assert port["ok"], port["findings"][:5]


def _port_modules():
    pkg = os.path.join(REPO, "bluefog_tpu_torch")
    files = []
    for sub in ("sim", "monitor", "lab", "analysis"):
        files += sorted(glob.glob(os.path.join(pkg, sub, "*.py")))
    return files


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
