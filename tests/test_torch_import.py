"""bluefog_tpu_torch stands alone: every module imports with jax, flax,
optax and networkx blocked, no source imports the JAX package, and entry
points ask for the card unless told to use the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import bluefog_tpu_torch
from bluefog_tpu_torch.core import basics

torch.set_num_threads(1)
PKG_DIR = os.path.dirname(bluefog_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    names = ["bluefog_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="bluefog_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_networkx():
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'networkx', 'bluefog_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax',"
        " 'networkx', 'triton') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_the_jax_package():
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("bluefog_tpu", "bench", "benchmarks", "jax", "flax", "optax",
                                   "networkx"), \
                    f"{path} imports {name}"


def test_init_selects_cuda_and_raises_without_a_card():
    try:
        if torch.cuda.is_available():
            basics.init(size=2)
            assert basics.device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                basics.init(size=2)
            assert not basics.is_initialized()
        basics.init(size=2, device="cpu")
        assert basics.device() == torch.device("cpu")
    finally:
        basics.shutdown()
    with pytest.raises(RuntimeError, match="not initialized"):
        basics.context()


NEW_MODULES = ["windows.py", "algorithms.py", "examples/bert_pushsum.py",
               "examples/average_consensus.py", "examples/optimization.py",
               "benchmarks/bert_pushsum.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_guard_covers_the_window_slice(rel):
    """The AST guard above walks these files, and none imports jax, the JAX
    package, ``bench`` or ``benchmarks``."""
    path = os.path.join(PKG_DIR, rel)
    assert path in set(_sources())
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            for name in names:
                assert name.split(".")[0] not in ("bluefog_tpu", "bench", "benchmarks", "jax",
                                                  "flax", "optax"), f"{rel} imports {name}"


@pytest.mark.parametrize("module", ["examples.bert_pushsum", "examples.average_consensus",
                                    "examples.optimization", "benchmarks.bert_pushsum"])
def test_window_slice_entry_points_ask_for_the_card(module):
    """Without ``--device`` every new entry point asks for the card, and
    raises where there is none (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    import importlib

    mod = importlib.import_module(f"bluefog_tpu_torch.{module}")
    args = mod._parser().parse_args([])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(args)
    assert not basics.is_initialized()
