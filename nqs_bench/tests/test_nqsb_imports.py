"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either, top-level names compared
whole (the port's name begins with the JAX package's)."""
import ast
import os

import pytest

from conftest import ROOT

BENCH_DIR = os.path.join(ROOT, "nqs_bench")
NEVER = {"jax", "jaxlib", "flax", "noisyquantumsimulator_tpu"}
PROGRAM = "noisyquantumsimulator_tpu_torch"


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every absolute import in the file, and of every
    string given to importlib.import_module or __import__."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import noisyquantumsimulator_tpu_torch.x\nfrom jax import numpy\n"
                 "import importlib\nimportlib.import_module('flax.linen')\n")
    assert imported(str(p)) == {PROGRAM, "jax", "importlib", "flax"}


@pytest.mark.parametrize("path", sorted(_sources(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not imported(path) & NEVER


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH_DIR, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (NEVER | {PROGRAM})


def test_the_run_checks_its_process(monkeypatch):
    import sys
    from nqs_bench import harness
    assert set(harness.FORBIDDEN) == NEVER
    monkeypatch.setitem(sys.modules, PROGRAM + ".fake", object())
    assert PROGRAM.split(".")[0] not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "noisyquantumsimulator_tpu", object())
    assert {"jaxlib", "noisyquantumsimulator_tpu"} <= set(harness.forbidden_modules())
