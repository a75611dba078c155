"""What the benchmark imports: no JAX anywhere, the program only in
``program.py``, nothing of the program in the reference."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.run import forbidden_modules
from benchmark.spec import HERE, ROOT

PORT = "alphazero_gomoku_tpu_torch"


def test_forbidden_names_are_compared_whole():
    found = forbidden_modules(["jax", "jaxlib.xla_client", "flax.core",
                               "alphazero_gomoku_tpu.games", "numpy",
                               PORT, PORT + ".ops", "jaxtyping", "flaxen"])
    assert found == ["alphazero_gomoku_tpu", "flax", "jax", "jaxlib"]
    assert forbidden_modules([PORT, PORT + ".selfplay.runner", "torch"]) \
        == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _files(*parts):
    top = os.path.join(HERE, *parts)
    for dirpath, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


@pytest.mark.parametrize("path", sorted(_files()))
def test_no_jax_in_the_benchmark(path):
    assert forbidden_modules(_imports(path)) == [], path


@pytest.mark.parametrize("path", sorted(_files("reference")))
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert PORT not in tops
    assert tops <= {"__future__", "dataclasses", "typing", "numpy", "torch",
                    "benchmark"}
    assert all(n.startswith("benchmark.reference") for n in _imports(path)
               if n.split(".")[0] == "benchmark")


@pytest.mark.parametrize("path", sorted(_files("nets")))
def test_nets_import_nothing_of_the_program(path):
    """An architecture's module imports the reference and the yardstick,
    and nothing of the program."""
    tops = {n.split(".")[0] for n in _imports(path)}
    assert PORT not in tops
    assert tops <= {"__future__", "typing", "numpy", "torch", "benchmark"}
    assert all(n.startswith(("benchmark.reference.", "benchmark.yardstick"))
               for n in _imports(path) if n.split(".")[0] == "benchmark")


def test_only_program_and_tests_import_the_program():
    for path in _files():
        rel = os.path.relpath(path, HERE)
        if rel in ("program.py",) or rel.startswith("tests"):
            continue
        assert PORT not in {n.split(".")[0] for n in _imports(path)}, rel


def test_reference_and_nets_load_alone():
    code = ("import sys, benchmark.reference.replay, benchmark.reference.net;"
            "from benchmark import spec; spec.net('resnet');"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'alphazero_gomoku_tpu', "
            f"'{PORT}'));"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
