"""The port stands alone: no JAX, nothing of the JAX package, no fallback.

The card's machine has no ``jax``, ``flax`` or ``msgpack``, so the port's
modules, ``chip_smoke.py`` and ``profile_search.py`` must import none of
them, and nothing of ``alphazero_gomoku_tpu`` (even a module there without
JAX in it).  The kernel wrappers take the plain version only for CPU tensors, and have no
``try`` that could turn a failed launch into one.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import alphazero_gomoku_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "alphazero_gomoku_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "alphazero_gomoku_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_search.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_every_port_module_imports():
    """Importing each module must not build kernels or touch a device."""
    names = [m.name for m in pkgutil.walk_packages(
        alphazero_gomoku_tpu_torch.__path__, "alphazero_gomoku_tpu_torch.")]
    for module in ("tree_kernels", "fused_net", "int8_net", "int8_tower"):
        assert f"alphazero_gomoku_tpu_torch.ops.{module}" in names
    for name in names:
        importlib.import_module(name)
    from alphazero_gomoku_tpu_torch.ops import _build
    assert not _build._LOADED


def test_kernel_wrappers_have_no_fallback():
    for name in ("tree_kernels.py", "fused_net.py", "int8_net.py",
                 "int8_tower.py"):
        tree = ast.parse((PORT / "ops" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name
