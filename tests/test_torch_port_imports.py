"""The port stands alone: no JAX, nothing of the JAX package, no fallback.

The card's machine has no ``jax``, ``flax`` or ``msgpack``, so the port's
modules and ``chip_smoke.py`` must import none of
them, nothing of ``alphazero_gomoku_tpu`` (even a module there without
JAX in it), and nothing of the repo's root ``bench.py``, ``tools/`` and
``repro/`` (they import the JAX package).  The kernel wrappers take the plain version only for CPU tensors, and have no
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
             "alphazero_gomoku_tpu", "bench", "tools", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for module in ("ops.tree_kernels", "ops.fused_net", "ops.int8_net",
                   "ops.int8_tower", "tools.matmul_rate",
                   "repro.width1_slice_write", "bench", "tools.ab_arena",
                   "tools.compare_snapshots", "tools.int8_ab",
                   "tools.cross_net_arena", "tools.gumbel_ab",
                   "tools.reuse_ab", "tools.kleaf_ab", "tools.harvest_run",
                   "tools.strength_probe", "tools.tactics_suites",
                   "tools.tactics_probe", "tools.distill_net",
                   "tools.policy_entropy_probe",
                   "tools.int8_calib_sensitivity", "tools.tt_rate_probe",
                   "tools.tree_kernel_microbench", "tools.search_cost_split",
                   "tools.hbm_budget", "tools.net_microbench",
                   "tools.int8_probe", "tools.device_parity",
                   "tools.gumbel_determinism_probe",
                   "tools.gumbel_flip_probe", "repro.envelope",
                   "repro.bisect_batch512", "repro.bisect_lockstep",
                   "repro.parent_probe", "repro.parent_longrun"):
        assert f"alphazero_gomoku_tpu_torch.{module}" in names
    for name in names:
        importlib.import_module(name)
    from alphazero_gomoku_tpu_torch.ops import _build
    assert not _build._LOADED


def test_kernel_wrappers_have_no_fallback():
    for name in ("ops/tree_kernels.py", "ops/fused_net.py",
                 "ops/int8_net.py", "ops/int8_tower.py",
                 "ops/game_kernels.py", "games/gomoku.py", "games/pente.py",
                 "tools/matmul_rate.py", "repro/width1_slice_write.py"):
        tree = ast.parse((PORT / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_root_script_loaded_by_path(path):
    """The root ``bench.py``, ``tools/`` and ``repro/`` are not packages: a
    port file could reach them only by path (or by putting ``tools/`` on
    ``sys.path``, as the JAX tactics probe does), which it must not."""
    text = path.read_text()
    for needle in ("spec_from_file_location", "runpy", "SourceFileLoader",
                   "sys.path"):
        assert needle not in text, f"{path.name} uses {needle}"


SEARCH = PORT / "search"


def _imports(path):
    """Every import statement of ``path``: ``(node, modules)``, relative
    modules resolved against the ``search`` package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield node, [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = "alphazero_gomoku_tpu_torch.search." + base
            yield node, [base] + [f"{base}.{a.name}" for a in node.names]


@pytest.mark.parametrize("path", sorted(SEARCH.glob("*.py")),
                         ids=lambda p: p.name)
def test_search_modules_import_only_at_the_top(path):
    """A function-level import hides a cycle between the search modules."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = [n for n in ast.walk(fn)
                     if isinstance(n, (ast.Import, ast.ImportFrom))]
            assert not inner, f"{path.name}: {fn.name} imports inside"


@pytest.mark.parametrize("name", ["tree.py", "gumbel.py"])
def test_search_config_and_halving_import_nothing_of_tree_packed(name):
    """``tree.py`` (config, noise, priors) and ``gumbel.py`` (halving
    schedule, completed Q) sit below ``tree_packed.py``, which imports both
    and holds the searches: the module graph's arrows point one way."""
    for _, modules in _imports(SEARCH / name):
        for mod in modules:
            assert "tree_packed" not in mod.split("."), \
                f"{name} imports {mod}"
