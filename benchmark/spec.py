"""What a run reads: ``BENCHMARK.json`` and the files it names.

Everything of one configuration, traffic mix, cell or per-layer metric sits
in a file of its own, found by its name:

  - ``benchmark/configs/<config>.json``: the net, its weights (path and
    sha256), its calibration boards, and its precision as data: the
    program's inference mode (``precision``), the peak that bounds it
    (``peak``, a key of ``yardstick.PEAK_OPS``), and the reference's net
    and the control's (``reference_net``, ``control_net``: ``{"qmax": q}``
    quantized or ``{"dtype": d}`` float, ``reference/net.make``);
  - ``benchmark/traffic/<traffic>.json``: the self-play a call plays
    (lanes, plies, search settings, the traced ply);
  - ``benchmark/checks/<cell>.json``: what the comparison samples and the
    limit of each number it compares;
  - ``benchmark/metrics/<metric>.py``: a ``read(ctx)`` that returns the
    per-layer metric, or None where it finds nothing to read.

A later change adds a configuration, a traffic mix, a cell or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CONFIG_KEYS = ("name", "source", "game", "board_size", "in_channels",
               "n_res_blocks", "channels", "value_hidden", "precision",
               "peak", "reference_net", "control_net", "checkpoint",
               "sha256", "calib")
TRAFFIC_KEYS = ("lanes", "plies_per_call", "opening_random_moves",
                "temp_threshold", "trace_ply", "search")
SEARCH_KEYS = ("kind", "n_simulations", "cpuct", "add_noise",
               "dirichlet_alpha", "dirichlet_epsilon", "dirichlet_moves",
               "max_depth", "reuse_budget", "gumbel_max_considered",
               "gumbel_c_visit", "gumbel_c_scale")
CHECK_KEYS = ("lanes_compared", "limits")
LIMIT_KEYS = ("game_mismatches", "pi_tv_mean", "root_q_gap_mean",
              "move_mismatch_pct")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _need(d: Dict, keys, what: str):
    missing = [k for k in keys if k not in d]
    if missing:
        raise ValueError(f"{what}: missing {missing}")


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, root: str = ROOT) -> Dict:
    c = _json(os.path.join(root, "benchmark", "configs", name + ".json"))
    _need(c, CONFIG_KEYS, f"configuration {name}")
    if c["name"] != name:
        raise ValueError(f"configuration file {name}.json names {c['name']}")
    for k in ("reference_net", "control_net"):
        if len(c[k]) != 1 or not set(c[k]) <= {"qmax", "dtype"}:
            raise ValueError(f"configuration {name}: {k} is one of "
                             "{'qmax': q} and {'dtype': d}")
    return c


def traffic(name: str, root: str = ROOT) -> Dict:
    t = _json(os.path.join(root, "benchmark", "traffic", name + ".json"))
    _need(t, TRAFFIC_KEYS, f"traffic {name}")
    _need(t["search"], SEARCH_KEYS, f"traffic {name}: search")
    if t["search"]["kind"] not in ("puct", "gumbel"):
        raise ValueError(f"traffic {name}: unknown search kind")
    return t


def checks(cell: str, root: str = ROOT) -> Dict:
    c = _json(os.path.join(root, "benchmark", "checks", cell + ".json"))
    _need(c, CHECK_KEYS, f"checks {cell}")
    _need(c["limits"], LIMIT_KEYS, f"checks {cell}: limits")
    return c


def metric_reader(name: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(name: str, root: str = ROOT) -> Dict:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic,
    checks, and the metrics it reports (end-to-end and per-layer)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": config(w["config"], root),
        "traffic": traffic(w["traffic"], root),
        "checks": checks(name, root),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "run_seconds": bench["run_seconds"],
    }
