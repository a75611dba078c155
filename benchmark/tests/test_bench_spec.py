"""BENCHMARK.json and the files it names: they load, they keep to the
format and limits the file must meet, and a new configuration, traffic
mix, cell or metric is picked up by adding files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import checkpoint, spec
from benchmark.spec import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return spec.benchmark()


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= len(b["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {"setup_s", "selfplay_moves_per_s"} <= {
        m["name"] for m in b["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cell_loads(cell):
    c = spec.cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["trace_ply"] >= 1
    limits = c["checks"]["limits"]
    assert all(v is not None for v in limits.values())
    assert {m["name"] for m in c["end_to_end"]} == {"setup_s",
                                                    "selfplay_moves_per_s"}
    assert len(c["per_layer"]) >= 1
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.benchmark()["configs"]])
def test_config_pins_its_checkpoint(name):
    c = spec.config(name)
    entry = [x for x in _bench()["configs"] if x["name"] == name][0]
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert entry["reduced"] == c["reduced"] == []
    assert checkpoint.sha256(os.path.join(ROOT, c["checkpoint"])) \
        == c["sha256"]
    params, stats, meta = checkpoint.load(
        os.path.join(ROOT, c["checkpoint"]), c["sha256"])
    for key in ("board_size", "n_res_blocks", "channels", "in_channels"):
        assert meta[key] == c[key]
    assert params["stem"]["w"].shape == (3, 3, c["in_channels"],
                                         c["channels"])
    assert len(params["blocks"]) == c["n_res_blocks"]


def test_wrong_checkpoint_is_refused():
    c = spec.config("gomoku15-6x128-int8t")
    with pytest.raises(ValueError, match="sha256"):
        checkpoint.load(os.path.join(ROOT, c["checkpoint"]), "0" * 64)


def test_every_config_and_metric_is_used():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"] + b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_additions_need_no_edit(tmp_path):
    """A copy of the checkout takes a new configuration, traffic mix, cell
    and per-layer metric from new files and entries alone."""
    root = tmp_path
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    conf = spec.config("gomoku15-6x128-int8t")
    conf["name"] = "gomoku15-6x128-int8t-copy"
    (root / "benchmark" / "configs" / "gomoku15-6x128-int8t-copy.json"
     ).write_text(json.dumps(conf))
    mix = spec.traffic("puct400-b128")
    mix["lanes"] = 256
    (root / "benchmark" / "traffic" / "puct400-b256.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "checks" / "new-cell.json").write_text(
        json.dumps(spec.checks("gomoku-puct400-b128")))
    (root / "benchmark" / "metrics" / "sims_in_slice.selfplay.py"
     ).write_text("def read(ctx):\n    return float(ctx['sims'])\n")
    b["configs"].append({"name": conf["name"], "source": "x",
                         "file": "benchmark/configs/"
                                 "gomoku15-6x128-int8t-copy.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new-cell", "config": conf["name"],
                           "traffic": "puct400-b256", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "sims_in_slice.selfplay", "unit": "sims",
                           "better": "higher", "source": "program_counter",
                           "layer": "search driver", "moves":
                           "selfplay_moves_per_s",
                           "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.cell("new-cell", str(root))
    assert c["traffic"]["lanes"] == 256
    assert c["config"]["name"] == "gomoku15-6x128-int8t-copy"
    # the metrics with no ``workloads`` list, and the one listing it
    assert [m["name"] for m in c["per_layer"]] == [
        m["name"] for m in b["per_layer"]]
    old = spec.cell("gomoku-puct400-b128", str(root))
    assert "sims_in_slice.selfplay" not in [m["name"]
                                            for m in old["per_layer"]]
    assert spec.metric_reader("sims_in_slice.selfplay", str(root))(
        {"sims": 7}) == 7.0
    # the cells already there are as they were
    assert spec.cell("gomoku-puct400-b128", str(root))["traffic"] \
        == spec.traffic("puct400-b128")
