"""BENCHMARK.json and the files it names: they load, they keep to the
format and limits the file must meet, and a new architecture,
configuration, traffic mix, cell or metric is picked up by adding files
alone."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import checkpoint, program, run, spec
from benchmark.spec import HERE, ROOT
from benchmark.tests import tiny
from benchmark.trace import Slice

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
    # set-up and one more end-to-end metric, which every per-layer metric
    # of the cell moves
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) == 2
    assert len(c["per_layer"]) >= 1
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in names


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


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.benchmark()["configs"]])
def test_seeded_weights_are_the_checkpoints_layout(name):
    """``nets/resnet.py``'s ``init``: the checkpoint's arrays, float32,
    the same for a seed and other for another, batch norm not the
    identity."""
    c = spec.config(name)
    init = spec.net("resnet").init
    params, stats = init(c, 2 ** 31 + 3)
    again = init(c, 2 ** 31 + 3)
    other = init(c, 2 ** 31 + 4)
    shipped = checkpoint.load(os.path.join(ROOT, c["checkpoint"]),
                              c["sha256"])
    for i, tree in enumerate((params, stats)):
        got = dict(_leaves(tree))
        want = dict(_leaves(shipped[i]))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.dtype == np.float32 and v.shape == want[k].shape, k
            assert np.array_equal(v, dict(_leaves(again[i]))[k]), k
            if not k.endswith("/b"):
                assert not np.array_equal(v, dict(_leaves(other[i]))[k]), k
    for bn, st in ((params["stem_bn"], stats["stem_bn"]),
                   (params["value_bn"], stats["value_bn"])):
        assert (bn["scale"] != 1).all() and (bn["bias"] != 0).all()
        assert (st["mean"] != 0).all() and (st["var"] > 1).all()


def _copy(root):
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)


def _write_config(root, conf):
    (root / "benchmark" / "configs" / (conf["name"] + ".json")).write_text(
        json.dumps(conf))


@pytest.mark.parametrize("change,match", [
    ({"arch": "nosuch"}, "benchmark/nets/nosuch.py"),
    ({"arch": "../reference/net"}, "no file"),
    ({"n_res_blocks": None}, "n_res_blocks"),
    ({"sha256": None}, "weights"),
    ({"weights_seed": 5}, "weights"),
    ({"checkpoint": None, "sha256": None}, "weights"),
    ({"checkpoint": None, "sha256": None, "weights_seed": 5.0}, "weights"),
])
def test_config_is_refused(tmp_path, change, match):
    """An unknown architecture names the file it lacks; a configuration
    without its architecture's keys, or without exactly one source of
    weights, is refused."""
    _copy(tmp_path)
    conf = spec.config("gomoku15-6x128-int8t")
    conf["name"] = "changed"
    for k, v in change.items():
        if v is None:
            del conf[k]
        else:
            conf[k] = v
    _write_config(tmp_path, conf)
    with pytest.raises(ValueError, match=re.escape(match)):
        spec.config("changed", str(tmp_path))


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


TOY = """
import numpy as np

KEYS = ("toy_width",)


def init(config, seed, device="cpu"):
    return {"w": np.full(config["toy_width"], seed, np.float32)}, {}


def make(params, stats, calib, device, spec):
    raise LookupError(f"the toy reference at {spec}")


def flops_per_eval(config):
    return 1000.0 * config["toy_width"]


def call_least_s(batch, config):
    return 1e-9 * batch * config["toy_width"]
"""


def _toy_records(tmp_path):
    """The tiny cell, its records of one call, and what ``run.compare``
    takes beside them."""
    root = tiny.make_root(tmp_path)
    cell = spec.cell("tiny", root)
    dev = torch.device("cpu")
    prog, game, params, stats, calib = run.prepare(cell, dev, root)
    traj = prog.play(torch.Generator(device=dev).manual_seed(1))
    return cell, game, [program.records(traj)], params, stats, calib


def test_additions_need_no_edit(tmp_path):
    """A copy of the checkout takes a new architecture, configuration,
    traffic mix, cell and per-layer metric from new files and entries
    alone: the architecture's keys are checked, the metric readers divide
    by its counts, and the check's reference is its ``make``."""
    root = tmp_path / "checkout"
    root.mkdir()
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
    # the metrics with no ``workloads`` list (none), and the one listing it
    assert [m["name"] for m in c["per_layer"]] == ["sims_in_slice.selfplay"]
    old = spec.cell("gomoku-puct400-b128", str(root))
    assert "sims_in_slice.selfplay" not in [m["name"]
                                            for m in old["per_layer"]]
    assert spec.metric_reader("sims_in_slice.selfplay", str(root))(
        {"sims": 7}) == 7.0
    # the cells already there are as they were
    assert spec.cell("gomoku-puct400-b128", str(root))["traffic"] \
        == spec.traffic("puct400-b128")

    # an architecture: its module, a configuration naming it, a cell
    (root / "benchmark" / "nets" / "toy.py").write_text(TOY)
    toy = {k: v for k, v in spec.config("gomoku15-6x128-int8t").items()
           if k not in ("n_res_blocks", "channels", "value_hidden",
                        "checkpoint", "sha256")}
    toy.update(name="toy-net", arch="toy", weights_seed=11)
    _write_config(root, toy)
    with pytest.raises(ValueError, match="toy_width"):
        spec.config("toy-net", str(root))
    toy["toy_width"] = 3
    _write_config(root, toy)
    (root / "benchmark" / "checks" / "toy-cell.json").write_text(
        json.dumps(spec.checks("gomoku-puct400-b128")))
    b["configs"].append({"name": "toy-net", "source": "x",
                         "file": "benchmark/configs/toy-net.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "toy-cell", "config": "toy-net",
                           "traffic": "puct400-b128", "chips": 1,
                           "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.cell("toy-cell", str(root))
    assert c["net"].KEYS == ("toy_width",)
    assert c["net"].init(c["config"], 11)[0]["w"].tolist() == [11.0] * 3
    ctx = {"slice": Slice(0, 100, [("net", 0, 50)], {1: 10},
                          [("conv", 20, 40, 1)]),
           "net_calls": [128, 64], "sims": 4,
           "calls": [{"moves": 10, "seconds": 1.0, "profiled": True},
                     {"moves": 600, "seconds": 2.0, "profiled": False}],
           "config": c["config"], "net": c["net"], "traffic": c["traffic"]}

    def read(metric):
        return spec.metric_reader(metric, str(root))(ctx)

    assert read("net_roofline_pct.selfplay") == pytest.approx(
        100 * 1e-9 * 192 * 3 * 1e9 / 20)
    assert read("step_mfu_pct.selfplay") == pytest.approx(
        100 * 600 * 400 * 3000.0 / 2.0 / 1978.9e12)
    # the check's reference is the architecture's ``make``
    cell, game, records, params, stats, calib = _toy_records(
        tmp_path / "tiny")
    with pytest.raises(LookupError, match="the toy reference at"):
        run.compare(dict(cell, net=c["net"]), game, records, 1, params,
                    stats, calib, torch.device("cpu"))
