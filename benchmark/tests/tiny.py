"""A small benchmark checkout for the CPU tests: a 1x8 net's checkpoint,
its configuration, a short traffic mix and a cell, with the real metric
readers, in a temporary directory."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from benchmark import checkpoint
from benchmark.spec import HERE

SEARCH = {"cpuct": 1.0, "add_noise": True, "dirichlet_alpha": 0.05,
          "dirichlet_epsilon": 0.25, "dirichlet_moves": 20, "max_depth": 8,
          "reuse_budget": 0, "gumbel_max_considered": 4,
          "gumbel_c_visit": 50.0, "gumbel_c_scale": 1.0}


def _net(rng, cin, c, size, blocks, hidden=64):
    def conv(k, ci, co):
        return (rng.standard_normal((k, k, ci, co)) * np.sqrt(
            2.0 / (k * k * ci))).astype(np.float32)

    def bn(ch):
        return ({"scale": (1 + 0.1 * rng.standard_normal(ch)).astype(
                    np.float32),
                 "bias": (0.1 * rng.standard_normal(ch)).astype(np.float32)},
                {"mean": (0.1 * rng.standard_normal(ch)).astype(np.float32),
                 "var": (1 + 0.1 * rng.random(ch)).astype(np.float32)})

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(
            np.float32), "b": np.zeros(o, np.float32)}

    hw = size * size
    params, stats = {}, {}
    params["stem"] = {"w": conv(3, cin, c)}
    params["stem_bn"], stats["stem_bn"] = bn(c)
    params["blocks"], stats["blocks"] = [], []
    for _ in range(blocks):
        p1, s1 = bn(c)
        p2, s2 = bn(c)
        params["blocks"].append({"conv1": {"w": conv(3, c, c)}, "bn1": p1,
                                 "conv2": {"w": conv(3, c, c)}, "bn2": p2})
        stats["blocks"].append({"bn1": s1, "bn2": s2})
    params["policy_conv"] = {"w": conv(1, c, 2)}
    params["policy_bn"], stats["policy_bn"] = bn(2)
    params["policy_fc"] = dense(2 * hw, hw)
    params["value_conv"] = {"w": conv(1, c, 1)}
    params["value_bn"], stats["value_bn"] = bn(1)
    params["value_fc1"] = dense(hw, hidden)
    params["value_fc2"] = dense(hidden, 1)
    return params, stats


def _save(path, params, stats, meta):
    from alphazero_gomoku_tpu_torch.models.checkpoint import save_checkpoint
    save_checkpoint(path, {"params": params, "batch_stats": stats,
                           "opt_state": {}}, meta)


INT8 = {"precision": "int8t", "peak": "int8", "reference_net": {"qmax": 127},
        "control_net": {"qmax": 7}}


def make_root(tmp, game="gomoku", search="puct", size=7, lanes=8,
              plies=6, sims=8, reuse=0, limits=None, channels=8,
              precision=None):
    """A checkout in ``tmp`` with one cell, ``tiny``; returns its root."""
    root = str(tmp)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "checks"), exist_ok=True)
    os.makedirs(os.path.join(root, "ckpt"), exist_ok=True)
    shutil.copytree(os.path.join(HERE, "metrics"),
                    os.path.join(root, "benchmark", "metrics"),
                    dirs_exist_ok=True)
    cin = 5 if game == "pente" else 3
    params, stats = _net(np.random.default_rng(3), cin, channels, size, 1)
    ck = os.path.join(root, "ckpt", "tiny.ckpt")
    _save(ck, params, stats, {"board_size": size, "n_res_blocks": 1,
                              "channels": channels, "in_channels": cin})
    config = {"name": "tiny-net", "source": "test", "reduced": [],
              "game": game, "board_size": size, "action_size": size * size,
              "in_channels": cin, "n_res_blocks": 1, "channels": channels,
              "value_hidden": 64, **(precision or INT8),
              "checkpoint": "ckpt/tiny.ckpt", "sha256": checkpoint.sha256(ck),
              "calib": {"kind": "random_play", "n": 32, "seed": 5}}
    traffic = {"lanes": lanes, "plies_per_call": plies,
               "opening_random_moves": 2, "temp_threshold": 4,
               "trace_ply": 2,
               "search": dict(SEARCH, kind=search, n_simulations=sims,
                              reuse_budget=reuse)}
    checks = {"lanes_compared": 3, "limits": limits or {
        "game_mismatches": 0, "pi_tv_mean": 1e-6, "root_q_gap_mean": 1e-6,
        "move_mismatch_pct": 0.0}}
    bench = json.load(open(os.path.join(os.path.dirname(HERE),
                                        "BENCHMARK.json")))
    bench["configs"] = [{"name": "tiny-net", "source": "test",
                         "file": "benchmark/configs/tiny-net.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny", "config": "tiny-net",
                           "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    for path, obj in (("benchmark/configs/tiny-net.json", config),
                      ("benchmark/traffic/tiny-mix.json", traffic),
                      ("benchmark/checks/tiny.json", checks),
                      ("BENCHMARK.json", bench)):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return root
