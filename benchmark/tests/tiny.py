"""A small benchmark checkout for the CPU tests: a 1x8 net's checkpoint (or
its ``weights_seed``), its configuration, a short traffic mix and a cell,
with the real architectures and metric readers, in a temporary
directory."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import checkpoint, spec
from benchmark.spec import HERE

SEARCH = {"cpuct": 1.0, "add_noise": True, "dirichlet_alpha": 0.05,
          "dirichlet_epsilon": 0.25, "dirichlet_moves": 20, "max_depth": 8,
          "reuse_budget": 0, "gumbel_max_considered": 4,
          "gumbel_c_visit": 50.0, "gumbel_c_scale": 1.0}


def _save(path, params, stats, meta):
    from alphazero_gomoku_tpu_torch.models.checkpoint import save_checkpoint
    save_checkpoint(path, {"params": params, "batch_stats": stats,
                           "opt_state": {}}, meta)


INT8 = {"precision": "int8t", "peak": "int8", "reference_net": {"qmax": 127},
        "control_net": {"qmax": 7}}


def make_root(tmp, game="gomoku", search="puct", size=7, lanes=8,
              plies=6, sims=8, reuse=0, limits=None, channels=8,
              precision=None, weights_seed=None,
              like="gomoku-puct400-b128", game_pool=None):
    """A checkout in ``tmp`` with one cell, ``tiny``; returns its root.
    Its weights are a checkpoint of ``nets/resnet.py``'s ``init`` at seed
    3, or with ``weights_seed`` that seed in the configuration.  It
    reports the metrics of the committed cell ``like``; its traffic names
    ``game_pool`` where that is given."""
    root = str(tmp)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "checks"), exist_ok=True)
    for d in ("metrics", "nets"):
        shutil.copytree(os.path.join(HERE, d),
                        os.path.join(root, "benchmark", d),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cin = 5 if game == "pente" else 3
    config = {"name": "tiny-net", "source": "test", "reduced": [],
              "game": game, "board_size": size, "action_size": size * size,
              "in_channels": cin, "n_res_blocks": 1, "channels": channels,
              "value_hidden": 64, **(precision or INT8),
              "calib": {"kind": "random_play", "n": 32, "seed": 5}}
    if weights_seed is None:
        params, stats = spec.net("resnet").init(config, 3)
        os.makedirs(os.path.join(root, "ckpt"), exist_ok=True)
        ck = os.path.join(root, "ckpt", "tiny.ckpt")
        _save(ck, params, stats, {"board_size": size, "n_res_blocks": 1,
                                  "channels": channels, "in_channels": cin})
        config.update(checkpoint="ckpt/tiny.ckpt",
                      sha256=checkpoint.sha256(ck))
    else:
        config["weights_seed"] = weights_seed
    traffic = {"lanes": lanes, "plies_per_call": plies,
               "opening_random_moves": 2, "temp_threshold": 4,
               "trace_ply": 2,
               "search": dict(SEARCH, kind=search, n_simulations=sims,
                              reuse_budget=reuse)}
    if game_pool is not None:
        traffic["game_pool"] = game_pool
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
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"] = ["tiny"]
    for path, obj in (("benchmark/configs/tiny-net.json", config),
                      ("benchmark/traffic/tiny-mix.json", traffic),
                      ("benchmark/checks/tiny.json", checks),
                      ("BENCHMARK.json", bench)):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return root
