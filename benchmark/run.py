"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  One process, on one card:

  1. set-up (``setup_s``): the CUDA context, the program's kernels (built
     by ``nvcc`` into ``alphazero_gomoku_tpu_torch/build/`` at first use,
     reused after), the weights (a checkpoint read and checked against its
     sha256, or drawn from the configuration's ``weights_seed`` by its
     architecture's ``init``), the int8 calibration, and a warm-up call of
     two plies at the cell's shapes;
  2. the window: whole calls of ``selfplay.runner.play_games`` back to back,
     each from empty boards with a generator on the card seeded from
     (``--seed``, call index), or, where the traffic names a ``game_pool``,
     from one of that many fixed calls in the seed's order
     (:func:`call_seed`), until ``--seconds`` have passed since the first
     began; ``selfplay_moves_per_s`` is the live games' moves of all calls
     over the time from the first call's start to the last call's
     synchronize.  In a cell that reports ``selfplay_card_us_per_search``
     the whole window runs under a profiler of the card's operations
     alone, and that metric is the union of their intervals
     (``trace.card_busy_ns``), in microseconds, over the window's
     searches: the lanes times the plies each call ran (a call searches
     every lane at every ply, a finished game's too).  With ``--trace 1``
     one ply of the first call is profiled
     and the per-layer metrics are read from it (``trace.py``,
     ``benchmark/metrics/``);
  3. the check: every record of every call replayed with the reference's
     rules, and the searches of a sample of lanes of one call (drawn from
     the seed, the longest game among them) replayed with the reference's
     search and net on the same draws (``reference/replay.py``);
  4. the result: the last line of standard output is one JSON object
     (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
     ``breakdown`` when traced, and ``checks`` last); the numbers compared
     and their limits are also the last lines of standard error.

It exits non-zero, printing no result, without a card, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``alphazero_gomoku_tpu`` is loaded
at the end (top-level module names compared whole).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Iterable, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "alphazero_gomoku_tpu")
# the end-to-end metric read from a profile of the whole window
CARD_TIME = "selfplay_card_us_per_search"


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that are forbidden, compared
    whole: ``alphazero_gomoku_tpu_torch`` is not ``alphazero_gomoku_tpu``."""
    return sorted({n.split(".")[0] for n in names}
                  & set(FORBIDDEN))


POOL_SEED = 20_260_000


def call_seed(seed: int, call: int, traffic: Optional[Dict] = None) -> int:
    """The generator seed of a run's call ``call``: drawn from (``seed``,
    ``call``); where the traffic names a ``game_pool`` of P, the seed of
    one of P fixed calls, every seed playing all P, in an order of its own
    (and then again in that order), so that every seed does one amount of
    work."""
    pool = (traffic or {}).get("game_pool")
    if not pool:
        return (int(seed) * 1_000_003 + call) % (1 << 63)
    order = list(range(pool))
    random.Random(int(seed)).shuffle(order)
    return call_seed(POOL_SEED, order[call % pool])


def check_sample(seed: int, n_calls: int, batch: int, k: int,
                 moves_played: List[List[int]]):
    """The call and the lanes the search check replays: drawn from the
    seed, with the call's longest game among the lanes."""
    rng = random.Random(int(seed) * 7919 + 1)
    call = rng.randrange(n_calls)
    lanes = rng.sample(range(batch), min(k, batch))
    moves = moves_played[call]
    longest = max(range(batch), key=lambda i: (moves[i], -i))
    if longest not in lanes:
        lanes[0] = longest
    return call, sorted(lanes)


def within(checks: Dict) -> bool:
    """Every number at or under its limit (a limit not set fails)."""
    return all(v["limit"] is not None and v["value"] <= v["limit"]
               for v in checks.values())


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def power_limit(index: int) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description="one benchmark run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def compare(spec: Dict, game, records: List[Dict], seed: int, params,
            stats, calib, device) -> Dict:
    """The reference's readings of the window's calls."""
    import torch

    from benchmark.reference import replay
    from benchmark.reference import search as rs

    tr = spec["traffic"]
    s = tr["search"]
    sp = replay.SelfPlay(batch=tr["lanes"], plies=tr["plies_per_call"],
                         temp_threshold=tr["temp_threshold"],
                         opening_random_moves=tr["opening_random_moves"])
    cfg = rs.SearchConfig(
        search=s["kind"], n_simulations=s["n_simulations"], cpuct=s["cpuct"],
        add_noise=s["add_noise"], dirichlet_alpha=s["dirichlet_alpha"],
        dirichlet_epsilon=s["dirichlet_epsilon"],
        dirichlet_moves=s["dirichlet_moves"], max_depth=s["max_depth"],
        reuse_budget=s["reuse_budget"],
        gumbel_max_considered=s["gumbel_max_considered"],
        gumbel_c_visit=s["gumbel_c_visit"],
        gumbel_c_scale=s["gumbel_c_scale"])
    t0 = time.perf_counter()
    bad = {"records": 0, "illegal": 0, "games": 0, "lanes": 0}
    for rec in records:
        for k, v in replay.game_mismatches(game, sp, rec).items():
            bad[k] += v
    moves = [rec["moves_played"].tolist() for rec in records]
    call, lanes = check_sample(seed, len(records), sp.batch,
                               spec["checks"]["lanes_compared"], moves)
    eval_ref = spec["net"].make(params, stats, calib, device,
                                spec["config"]["reference_net"])
    gen = torch.Generator(device=device).manual_seed(
        call_seed(seed, call, tr))
    gaps = replay.search_gaps(game, cfg, sp, eval_ref, records[call],
                              gen, lanes)
    n = max(1, len(gaps["tv"]))
    log(f"[check] call {call} lanes {lanes}: {len(gaps['tv'])} records "
        f"compared; game replay {bad}; {time.perf_counter() - t0:.2f} s")
    return {
        "numbers": {
            "game_mismatches": bad["records"] + bad["illegal"] + bad["games"],
            "pi_tv_mean": sum(gaps["tv"]) / n,
            "root_q_gap_mean": sum(gaps["q_gap"]) / n,
            "move_mismatch_pct": 100.0 * sum(gaps["moved"]) / n,
        },
        "failed_games": bad["lanes"],
        "compared": len(gaps["tv"]),
    }


def prepare(cell: Dict, device, root: str):
    """The set-up: the weights (the checkpoint read and checked, or drawn
    from ``weights_seed``: the same arrays go to the program and the
    reference), the calibration boards, the program's net and self-play,
    and a warm-up call of two plies.  Returns ``(program, reference game,
    params, batch_stats, calib)``."""
    import torch

    from benchmark import calib as bcalib
    from benchmark import checkpoint
    from benchmark import program as bprog
    from benchmark.reference.games import Game

    cfg, tr = cell["config"], cell["traffic"]
    if "weights_seed" in cfg:
        params, stats = cell["net"].init(cfg, cfg["weights_seed"], device)
    else:
        params, stats, _ = checkpoint.load(
            os.path.join(root, cfg["checkpoint"]), cfg["sha256"])
    game = Game(cfg["game"], cfg["board_size"],
                capture_planes=cfg["in_channels"] == 5)
    c = cfg["calib"]
    calib = bcalib.random_play_boards(game, c["n"], c["seed"])
    prog = bprog.Program(cfg, tr, params, stats, calib, device)
    prog.play(torch.Generator(device=device).manual_seed(call_seed(-1, 0)),
              plies=2)
    return prog, game, params, stats, calib


def judge(cell: Dict, numbers: Dict):
    """``(checks, correct)``: each number beside its limit."""
    limits = cell["checks"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, within(checks)


def main(argv=None, device=None, root: Optional[str] = None) -> int:
    """One run.  ``device`` and ``root`` are for the tests: a CPU device
    skips the look for a card; ``root`` is the checkout to read."""
    args = parse(argv)
    import numpy as np
    import torch

    from benchmark import spec as bspec, trace

    root = root or bspec.ROOT
    cell = bspec.cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA card: the benchmark runs only on one")
            return 2
        if torch.cuda.device_count() < cell["workload"]["chips"]:
            log(f"{args.workload} needs {cell['workload']['chips']} cards, "
                f"{torch.cuda.device_count()} found")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = cell["config"], cell["traffic"]
    log(f"[setup] {args.workload}: load average {os.getloadavg()[0]:.2f}")

    from benchmark import program as bprog
    prog, game, params, stats, calib = prepare(cell, device, root)
    sync()
    gc.collect()

    # the window
    probe = bprog.Probe(tr["trace_ply"]) if args.trace else None
    trajs, spans = [], []
    setup_s = time.perf_counter() - T0
    card = None
    if on_card and not args.trace and CARD_TIME in {
            m["name"] for m in cell["end_to_end"]}:
        card = trace.card_profiler()
        card.start()
    start = time.perf_counter()
    cpu0 = time.thread_time()
    while True:
        i = len(trajs)
        gen = torch.Generator(device=device).manual_seed(
            call_seed(args.seed, i, tr))
        c0 = time.perf_counter()
        trajs.append(prog.play(gen, probe=probe if i == 0 else None))
        sync()
        if i == 0 and probe is not None:
            probe.stop()
        c1 = time.perf_counter()
        spans.append((c0, c1))
        if c1 - start >= args.seconds:
            break
    window_s = spans[-1][1] - start
    cpu_s = time.thread_time() - cpu0
    card_ns = None
    if card is not None:
        t0 = time.perf_counter()
        card.stop()
        card_ns, card_ops = trace.card_busy_ns(card)
        del card
        log(f"[card] {card_ops} device operations in the window, busy "
            f"{card_ns / 1e9:.6f} s; read in {time.perf_counter() - t0:.1f} s")
    plies = tr["plies_per_call"]
    call_moves = [int(torch.clamp(t.moves_played, max=plies).sum())
                  for t in trajs]
    moves = sum(call_moves)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    # the main thread's CPU time: near the window where the host sets the
    # pace (a synchronize spins on the card)
    log(f"[window] {len(trajs)} calls, {moves} moves in {window_s:.3f} s "
        f"(main thread CPU {cpu_s:.3f} s); set-up {setup_s:.3f} s; calls "
        + ", ".join(f"{m} in {b - a:.3f} s"
                    for m, (a, b) in zip(call_moves, spans)))

    metrics: Dict[str, Dict] = {}
    breakdown = None
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(device) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    if on_card:
        dev_info["power_limit"] = power_limit(device.index or 0)
    if args.trace:
        sl = trace.from_profiler(probe.prof)
        ctx = {"slice": sl, "sims": probe.walks, "net_calls": probe.net_calls,
               "calls": [{"moves": m, "seconds": b - a, "profiled": i == 0}
                         for i, (m, (a, b)) in
                         enumerate(zip(call_moves, spans))],
               "config": cfg, "net": cell["net"], "traffic": tr}
        for m in cell["per_layer"]:
            v = bspec.metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = sl.breakdown()
        dev_info["busy_s"] = sl.busy_ns() / 1e9
        dev_info["window_s"] = sl.wall_ns / 1e9
        log(f"[trace] {probe.walks} simulations, {sl.count()} device ops, "
            f"{sl.unmatched()} without a launch in the trace; per layer "
            + ", ".join(f"{lay} {sl.count(lay)} ops "
                        f"{sl.busy_ns(lay) / 1e6:.3f} ms"
                        for lay in trace.LAYERS + (trace.GLUE,)))
        for lay in trace.LAYERS + (trace.GLUE,):
            log(f"[trace] {lay}: {sl.top_names(lay)}")
    else:
        values = {"selfplay_moves_per_s": moves / window_s,
                  "setup_s": setup_s}
        if card_ns is not None:
            # a call runs until its longest game ends or the ply cap
            searches = sum(tr["lanes"] * min(plies, int(t.moves_played.max()))
                           for t in trajs)
            values[CARD_TIME] = card_ns / 1e3 / searches
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # the check, after the program's net is gone
    prog.free()
    records = [bprog.records(t) for t in trajs]
    del trajs
    if on_card:
        torch.cuda.empty_cache()
    result = compare(cell, game, records, args.seed, params, stats,
                     np.asarray(calib), device)
    checks, correct = judge(cell, result["numbers"])

    found = forbidden_modules(sys.modules)
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    out = {"correct": correct, "attempted": len(records) * tr["lanes"],
           "failed": result["failed_games"], "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, v in checks.items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
