"""The readings the comparison's limits are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--out PATH]

One process sets the cell up once (as a run does), then for each seed plays
the call a run's window would start with (call 0, its generator seeded from
the seed) and judges it as a run judges its window: the program's readings.
For each control seed it plays the same call with the reference's net at
the configuration's ``control_net`` (``reference/net.py``; for the int8
configurations ``qmax`` 7, int4, the step below int8) in the program's
net's place, on the program's searches, and judges that: the control's
readings, which have to fail.  Each reading is a JSON
line on standard output (and in ``--out``).  The benchmark's runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import program as bprog
from benchmark import run
from benchmark import spec as bspec
from benchmark.reference import net as rnet

def control_eval(config, params, stats, calib, device):
    """The reference's net at the configuration's ``control_net``, as the
    program's eval function (``eval_fn(net, obs) -> (probs, value
    [B, 1])``)."""
    net = rnet.make(params, stats, calib, device, config["control_net"])

    def eval_fn(_net, obs):
        probs, value = net(obs)
        return probs, value[:, None]
    return eval_fn


def readings(cell, prog, game, params, stats, calib, device, seeds,
             control: bool):
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(
            run.call_seed(seed, 0))
        t0 = time.perf_counter()
        traj = prog.play(gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        play_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        res = run.compare(cell, game, [bprog.records(traj)], seed, params,
                          stats, calib, device)
        checks, correct = run.judge(cell, res["numbers"])
        yield {"side": "control" if control else "program", "seed": seed,
               "play_s": play_s, "check_s": time.perf_counter() - t1,
               "compared": res["compared"], "numbers": res["numbers"],
               "correct_at_limits": correct}


def main(argv=None, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    root = root or bspec.ROOT
    cell = bspec.cell(a.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog, game, params, stats, calib = run.prepare(cell, device, root)

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    out = open(a.out, "a") if a.out else None
    for control, which in ((False, a.seeds), (True, a.control_seeds)):
        if control:
            prog.eval_fn = control_eval(cell["config"], params, stats, calib,
                                        device)
        for row in readings(cell, prog, game, params, stats, calib, device,
                            seeds(which), control):
            line = json.dumps(dict(row, workload=a.workload))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
