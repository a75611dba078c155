"""On the card: does the Gumbel search on the kernels repeat itself?

Counterpart of the JAX repo's ``tools/gumbel_determinism_probe.py``.  A race
in a kernel (a read before another thread's write lands, an unordered
reduction) shows as run-to-run variance; the same search on the same inputs
must give the same pi, root_q and root action bit for bit every time.  This
runs one Gumbel search (``GUMBEL_SIMS`` simulations, 64 random-play
positions at 15x15, the seeded 2x64 net of ``tools/device_parity.py`` on the
int8 tower) ``N`` times on the kernels (K3, K2, K5), and twice on the plain
versions as the control, and holds the first kernel run against the plain
one (they are equal bit for bit by design).

    python -m alphazero_gomoku_tpu_torch.tools.gumbel_determinism_probe [N]

One JSON line; exit 1 unless the kernel runs repeat.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_inference
from alphazero_gomoku_tpu_torch.search import MCTSConfig, run_search
from alphazero_gomoku_tpu_torch.tools.device_parity import (
    INFER,
    make_sides,
    random_states,
)

SIZE, BATCH, PLIES, GUMBEL_SIMS = 15, 64, 6, 96


def main(argv=None, device=None):
    """``argv[0]`` the kernel runs (4 by default); ``device`` None is the
    card."""
    n_rep = int(argv[0]) if argv else 4
    dev = resolve_device(device)
    env = make_env("gomoku", SIZE)
    model = AZModel(board_size=SIZE, n_res_blocks=2, channels=64, seed=11,
                    device=dev)
    eval_fn, bundle = make_inference(INFER, model.cfg, *model.jax_params(),
                                     device=dev)
    sides = make_sides(model.cfg, eval_fn)
    cfg = MCTSConfig(n_simulations=GUMBEL_SIMS, add_noise=False,
                     max_depth=56, search="gumbel")
    states = random_states(env, BATCH, PLIES, PLIES, dev)

    def run(side):
        fn, ops = sides[side]
        gen = torch.Generator(device=dev).manual_seed(7)
        pi, root_q, action, _ = run_search(env, cfg, fn, bundle, states,
                                           generator=gen, ops=ops)
        return [x.cpu().numpy() for x in (pi, root_q, action)]

    outs = []
    for r in range(n_rep):
        t0 = time.time()
        outs.append(run("kernels"))
        print(f"kernel rep {r}: {time.time() - t0:.2f}s", flush=True)
    plain = [run("plain") for _ in range(2)]

    def stable(runs):
        return all(all((a == b).all() for a, b in zip(runs[0], o))
                   for o in runs[1:])

    kernels_stable, plain_stable = stable(outs), stable(plain)
    cross = float(np.abs(outs[0][0] - plain[0][0]).max())
    print(json.dumps({
        "kernels_deterministic": bool(kernels_stable),
        "plain_deterministic": bool(plain_stable),
        "repeats": n_rep,
        "kernels_equal_plain": bool(stable([outs[0], plain[0]])),
        "cross_backend_pi_max_diff": cross,
        "verdict": ("deterministic" if kernels_stable and plain_stable
                    else "NONDETERMINISM: suspect a race in a kernel"),
    }), flush=True)
    return 0 if kernels_stable else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
