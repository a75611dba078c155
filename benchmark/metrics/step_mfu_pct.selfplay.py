"""step_mfu_pct.selfplay: the whole self-play step's share of the card's
peak, in %: moves x simulations a move x one board's evaluation
(``yardstick.net_flops_per_eval``) / seconds / the dense peak that the
configuration names (``peak``), over the calls of the traced run that the
profiler did not touch.  Moves ``selfplay_moves_per_s``."""

from benchmark import yardstick


def read(ctx):
    calls = [c for c in ctx["calls"] if not c["profiled"]]
    seconds = sum(c["seconds"] for c in calls)
    moves = sum(c["moves"] for c in calls)
    if seconds <= 0 or moves <= 0:
        return None
    cfg = ctx["config"]
    flops = yardstick.net_flops_per_eval(cfg["board_size"],
                                         cfg["n_res_blocks"],
                                         cfg["channels"], cfg["in_channels"])
    sims = ctx["traffic"]["search"]["n_simulations"]
    peak = yardstick.PEAK_OPS[cfg["peak"]]
    return 100.0 * moves * sims * flops / seconds / peak
