"""device_idle_pct.selfplay: the share of the profiled ply in which the card
ran nothing, in %: 100 * (1 - union of kernel, copy and set intervals /
the slice's wall).  Moves ``selfplay_moves_per_s``."""


def read(ctx):
    sl = ctx["slice"]
    busy = sl.busy_ns()
    if busy <= 0 or sl.wall_ns <= 0:
        return None
    return 100.0 * (1.0 - busy / sl.wall_ns)
