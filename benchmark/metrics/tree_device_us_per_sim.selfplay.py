"""tree_device_us_per_sim.selfplay: device time of the tree functions (the
walks and backups of ``ops/tree_kernels.py``, whatever implements them) a
simulation of the profiled ply, in us: the union of the device intervals
launched inside the harness's ranges around the ``TreeOps`` functions /
the simulations (walks) in the slice.  Moves ``selfplay_moves_per_s``."""


def read(ctx):
    busy = ctx["slice"].busy_ns("tree")
    if busy <= 0 or ctx["sims"] <= 0:
        return None
    return busy / 1e3 / ctx["sims"]
