"""device_ops_per_sim.selfplay: kernels, copies and sets the card ran in the
profiled ply, a simulation: the launches the host's glue pays for.  Moves
``selfplay_moves_per_s``."""


def read(ctx):
    n = ctx["slice"].count()
    if n <= 0 or ctx["sims"] <= 0:
        return None
    return n / ctx["sims"]
