"""game_device_us_per_sim.selfplay: device time of the game step (the env's
methods: ``games/gomoku.py``, ``games/pente.py``, ``ops/lines.py``) a
simulation of the profiled ply, in us: the union of the device intervals
launched inside the harness's ranges around the env's methods / the
simulations in the slice.  Moves ``selfplay_moves_per_s``."""


def read(ctx):
    busy = ctx["slice"].busy_ns("game")
    if busy <= 0 or ctx["sims"] <= 0:
        return None
    return busy / 1e3 / ctx["sims"]
