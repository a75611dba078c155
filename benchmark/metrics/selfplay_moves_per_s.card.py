"""selfplay_moves_per_s.card: the live games' moves a second, as
``selfplay_moves_per_s`` counts them, over the calls of the traced run that
the profiler did not touch, in a cell whose end-to-end metric besides
set-up is ``selfplay_card_us_per_search``.  Moves
``selfplay_card_us_per_search``."""


def read(ctx):
    calls = [c for c in ctx["calls"] if not c["profiled"]]
    seconds = sum(c["seconds"] for c in calls)
    moves = sum(c["moves"] for c in calls)
    if seconds <= 0 or moves <= 0:
        return None
    return moves / seconds
