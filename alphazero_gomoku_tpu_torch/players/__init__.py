"""Match-play player plugins (the reference's ``players/`` protocol).

Counterpart of ``alphazero_gomoku_tpu/players/__init__.py``.  Each module
exposes a class named ``Player`` constructed as ``Player(rules, size)`` with
a method ``play(board, turn_number, last_opponent_move) -> (r, c) | None``
(reference ``players/player.py:54``, loaded dynamically by module name in
``play.py:19-30``).  ``load_player`` resolves short names like
``"player_mcts"`` against this package first, so that no short name reaches
the repo root's modules of the same name, which drive the JAX package.
"""

import importlib
import time
from typing import Optional, Tuple


def request_move(player, game, turn_number: int, max_retries: int = 20,
                 log=print) -> Optional[Tuple[int, int]]:
    """Ask a player for one legal move and APPLY it; None means forfeit.

    Shared by the match CLI, tournament runner and GUI engine so that
    None/illegal-move handling is identical everywhere: each bad attempt
    (exception, None, out-of-bounds, occupied) counts toward
    ``max_retries``; exhausting them forfeits. Returns the applied move and
    prints per-move think time like the reference runners.
    """
    for _ in range(max_retries):
        t0 = time.time()
        try:
            move = player.play(game.clone(), turn_number, game.last_move)
        except Exception as e:  # noqa: BLE001 — plugin code is untrusted
            log(f"player {game.current_player} raised: {e}")
            continue
        log(f"  think time: {time.time() - t0:.2f}s")
        if move is None:
            log("player returned no move; retrying")
            continue
        if game.do_move(move):  # validates bounds + occupancy
            return tuple(move)
        log(f"illegal move {move}; retrying")
    log(f"player {game.current_player} failed to produce a legal move; "
        "forfeits")
    return None


def load_player(module_name: str, rules: str, size: int, **player_kwargs):
    """Instantiate a ``Player`` from a module name (reference play.py:19-30).

    ``player_kwargs`` override the module's constructor defaults (e.g.
    ``n_simulations=400, model_path="checkpoints/foo.ckpt"`` or
    ``device="cpu"`` for the AlphaZero variants, ``n_playout=50`` for the
    pure-MCTS player).  Only a candidate module that does not exist moves
    the search on to the next one; a module that exists but fails to import
    raises, so that it is never replaced by another of the same name.
    """
    module_name = module_name.replace(".py", "").strip()
    candidates = [
        f"alphazero_gomoku_tpu_torch.players.{module_name}",
        module_name,
        f"players.{module_name}",
    ]
    last_err = None
    for name in candidates:
        try:
            module = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name is None or not (name == e.name
                                      or name.startswith(e.name + ".")):
                raise
            last_err = e
            continue
        if hasattr(module, "Player"):
            return module.Player(rules, size, **player_kwargs)
        raise ValueError(f"no Player class found in {name}")
    raise ValueError(f"could not load player {module_name!r}: {last_err}")
