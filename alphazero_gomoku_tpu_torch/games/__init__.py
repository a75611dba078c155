"""Game rule engines of the port.

Counterpart of ``alphazero_gomoku_tpu/games/__init__.py``: the batched tensor
transition functions (``gomoku``, ``pente``; :func:`make_env`) and the NumPy
host engines with the reference's object API (``host``;
:func:`make_host_game`), which the play CLIs, the GUI and the pure-MCTS
player use.
"""

from alphazero_gomoku_tpu_torch.games.host import Gomoku, Pente  # noqa: F401
from alphazero_gomoku_tpu_torch.games.gomoku import (  # noqa: F401
    GomokuEnv,
    GomokuState,
)
from alphazero_gomoku_tpu_torch.games.pente import (  # noqa: F401
    PenteEnv,
    PenteState,
)


def make_env(name: str, size: int = 15, capture_planes: bool = False):
    """Return the batched env for a game name.

    ``capture_planes`` (Pente only) adds the two captured-pair observation
    planes; Gomoku ignores it.
    """
    name = name.lower()
    if name == "gomoku":
        return GomokuEnv(size)
    if name == "pente":
        return PenteEnv(size, capture_planes=capture_planes)
    raise ValueError(f"unknown game: {name!r} (expected 'gomoku' or 'pente')")


def make_host_game(name: str, size: int = 15):
    """Return a host-side object engine for a game name."""
    name = name.lower()
    if name == "gomoku":
        return Gomoku(size)
    if name == "pente":
        return Pente(size)
    raise ValueError(f"unknown game: {name!r} (expected 'gomoku' or 'pente')")
