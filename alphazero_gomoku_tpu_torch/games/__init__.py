"""Game rule engines of the port (batched tensor transition functions)."""

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
