"""Game rule engines of the port (batched tensor transition functions)."""

from alphazero_gomoku_tpu_torch.games.gomoku import (  # noqa: F401
    GomokuEnv,
    GomokuState,
)


def make_env(name: str, size: int = 15):
    """Return the batched env for a game name (``"gomoku"`` only so far)."""
    name = name.lower()
    if name == "gomoku":
        return GomokuEnv(size)
    if name == "pente":
        raise NotImplementedError(
            "Pente is not ported yet (ROADMAP Queue A item 9)")
    raise ValueError(f"unknown game: {name!r} (expected 'gomoku' or 'pente')")
