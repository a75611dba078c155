"""Append-only text-file IPC for GUI mirror mode.

A copy of ``alphazero_gomoku_tpu/gui/mirror_ipc.py``.

Capability equivalent of the reference's two-file protocol (U2 in SURVEY.md
§2): the engine appends accepted moves to ``mirror_log.txt``
(``gui.py:157-160``) which the spectator UI tails and re-applies
(``interface.py:740-768``); human clicks in the UI are appended to
``input_log.txt`` and polled by the engine (``interface.py:727-738``,
``gui.py:111-134``).  Lines are ``"r,c"`` (0-based); malformed lines are
tolerated and skipped.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

MIRROR_LOG = "mirror_log.txt"
INPUT_LOG = "input_log.txt"


class MoveLogWriter:
    """Appends moves to a log file, creating/truncating it on start."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "w"):
            pass

    def append(self, move: Tuple[int, int]) -> None:
        with open(self.path, "a") as f:
            f.write(f"{int(move[0])},{int(move[1])}\n")


class MoveLogTailer:
    """Incrementally reads new "r,c" lines from a log file."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def poll(self) -> List[Tuple[int, int]]:
        if not os.path.exists(self.path):
            return []
        moves: List[Tuple[int, int]] = []
        with open(self.path, "r") as f:
            f.seek(self._offset)
            for line in f:
                if not line.endswith("\n"):
                    break  # partial write; re-read next poll
                self._offset += len(line)
                parsed = parse_move_line(line)
                if parsed is not None:
                    moves.append(parsed)
        return moves


def parse_move_line(line: str) -> Optional[Tuple[int, int]]:
    try:
        r_s, c_s = line.strip().split(",")
        return (int(r_s), int(c_s))
    except (ValueError, AttributeError):
        return None
