"""The port's GUI: the mirror-mode file IPC, the engine and the pygame views.

``gui/engine.run_engine`` plays bot against bot in each package with the
pure-MCTS players' ``random.Random()`` seeded in the order they are made
(the same in both engines): the two ``mirror_log.txt`` files must hold the
same lines.  The engine spawns the PORT's mirror (a patched ``Popen``
records the command), and importing ``gui.engine`` or ``gui.interface``
must not import pygame (the card's machine has none).  The headless
rendering tests of ``tests/test_gui.py`` run on the port's views, where
pygame is installed (``importorskip``).
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import alphazero_gomoku_tpu.gui.engine as jengine
import alphazero_gomoku_tpu.search.pure_mcts as jpm
import alphazero_gomoku_tpu_torch.gui.engine as tengine
import alphazero_gomoku_tpu_torch.search.pure_mcts as tpm
from alphazero_gomoku_tpu_torch.gui.mirror_ipc import (
    MoveLogTailer,
    MoveLogWriter,
    parse_move_line,
)

from torch_port_play import seed_pure_mcts

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("game,size,moves", [("gomoku", 7, 12),
                                             ("pente", 9, 16)])
def test_engine_bot_vs_bot_writes_the_jax_mirror_log(game, size, moves,
                                                     tmp_path, monkeypatch):
    logs = {}
    for name, engine, pm in (("jax", jengine, jpm), ("port", tengine, tpm)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        seed_pure_mcts(monkeypatch, pm)
        engine.run_engine(game, size=size, p1="player_mcts",
                          p2="player_mcts", spawn_mirror=False,
                          max_moves=moves)
        logs[name] = (d / "mirror_log.txt").read_text().splitlines()
    assert logs["port"] == logs["jax"]
    assert 0 < len(logs["port"]) <= moves
    parsed = [parse_move_line(ln) for ln in logs["port"]]
    assert None not in parsed


def test_engine_spawns_the_port_mirror_and_stops_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    spawned = []

    class FakeProc:
        def __init__(self, args):
            spawned.append(args)
            self.stopped = False

        def terminate(self):
            self.stopped = True

        def wait(self, timeout=None):
            assert self.stopped
            return 0

    monkeypatch.setattr(tengine.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(tengine.time, "sleep", lambda s: None)
    tengine.run_engine("gomoku", size=7, p1="player_mcts", p2="player_mcts",
                       spawn_mirror=True, max_moves=2)
    assert spawned == [[sys.executable, "-m",
                        "alphazero_gomoku_tpu_torch.gui.interface",
                        "mirror", "gomoku", "bot", "bot", "7"]]


def test_engine_accepts_human_click_via_input_log(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def feed_clicks():
        time.sleep(0.3)
        with open("input_log.txt", "a") as f:
            f.write("3,3\n")

    t = threading.Thread(target=feed_clicks)
    t.start()
    tengine.run_engine("gomoku", size=7, p1="human", p2="player_mcts",
                       spawn_mirror=False, max_moves=2)
    t.join(timeout=30)
    assert not t.is_alive()
    lines = open("mirror_log.txt").read().strip().splitlines()
    assert lines[0] == "3,3" and len(lines) == 2


def test_importing_the_engine_and_views_needs_no_pygame():
    code = ("import sys\n"
            "import alphazero_gomoku_tpu_torch.gui.engine\n"
            "import alphazero_gomoku_tpu_torch.gui.interface\n"
            "assert 'pygame' not in sys.modules\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_move_log_roundtrip_and_partial_lines(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = MoveLogWriter("mirror_log.txt")
    t = MoveLogTailer("mirror_log.txt")
    assert t.poll() == []
    w.append((7, 7))
    w.append((0, 14))
    assert t.poll() == [(7, 7), (0, 14)]
    assert t.poll() == []
    with open("log.txt", "w") as f:
        f.write("1,2\n3,")
    t2 = MoveLogTailer("log.txt")
    assert t2.poll() == [(1, 2)]
    with open("log.txt", "a") as f:
        f.write("4\n")
    assert t2.poll() == [(3, 4)]
    assert parse_move_line("garbage\n") is None
    assert parse_move_line("1,2,3\n") is None


def test_headless_board_rendering(tmp_path, monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.chdir(tmp_path)
    from alphazero_gomoku_tpu_torch.games.host import Gomoku
    from alphazero_gomoku_tpu_torch.gui.interface import (
        CELL, MARGIN, board_pixel_size, draw_board, to_board_coords,
    )

    pygame.init()
    size = 9
    px = board_pixel_size(size)
    surf = pygame.display.set_mode((px, px + 120))
    font = pygame.font.SysFont(None, 24)
    g = Gomoku(size)
    g.do_move((4, 4))
    g.do_move((4, 5))
    draw_board(surf, g, font)
    c1 = surf.get_at((MARGIN + 4 * CELL, MARGIN + 4 * CELL))[:3]
    c2 = surf.get_at((MARGIN + 5 * CELL, MARGIN + 4 * CELL))[:3]
    assert c1 == (200, 30, 30) and c2 == (30, 60, 200)
    assert to_board_coords((MARGIN + 3 * CELL, MARGIN + 2 * CELL),
                           size) == (2, 3)
    assert to_board_coords((1, 1), size) is None
    draw_board(surf, g, font, shown_history=1)
    assert surf.get_at((MARGIN + 5 * CELL, MARGIN + 4 * CELL))[:3] != (
        30, 60, 200)
    pygame.quit()


def test_onscreen_replay_buttons(tmp_path, monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.chdir(tmp_path)
    from alphazero_gomoku_tpu_torch.gui.interface import App

    pygame.init()
    app = App(size=9)
    app.game_name = "gomoku"
    app.selected = {1: "human", 2: "human"}
    app.start_game()
    for mv in [(4, 4), (4, 5), (5, 5)]:
        app.game.do_move(mv)
    back, fwd, live = app._replay_buttons()
    assert app.replay_pos is None
    app._click(back.rect.center)
    assert app.replay_pos == 2
    app._click(back.rect.center)
    assert app.replay_pos == 1
    app._click(fwd.rect.center)
    assert app.replay_pos == 2
    app._click(fwd.rect.center)
    assert app.replay_pos is None
    app._click(back.rect.center)
    app._click(live.rect.center)
    assert app.replay_pos is None
    assert len(app.game.move_history) == 3
    # a frame of each state draws (the App's pygame handle is the views')
    assert app._frame()
    pygame.quit()


def test_mirror_view_replays_the_log(tmp_path, monkeypatch):
    pytest.importorskip("pygame")
    monkeypatch.chdir(tmp_path)
    from alphazero_gomoku_tpu_torch.gui.interface import run_mirror

    w = MoveLogWriter("mirror_log.txt")
    for mv in [(3, 3), (3, 4), (4, 4)]:
        w.append(mv)
    run_mirror("gomoku", 7, "bot", "bot", max_frames=3)
