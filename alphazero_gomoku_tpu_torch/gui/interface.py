"""Pygame GUI: menus, board rendering, replay scrubber, mirror spectator.

Capability equivalent of the reference's ``interface.py`` (U1/U2 in
SURVEY.md §2): a menu state machine (game select -> player select ->
playing), board/stone/ghost-stone/last-move rendering, click input, an
in-game replay scrubber that rebuilds positions from ``move_history``,
Pente capture counters, an endgame overlay with rematch, and a mirror mode
that tails the engine's move log and forwards clicks (see
:mod:`.mirror_ipc`).

Counterpart of ``alphazero_gomoku_tpu/gui/interface.py``.  Bot moves run
synchronously in the frame loop like the reference
(``interface.py:616-628``); the AlphaZero players search on the CUDA card,
so stalls are bounded by search time.  pygame is imported only where the
GUI draws (:func:`_pygame`): importing this module, as ``gui.engine`` and
the tests do, needs no pygame.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.gui.mirror_ipc import (
    INPUT_LOG,
    MIRROR_LOG,
    MoveLogTailer,
    MoveLogWriter,
)
from alphazero_gomoku_tpu_torch.players import load_player

CELL = 40
MARGIN = 40
PANEL = 120
BG = (222, 184, 135)
LINE = (60, 40, 20)
P1_COLOR = (200, 30, 30)
P2_COLOR = (30, 60, 200)
TEXT = (20, 20, 20)
BUTTON_BG = (245, 222, 179)
BUTTON_HI = (255, 240, 200)

PLAYER_CHOICES = ["human", "player_mcts", "player_alpha", "player_alpha2"]
GAME_CHOICES = ["gomoku", "pente"]


def _pygame():
    """pygame, imported by the code that draws."""
    os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    import pygame
    return pygame


class Button:
    def __init__(self, rect, label, value):
        pygame = _pygame()
        self.rect = pygame.Rect(rect)
        self.label = label
        self.value = value

    def draw(self, surf, font, hover):
        pygame = _pygame()
        pygame.draw.rect(surf, BUTTON_HI if hover else BUTTON_BG, self.rect,
                         border_radius=6)
        pygame.draw.rect(surf, LINE, self.rect, 2, border_radius=6)
        text = font.render(self.label, True, TEXT)
        surf.blit(text, text.get_rect(center=self.rect.center))

    def hit(self, pos):
        return self.rect.collidepoint(pos)


class HumanGUIPlayer:
    """Click-driven player: the frame loop feeds it board clicks."""

    def __init__(self, rules="gomoku", board_size=15):
        self.board_size = board_size
        self._click: Optional[Tuple[int, int]] = None

    def set_click(self, move):
        self._click = move

    def play(self, board, turn_number, last_opponent_move):
        move, self._click = self._click, None
        return move


def board_pixel_size(size: int) -> int:
    return 2 * MARGIN + (size - 1) * CELL


def to_board_coords(pos, size) -> Optional[Tuple[int, int]]:
    x, y = pos
    c = round((x - MARGIN) / CELL)
    r = round((y - MARGIN) / CELL)
    if 0 <= r < size and 0 <= c < size and (
        abs(x - (MARGIN + c * CELL)) <= CELL // 2
        and abs(y - (MARGIN + r * CELL)) <= CELL // 2
    ):
        return (r, c)
    return None


def draw_board(surf, game, font, ghost: Optional[Tuple[int, int]] = None,
               shown_history: Optional[int] = None):
    """Render the grid + stones; ``shown_history`` rewinds via move_history."""
    pygame = _pygame()
    size = game.size
    surf.fill(BG)
    for i in range(size):
        x = MARGIN + i * CELL
        end = MARGIN + (size - 1) * CELL
        pygame.draw.line(surf, LINE, (MARGIN, x), (end, x), 1)
        pygame.draw.line(surf, LINE, (x, MARGIN), (x, end), 1)

    if shown_history is None:
        board = game.board
        last = game.last_move
    else:  # replay scrubber: rebuild the position at ply N
        replay = make_host_game(
            "pente" if hasattr(game, "captures") else "gomoku", size
        )
        for mv in game.move_history[:shown_history]:
            replay.do_move(mv)
        board = replay.board
        last = (game.move_history[shown_history - 1]
                if shown_history else None)

    for r in range(size):
        for c in range(size):
            v = int(board[r, c])
            if v:
                center = (MARGIN + c * CELL, MARGIN + r * CELL)
                pygame.draw.circle(
                    surf, P1_COLOR if v == 1 else P2_COLOR, center,
                    CELL // 2 - 4)
    if last is not None:
        center = (MARGIN + last[1] * CELL, MARGIN + last[0] * CELL)
        pygame.draw.circle(surf, (255, 255, 255), center, CELL // 2 - 2, 2)
    if ghost is not None:
        center = (MARGIN + ghost[1] * CELL, MARGIN + ghost[0] * CELL)
        color = P1_COLOR if game.current_player == 1 else P2_COLOR
        pygame.draw.circle(surf, color, center, CELL // 2 - 4, 2)

    if hasattr(game, "captures"):
        cap = font.render(
            f"captures  P1: {game.captures[1]}   P2: {game.captures[2]}",
            True, TEXT)
        surf.blit(cap, (MARGIN, board_pixel_size(size) + 8))


class App:
    """Menu -> select -> playing state machine (reference interface.py:32-34)."""

    def __init__(self, size: int = 15):
        pygame = _pygame()
        pygame.init()
        self.size = size
        px = board_pixel_size(size)
        self.screen = pygame.display.set_mode((px, px + PANEL))
        pygame.display.set_caption("alphazero_gomoku_tpu")
        self.font = pygame.font.SysFont(None, 24)
        self.big = pygame.font.SysFont(None, 40)
        self.state = "menu"
        self.game_name = "gomoku"
        self.selected = {1: None, 2: None}
        self.game = None
        self.players = {}
        self.replay_pos: Optional[int] = None
        self.clock = pygame.time.Clock()

    # -- state builders --------------------------------------------------
    def _menu_buttons(self):
        px = board_pixel_size(self.size)
        return [Button((px // 2 - 100, 150 + 70 * i, 200, 50),
                       name.capitalize(), name)
                for i, name in enumerate(GAME_CHOICES)]

    def _select_buttons(self):
        px = board_pixel_size(self.size)
        buttons = []
        for seat in (1, 2):
            for i, name in enumerate(PLAYER_CHOICES):
                buttons.append(Button(
                    (40 + (seat - 1) * (px // 2), 150 + 60 * i,
                     px // 2 - 80, 44),
                    f"P{seat}: {name}", (seat, name)))
        buttons.append(Button((px // 2 - 80, 150 + 60 * len(PLAYER_CHOICES) + 20,
                               160, 50), "Start", ("start", None)))
        return buttons

    def _replay_buttons(self):
        """On-screen scrubber controls (reference interface.py:317-324):
        "<" / ">" step the replay like the arrow keys, "live" returns to
        the head.  Drawn in the panel during play AND after game over, so
        a finished game can be reviewed before the rematch click."""
        px = board_pixel_size(self.size)
        y = px + 70
        return [Button((px - 150, y, 40, 34), "<", ("replay", -1)),
                Button((px - 104, y, 40, 34), ">", ("replay", +1)),
                Button((px - 58, y, 48, 34), "live", ("replay", None))]

    def _make_player(self, name: str):
        if name == "human":
            return HumanGUIPlayer(self.game_name, self.size)
        return load_player(name, self.game_name, self.size)

    def start_game(self):
        self.game = make_host_game(self.game_name, self.size)
        self.players = {s: self._make_player(self.selected[s] or "human")
                        for s in (1, 2)}
        self.replay_pos = None
        self.state = "playing"

    # -- frame loop -------------------------------------------------------
    def run(self):
        pygame = _pygame()
        while True:
            if not self._frame():
                break
        pygame.quit()

    def _frame(self) -> bool:
        pygame = _pygame()
        mouse = pygame.mouse.get_pos()
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                return False
            if event.type == pygame.MOUSEBUTTONDOWN:
                self._click(event.pos)
            if event.type == pygame.KEYDOWN and self.state == "playing":
                self._key(event.key)

        if self.state == "menu":
            self.screen.fill(BG)
            title = self.big.render("Choose a game", True, TEXT)
            self.screen.blit(title, (MARGIN, 60))
            for b in self._menu_buttons():
                b.draw(self.screen, self.font, b.hit(mouse))
        elif self.state == "select":
            self.screen.fill(BG)
            title = self.big.render(f"{self.game_name}: choose players",
                                    True, TEXT)
            self.screen.blit(title, (MARGIN, 60))
            for b in self._select_buttons():
                hilite = (b.hit(mouse)
                          or (isinstance(b.value, tuple)
                              and b.value[0] in (1, 2)
                              and self.selected.get(b.value[0]) == b.value[1]))
                b.draw(self.screen, self.font, hilite)
        else:
            self._playing_frame(mouse)

        pygame.display.flip()
        self.clock.tick(60)
        return True

    def _click(self, pos):
        if self.state == "menu":
            for b in self._menu_buttons():
                if b.hit(pos):
                    self.game_name = b.value
                    self.state = "select"
        elif self.state == "select":
            for b in self._select_buttons():
                if b.hit(pos):
                    kind, val = b.value
                    if kind == "start":
                        if self.selected[1] and self.selected[2]:
                            self.start_game()
                    else:
                        self.selected[kind] = val
        elif self.state == "playing":
            for b in self._replay_buttons():
                if b.hit(pos):
                    self._step_replay(b.value[1])
                    return
            if self.game.is_game_over():
                self.start_game()  # rematch on click
                return
            move = to_board_coords(pos, self.size)
            player = self.players[self.game.current_player]
            if move is not None and isinstance(player, HumanGUIPlayer):
                player.set_click(move)

    def _step_replay(self, delta: Optional[int]):
        """Scrub by ``delta`` plies; ``None`` returns to the live head."""
        n = len(self.game.move_history)
        if delta is None:
            self.replay_pos = None
        elif delta < 0:
            cur = n if self.replay_pos is None else self.replay_pos
            self.replay_pos = max(0, cur + delta)
        elif self.replay_pos is not None:
            self.replay_pos = min(n, self.replay_pos + delta)
            if self.replay_pos == n:
                self.replay_pos = None

    def _key(self, key):
        """Replay scrubber: left/right step, escape returns to live."""
        pygame = _pygame()
        if key == pygame.K_LEFT:
            self._step_replay(-1)
        elif key == pygame.K_RIGHT:
            self._step_replay(+1)
        elif key == pygame.K_ESCAPE:
            self._step_replay(None)

    def _playing_frame(self, mouse):
        game = self.game
        ghost = None
        player = self.players[game.current_player]
        if (not game.is_game_over() and self.replay_pos is None
                and isinstance(player, HumanGUIPlayer)):
            ghost = to_board_coords(mouse, self.size)
        draw_board(self.screen, game, self.font, ghost, self.replay_pos)

        px = board_pixel_size(self.size)
        for b in self._replay_buttons():
            b.draw(self.screen, self.font, b.hit(mouse))
        if game.is_game_over():
            winner = game.get_winner()
            msg = "Draw" if winner == 0 else f"Player {winner} wins!"
            overlay = self.big.render(msg + "  (click for rematch)", True, TEXT)
            self.screen.blit(overlay, (MARGIN, px + 40))
            if self.replay_pos is not None:
                note = self.font.render(
                    f"replay {self.replay_pos}/{len(game.move_history)}",
                    True, TEXT)
                self.screen.blit(note, (MARGIN, px + 70))
            return
        if self.replay_pos is not None:
            note = self.font.render(
                f"replay {self.replay_pos}/{len(game.move_history)} "
                "(< > to scrub, live/esc = resume)", True, TEXT)
            self.screen.blit(note, (MARGIN, px + 40))
            return

        status = self.font.render(
            f"player {game.current_player} to move", True, TEXT)
        self.screen.blit(status, (MARGIN, px + 40))

        # bot (or pending human click) move — synchronous like the reference
        move = player.play(game.clone(), len(game.move_history),
                           game.last_move)
        if move is not None:
            game.do_move(move)


# ----------------------------------------------------------------------
# mirror-mode spectator (reference interface.py:661-844)
# ----------------------------------------------------------------------
def run_mirror(game_name: str = "gomoku", size: int = 15,
               p1_kind: str = "human", p2_kind: str = "bot",
               max_frames: Optional[int] = None):
    """Tail ``mirror_log.txt``, re-apply moves locally, forward clicks."""
    pygame = _pygame()
    pygame.init()
    px = board_pixel_size(size)
    screen = pygame.display.set_mode((px, px + PANEL))
    pygame.display.set_caption("mirror")
    font = pygame.font.SysFont(None, 24)
    clock = pygame.time.Clock()

    game = make_host_game(game_name, size)
    tail = MoveLogTailer(MIRROR_LOG)
    clicks = MoveLogWriter(INPUT_LOG)
    kinds = {1: p1_kind, 2: p2_kind}

    frames = 0
    while max_frames is None or frames < max_frames:
        frames += 1
        for event in pygame.event.get():
            if event.type == pygame.QUIT:
                pygame.quit()
                return
            if (event.type == pygame.MOUSEBUTTONDOWN
                    and kinds[game.current_player] == "human"
                    and not game.is_game_over()):
                move = to_board_coords(event.pos, size)
                if move is not None and game.board[move] == 0:
                    clicks.append(move)

        for move in tail.poll():
            game.do_move(move)

        draw_board(screen, game, font)
        if game.is_game_over():
            w = game.get_winner()
            msg = "Draw" if w == 0 else f"Player {w} wins!"
            screen.blit(font.render(msg, True, TEXT), (MARGIN, px + 40))
        pygame.display.flip()
        clock.tick(60)
    pygame.quit()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "mirror":
        game_name = argv[1] if len(argv) > 1 else "gomoku"
        p1 = argv[2] if len(argv) > 2 else "human"
        p2 = argv[3] if len(argv) > 3 else "bot"
        size = int(argv[4]) if len(argv) > 4 else 15
        run_mirror(game_name, size, p1, p2)
    else:
        App().run()


if __name__ == "__main__":
    main()
