"""Curated tactics suites for Gomoku and Pente (>=20 positions each).

Counterpart of the JAX repo's ``tools/tactics_suites.py``, the same positions
and the same oracle, on the port's host engines
(``alphazero_gomoku_tpu_torch/games/host.py``).

Every position is mechanically validated against the host rules oracle
rather than trusted by authorship:
``validate_position`` DERIVES the correct-move set from the rules and asserts
it equals the position's ``keys``.  Categories and their ground-truth
definitions (all computed with the oracle, so Pente capture wins, capture
blocks, and capture traps are handled by the same code path):

- ``win1``          to-move wins immediately; ``keys`` == the exact set of
                    immediately-winning squares.
- ``win_priority``  same as ``win1`` but the opponent ALSO has a win-in-one
                    (validated), so a searcher must prefer its own win over
                    blocking.
- ``block_win1``    the opponent (if given the move) wins in one; ``keys`` ==
                    the exact set of our moves after which the opponent has
                    no win-in-one.  In Pente this derivation automatically
                    covers capture wins, capture blocks that break a four,
                    and "blocking square feeds a winning capture" traps.
- ``block_open3``   the opponent threatens an unstoppable double attack in
                    one move (e.g. completing an open four); ``keys`` == the
                    set of our moves that neutralize it, derived by a
                    windowed 3-ply forced-loss search.
- ``make_open4``    we can create a double immediate-win threat (open four)
                    that survives every opponent reply; ``keys`` == the set
                    of moves with that property.

The probe (``tools/tactics_probe.py``) runs priors + search over these
positions.  ``python -m alphazero_gomoku_tpu_torch.tools.tactics_suites``
validates both suites (host only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

Move = Tuple[int, int]

SIZE = 15
C = SIZE // 2  # 7


@dataclasses.dataclass(frozen=True)
class TacticsPosition:
    name: str
    game: str                   # "gomoku" | "pente"
    category: str               # see module docstring
    board: np.ndarray           # int8 [S, S] of {0,1,2}
    to_move: int                # 1 | 2
    keys: FrozenSet[Move]       # the derived-correct move set
    captures: Tuple[int, int] = (0, 0)   # pente: pairs captured by (p1, p2)
    note: str = ""

    @property
    def size(self) -> int:
        return int(self.board.shape[0])


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def _board(stones: Dict[int, List[Move]], size: int = SIZE) -> np.ndarray:
    b = np.zeros((size, size), np.int8)
    for player, cells in stones.items():
        for r, c in cells:
            assert b[r, c] == 0, f"overlapping stone at {(r, c)}"
            b[r, c] = player
    return b


# Filler slots: isolated singles >=3 apart (Chebyshev) from each other, used
# to make stone counts consistent with the side to move.  Isolated singles
# cannot form lines or capturable pairs and sit far from the tactical region.
_FILLER_SLOTS = [(14, cc) for cc in range(0, 15, 3)] + \
                [(12, cc) for cc in range(1, 15, 3)] + \
                [(0, cc) for cc in range(0, 15, 3)] + \
                [(2, cc) for cc in range(1, 15, 3)]


def _add_parity_filler(board: np.ndarray, to_move: int,
                       captures: Tuple[int, int] = (0, 0),
                       avoid: Set[Move] = frozenset()) -> np.ndarray:
    """Pad with far isolated singles so move parity is a legal game's.

    ``played_p`` counts stones player p has placed = on-board stones plus
    stones of p removed by opponent captures (2 per pair).  A legal position
    has played1 == played2 when P1 is to move, played1 == played2 + 1 when
    P2 is to move.
    """
    b = board.copy()
    size = b.shape[0]

    def played():
        n1 = int((b == 1).sum()) + 2 * captures[1]
        n2 = int((b == 2).sum()) + 2 * captures[0]
        return n1, n2

    def ok():
        n1, n2 = played()
        return n1 == n2 if to_move == 1 else n1 == n2 + 1

    slots = iter(_FILLER_SLOTS)
    while not ok():
        n1, n2 = played()
        want = (n1 - n2) if to_move == 1 else (n1 - n2 - 1)
        color = 2 if want > 0 else 1   # pad the deficient side
        for r, c in slots:
            if (r, c) in avoid or b[r, c] != 0:
                continue
            # keep >=3 away from every existing stone so the filler can
            # never join a line of interest or a capture pattern
            rs, cs = np.nonzero(b)
            if len(rs) and (np.maximum(abs(rs - r), abs(cs - c)) < 3).any():
                continue
            b[r, c] = color
            break
        else:
            raise AssertionError("no filler slot available")
    return b


def _pos(name: str, game: str, category: str, stones: Dict[int, List[Move]],
         to_move: int, keys, captures: Tuple[int, int] = (0, 0),
         note: str = "") -> TacticsPosition:
    keys = frozenset((int(r), int(c)) for r, c in keys)
    b = _board(stones)
    b = _add_parity_filler(b, to_move, captures, avoid=keys)
    return TacticsPosition(name=name, game=game, category=category, board=b,
                           to_move=to_move, keys=keys, captures=captures,
                           note=note)


def _row(r: int, cols) -> List[Move]:
    return [(r, c) for c in cols]


def _col(c: int, rows) -> List[Move]:
    return [(r, c) for r in rows]


def _diag(r0: int, c0: int, n: int, dr: int = 1, dc: int = 1) -> List[Move]:
    return [(r0 + i * dr, c0 + i * dc) for i in range(n)]


# ---------------------------------------------------------------------------
# Gomoku suite (23 positions)
# ---------------------------------------------------------------------------

def gomoku_suite() -> List[TacticsPosition]:
    P: List[TacticsPosition] = []
    g = "gomoku"

    # --- win1: complete five ------------------------------------------------
    P.append(_pos("win1_row_east", g, "win1",
                  {1: _row(C, range(4, 8)), 2: [(C, 3)]}, 1, {(C, 8)}))
    P.append(_pos("win1_col_south", g, "win1",
                  {1: _col(C, range(3, 7)), 2: [(2, C)]}, 1, {(7, C)}))
    P.append(_pos("win1_diag", g, "win1",
                  {1: _diag(4, 4, 4), 2: [(3, 3)]}, 1, {(8, 8)}))
    P.append(_pos("win1_antidiag", g, "win1",
                  {1: _diag(4, 10, 4, 1, -1), 2: [(3, 11)]}, 1, {(8, 6)}))
    P.append(_pos("win1_open_four", g, "win1",
                  {1: _row(C, range(4, 8)), 2: []}, 1, {(C, 3), (C, 8)},
                  note="open four: two winning squares"))
    P.append(_pos("win1_split_2_2", g, "win1",
                  {1: [(C, 4), (C, 5), (C, 7), (C, 8)], 2: []}, 1, {(C, 6)}))
    P.append(_pos("win1_split_3_1", g, "win1",
                  {1: [(C, 4), (C, 5), (C, 6), (C, 8)], 2: [(C, 3)]},
                  1, {(C, 7)}))
    P.append(_pos("win1_top_edge", g, "win1",
                  {1: _row(0, range(10, 14)), 2: [(0, 9)]}, 1, {(0, 14)}))
    P.append(_pos("win1_bottom_edge_col", g, "win1",
                  {1: _col(2, range(10, 14)), 2: [(9, 2)]}, 1, {(14, 2)}))
    P.append(_pos("win1_double_line_cross", g, "win1",
                  {1: _col(5, range(3, 7)) + _row(C, range(1, 5)),
                   2: [(2, 5), (C, 0)]}, 1, {(C, 5)},
                  note="one square completes five on two lines"))

    # --- block_win1: opponent completes five unless stopped -----------------
    P.append(_pos("block4_row", g, "block_win1",
                  {1: _row(C, range(4, 8)), 2: [(C, 3)]}, 2, {(C, 8)}))
    P.append(_pos("block4_split", g, "block_win1",
                  {1: [(C, 4), (C, 5), (C, 7), (C, 8)], 2: []}, 2, {(C, 6)}))
    P.append(_pos("block4_diag", g, "block_win1",
                  {1: _diag(4, 4, 4), 2: [(3, 3)]}, 2, {(8, 8)}))
    P.append(_pos("block4_col", g, "block_win1",
                  {1: _col(C, range(3, 7)), 2: [(2, C)]}, 2, {(7, C)}))
    P.append(_pos("block4_edge", g, "block_win1",
                  {1: _row(14, range(9, 13)), 2: [(14, 8)]}, 2, {(14, 13)},
                  note="(14,14) does not complete the five; (14,13) does"))

    # --- win_priority: take our win, don't block theirs ---------------------
    P.append(_pos("winprio_row_vs_col", g, "win_priority",
                  {1: _row(C, range(4, 8)) + [(3, 11)],
                   2: _col(11, range(4, 8)) + [(C, 3)]},
                  1, {(C, 8)},
                  note="P2 threatens (8,11); P1 must still play (7,8)"))
    P.append(_pos("winprio_diag_vs_row", g, "win_priority",
                  {2: _diag(3, 3, 4) + [(10, 3)],
                   1: _row(10, range(4, 8)) + [(2, 2)]},
                  2, {(7, 7)},
                  note="P1 threatens (10,8); P2 must play (7,7)"))

    # --- block_open3: neutralize the open three -----------------------------
    P.append(_pos("open3_row", g, "block_open3",
                  {1: _row(C, range(6, 9)), 2: []}, 2, {(C, 5), (C, 9)}))
    P.append(_pos("open3_diag", g, "block_open3",
                  {1: _diag(5, 5, 3), 2: []}, 2, {(4, 4), (8, 8)}))
    P.append(_pos("open3_split", g, "block_open3",
                  {1: [(C, 5), (C, 6), (C, 8)], 2: []}, 2,
                  {(C, 4), (C, 7), (C, 9)},
                  note="gap or either end survives; two-beyond does not"))
    P.append(_pos("open3_col", g, "block_open3",
                  {1: _col(9, range(5, 8)), 2: []}, 2, {(4, 9), (8, 9)}))
    P.append(_pos("open3_near_edge", g, "block_open3",
                  {1: _row(C, range(1, 4)), 2: []}, 2,
                  {(C, 0), (C, 4), (C, 5)},
                  note="edge kills one extension; three ways to survive"))

    # --- make_open4: create the unstoppable double threat -------------------
    P.append(_pos("make4_from_open3", g, "make_open4",
                  {1: _row(C, range(6, 9)), 2: [(3, 3), (3, 6)]}, 1,
                  {(C, 5), (C, 9)}))
    P.append(_pos("make4_fill_gap", g, "make_open4",
                  {1: [(C, 5), (C, 6), (C, 8)], 2: [(3, 3), (11, 11)]}, 1,
                  {(C, 7)}))
    return P


# ---------------------------------------------------------------------------
# Pente suite (21 positions)
# ---------------------------------------------------------------------------

def pente_suite() -> List[TacticsPosition]:
    P: List[TacticsPosition] = []
    g = "pente"

    # --- win1: five in a row (same rule as gomoku) --------------------------
    P.append(_pos("pwin1_row", g, "win1",
                  {1: _row(C, range(4, 8)), 2: [(C, 3)]}, 1, {(C, 8)}))
    P.append(_pos("pwin1_diag", g, "win1",
                  {1: _diag(4, 4, 4), 2: [(3, 3)]}, 1, {(8, 8)}))
    P.append(_pos("pwin1_col", g, "win1",
                  {1: _col(C, range(3, 7)), 2: [(2, C)]}, 1, {(7, C)}))

    # --- win1 via fifth captured pair ---------------------------------------
    P.append(_pos("pcapwin_row", g, "win1",
                  {1: [(9, 8)], 2: [(9, 9), (9, 10)]}, 1, {(9, 11)},
                  captures=(4, 0),
                  note="capturing the pair is the 5th pair: win"))
    P.append(_pos("pcapwin_diag", g, "win1",
                  {1: [(4, 4)], 2: [(5, 5), (6, 6)]}, 1, {(7, 7)},
                  captures=(4, 0)))
    P.append(_pos("pcapwin_double", g, "win1",
                  {1: [(7, 4), (4, 7)], 2: [(7, 5), (7, 6), (5, 7), (6, 7)]},
                  1, {(7, 7)}, captures=(3, 0),
                  note="one placement captures two pairs at once: 3+2=5"))
    P.append(_pos("pwin1_five_over_capture", g, "win1",
                  {1: _row(C, range(4, 8)) + [(10, 8)],
                   2: [(C, 3), (10, 9), (10, 10)]}, 1, {(C, 8)},
                  captures=(2, 0),
                  note="a non-winning capture at (10,11) is available; only "
                       "the five wins"))

    # --- win_priority: capture race, we move first --------------------------
    P.append(_pos("pcap_race", g, "win_priority",
                  {1: [(9, 8), (3, 3), (3, 4)], 2: [(9, 9), (9, 10), (3, 2)]},
                  1, {(9, 11)}, captures=(4, 4),
                  note="both at 4 pairs, both have a capture; take ours "
                       "(theirs is (3,5) capturing (3,3),(3,4))"))

    # --- block_win1 ----------------------------------------------------------
    P.append(_pos("pblock4_row", g, "block_win1",
                  {1: _row(C, range(4, 8)), 2: [(C, 3)]}, 2, {(C, 8)}))
    P.append(_pos("pblock4_diag", g, "block_win1",
                  {1: _diag(4, 4, 4), 2: [(3, 3)]}, 2, {(8, 8)}))
    P.append(_pos("pblock4_or_capture", g, "block_win1",
                  {1: [(C, 3), (5, 6)], 2: _row(C, range(4, 8)) + [(6, 6)]},
                  1, {(C, 8), (8, 6)},
                  note="block the four at (7,8) OR capture (6,6),(7,6) "
                       "through (8,6), which breaks the four"))
    P.append(_pos("pblock_capwin", g, "block_win1",
                  {1: [(9, 9), (9, 10)], 2: [(9, 8)]}, 1, {(9, 11)},
                  captures=(0, 4),
                  note="opponent at 4 pairs threatens (9,11); extending our "
                       "pair to a triple makes it uncapturable"))
    P.append(_pos("pdont_feed_the_capture", g, "block_win1",
                  {1: [(C, 3), (5, 6), (8, 8)],
                   2: _row(C, range(4, 8)) + [(6, 6), (9, 8)]},
                  1, {(8, 6), (5, 5)},
                  captures=(0, 4),
                  note="blocking at (7,8) creates the pair (7,8),(8,8) which "
                       "(6,8) captures for the opponent's 5th pair AND "
                       "unblocks the four; only the counter-captures survive "
                       "((8,6) takes (6,6),(7,6); (5,5) takes (6,6),(7,7))"))
    P.append(_pos("pblock_capwin_vs_our_pair", g, "block_win1",
                  {1: [(4, 4), (4, 5)], 2: [(4, 3)]}, 1, {(4, 6)},
                  captures=(0, 4)))

    # --- block_open3 ----------------------------------------------------------
    P.append(_pos("popen3_row", g, "block_open3",
                  {1: _row(C, range(5, 8)), 2: []}, 2, {(C, 4), (C, 8)}))
    P.append(_pos("popen3_col", g, "block_open3",
                  {1: _col(9, range(5, 8)), 2: []}, 2, {(4, 9), (8, 9)}))
    P.append(_pos("popen3_diag", g, "block_open3",
                  {1: _diag(5, 5, 3), 2: []}, 2, {(4, 4), (8, 8)},
                  note="a capture-answer variant was tried here and the "
                       "oracle proved it ill-posed: a standing capture on a "
                       "stone of the three still works AFTER the open four "
                       "forms, so the three is never a forced threat"))
    P.append(_pos("popen3_split", g, "block_open3",
                  {1: [(C, 5), (C, 6), (C, 8)], 2: []}, 2,
                  {(C, 4), (C, 7), (C, 9)}))

    # --- make_open4 -----------------------------------------------------------
    P.append(_pos("pmake4_from_open3", g, "make_open4",
                  {1: _row(C, range(6, 9)), 2: [(3, 3), (3, 6)]}, 1,
                  {(C, 5), (C, 9)}))
    P.append(_pos("pmake4_fill_gap", g, "make_open4",
                  {1: [(C, 5), (C, 6), (C, 8)], 2: [(3, 3), (11, 11)]}, 1,
                  {(C, 7)}))
    P.append(_pos("pmake4_safe_side_only", g, "make_open4",
                  {1: _row(C, range(5, 8)) + [(6, 4)], 2: [(5, 4)]}, 1,
                  {(C, 8)},
                  note="extending at (7,4) builds the open four into a "
                       "capturable pair (6,4),(7,4) — opponent's (8,4) "
                       "capture breaks it; only the safe side wins"))
    P.append(_pos("pmake4_col", g, "make_open4",
                  {1: _col(10, range(5, 8)), 2: [(2, 2), (12, 2)]}, 1,
                  {(4, 10), (8, 10)}))
    return P


def suite_for(game: str) -> List[TacticsPosition]:
    return gomoku_suite() if game == "gomoku" else pente_suite()


# ---------------------------------------------------------------------------
# oracle-driven validation
# ---------------------------------------------------------------------------

def _host_game(pos: TacticsPosition, to_move: Optional[int] = None):
    from alphazero_gomoku_tpu_torch.games import host

    if pos.game == "gomoku":
        g = host.Gomoku(pos.size)
    else:
        g = host.Pente(pos.size)
        g.captures = {1: int(pos.captures[0]), 2: int(pos.captures[1])}
    g.board = pos.board.copy()
    g.current_player = int(to_move if to_move is not None else pos.to_move)
    return g


def _near_stone_cells(board: np.ndarray, radius: int) -> List[Move]:
    """Empty cells within Chebyshev ``radius`` of any stone."""
    rs, cs = np.nonzero(board)
    if not len(rs):
        return []
    out = set()
    size = board.shape[0]
    for r, c in zip(rs.tolist(), cs.tolist()):
        for rr in range(max(0, r - radius), min(size, r + radius + 1)):
            for cc in range(max(0, c - radius), min(size, c + radius + 1)):
                if board[rr, cc] == 0:
                    out.add((rr, cc))
    return sorted(out)


def _wins_in_one(g, windowed: bool = True) -> Set[Move]:
    """Moves for ``g.current_player`` that immediately win.

    A winning move always touches the structure it completes (the 5th stone
    of a line or the trigger of a capture), so scanning cells adjacent to
    stones is exact; ``windowed=False`` scans all legal cells.
    """
    cells = (_near_stone_cells(g.board, 1) if windowed
             else g.get_legal_moves())
    me = g.current_player
    wins = set()
    for m in cells:
        g.do_move(m)
        if g.get_winner() == me:
            wins.add(m)
        g.undo_move()
    return wins


def _opp_wins_if_passed(g) -> Set[Move]:
    """Winning squares of the side NOT to move (the threat we must answer)."""
    h = g.clone()
    h.current_player = 3 - g.current_player
    return _wins_in_one(h)


def _forced_loss(g, radius: int = 2) -> bool:
    """True if the side to move (the THREATENING side here) has a reply that
    wins outright or creates >=2 win squares no single answer can kill.

    3-ply windowed search: for a reply r to be a killer, after r every
    defender move m must leave the attacker at least one win-in-one.
    """
    attacker = g.current_player
    for r in _near_stone_cells(g.board, radius):
        g.do_move(r)
        if g.get_winner() == attacker:
            g.undo_move()
            return True
        h = g.clone()
        h.current_player = attacker
        threats = _wins_in_one(h)
        if len(threats) >= 2 and not _wins_in_one(g):
            # defender (now to move in g) tries every windowed answer
            killed = False
            for m in _near_stone_cells(g.board, radius):
                g.do_move(m)
                hh = g.clone()
                hh.current_player = attacker
                if not _wins_in_one(hh):
                    killed = True
                g.undo_move()
                if killed:
                    break
            if not killed:
                g.undo_move()
                return True
        g.undo_move()
    return False


def derive_keys(pos: TacticsPosition) -> Set[Move]:
    """Compute the ground-truth correct-move set for a position."""
    g = _host_game(pos)
    cat = pos.category

    if cat in ("win1", "win_priority"):
        return _wins_in_one(g, windowed=False)

    if cat == "block_win1":
        keys = set()
        for m in g.get_legal_moves():
            g.do_move(m)
            if g.get_winner() == pos.to_move:
                keys.add(m)       # counter-win also neutralizes
            else:
                h = g.clone()
                h.current_player = 3 - pos.to_move
                if not _wins_in_one(h):
                    keys.add(m)
            g.undo_move()
        return keys

    if cat == "block_open3":
        keys = set()
        for m in _near_stone_cells(g.board, 2):
            g.do_move(m)          # our candidate answer; opp to move in g
            if not _forced_loss(g):
                keys.add(m)
            g.undo_move()
        return keys

    if cat == "make_open4":
        keys = set()
        for m in _near_stone_cells(g.board, 2):
            g.do_move(m)
            h = g.clone()
            h.current_player = pos.to_move
            if g.get_winner() == 0 and len(_wins_in_one(h)) >= 2:
                # survives every reply: opponent cannot reach zero threats
                survives = True
                for r in _near_stone_cells(g.board, 2):
                    g.do_move(r)
                    if g.get_winner() == (3 - pos.to_move):
                        survives = False   # opponent counter-win (capture)
                    else:
                        hh = g.clone()
                        hh.current_player = pos.to_move
                        if not _wins_in_one(hh):
                            survives = False
                    g.undo_move()
                    if not survives:
                        break
                if survives:
                    keys.add(m)
            g.undo_move()
        return keys

    raise ValueError(f"unknown category {cat!r}")


def validate_position(pos: TacticsPosition) -> None:
    """Assert the authored ``keys`` equal the oracle-derived set, plus
    category-specific sanity invariants."""
    g = _host_game(pos)
    assert not g.is_game_over(), f"{pos.name}: position is already terminal"
    n1, n2 = int((pos.board == 1).sum()), int((pos.board == 2).sum())
    played1 = n1 + 2 * pos.captures[1]
    played2 = n2 + 2 * pos.captures[0]
    want = 0 if pos.to_move == 1 else 1
    assert played1 - played2 == want, \
        f"{pos.name}: illegal parity (played {played1} vs {played2})"

    derived = derive_keys(pos)
    assert derived == set(pos.keys), (
        f"{pos.name}: keys mismatch\n  authored: {sorted(pos.keys)}\n"
        f"  derived:  {sorted(derived)}")

    if pos.category == "win_priority":
        assert _opp_wins_if_passed(_host_game(pos)), \
            f"{pos.name}: win_priority needs an opponent threat"
    if pos.category == "block_open3":
        h = _host_game(pos, to_move=3 - pos.to_move)
        assert _forced_loss(h), \
            f"{pos.name}: block_open3 needs a live double-attack threat"
        assert not _wins_in_one(_host_game(pos), windowed=False), \
            f"{pos.name}: to-move has an immediate win; wrong category"
    if pos.category == "make_open4":
        assert not _wins_in_one(_host_game(pos), windowed=False), \
            f"{pos.name}: to-move already wins in one; wrong category"


def validate_suite(game: str) -> int:
    suite = suite_for(game)
    names = [p.name for p in suite]
    assert len(names) == len(set(names)), "duplicate position names"
    assert len(suite) >= 20, f"{game} suite has only {len(suite)} positions"
    for pos in suite:
        validate_position(pos)
    return len(suite)


if __name__ == "__main__":
    for game in ("gomoku", "pente"):
        n = validate_suite(game)
        print(f"{game}: {n} positions validated")
