"""Heuristic (network-free) MCTS baseline — host side, vectorized NumPy.

Counterpart (a copy) of ``alphazero_gomoku_tpu/search/pure_mcts.py``, on the
port's own C scans (``native/``); both are host code and never touch the
card.  ``winning_cells`` is also the AlphaZero player's tactical guard.

Capability equivalent of the reference's ``mcts/mcts_pure.py`` (M3 in
SURVEY.md §2): an object-tree PUCT search whose priors come from handcrafted
threat heuristics and whose leaf values come from short rollouts with
immediate-win / immediate-block scanning.  It exists as a comparison baseline
and as the engine behind the ``player_mcts`` plugin.

Behaviour spec matched to the reference:
  - prior policy: per-move score ``2*attack + 1.5*defense + 0.1*(-manhattan
    distance to centre)`` (+ ``3*capture_potential`` for Pente), softmaxed
    (``mcts_pure.py:59-81,202-234``).
  - threat buckets per direction (Gomoku): >=5: 100, open four: 50, closed
    four: 25, open three: 10, closed three: 4, open two: 2
    (``mcts_pure.py:105-116``); Pente buckets: >=5: 120, four: 60, three:
    15, two: 4, capture potential 20/pattern (``mcts_pure.py:261-289``).
  - PUCT: ``Q + c * P * sqrt(parent_N) / (1 + N)``, incremental-mean Q
    (``mcts_pure.py:34-48``).
  - rollout (depth <= 3): play the immediate winning move if any (value 1),
    else block the opponent's immediate win (value 0.8), else sample from
    the heuristic policy; terminal scoring 1 / 0 / draw 0.5
    (``mcts_pure.py:133-175``).
  - final move = most-visited root child; random legal fallback
    (``mcts_pure.py:178-192``).

Unlike the reference's per-cell Python walks + deepcopies, the threat and
capture heuristics here are whole-board vectorized (shift-and-cumprod run
lengths), immediate win/block detection is a single board pass
(:func:`winning_cells`), and states are cloned through the cheap host
engines.

Deliberate fixes vs the reference (see DECISIONS.md):
  - terminal nodes are never expanded (the reference expands them and can
    then search PAST the end of the game, where ``check_winner``'s
    last-move-local scan no longer sees the win).

Known inherited quirk kept for behavioural parity: the rollout value scale
([0, 1] with 0.8 for blocks) is backed up with per-hop negation as if it
were zero-centred, and the depth parity of rollout outcomes is not
perspective-adjusted (``mcts_pure.py:133-175``) — the baseline's deep value
signal is noisy in the reference and stays so here; its tactical strength
comes from the immediate win/block scans.
"""

from __future__ import annotations

import ctypes
import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from alphazero_gomoku_tpu_torch.native import load_puremcts

_DIR_PAIRS = ((1, 0), (0, 1), (1, 1), (1, -1))


def _board_ptr(board: np.ndarray):
    b = np.ascontiguousarray(board, dtype=np.int8)
    return b, b.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _shift(mask: np.ndarray, dr: int, dc: int, fill=0) -> np.ndarray:
    """Board-sized array shifted so out[r,c] = mask[r+dr, c+dc]."""
    h, w = mask.shape
    out = np.full_like(mask, fill)
    rs_src = slice(max(dr, 0), h + min(dr, 0))
    cs_src = slice(max(dc, 0), w + min(dc, 0))
    rs_dst = slice(max(-dr, 0), h + min(-dr, 0))
    cs_dst = slice(max(-dc, 0), w + min(-dc, 0))
    out[rs_dst, cs_dst] = mask[rs_src, cs_src]
    return out


def _runs_and_open(board: np.ndarray, player: int, dr: int, dc: int):
    """For every cell: capped run length (<=4) of ``player`` stones starting
    one step away along +(dr,dc), and whether the cell past the run is empty.
    """
    mine = (board == player).astype(np.int8)
    empty = (board == 0)
    run = np.zeros(board.shape, np.int8)
    chain = np.ones(board.shape, np.int8)
    for k in range(1, 5):
        chain = chain * _shift(mine, k * dr, k * dc)
        run += chain
    open_end = np.zeros(board.shape, bool)
    for k in range(5):
        open_end |= (run == k) & _shift(empty, (k + 1) * dr, (k + 1) * dc,
                                        fill=False)
    return run, open_end


def threat_scores(board: np.ndarray, player: int,
                  table: str = "gomoku") -> np.ndarray:
    """Per-cell threat score for placing ``player`` at each cell.

    Dispatches to the native C kernel when available (the NumPy path costs
    ~1 ms/call in 225-cell numpy dispatch overhead; the C path ~5 us);
    ``AZG_NO_NATIVE=1`` forces NumPy. Both paths are differential-tested
    equal (tests/test_torch_port_pure_mcts.py)."""
    lib = load_puremcts()
    if lib is not None:
        b, ptr = _board_ptr(board)
        out = np.empty(b.shape, np.float32)
        lib.az_threat_scores(
            ptr, b.shape[0], player, 0 if table == "gomoku" else 1,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    return _threat_scores_np(board, player, table)


def _threat_scores_np(board: np.ndarray, player: int,
                      table: str = "gomoku") -> np.ndarray:
    """Vectorized per-cell threat score (NumPy reference path)."""
    score = np.zeros(board.shape, np.float32)
    for dr, dc in _DIR_PAIRS:
        r_p, o_p = _runs_and_open(board, player, dr, dc)
        r_m, o_m = _runs_and_open(board, player, -dr, -dc)
        count = 1 + r_p.astype(np.int32) + r_m.astype(np.int32)
        opens = o_p.astype(np.int32) + o_m.astype(np.int32)
        if table == "gomoku":
            score += np.select(
                [count >= 5,
                 (count == 4) & (opens == 2), (count == 4) & (opens == 1),
                 (count == 3) & (opens == 2), (count == 3) & (opens == 1),
                 (count == 2) & (opens == 2)],
                [100.0, 50.0, 25.0, 10.0, 4.0, 2.0], 0.0)
        else:  # pente buckets
            score += np.select(
                [count >= 5,
                 (count == 4) & (opens >= 1),
                 (count == 3) & (opens >= 1),
                 (count == 2) & (opens >= 1)],
                [120.0, 60.0, 15.0, 4.0], 0.0)
    return score


def capture_potential(board: np.ndarray, player: int) -> np.ndarray:
    """Per-cell count of capturable opponent pairs (pattern me-opp-opp-me
    along the 4 axes, checked in the + direction like the reference).

    This is the PRIOR heuristic (reference ``mcts_pure.py:277-289`` scans
    only the positive rays); for true capture counts use
    :func:`capture_count_all`."""
    lib = load_puremcts()
    if lib is not None:
        b, ptr = _board_ptr(board)
        out = np.empty(b.shape, np.int32)
        lib.az_capture_potential(
            ptr, b.shape[0], player,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    return _capture_potential_np(board, player)


def _capture_potential_np(board: np.ndarray, player: int) -> np.ndarray:
    opp = 3 - player
    o = (board == opp)
    m = (board == player)
    pot = np.zeros(board.shape, np.int32)
    for dr, dc in _DIR_PAIRS:
        pot += (
            _shift(o, dr, dc, False)
            & _shift(o, 2 * dr, 2 * dc, False)
            & _shift(m, 3 * dr, 3 * dc, False)
        ).astype(np.int32)
    return pot


def capture_count_all(board: np.ndarray, player: int) -> np.ndarray:
    """Per-cell TRUE number of pairs ``player`` would capture (all 8 rays)."""
    lib = load_puremcts()
    if lib is not None:
        b, ptr = _board_ptr(board)
        out = np.empty(b.shape, np.int32)
        lib.az_capture_count_all(
            ptr, b.shape[0], player,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    return _capture_count_all_np(board, player)


def _capture_count_all_np(board: np.ndarray, player: int) -> np.ndarray:
    opp = 3 - player
    o = (board == opp)
    m = (board == player)
    pot = np.zeros(board.shape, np.int32)
    for dr, dc in _DIR_PAIRS:
        for sr, sc in ((dr, dc), (-dr, -dc)):
            pot += (
                _shift(o, sr, sc, False)
                & _shift(o, 2 * sr, 2 * sc, False)
                & _shift(m, 3 * sr, 3 * sc, False)
            ).astype(np.int32)
    return pot


def winning_cells(state, player: int) -> np.ndarray:
    """Bool board: cells where ``player`` would win by playing there NOW.

    Vectorized equivalent of the reference's clone-every-move immediate-win
    scan (``mcts_pure.py:141-146``): a placement wins iff it completes a
    5-in-a-row (captures only remove opponent stones, so the mover's line is
    unaffected by simultaneous captures), or — Pente — lifts the mover's
    captured-pair count to the threshold.
    """
    board = state.board
    lib = load_puremcts()
    if lib is not None:
        need = (max(5 - state.captures[player], 0)
                if hasattr(state, "captures") else -1)
        b, ptr = _board_ptr(board)
        out = np.empty(b.shape, np.uint8)
        lib.az_winning_cells(
            ptr, b.shape[0], player, need,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)
    empty = board == 0
    win = np.zeros(board.shape, bool)
    for dr, dc in _DIR_PAIRS:
        r_p, _ = _runs_and_open(board, player, dr, dc)
        r_m, _ = _runs_and_open(board, player, -dr, -dc)
        win |= (1 + r_p.astype(np.int32) + r_m.astype(np.int32)) >= 5
    if hasattr(state, "captures"):
        need = 5 - state.captures[player]
        win |= _capture_count_all_np(board, player) >= max(need, 0)
    return win & empty


_CENTER_CACHE: Dict[int, np.ndarray] = {}


def _center_bias(size: int) -> np.ndarray:
    if size not in _CENTER_CACHE:
        r = np.abs(np.arange(size) - size // 2)
        _CENTER_CACHE[size] = -(r[:, None] + r[None, :]).astype(np.float32)
    return _CENTER_CACHE[size]


class _PureNode:
    __slots__ = ("parent", "children", "n", "q", "p", "move", "state")

    def __init__(self, parent=None, prior=1.0, move=None, state=None):
        self.parent = parent
        self.children: Dict[Tuple[int, int], "_PureNode"] = {}
        self.n = 0
        self.q = 0.0
        self.p = prior
        self.move = move
        self.state = state

    def best_child(self, c_puct: float):
        sqrt_n = math.sqrt(self.n)
        best, best_score = None, -float("inf")
        for child in self.children.values():
            u = c_puct * child.p * sqrt_n / (1 + child.n)
            s = child.q + u
            if s > best_score:
                best, best_score = child, s
        return best

    def update_path(self, leaf_value: float):
        node, v = self, leaf_value
        while node is not None:
            node.n += 1
            node.q += (v - node.q) / node.n
            node, v = node.parent, -v


class PureMCTS:
    """Heuristic PUCT search over host game objects (Gomoku or Pente)."""

    def __init__(self, n_playout: int = 100, c_puct: float = 1.4,
                 table: str = "gomoku", rollout_depth: int = 3,
                 rng: Optional[random.Random] = None):
        self.n_playout = n_playout
        self.c_puct = c_puct
        self.table = table
        self.rollout_depth = rollout_depth
        self.rng = rng or random.Random()

    # -- heuristic policy ----------------------------------------------
    def _policy(self, state) -> Tuple[List[Tuple[int, int]], np.ndarray]:
        """(legal moves, softmax prior) — moves in row-major order, the same
        order ``get_legal_moves`` produces."""
        board = state.board
        me = state.current_player
        rs, cs = np.nonzero(board == 0)
        if rs.size == 0:
            return [], np.empty(0)
        moves = list(zip(rs.tolist(), cs.tolist()))
        lib = load_puremcts()
        if lib is not None and state.size <= 32:
            b, ptr = _board_ptr(board)
            score = np.empty(b.shape, np.float32)
            lib.az_policy_scores(
                ptr, state.size, me, 0 if self.table == "gomoku" else 1,
                score.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            score = score + 0.1 * _center_bias(state.size)
        else:
            score = (2.0 * threat_scores(board, me, self.table)
                     + 1.5 * threat_scores(board, 3 - me, self.table)
                     + 0.1 * _center_bias(state.size))
            if self.table == "pente":
                score = score + 3.0 * 20.0 * capture_potential(board, me)
        vals = score[rs, cs].astype(np.float64)
        if not vals.any():
            vals = np.ones(len(moves))
        probs = np.exp(vals - vals.max())
        probs /= probs.sum()
        return moves, probs

    # -- immediate tactics ---------------------------------------------
    def _winning_move(self, state, player) -> Optional[Tuple[int, int]]:
        """First legal move (row-major, matching ``get_legal_moves`` order)
        that makes ``player`` win right now — one vectorized board pass
        instead of the reference's clone-per-candidate scan."""
        cells = winning_cells(state, player)
        if not cells.any():
            return None
        idx = int(np.flatnonzero(cells)[0])
        return divmod(idx, state.size)

    # -- rollout --------------------------------------------------------
    def _rollout(self, state) -> float:
        depth = 0
        while not state.is_game_over() and depth < self.rollout_depth:
            me = state.current_player
            win = self._winning_move(state, me)
            if win is not None:
                state.do_move(win)
                return 1.0
            block = self._winning_move(state, 3 - me)
            if block is not None:
                state.do_move(block)
                return 0.8
            moves, probs = self._policy(state)
            if not moves:
                break
            state.do_move(self.rng.choices(moves, weights=probs, k=1)[0])
            depth += 1
        winner = state.check_winner()
        if winner == 0:
            return 0.5
        return 1.0 if winner == state.current_player else 0.0

    # -- one playout -----------------------------------------------------
    def _playout(self, root: _PureNode):
        """One PUCT playout from ``root`` (whose ``state`` is the position).

        Children carry only (move, prior); the leaf position is materialised
        by replaying the selected path on ONE scratch clone — the reference
        clones once per simulation too (``mcts_pure.py:121-131``), but the
        earlier design here cloned the full game object into every expanded
        child (~225 clones/expansion), which dominated the profile.
        """
        node = root
        state = root.state.clone()
        while node.children:
            node = node.best_child(self.c_puct)
            state.do_move(node.move)
        # never expand past the end of the game (the reference does, which
        # loses the win signal: check_winner only scans through last_move)
        if not state.is_game_over():
            moves, probs = self._policy(state)
            for move, prob in zip(moves, probs):
                node.children[move] = _PureNode(node, float(prob), move)
        value = self._rollout(state)
        node.update_path(-value)

    # -- public ----------------------------------------------------------
    def get_move(self, state) -> Optional[Tuple[int, int]]:
        root = _PureNode(state=state.clone())
        for _ in range(self.n_playout):
            self._playout(root)
        if not root.children:
            moves = state.get_legal_moves()
            return self.rng.choice(moves) if moves else None
        return max(root.children.values(), key=lambda c: c.n).move


class MCTSGomoku(PureMCTS):
    """Reference-named alias (``mcts_pure.py:52``)."""

    def __init__(self, n_playout: int = 100, c_puct: float = 1.4, **kw):
        super().__init__(n_playout, c_puct, table="gomoku", **kw)


class MCTSPente(PureMCTS):
    """Reference-named alias (``mcts_pure.py:195``)."""

    def __init__(self, n_playout: int = 120, c_puct: float = 1.4, **kw):
        super().__init__(n_playout, c_puct, table="pente", **kw)
