"""Shared implementation for the AlphaZero checkpoint players.

Counterpart of ``alphazero_gomoku_tpu/players/alpha_base.py`` (the
reference's near-identical ``player.py`` / ``player_alpha.py`` /
``player_alpha2.py`` trio, SURVEY.md §2 A1): wrap the network + MCTS behind
the ``play()`` protocol, loading a snapshot checkpoint and searching with
noise off / deterministic argmax.  The variants only change defaults
(simulation count, snapshot path).

On the port the position is rebuilt on the card via ``env.from_board`` (a
batch of one) and searched by the packed searches, which drive the tree
kernels (``select_walk`` and ``backup_paths`` for PUCT,
``gumbel_select_walk`` and ``backup_paths`` for Gumbel).  The JAX player
searches a batch of one on its XLA array tree, because its Pallas kernels
need 8 lanes; the JAX package holds that search bit-identical to its packed
one, reuse included, and the CUDA kernels have no lane floor, so the port
has no array tree.  The network is the float32 ``ResNet``, as the JAX
player's ``make_eval_fn``.  The side to move is inferred from the stone and
captured-pair counts on the board, as in the JAX player.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from alphazero_gomoku_tpu_torch.device import resolve_device
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import AZModel, make_eval_fn
from alphazero_gomoku_tpu_torch.models.checkpoint import peek_metadata
from alphazero_gomoku_tpu_torch.ops.tree_kernels import KERNELS
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.pure_mcts import winning_cells
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    packed_advance_root,
    run_search,
)


def infer_to_move(board: np.ndarray, captures=(0, 0)) -> int:
    """Exact side-to-move from stones + captured-pair counts.

    Each move adds one stone of the mover; each captured pair removes two
    OPPONENT stones, so ``moves_by_p = stones_of_p + 2 * pairs_captured_BY_
    opponent``.  P1 moved first, hence P1 is to move iff the move counts are
    equal.  (Turn-number parity is unreliable: the reference's callers
    disagree on the convention — ``play.py`` pre-increments to 1, the
    tournament runner doesn't count its random opening, the GUI passes
    moves-played.)
    """
    stones1 = int((board == 1).sum())
    stones2 = int((board == 2).sum())
    moves1 = stones1 + 2 * int(captures[1])
    moves2 = stones2 + 2 * int(captures[0])
    return 1 if moves1 == moves2 else 2


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


#: constructor default shared by every shipped player variant; any other
#: value counts as an explicitly requested checkpoint
DEFAULT_MODEL_PATH = "models/best_latest.ckpt"


def _resolve_checkpoint(path: Optional[str], rules: str,
                        allow_default: bool = True) -> Optional[str]:
    """Find a usable snapshot: the given path as-is, then repo-relative,
    then (``allow_default``) the shipped default in ``checkpoints/``
    (cwd-independent, so the GUI and CLIs work from anywhere)."""
    if path and os.path.exists(path):
        return path
    candidates = []
    if path:
        candidates.append(os.path.join(_REPO_ROOT, path))
    if allow_default:
        candidates.append(os.path.join(_REPO_ROOT, "checkpoints",
                                       f"best_{rules}.ckpt"))
    for c in candidates:
        if os.path.exists(c):
            return c
    return path


class _BoardView:
    """Minimal state shim for the pure-MCTS tactical scans."""

    def __init__(self, board: np.ndarray, captures=None):
        self.board = board
        self.size = board.shape[0]
        if captures is not None:
            self.captures = {1: captures[0], 2: captures[1]}


class AlphaZeroPlayer:
    def __init__(
        self,
        rules: str = "gomoku",
        board_size: int = 15,
        n_simulations: int = 3000,
        c_puct: float = 1.0,
        model_path: Optional[str] = "models/best_latest.ckpt",
        n_res_blocks: int = 3,
        channels: int = 64,
        tactical_guard: bool = True,
        tree_reuse: bool = True,
        search: str = "puct",   # "gumbel": sequential halving
                                # (search/gumbel.py) — play argmax of the
                                # improved policy; disables tree reuse
        gumbel_parallel: bool = True,  # gumbel only: batch each halving
                                # round's sims into ONE walk and forward
        device=None,            # None: the CUDA card (raises without one)
    ):
        self.device = resolve_device(device)
        self.rules = str(rules).lower()
        self.board_size = board_size
        self.n_simulations = n_simulations
        self.c_puct = c_puct
        self.model_path = model_path
        #: exact one-ply tactics pin (win now / block the opponent's win
        #: now) computed by the native winning-cell scan before searching,
        #: as in the JAX player: a value head that is confidently lost
        #: flattens PUCT visit counts, and the argmax move degenerates
        #: exactly when one forced block would save the game.  The guard
        #: never fires outside exact mate-in-one situations.
        self.tactical_guard = bool(tactical_guard)

        self.env = make_env(self.rules, board_size)
        explicit = model_path not in (None, DEFAULT_MODEL_PATH)
        model_path = _resolve_checkpoint(model_path, self.rules,
                                         allow_default=not explicit)
        if explicit and not (model_path and os.path.exists(model_path)):
            # never silently substitute another net for a checkpoint the
            # caller asked for by name (a typo'd --p1-model must not load
            # the shipped default or random weights)
            raise FileNotFoundError(
                f"AlphaZero player: requested checkpoint {model_path!r} "
                "does not exist")
        if model_path and os.path.exists(model_path) and not explicit:
            # the shipped default resolved: only use it when it matches the
            # requested board (a 9x9 probe player must not die on the
            # 15x15 default; explicit paths still fail loudly on mismatch)
            try:
                ck_size = peek_metadata(model_path).get("board_size")
            except Exception:
                ck_size = None
            if ck_size is not None and ck_size != board_size:
                print(f"[AlphaZeroPlayer] default checkpoint {model_path} "
                      f"is {ck_size}x{ck_size}, not {board_size}x"
                      f"{board_size}; using fresh weights")
                model_path = None
        if model_path and os.path.exists(model_path):
            print(f"[AlphaZeroPlayer] loading model: {model_path}")
            # size the net from the checkpoint's own metadata so plugins
            # load 6x128 (or any) snapshots without architecture flags
            self.net = AZModel.from_checkpoint(model_path,
                                               board_size=board_size,
                                               device=self.device)
        else:
            print(f"[AlphaZeroPlayer] WARNING: no model at {model_path!r}; "
                  "playing with random weights")
            self.net = AZModel(board_size=board_size,
                               n_res_blocks=n_res_blocks, channels=channels,
                               device=self.device)
        if self.rules == "pente" and self.net.cfg.in_channels == 5:
            # checkpoint was trained with the captured-pair planes opt-in;
            # rebuild the env so encode() matches the net's input layout
            self.env = make_env(self.rules, board_size, capture_planes=True)

        # fpu_mode="parent": the engine-play search setting of the JAX
        # player (self-play keeps "zero").  tree_reuse carries the search
        # tree across the player's own moves AND through the opponent's
        # reply (detected by board diff); noise stays off, so reuse only
        # adds information.
        self.search = str(search)
        if self.search == "gumbel":
            tree_reuse = False   # not supported with gumbel, as in JAX
        self.tree_reuse = bool(tree_reuse)
        self.cfg = MCTSConfig(
            n_simulations=n_simulations, cpuct=c_puct, add_noise=False,
            fpu_mode="parent", search=self.search,
            gumbel_round_parallel=(bool(gumbel_parallel)
                                   and self.search == "gumbel"),
            reuse_budget=n_simulations if tree_reuse else 0)
        self._eval_fn = make_eval_fn()
        self._bundle = self.net.eval_net()
        #: the tree functions the searches call: the kernel wrappers, or
        #: ``tree_kernels.PLAIN`` (the plain versions, to hold the kernels
        #: against on the card)
        self.tree_ops = KERNELS
        self._carry = None
        self._board_after_our_move: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # the search, on a batch of one
    # ------------------------------------------------------------------
    def _moves(self, turn_number: int) -> torch.Tensor:
        return torch.tensor([int(turn_number)], dtype=torch.int32,
                            device=self.device)

    def _root_uniforms(self, turn_number: int) -> torch.Tensor:
        """The Gumbel search's root uniforms ``[1, A]``: a generator seeded
        with ``turn_number`` on the player's device (the JAX player draws
        from ``PRNGKey(turn_number)``, which torch cannot reproduce)."""
        gen = torch.Generator(device=self.device).manual_seed(
            int(turn_number))
        return torch.clamp(torch.rand((1, self.env.num_actions),
                                      generator=gen, device=self.device),
                           min=1e-12)

    def _search(self, state, turn_number: int, carry=None):
        """One search: ``(pi, the searched tree)``.  ``carry`` (with reuse)
        resumes the held tree, whose root is the position (``state`` is then
        None); Gumbel's root uniforms are :meth:`_root_uniforms`'s."""
        gumbel = self.search == "gumbel"
        pi, _, _, carry = run_search(
            self.env, self.cfg, self._eval_fn, self._bundle, state,
            None if gumbel else self._moves(turn_number), carry=carry,
            uniforms=self._root_uniforms(turn_number) if gumbel else None,
            ops=self.tree_ops)
        return pi[0].cpu().numpy(), carry

    def _advance(self, carry, action: int):
        return packed_advance_root(
            self.env, self.cfg, carry,
            torch.tensor([action], dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    def _resume_carry_from_board(self, raw: np.ndarray, to_move: int):
        """Advance the held tree through the opponent's reply, if the
        board diff since our last move identifies it unambiguously
        (exactly one added opponent stone; removed cells are ours —
        Pente captures).  Returns the advanced carry or None (fresh
        search)."""
        prev = self._board_after_our_move
        if self._carry is None or prev is None or prev.shape != raw.shape:
            return None
        pf, cf = prev.reshape(-1), raw.reshape(-1)
        added = np.flatnonzero((pf == 0) & (cf != 0))
        removed = np.flatnonzero((pf != 0) & (cf == 0))
        changed = np.flatnonzero((pf != cf) & (pf != 0) & (cf != 0))
        opp = 3 - to_move
        if (len(added) != 1 or cf[added[0]] != opp or len(changed)
                or (len(removed) and self.rules != "pente")
                or any(pf[i] == opp for i in removed)):
            return None
        return self._advance(self._carry, int(added[0]))

    # ------------------------------------------------------------------
    def play(self, board, turn_number: int,
             last_opponent_move) -> Optional[Tuple[int, int]]:
        raw = np.asarray(board if isinstance(board, (list, np.ndarray))
                         else board.board, dtype=np.int8)
        caps = getattr(board, "captures", None)
        caps = (caps.get(1, 0), caps.get(2, 0)) if isinstance(caps, dict) \
            else (0, 0)
        to_move = infer_to_move(raw, caps)
        boards = torch.from_numpy(raw.copy())[None].to(self.device)
        if self.rules == "pente":
            state = self.env.from_board(boards, to_move, captures=caps)
        else:
            state = self.env.from_board(boards, to_move)
        if bool(state.done[0]):
            return None
        carry = (self._resume_carry_from_board(raw, to_move)
                 if self.tree_reuse else None)
        action = None
        if self.tactical_guard:
            view = _BoardView(
                raw, caps if self.rules == "pente" else None)
            mine = winning_cells(view, to_move)
            if mine.any():
                action = int(np.flatnonzero(mine)[0])
            else:
                theirs = winning_cells(view, 3 - to_move)
                if theirs.any():
                    # block (one of) the opponent's immediate wins; with
                    # two or more disjoint wins it is lost either way
                    action = int(np.flatnonzero(theirs)[0])
        if action is None:
            pi, carry = self._search(None if carry is not None else state,
                                     turn_number, carry)
            action = int(np.argmax(pi))
        if self.tree_reuse:
            # carry the tree through OUR move (a guard move may hit an
            # unexpanded edge: packed_advance_root starts that lane afresh)
            self._carry = (self._advance(carry, action)
                           if carry is not None else None)
            after = self.env.step(state, torch.tensor(
                [action], dtype=torch.int32, device=self.device))
            self._board_after_our_move = after.board[0].cpu().numpy()
        return divmod(action, self.board_size)
