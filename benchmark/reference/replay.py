"""Judge a call of lockstep self-play against the reference.

A call plays ``batch`` games from empty boards for at most ``plies`` plies,
searching every lane each ply, and records per ply and lane the board
before the move, the player to move, the captured pairs, the search's
policy ``pi`` and root value, the move and whether the record is active
(the game is running and the ply is past the random opening); at the end
each game's winner and length.  Its generator gives, each ply, in this
order: a Gumbel search's root uniforms ``[B, A]``, or a PUCT search's
Dirichlet draw (``[8, B, A]`` uniforms, then ``[8, B, A]`` exponentials)
and its sampling uniforms ``[B, A]``; then, on an opening ply, the opening
uniforms ``[B, A]``.  The loop stops early once every game is over.

:func:`game_mismatches` replays every record of every lane with the
reference's rules.  :func:`search_gaps` replays the searches of a few lanes
with the reference's search and net, on the same draws: each ply from the
game the call recorded (the recorded move is played, whatever the
reference would have played), the tree carried by subtree reuse kept by the
reference itself.  Records are a dict of tensors with the keys named above
(``boards``, ``players``, ``captures``, ``pis``, ``root_qs``, ``actions``,
``active``, ``winners``, ``moves_played``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from benchmark.reference import search as rs
from benchmark.reference.games import Game, State, take

F32_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SelfPlay:
    batch: int
    plies: int
    temp_threshold: int = 10
    opening_random_moves: int = 0


def center_mask(game: Game, device) -> torch.Tensor:
    size = game.size
    span = min(9, size)
    r0 = (size - span) // 2
    ar = torch.arange(size, device=device)
    rows = (ar >= r0) & (ar < r0 + span)
    return (rows[:, None] & rows[None, :]).reshape(-1).to(torch.float32)


def opening_moves(legal: torch.Tensor, center: torch.Tensor,
                  uniforms: torch.Tensor) -> torch.Tensor:
    """A uniform random legal point of the centre 9x9 (of the whole board
    where the centre is full), by the Gumbel-max trick."""
    in_center = legal * center
    pool = torch.where(in_center.sum(dim=-1, keepdim=True) > 0, in_center,
                       legal)
    logits = torch.where(pool > 0, 0.0, -1e30)
    g = -torch.log(-torch.log(torch.clamp(uniforms, min=F32_TINY)))
    return torch.argmax(logits + g, dim=-1)


def sample_moves(pi: torch.Tensor, temp: torch.Tensor, legal: torch.Tensor,
                 uniforms: torch.Tensor) -> torch.Tensor:
    """``argmax(log(pi + 1e-15) / T + g)`` with each row's temperature
    ``T`` (``[B]``); the argmax of ``pi`` where ``T <= 0`` or the sample is
    illegal."""
    logits = torch.log(pi + 1e-15) / torch.clamp(temp, min=1e-8)[:, None]
    g = -torch.log(-torch.log(torch.clamp(uniforms, min=F32_TINY)))
    sampled = torch.argmax(logits + g, dim=-1)
    greedy = torch.argmax(pi, dim=-1)
    ok = legal.gather(1, sampled[:, None]).squeeze(1)
    return torch.where((temp <= 0.0) | ~ok, greedy, sampled)


def temperature(t: int, threshold: int) -> float:
    """The call's temperature at ply ``t``, as a float32 value."""
    return float(torch.clamp(1.0 - torch.tensor(t, dtype=torch.float32)
                             / threshold, min=0.0))


def game_mismatches(game: Game, sp: SelfPlay, rec: Dict) -> Dict[str, int]:
    """Replay every lane's recorded moves from empty boards; count the
    records whose board, player to move, captures or active flag differ
    from the reference's, the moves played on an occupied point or off the
    board, the games whose winner or length differ, and the lanes with any
    of these."""
    dev = rec["boards"].device
    state = game.initial(sp.batch, dev)
    a = game.num_actions
    bad = torch.zeros(sp.batch, dtype=torch.int64, device=dev)
    illegal = torch.zeros_like(bad)
    for t in range(sp.plies):
        if bool(state.done.all()):
            bad += rec["active"][t:].sum(dim=0)
            break
        live = ~state.done
        want_active = live & (t >= sp.opening_random_moves)
        wrong = ((rec["boards"][t] != state.board).reshape(sp.batch, -1)
                 .any(dim=1)
                 | (rec["players"][t] != state.to_move)
                 | (rec["captures"][t] != state.captures).any(dim=1)
                 | (rec["active"][t] != want_active))
        bad += wrong
        act = rec["actions"][t].long()
        on_board = (act >= 0) & (act < a)
        legal = game.legal(state).gather(
            1, act.clamp(0, a - 1)[:, None]).squeeze(1)
        illegal += live & ~(on_board & legal)
        state = game.step_safe(state, act.clamp(0, a - 1))
    games = (rec["winners"] != state.winner) \
        | (rec["moves_played"] != state.move_count)
    return {"records": int(bad.sum()), "illegal": int(illegal.sum()),
            "games": int(games.sum()),
            "lanes": int(((bad > 0) | (illegal > 0) | games).sum())}


def _draws(cfg: rs.SearchConfig, sp: SelfPlay, generator, plies: int,
           shape, idx, alpha: float):
    """Each ply's draws, in the call's order, for the lanes ``idx``."""
    out = []
    for t in range(plies):
        d = {}
        if cfg.search == "gumbel":
            d["root"] = torch.rand(shape, generator=generator,
                                   device=idx.device)[idx]
        else:
            if cfg.add_noise:
                size = (rs.DIRICHLET_TERMS,) + shape
                nu = torch.rand(size, generator=generator, device=idx.device)
                ne = torch.empty(size, device=idx.device).exponential_(
                    generator=generator)
                d["noise"] = rs.dirichlet(nu, ne, alpha)[idx]
            d["sample"] = torch.rand(shape, generator=generator,
                                     device=idx.device)[idx]
        if t < sp.opening_random_moves:
            d["opening"] = torch.rand(shape, generator=generator,
                                      device=idx.device)[idx]
        elif sp.opening_random_moves:
            # no draw: the call draws opening uniforms on opening plies only
            d["opening"] = torch.zeros_like(next(iter(d.values())))
        out.append(d)
    return out


def _search(game, cfg, sp, eval_fn, roots, plies, draws, carry=None):
    """One search of ``roots`` (each at ply ``plies[i]``) and the moves the
    call would play there: ``(pi, root_q, move, tree)``."""
    live = ~roots.done
    legal = game.legal(roots)
    if cfg.search == "gumbel":
        pi, q, win, tree = rs.gumbel(game, cfg, eval_fn, roots,
                                     draws["root"], carry=carry)
        move = torch.where(live, win.long(), 0)
    else:
        pi, q, tree = rs.puct(game, cfg, eval_fn, roots, plies,
                              draws.get("noise"), carry=carry)
        temp = torch.tensor([temperature(int(t), sp.temp_threshold)
                             for t in plies.tolist()], device=pi.device)
        safe = torch.where(live[:, None], pi, 1.0)
        move = sample_moves(safe, temp, legal | ~live[:, None],
                            draws["sample"])
    if "opening" in draws:
        opening = plies < sp.opening_random_moves
        move = torch.where(opening, opening_moves(
            legal.to(torch.float32), center_mask(game, pi.device),
            draws["opening"]), move)
    return pi, q, move, tree


def search_gaps(game: Game, cfg: rs.SearchConfig, sp: SelfPlay, eval_fn,
                rec: Dict, generator: torch.Generator,
                lanes: List[int]) -> Dict[str, list]:
    """The reference's searches of ``lanes`` on the call's draws; per live
    record of those lanes the total-variation distance between the call's
    ``pi`` and the reference's, the gap of the root values, and whether
    the reference would have played another move.  ``generator`` is a
    fresh generator seeded as the call's was.

    Without a carried tree every (ply, lane) root is searched at once, in
    one batch; with one the plies go in turn, the tree re-rooted at each
    recorded move."""
    dev = rec["boards"].device
    b, a = sp.batch, game.num_actions
    idx = torch.tensor(lanes, dtype=torch.long, device=dev)
    played = rec["actions"].long().clamp(0, a - 1)
    chain = []
    full = game.initial(b, dev)
    for t in range(sp.plies):
        if bool(full.done.all()):
            break
        chain.append(take(full, idx))
        full = game.step_safe(full, played[t])
    draws = _draws(cfg, sp, generator, len(chain), (b, a), idx,
                   cfg.dirichlet_alpha)
    found = {"pi": [], "q": [], "move": [], "t": [], "lane": []}

    def keep(pi, q, move, ts, js):
        found["pi"].append(pi)
        found["q"].append(q)
        found["move"].append(move)
        found["t"].append(ts)
        found["lane"].append(js)

    if cfg.reuse_budget == 0:
        # the live (ply, lane) roots, one search
        ts, js = [], []
        for t, roots in enumerate(chain):
            live = torch.nonzero(~roots.done).flatten()
            ts.append(torch.full_like(live, t))
            js.append(live)
        ts, js = torch.cat(ts), torch.cat(js)
        roots = State(*(torch.stack(f)[ts, js] for f in zip(*chain)))
        batch = {k: torch.stack([d[k] for d in draws])[ts, js]
                 for k in draws[0]}
        pi, q, move, _ = _search(game, cfg, sp, eval_fn, roots,
                                 ts.to(torch.int32), batch)
        keep(pi, q, move, ts, js)
    else:
        tree = rs.new_tree(game, cfg, chain[0])
        for t, roots in enumerate(chain):
            plies = torch.full((len(lanes),), t, dtype=torch.int32,
                               device=dev)
            pi, q, move, out = _search(game, cfg, sp, eval_fn, roots, plies,
                                       draws[t], carry=tree)
            live = torch.nonzero(~roots.done).flatten()
            keep(pi[live], q[live], move[live], torch.full_like(live, t),
                 live)
            tree = rs.advance_root(game, cfg, out, played[t][idx])
    ts, js = torch.cat(found["t"]), torch.cat(found["lane"])
    lane_ids = idx[js]
    pi, q, move = (torch.cat(found[k]) for k in ("pi", "q", "move"))
    tv = 0.5 * (rec["pis"][ts, lane_ids] - pi).abs().sum(dim=-1)
    qgap = (rec["root_qs"][ts, lane_ids] - q).abs()
    moved = (played[ts, lane_ids] != move).to(torch.int32)
    return {"tv": tv.tolist(), "q_gap": qgap.tolist(),
            "moved": moved.tolist()}
