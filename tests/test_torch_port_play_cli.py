"""Parity: the port's match and tournament CLIs against the JAX package's.

``cli/play.py`` and ``cli/play_loop.py`` run ``player_mcts`` on both seats
in each package; the pure-MCTS players' ``random.Random()`` is seeded in the
order the players are made (the same order in both CLIs), so the games must
be the same move for move, and the tournament's metrics file must have the
same name and keys and the same moves, seats, wins and draws.  An AlphaZero
seat (the port's ``player`` on a small checkpoint) plays through the port's
CLI on the CPU, where its device is patched: the CLIs take no device flag,
as the JAX ones take none, and the port's players run on the card.
"""

import json

import pytest
import torch

import alphazero_gomoku_tpu.cli.play as jplay
import alphazero_gomoku_tpu.cli.play_loop as jloop
import alphazero_gomoku_tpu.search.pure_mcts as jpm
import alphazero_gomoku_tpu_torch.cli.play as tplay
import alphazero_gomoku_tpu_torch.cli.play_loop as tloop
import alphazero_gomoku_tpu_torch.players.alpha_base as tab
import alphazero_gomoku_tpu_torch.search.pure_mcts as tpm
from alphazero_gomoku_tpu_torch.games import make_host_game
from alphazero_gomoku_tpu_torch.models import AZModel

from torch_port_play import seed_pure_mcts
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _recording(monkeypatch, module):
    """Every move ``request_move`` applies in the module, in order."""
    moves = []
    real = module.request_move

    def request_move(*args, **kw):
        move = real(*args, **kw)
        moves.append(move)
        return move

    monkeypatch.setattr(module, "request_move", request_move)
    return moves


@pytest.mark.parametrize("game,size", [("gomoku", 7), ("pente", 9)])
def test_run_match_plays_the_jax_cli_game(game, size, monkeypatch, capsys):
    results = []
    for cli, pm in ((jplay, jpm), (tplay, tpm)):
        seed_pure_mcts(monkeypatch, pm)
        moves = _recording(monkeypatch, cli)
        winner = cli.run_match("player_mcts", "player_mcts", game, size)
        results.append((winner, moves))
    assert results[1] == results[0]
    winner, moves = results[1]
    assert winner in (0, 1, 2) and len(moves) >= 9
    assert "think time" in capsys.readouterr().out


def test_play_main_flags_as_jax(monkeypatch, capsys):
    argv = ["player_mcts", "player_mcts", "--game", "gomoku", "--size", "7",
            "--p1-sims", "5", "--p2-sims", "40"]
    results = []
    for cli, pm in ((jplay, jpm), (tplay, tpm)):
        seed_pure_mcts(monkeypatch, pm)
        moves = _recording(monkeypatch, cli)
        assert cli.main(argv) == 0
        results.append(moves)
    assert results[1] == results[0]
    with pytest.raises(SystemExit):
        tplay.main(["player_mcts", "player_mcts", "--p1-search", "bogus"])


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {prefix}
        for k, v in tree.items():
            out |= _leaf_paths(v, prefix + (k,))
        return out
    return {prefix}


@pytest.mark.parametrize("game", ["gomoku", "pente"])
def test_tournament_writes_the_jax_cli_metrics(game, tmp_path, monkeypatch):
    out = {}
    for name, cli, pm in (("jax", jloop, jpm), ("port", tloop, tpm)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        seed_pure_mcts(monkeypatch, pm)
        cli.main(["player_mcts", "player_mcts", "2", "--game", game,
                  "--size", "7", "--seed", "5", "--p2-sims", "10"])
        files = list((d / "metrics").glob("*.json"))
        assert len(files) == 1
        out[name] = (files[0].name, json.loads(files[0].read_text()))
    (jname, jm), (tname, tm) = out["jax"], out["port"]
    assert tname == jname
    assert _leaf_paths(tm) == _leaf_paths(jm)
    for key in ("player1", "player2", "game", "n_games", "move_made",
                "wins", "draws", "starting_player_per_game"):
        assert tm[key] == jm[key], key
    assert tm["n_games"] == 2 and tm["draws"] + sum(tm["wins"].values()) == 2
    assert tm["player1"][0] == "player_mcts[1]"
    assert tm["starting_player_per_game"]["game_2"] == "player_mcts[2]"


def test_an_alphazero_seat_plays_through_the_port_cli(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "net.ckpt")
    AZModel(board_size=7, n_res_blocks=1, channels=8, seed=1,
            device="cpu").save(ckpt)
    monkeypatch.setattr(tab, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.chdir(tmp_path)
    seed_pure_mcts(monkeypatch, tpm)
    moves = _recording(monkeypatch, tplay)
    assert tplay.main(["player", "player_mcts", "--size", "7",
                       "--p1-model", ckpt, "--p1-sims", "8"]) == 0
    g = make_host_game("gomoku", 7)
    for mv in moves:
        assert mv is not None and g.do_move(mv)
    assert g.is_game_over()
    metrics = tloop.loop_for_n_games(
        "player", "player_mcts", 1, size=7, seed=3,
        p1_kwargs={"model_path": ckpt, "n_simulations": 8})
    assert metrics["player1"] == ("player", 8, ckpt)
    assert metrics["draws"] + sum(metrics["wins"].values()) == 1
