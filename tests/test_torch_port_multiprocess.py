"""Two gloo processes run the port's training loop, the counterpart of
``tests/test_multiprocess.py``.

One group of two ranks (``torch_port_ranks.spawn("loops")``) runs
``train_alphazero(mesh="auto")`` at 7x7 on a 1x8 net, one iteration each
with the replicated replay, the per-rank replay (``replay_sharding=
"per_host"``), continuous self-play and a batch size the two ranks do not
divide (15: the replicated epoch stays unsharded, as in the JAX loop, and
rank 0's result is broadcast); each rank writes into a model
directory of its own, standing for what it would have written to a shared
file system.  The checks:

  - both ranks record the same losses and win rate (the training state is
    replicated, and the loss terms are the global batch's);
  - only rank 0 writes ``best_latest.ckpt``, the snapshot and, with the
    replicated replay, the buffer file;
  - with per-rank replay each rank keeps its own games (fewer than the
    iteration's), a buffer of ``buffer_size / 2``, and writes its own
    buffer file, keyed by its rank and the world size
    (``replay_buffer_latest.proc{rank}of2.npz``).
"""

import pytest

import torch_port_ranks as R


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    results, _ = R.spawn("loops", 2, root)
    return root, results


def _files(root, mode, rank):
    d = root / mode / f"proc{rank}"
    return sorted(p.name for p in d.iterdir()) if d.exists() else []


@pytest.mark.parametrize("mode", ["replicated", "continuous", "odd_batch"])
def test_two_process_training_loop(loops, mode):
    root, (r0, r1) = loops
    assert r0[mode] == r1[mode], f"ranks diverged: {r0[mode]} vs {r1[mode]}"
    assert r0[mode]["moves"] > 0 and r0[mode]["buffer_size"] > 0
    assert r0[mode]["loss"] is not None
    assert r0[mode]["win_rate"] is not None
    files = _files(root, mode, 0)
    assert "best_latest.ckpt" in files
    assert "replay_buffer_latest.npz" in files
    assert any(f.startswith("snapshot_iter1_") for f in files)
    assert _files(root, mode, 1) == []


def test_two_process_per_host_replay(loops):
    root, (r0, r1) = loops
    a, b = r0["per_host"], r1["per_host"]
    assert a["loss"] == b["loss"] and a["win_rate"] == b["win_rate"]
    # each rank collected only its own games' samples
    assert a["moves"] > 0 and b["moves"] > 0
    assert a["moves"] + b["moves"] == r0["replicated"]["moves"]
    assert 0 < a["buffer_size"] <= 256 and 0 < b["buffer_size"] <= 256
    assert "replay_buffer_latest.proc0of2.npz" in _files(root, "per_host", 0)
    assert "best_latest.ckpt" in _files(root, "per_host", 0)
    assert _files(root, "per_host", 1) == [
        "replay_buffer_latest.proc1of2.npz"]
