"""Pre-flight device-memory check for self-play.

Counterpart of ``alphazero_gomoku_tpu/selfplay/budget.py:37-126``.  The JAX
module checks XLA's own ahead-of-time memory analysis of a jitted program
against the chip before its first run, because a TPU worker that runs out
of memory faults instead of raising.  PyTorch has no ahead-of-time
analysis, and a CUDA out-of-memory error is a clean exception
(``torch.OutOfMemoryError``) that leaves the process running; what the
check adds here is an error before the first allocation, naming the terms
of the config that overflow, in place of one raised mid-run from whichever
allocation crossed the line.

:func:`selfplay_memory` reckons a self-play call's peak from the shapes it
allocates:

  - the packed tree of each search (``search/tree_packed.py``'s
    ``init_packed``: ``batch x node_capacity x GROUP x seg`` float32) and
    its two int32 sidecars (parents, parent actions); with subtree reuse,
    two more trees while ``packed_advance_root`` re-roots the carried one
    (its gather of the tiles and the masked copy of them);
  - the node-state stack (every field of the game state at every node);
  - the trajectory records (``runner.py``'s ``[T, B, ...]`` tensors, ``T``
    the move cap, or the plies of a continuous stream);
  - the tower's activations at the evaluation batch (``batch`` times the
    k-leaf count, or the Gumbel fan when rounds run in parallel):
    ``ACTIVATION_COPIES`` float32 planes of ``channels x H x W`` a board
    alive at once, the observations and the heads' outputs, beside the
    float32 weights twice (the trained copy and the search bundle).

:func:`preflight_memory_check` compares that peak with ``margin`` times the
card's total memory (``torch.cuda.mem_get_info``) and raises
:class:`MemoryBudgetError` over it; on the CPU it returns None (no check),
as the JAX one does where the backend cannot report.  The reckoning is one
process's: ranks that share a card divide the margin among them
(``train_alphazero`` passes ``DEFAULT_MARGIN`` over their count).
``chip_smoke.py`` prints the reckoning beside ``torch.cuda.max_memory_allocated`` of the real
call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from alphazero_gomoku_tpu_torch.ops.tree_kernels import GROUP, packed_layout

# float32 activation planes of the tower alive at once during an
# evaluation (the block's input, its conv output, the batch norm's output
# and the skip sum)
ACTIVATION_COPIES = 4

# the share of the card's memory a process's reckoned peak may fill
DEFAULT_MARGIN = 0.92


class MemoryBudgetError(RuntimeError):
    """A config's reckoned peak exceeds the device budget."""


def device_hbm_bytes(device=None) -> Optional[int]:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``); None
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def _state_bytes_per_node(env) -> int:
    """Bytes of one game state: the int8 board, four int32 counters, the
    done flag, and Pente's two int32 capture counts."""
    per = env.size * env.size + 4 * 4 + 1
    if env.name == "pente":
        per += 2 * 4
    return per


def _weight_count(net_cfg) -> int:
    c, hw = net_cfg.channels, net_cfg.board_size ** 2
    convs = 9 * net_cfg.in_channels * c + net_cfg.n_res_blocks * 2 * 9 * c * c
    bn = 4 * c * (1 + 2 * net_cfg.n_res_blocks) + 4 * 3
    heads = (2 * c + 2 * hw * net_cfg.action_size + net_cfg.action_size
             + c + hw * net_cfg.value_hidden + 2 * net_cfg.value_hidden + 1)
    return convs + bn + heads


def selfplay_memory(env, cfg, net_cfg,
                    total_steps: Optional[int] = None) -> Dict[str, int]:
    """The bytes a self-play call of ``cfg`` (a ``SelfPlayConfig``) on
    ``net_cfg``'s tower allocates, by term, and their sum ``peak_bytes``.
    ``total_steps`` is a continuous stream's plies (None: lockstep games to
    the move cap)."""
    b, mcts = cfg.batch_games, cfg.mcts
    a, hw = env.num_actions, env.size * env.size
    cap = mcts.node_capacity
    layout = packed_layout(a, cap)
    tiles = b * cap * GROUP * layout.seg * 4
    tree = tiles + 2 * b * cap * 4
    reroot = 2 * tiles if mcts.reuse_budget > 0 else 0
    node_states = b * cap * _state_bytes_per_node(env)
    t = cfg.resolved_max_moves(env) if total_steps is None else total_steps
    # boards, players, pis, root values, actions, flags, captures; a stream
    # adds its per-ply winners and end flag
    per_record = hw + 4 + 4 * a + 4 + 4 + 1 + 8
    if total_steps is not None:
        per_record += 4 + 1
    records = t * b * per_record
    if total_steps is None:     # the games' winners and lengths
        records += 2 * 4 * b
    fan = mcts.leaves_per_sim
    if mcts.search == "gumbel" and mcts.gumbel_round_parallel:
        fan = max(fan, mcts.gumbel_max_considered)
    evals = b * fan
    activations = (evals * hw * (ACTIVATION_COPIES * net_cfg.channels
                                 + net_cfg.in_channels) * 4
                   + evals * 2 * (a + 1) * 4)
    weights = 2 * 4 * _weight_count(net_cfg)
    terms = {"tree_bytes": tree, "reroot_bytes": reroot,
             "node_state_bytes": node_states,
             "record_bytes": records, "activation_bytes": activations,
             "weight_bytes": weights}
    terms["peak_bytes"] = sum(terms.values())
    return terms


def preflight_memory_check(reckoning: Dict[str, int],
                           margin: float = DEFAULT_MARGIN,
                           label: str = "program", device=None,
                           limit_bytes: Optional[int] = None
                           ) -> Optional[Dict[str, Any]]:
    """Check a reckoning (:func:`selfplay_memory`) against the device.

    Raises :class:`MemoryBudgetError` when its ``peak_bytes`` exceeds
    ``margin`` of ``limit_bytes`` (default: the card's total memory);
    returns the reckoning with ``limit_bytes`` and ``margin`` added, or
    None where there is no limit to check against (the CPU).
    """
    limit = device_hbm_bytes(device) if limit_bytes is None else limit_bytes
    if limit is None:
        return None
    acct = dict(reckoning, limit_bytes=int(limit), margin=margin)
    if acct["peak_bytes"] > margin * limit:
        gib = 1024 ** 3
        parts = ", ".join(f"{k[:-6].replace('_', ' ')} {v / gib:.2f}"
                          for k, v in reckoning.items()
                          if k != "peak_bytes")
        raise MemoryBudgetError(
            f"{label}: reckoned peak device memory "
            f"{acct['peak_bytes'] / gib:.2f} GiB exceeds {margin:.0%} of "
            f"the {limit / gib:.2f} GiB device limit ({parts} GiB). Reduce "
            f"batch_games, n_simulations (node capacity), the move cap or "
            f"the leaves evaluated at once before running.")
    return acct


def with_preflight(fn, reckoning: Dict[str, int], label: str = "program",
                   margin: float = DEFAULT_MARGIN, device=None):
    """Wrap ``fn`` so that its first call checks ``reckoning`` against the
    device (:func:`preflight_memory_check`) before it runs; later calls go
    straight through."""
    checked = False

    def call(*args, **kwargs):
        nonlocal checked
        if not checked:
            preflight_memory_check(reckoning, margin=margin, label=label,
                                   device=device)
            checked = True
        return fn(*args, **kwargs)

    return call
