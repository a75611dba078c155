"""Training CLI: every ``train_alphazero`` knob as a flag.

Counterpart of ``alphazero_gomoku_tpu/cli/train.py:16-256``: the JAX CLI's
flags with its defaults, and ``--device`` (default the card; ``cpu`` runs
the port on the CPU).  ``--game pente`` (with ``--pente-capture-planes``)
and ``--selfplay-mode continuous`` (with ``--selfplay-steps``) run.  The
multi-process flags join the process group before the loop
(``parallel.initialize_distributed``), one process per card:
``--distributed`` reads ``torchrun``'s environment, and
``--coordinator-address`` (``host:port`` of rank 0) with
``--num-processes`` and ``--process-id`` is an explicit rendezvous; the
loop then runs data-parallel over the ranks (``mesh="auto"``).
``--profile-trace-dir`` writes a ``torch.profiler`` trace of the second
iteration (the first when only one runs).

    python -m alphazero_gomoku_tpu_torch.cli.train [flags]
    torchrun --nproc_per_node N -m alphazero_gomoku_tpu_torch.cli.train \
        --distributed [flags]
"""

from __future__ import annotations

import argparse
import sys

from alphazero_gomoku_tpu_torch.parallel import initialize_distributed
from alphazero_gomoku_tpu_torch.selfplay import train_alphazero


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train AlphaZero on the card")
    ap.add_argument("--game", default="gomoku", choices=["gomoku", "pente"])
    ap.add_argument("--board-size", type=int, default=15)
    ap.add_argument("--num-iterations", type=int, default=300)
    ap.add_argument("--games-per-iteration", type=int, default=70,
                    help="lockstep self-play games per iteration")
    ap.add_argument("--n-simulations", type=int, default=1600)
    ap.add_argument("--cpuct", type=float, default=1.0)
    ap.add_argument("--buffer-size", type=int, default=60000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--epochs-per-iter", type=int, default=5)
    ap.add_argument("--temp-threshold", type=int, default=10)
    ap.add_argument("--eval-games", type=int, default=60)
    ap.add_argument("--eval-mcts-simulations", type=int, default=1600)
    ap.add_argument("--eval-every", type=int, default=1,
                    help="run the candidate-vs-best arena every N "
                         "iterations (skipped iterations keep training; "
                         "see train_alphazero)")
    ap.add_argument("--win-rate-threshold", type=float, default=0.5)
    ap.add_argument("--gate-stat", default="ci_low",
                    choices=["ci_low", "win_rate"],
                    help="gate statistic: 'ci_low' promotes only when "
                         "the Wilson 95%% lower bound clears the "
                         "threshold (and resets only when the upper "
                         "bound falls below it); 'win_rate' is the "
                         "reference point-estimate gate")
    ap.add_argument("--dirichlet-alpha", type=float, default=0.05)
    ap.add_argument("--dirichlet-epsilon", type=float, default=0.15)
    ap.add_argument("--dirichlet-n-moves", type=int, default=10)
    ap.add_argument("--mcts-max-depth", type=int, default=64,
                    help="select-walk depth cap (0 = unbounded)")
    ap.add_argument("--mcts-backend", default="xla",
                    choices=["xla", "pallas"],
                    help="accepted for the JAX CLI's scripts: the port has "
                         "one search, the packed tree on the CUDA tree "
                         "kernels, which both values run")
    ap.add_argument("--mcts-fpu-mode", default="zero",
                    choices=["zero", "parent"],
                    help="first-play urgency for unvisited edges: 'zero' "
                         "is reference-exact; 'parent' inherits the node "
                         "mean (keeps search coherent when the value head "
                         "is extreme; see MCTSConfig.fpu_mode)")
    ap.add_argument("--mcts-reuse-budget", type=int, default=0,
                    help="self-play cross-move subtree reuse: keep up to "
                         "N nodes of the played subtree between moves "
                         "(0 = off, reference-exact; requires "
                         "--mcts-backend pallas)")
    ap.add_argument("--mcts-search", default="puct",
                    choices=["puct", "gumbel"],
                    help="root search algorithm: 'puct' is the "
                         "reference-parity search; 'gumbel' is Gumbel "
                         "sequential halving (Danihelka et al. 2022) — "
                         "policy-improvement guarantees at small "
                         "simulation budgets, no Dirichlet/temperature "
                         "(see search/gumbel.py)")
    ap.add_argument("--gumbel-max-considered", type=int, default=16,
                    help="root actions entering sequential halving")
    ap.add_argument("--gumbel-round-parallel", action="store_true",
                    help="batch each halving round's simulations into "
                         "one network call (latency lever for small "
                         "game batches; serial-exact outside the "
                         "endgame duplicate-candidate case)")
    ap.add_argument("--mcts-leaves-per-sim", type=int, default=1,
                    help="k leaves selected (with virtual loss) per "
                         "network call; 1 = reference-exact sequential "
                         "search, larger k batches the NN harder")
    ap.add_argument("--n-res-blocks", type=int, default=3)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--model-dir", default="models")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--anchor-arena-every", type=int, default=0,
                    help="every N iterations also play the candidate "
                         "against a FIXED anchor net (absolute strength "
                         "trend; 0 = off)")
    ap.add_argument("--anchor-model-path", default=None,
                    help="anchor checkpoint (default: frozen copy of the "
                         "starting weights)")
    ap.add_argument("--anchor-mcts-simulations", type=int, default=0,
                    help="sims/move for the anchor arena (0 = inherit "
                         "--eval-mcts-simulations). Take the anchor signal "
                         "at the config promotions are decided under — "
                         "run-15's gumbel@64 anchor read ~0.5 while the "
                         "f32 puct@400 promotion metric regressed")
    ap.add_argument("--anchor-search", default=None,
                    choices=["puct", "gumbel"],
                    help="search mode for the anchor arena (default: "
                         "inherit --mcts-search)")
    ap.add_argument("--gate-mode", default="reset",
                    choices=["reset", "track"],
                    help="on gate failure: 'reset' restores the candidate "
                         "from best (reference parity); 'track' lets the "
                         "candidate keep training and only holds back the "
                         "promotion of best (drift-proof peak tracking)")
    ap.add_argument("--buffer-save-every", type=int, default=1,
                    help="persist the replay buffer every N iterations "
                         "(1 = reference parity; ~11 s/save at the 120k "
                         "production ring — raise for long runs)")
    ap.add_argument("--pretrained-model-path", default=None)
    ap.add_argument("--candidate-model-path", default=None,
                    help="track-mode resume: restore the candidate from "
                         "its own snapshot (best loads "
                         "--pretrained-model-path)")
    ap.add_argument("--next-iteration-continuation", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--value-loss-weight", type=float, default=1.0,
                    help="scale on the value MSE loss term")
    ap.add_argument("--value-target-mix", type=float, default=0.0,
                    help="soften z toward the root search value: "
                         "target = (1-mix)*z + mix*root_q")
    ap.add_argument("--opening-random-moves", type=int, default=0,
                    help="random centre plies before search play "
                         "(diversity; not recorded as samples)")
    ap.add_argument("--pcr-cheap-sims", type=int, default=0,
                    help="playout cap randomization (KataGo 1902.10565): "
                         "simulations for CHEAP plies (0 = off); cheap "
                         "plies are value-only samples, policy trains on "
                         "the full-simulation plies")
    ap.add_argument("--pcr-full-prob", type=float, default=0.25,
                    help="probability a ply runs the full search under "
                         "playout cap randomization")
    ap.add_argument("--selfplay-max-moves", type=int, default=0,
                    help="self-play move cap (0 = board^2); capped games "
                         "score draws — lower it for a draw curriculum "
                         "that feeds the value head non-decisive lines")
    ap.add_argument("--use-fused-inference", action="store_true",
                    help="use the fused bf16 tower kernel for "
                         "self-play/arena leaf evaluation "
                         "(alias for --inference fused)")
    ap.add_argument("--inference", default="f32",
                    choices=["f32", "bf16", "fused", "int8", "int8t"],
                    help="search-time network forward: the float32 net, "
                         "the folded-BN bfloat16 forward, the fused bf16 "
                         "tower kernel, per-channel int8, or int8t — the "
                         "same int8 scheme through the int8 tower kernel "
                         "(training steps always use float32)")
    ap.add_argument("--profile-trace-dir", default=None,
                    help="write a torch.profiler (Chrome) trace of the 2nd "
                         "iteration into this directory")
    ap.add_argument("--no-symmetries", action="store_true")
    ap.add_argument("--selfplay-mode", default="lockstep",
                    choices=["lockstep", "continuous"])
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process: join the process group from "
                         "torchrun's environment (one process per card; "
                         "see parallel/distributed.py)")
    ap.add_argument("--coordinator-address", default=None,
                    help="host:port of process 0 (an explicit rendezvous, "
                         "with --num-processes and --process-id)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--replay-sharding", default="replicated",
                    choices=["replicated", "per_host"],
                    help="multi-process replay placement: 'replicated' "
                         "all-gathers every host's games into full-replica "
                         "buffers (reference-equivalent sampling); "
                         "'per_host' keeps each host's own games only and "
                         "splits --buffer-size across hosts — scale-out "
                         "once buffers outgrow one host's RAM")
    ap.add_argument("--pente-capture-planes", action="store_true",
                    help="append 2 captured-pair observation planes (Pente "
                         "only; trains a 5-input-channel net)")
    ap.add_argument("--selfplay-steps", type=int, default=0,
                    help="continuous-mode plies per iteration (0 = board^2)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs the port on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.distributed or args.coordinator_address:
        initialize_distributed(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
            auto=args.distributed and not args.coordinator_address,
            device=args.device,
        )
    train_alphazero(
        game_name=args.game,
        board_size=args.board_size,
        num_iterations=args.num_iterations,
        games_per_iteration=args.games_per_iteration,
        n_simulations=args.n_simulations,
        buffer_size=args.buffer_size,
        batch_size=args.batch_size,
        epochs_per_iter=args.epochs_per_iter,
        temp_threshold=args.temp_threshold,
        eval_games=args.eval_games,
        eval_mcts_simulations=args.eval_mcts_simulations,
        eval_every=args.eval_every,
        win_rate_threshold=args.win_rate_threshold,
        gate_stat=args.gate_stat,
        cpuct=args.cpuct,
        model_dir=args.model_dir,
        save_every=args.save_every,
        buffer_save_every=args.buffer_save_every,
        pretrained_model_path=args.pretrained_model_path,
        candidate_model_path=args.candidate_model_path,
        next_iteration_continuation=args.next_iteration_continuation,
        dirichlet_alpha=args.dirichlet_alpha,
        dirichlet_epsilon=args.dirichlet_epsilon,
        dirichlet_n_moves=args.dirichlet_n_moves,
        mcts_max_depth=args.mcts_max_depth,
        mcts_backend=args.mcts_backend,
        mcts_leaves_per_sim=args.mcts_leaves_per_sim,
        mcts_fpu_mode=args.mcts_fpu_mode,
        mcts_reuse_budget=args.mcts_reuse_budget,
        mcts_search=args.mcts_search,
        gumbel_max_considered=args.gumbel_max_considered,
        gumbel_round_parallel=args.gumbel_round_parallel,
        anchor_arena_every=args.anchor_arena_every,
        anchor_model_path=args.anchor_model_path,
        anchor_mcts_simulations=args.anchor_mcts_simulations,
        anchor_search=args.anchor_search,
        gate_mode=args.gate_mode,
        n_res_blocks=args.n_res_blocks,
        channels=args.channels,
        lr=args.lr,
        weight_decay=args.weight_decay,
        seed=args.seed,
        value_loss_weight=args.value_loss_weight,
        value_target_mix=args.value_target_mix,
        opening_random_moves=args.opening_random_moves,
        selfplay_max_moves=args.selfplay_max_moves,
        replay_sharding=args.replay_sharding,
        pcr_cheap_sims=args.pcr_cheap_sims,
        pcr_full_prob=args.pcr_full_prob,
        use_fused_inference=args.use_fused_inference,
        inference=args.inference,
        profile_trace_dir=args.profile_trace_dir,
        use_symmetries=not args.no_symmetries,
        selfplay_mode=args.selfplay_mode,
        selfplay_steps=args.selfplay_steps,
        pente_capture_planes=args.pente_capture_planes,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
