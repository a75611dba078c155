"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is false,
which it decides inside the test so that every pytest worker collects the
same tests.  This file imports no JAX: the card's machine has none, and there
it runs without the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import dataclasses

import pytest
import torch

from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    fit_batch_stats,
    init_params,
    make_eval_fn,
    params_from_jax,
)
from alphazero_gomoku_tpu_torch.models.model import (
    AdamState,
    Optimizer,
    split_state,
    train_step,
)
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
from alphazero_gomoku_tpu_torch.repro import envelope as ev
from alphazero_gomoku_tpu_torch.repro import parent_probe
from alphazero_gomoku_tpu_torch.repro import width1_slice_write as ws
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.search.gumbel import (
    halving_schedule,
    run_gumbel_mcts,
)
from alphazero_gomoku_tpu_torch.search import tree_packed as tp
from alphazero_gomoku_tpu_torch.search.tree_packed import (
    run_gumbel_packed_with_tree,
    run_mcts_packed,
    run_mcts_packed_with_tree,
)
from alphazero_gomoku_tpu_torch.tools import matmul_rate as mr

from torch_port_edges import (
    DEPTH,
    EDGE_CASES,
    N_NODES,
    edge_paths,
    edge_roots,
    edge_tree,
)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_states(env, batch, plies, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    states = env.init_batch(batch, dev)
    for _ in range(plies):
        legal = env.legal_mask(states).float()
        u = torch.rand(legal.shape, generator=g, device=dev)
        acts = torch.argmax(torch.where(legal > 0, u, -1.0), dim=1)
        states = env.step_safe(states, acts)
    return states


def _pente_obs(size, batch, seed, dev):
    """Pente encodings with capture planes (5 planes): random-play boards,
    and captured pairs k = 0..4 of both sides spread over the lanes (the
    planes hold k / 5)."""
    env = make_env("pente", size, capture_planes=True)
    states = _random_states(env, batch, 2 * size, seed, dev)
    g = torch.Generator().manual_seed(seed)
    k = torch.arange(2 * batch, dtype=torch.int32)[torch.randperm(
        2 * batch, generator=g)].reshape(batch, 2) % 5
    return env.encode(states._replace(captures=k.to(dev)))


def _grown_tree(dev, size=15, batch=64, sims=48, capacity=402, depth=56,
                plies=6, fpu="zero"):
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, *init_params(cfg, 0), device=dev)
    mcfg = MCTSConfig(n_simulations=sims, max_nodes=capacity, max_depth=depth,
                      cpuct=1.0, dirichlet_alpha=0.05, dirichlet_epsilon=0.15,
                      fpu_mode=fpu)
    states = _random_states(env, batch, plies, 1, dev)
    moves = torch.full((batch,), plies, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    _, _, tree = run_mcts_packed_with_tree(env, mcfg, make_eval_fn(), net,
                                           states, moves, g)
    return mcfg, tk.packed_layout(size * size, capacity), tree.packed


@pytest.mark.parametrize("fpu", ["zero", "parent"])
def test_select_walk_kernel_equals_plain(fpu):
    dev = _card()
    mcfg, layout, packed = _grown_tree(dev, fpu=fpu)
    for depth in (mcfg.depth_limit, 2):
        got = tk.select_walk(packed, layout, 1.0, depth, fpu == "parent")
        want = tk.select_walk_plain(packed, layout, 1.0, depth,
                                    fpu == "parent")
        torch.cuda.synchronize()
        for name, x, y in zip(("leaf", "action", "path_nodes",
                               "path_actions", "path_len"), got, want):
            assert torch.equal(x, y), name


def test_backup_paths_kernel_equals_plain():
    dev = _card()
    mcfg, layout, packed = _grown_tree(dev)
    leaf, action, pnodes, pacts, plen = tk.select_walk(
        packed, layout, 1.0, mcfg.depth_limit)
    b = packed.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    values = torch.rand(b, generator=g, device=dev) * 2 - 1
    priors = torch.rand((b, layout.num_actions), generator=g, device=dev)
    done = torch.rand(b, generator=g, device=dev) < 0.2
    slot = mcfg.n_simulations + 1
    args = (pnodes, pacts, plen, values, action >= 0, slot, layout, priors,
            done)
    got = tk.backup_paths(packed.clone(), *args)
    want = tk.backup_paths_plain(packed.clone(), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(got, packed)


# the edge trees and paths of tests/torch_port_edges.py (held against the
# JAX kernels on the CPU by tests/test_torch_port_tree_edges.py): a batch of
# one, a ragged batch, the main path's 256 and the k-leaf path's 1024 lanes;
# boards of 81, 225 and 361 actions (seg 128, 256 and 384)
EDGE_BATCHES = (1, 11, 256, 1024)
EDGE_SIZES = (9, 15, 19)


@pytest.mark.parametrize("batch", EDGE_BATCHES)
@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("mode", tk.BACKUP_MODES)
def test_backup_paths_kernel_equals_plain_on_edge_paths(mode, case, batch):
    dev = _card()
    for size in EDGE_SIZES:
        seed = 100 * size + EDGE_CASES.index(case)
        packed = torch.from_numpy(edge_tree(batch, size, seed)).to(dev)
        p = edge_paths(case, batch, size, seed + 1)
        args = [torch.from_numpy(p[k]).to(dev) for k in (
            "path_nodes", "path_actions", "path_len", "values", "expanding")]
        args += [p["slot"], tk.packed_layout(size * size, N_NODES),
                 torch.from_numpy(p["priors"]).to(dev),
                 torch.from_numpy(p["done"]).to(dev)]
        tk.reset_launch_counts()
        got = tk.backup_paths(packed.clone(), *args, mode=mode)
        want = tk.backup_paths_plain(packed.clone(), *args, mode=mode)
        torch.cuda.synchronize()
        assert tk.backup_paths.mode_launches[mode] == 1
        assert torch.equal(got, want), size
        assert not torch.equal(got, packed)


@pytest.mark.parametrize("batch", EDGE_BATCHES)
@pytest.mark.parametrize("size", EDGE_SIZES)
@pytest.mark.parametrize("fpu", [False, True], ids=["zero", "parent"])
def test_select_walk_kernel_equals_plain_on_edge_trees(fpu, size, batch):
    """Child indices beyond ``n_nodes`` and below -1, terminal nodes, and
    cycles into the depth cap; 4, 8 and 16 columns a thread."""
    dev = _card()
    packed = torch.from_numpy(edge_tree(batch, size, size + batch)).to(dev)
    layout = tk.packed_layout(size * size, N_NODES)
    for depth in (DEPTH, 40):
        got = tk.select_walk(packed, layout, 1.25, depth, fpu)
        want = tk.select_walk_plain(packed, layout, 1.25, depth, fpu)
        torch.cuda.synchronize()
        for name, x, y in zip(("leaf", "action", "path_nodes",
                               "path_actions", "path_len"), got, want):
            assert torch.equal(x, y), (depth, name)


def test_backup_paths_kernel_equals_plain_past_its_default_shared_memory():
    """Path rows deeper than 48 KB of per-hop entries (6144 hops), and paths
    longer than a block's threads, most of whose hops repeat an entry."""
    dev = _card()
    batch, size, depth = 4, 9, 7000
    packed = torch.from_numpy(edge_tree(batch, size, 5)).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    nodes = torch.randint(-2, N_NODES + 2, (depth, batch), generator=g,
                          device=dev, dtype=torch.int32)
    acts = torch.randint(-1, 12, (depth, batch), generator=g, device=dev,
                         dtype=torch.int32)
    plen = torch.tensor([depth, depth - 1, 300, 0], dtype=torch.int32,
                        device=dev)
    args = (nodes, acts, plen, torch.rand(batch, generator=g, device=dev),
            torch.ones(batch, dtype=torch.bool, device=dev), N_NODES + 1,
            tk.packed_layout(size * size, N_NODES),
            torch.rand((batch, size * size), generator=g, device=dev),
            torch.zeros(batch, dtype=torch.bool, device=dev))
    for mode in tk.BACKUP_MODES:
        got = tk.backup_paths(packed.clone(), *args, mode=mode)
        want = tk.backup_paths_plain(packed.clone(), *args, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode


def test_search_pi_kernels_equal_plain_and_count_launches():
    dev = _card()
    size, batch, sims = 15, 16, 24
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, *init_params(cfg, 0), device=dev)
    mcfg = MCTSConfig(n_simulations=sims, cpuct=1.0, dirichlet_alpha=0.05,
                      dirichlet_epsilon=0.15, max_depth=56)
    states = _random_states(env, batch, 4, 5, dev)
    moves = torch.full((batch,), 4, dtype=torch.int32, device=dev)
    pis = []
    for ops in (tk.KERNELS, tk.PLAIN):
        tk.reset_launch_counts()
        g = torch.Generator(device=dev).manual_seed(7)
        pis.append(run_mcts_packed(env, mcfg, make_eval_fn(), net, states,
                                   moves, g, ops=ops)[0])
        if ops is tk.KERNELS:
            assert tk.select_walk.launches == sims
            assert tk.backup_paths.launches == sims
    assert torch.equal(pis[0], pis[1])


def test_kernel_wrappers_raise_on_bad_cuda_inputs():
    dev = _card()
    layout = tk.packed_layout(81, 6)
    packed = tk.init_packed(2, layout, dev)
    with pytest.raises(ValueError):
        tk.select_walk(packed[:, :8], layout, 1.0, 4)
    with pytest.raises(TypeError):
        tk.select_walk(packed.double(), layout, 1.0, 4)
    wide = tk.packed_layout(tk.PUCT_MAX_ACTIONS + 1, 6)
    with pytest.raises(ValueError, match="at most"):
        tk.select_walk(tk.init_packed(2, wide, dev), wide, 1.0, 4)
    # a contiguous view 4 bytes into its storage: the slot tile's 16-byte
    # stores need 16-byte alignment
    shifted = torch.zeros(packed.numel() + 1, device=dev)[1:].view(
        packed.shape)
    i32 = dict(dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tk.backup_paths(shifted, torch.zeros((4, 2), **i32),
                        torch.zeros((4, 2), **i32), torch.ones(2, **i32),
                        torch.zeros(2, device=dev),
                        torch.ones(2, dtype=torch.bool, device=dev), 1,
                        layout, torch.zeros((2, 81), device=dev),
                        torch.zeros(2, dtype=torch.bool, device=dev))


def _gumbel_tree(dev, size=15, batch=64, sims=48, m=16):
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=64)
    params, stats = init_params(cfg, 0)
    folded = fn.fold_bn(cfg, params, stats, device=dev)
    mcfg = MCTSConfig(n_simulations=sims, search="gumbel",
                      gumbel_max_considered=m, add_noise=False, max_depth=56)
    states = _random_states(env, batch, 6, 1, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    *_, tree = run_gumbel_packed_with_tree(
        env, mcfg, fn.make_fused_eval_fn(cfg), folded, states, g)
    return (env, mcfg, tk.packed_layout(size * size, mcfg.node_capacity),
            tree.packed)


@pytest.mark.parametrize("fan", [1, 16])
def test_gumbel_select_walk_kernel_equals_plain(fan):
    dev = _card()
    env, mcfg, layout, packed = _gumbel_tree(dev)
    b = packed.shape[0]
    g = torch.Generator(device=dev).manual_seed(fan)
    # distinct legal root actions per tree: the root prior row's legal ones,
    # in a random order
    legal = packed[:, tk.SL_P, :layout.num_actions] >= 0
    u = torch.rand(legal.shape, generator=g, device=dev)
    root = torch.argsort(torch.where(legal, u, -1.0), dim=1,
                         descending=True)[:, :fan].reshape(-1).int()
    for depth in (mcfg.depth_limit, 2):
        got = tk.gumbel_select_walk(packed, root, layout, depth,
                                    mcfg.gumbel_c_visit, mcfg.gumbel_c_scale,
                                    fan)
        want = tk.gumbel_select_walk_plain(packed, root, layout, depth,
                                           mcfg.gumbel_c_visit,
                                           mcfg.gumbel_c_scale, fan)
        torch.cuda.synchronize()
        assert got[0].shape == (b * fan,)
        for name, x, y in zip(("leaf", "action", "path_nodes",
                               "path_actions", "path_len"), got, want):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("batch", EDGE_BATCHES)
@pytest.mark.parametrize("size", EDGE_SIZES)
@pytest.mark.parametrize("fan", [1, 16])
def test_gumbel_select_walk_kernel_equals_plain_on_edge_trees(fan, size,
                                                              batch):
    """The edge trees of ``tests/torch_port_edges.py`` (values from 1e-30 to
    1e30, priors of 1e-30, clamped and negative children, terminal nodes,
    cycles into the depth cap) with legal, illegal, negative and too-large
    forced root actions; 4, 8 and 16 columns a thread."""
    dev = _card()
    tree = edge_tree(batch, size, 7 * size + batch)
    root = torch.from_numpy(edge_roots(tree, size, fan, batch)).to(dev)
    packed = torch.from_numpy(tree).to(dev)
    layout = tk.packed_layout(size * size, N_NODES)
    for depth in (DEPTH, 40):
        tk.reset_launch_counts()
        got = tk.gumbel_select_walk(packed, root, layout, depth, 50.0, 1.0,
                                    fan)
        want = tk.gumbel_select_walk_plain(packed, root, layout, depth, 50.0,
                                           1.0, fan)
        torch.cuda.synchronize()
        assert tk.gumbel_select_walk.launches == 1
        for name, x, y in zip(("leaf", "action", "path_nodes",
                               "path_actions", "path_len"), got, want):
            assert torch.equal(x, y), (depth, name)


def test_exp_log_f32_on_the_card_equal_the_cpu():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    x = -torch.rand(100000, generator=g) * 110
    y = torch.rand(100000, generator=g) + 1e-30
    assert torch.equal(tk.exp_f32(x.to(dev)).cpu(), tk.exp_f32(x))
    assert torch.equal(tk.log_f32(y.to(dev)).cpu(), tk.log_f32(y))


# the towers' kernels at the edges of their tiles (csrc/conv_tile.cuh):
# boards of one (9x9), four (15x15) and seven (19x19) 64-row tiles, a batch
# of one, a ragged batch, the main path's 256 and the k-leaf path's 1024
TOWER_BOARDS = (9, 15, 19)
TOWER_BATCHES = (1, 11, 256, 1024)


@pytest.mark.parametrize("batch", TOWER_BATCHES)
@pytest.mark.parametrize("size", TOWER_BOARDS)
@pytest.mark.parametrize("channels", [64, 128])
def test_fused_tower_kernel_close_to_plain(channels, size, batch):
    """The kernel sums in another order than the plain version; a sum on the
    other side of a bf16 rounding boundary moves the next conv's input by a
    bf16 step (see ``chip_smoke.FUSED_TOWER_STEPS``), and such steps add up
    over the convs and through the heads.  So tower, logits and value are
    held against a float64 evaluation of the same folded net, with the same
    bf16 storage points (``fused_tower_plain(..., torch.float64)``): the
    kernel may be at most twice as far from it as the plain version is on
    the same inputs (any float32 order lands about as far), or one bf16 step
    of the output's scale (2^-8 of it), whichever is larger.  The scale of
    the tower and of the logits is the reference's largest magnitude; the
    value is a tanh, whose scale is its range, 1: a batch's largest |value|
    (at a batch of one, one value) can lie anywhere near 0, and one bf16
    step of it is no bound on what one flipped rounding in the tower makes
    of the value through its head.  A kernel with a tap or a bias wrong lands far
    beyond that."""
    dev = _card()
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=channels)
    # BN fitted to random boards: live heads, and folded biases that are not
    # all zero, so that a bias the kernel gets wrong shows
    params, stats = init_params(cfg, 1)
    stats = fit_batch_stats(cfg, params, stats,
                            q8.random_calib_obs(cfg, n=64, seed=2), device=dev)
    obs = make_env("gomoku", size).encode(_random_states(
        make_env("gomoku", size), batch, 2 * size, 3, dev))
    _hold_fused(cfg, params, stats, obs, dev)


@pytest.mark.parametrize("batch", (1, 11, 64, 256))
@pytest.mark.parametrize("size", TOWER_BOARDS)
def test_fused_tower_kernel_close_to_plain_on_capture_planes(size, batch):
    """Pente's 5 planes (the stem's K 45 of 48 real columns) with captured
    pairs k / 5, k = 0..4, 2x128, BN fitted to Pente boards, held by the
    float64 criterion above, the C4 criterion (``chip_smoke.py`` phase 23a
    holds the 6x128 net at 15x15 by it).  The kernel's distance from the
    plain version is printed, not held: on these planes it reached 2.06e-3
    of the tower's largest value (19x19, batch 11), above the 2e-3 that the
    3-plane cases hold beside the criterion; within one bf16 step, and the
    float64 criterion passed where it was measured."""
    dev = _card()
    cfg = NetConfig(board_size=size, action_size=size * size, in_channels=5,
                    n_res_blocks=2, channels=128)
    params, stats = init_params(cfg, 1)
    stats = fit_batch_stats(cfg, params, stats, _pente_obs(size, 64, 2, dev),
                            device=dev)
    _hold_fused(cfg, params, stats, _pente_obs(size, batch, 3, dev), dev,
                plain_rel=None)


def _hold_fused(cfg, params, stats, obs, dev, plain_rel=2e-3):
    """``fused_tower`` against float64, as the fused tests' docstring says,
    and (``plain_rel``) within that share of the tower's largest value of
    its plain version."""
    folded = fn.fold_bn(cfg, params, stats, device=dev)
    fn.reset_launch_counts()
    got = fn.fused_tower(folded, obs)
    assert fn.fused_tower.launches == 1
    want = fn.fused_tower_plain(folded, obs)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    dist = float((got - want).abs().max())
    print(f"kernel from plain: {dist:.3g} ({dist / max(scale, 1.0):.3g} of "
          f"the scale)")
    if plain_rel is not None:
        assert dist <= plain_rel * max(scale, 1.0)
    ref = fn.fused_tower_plain(folded, obs, torch.float64)
    kernel = (got, *fn.fused_predict(cfg, folded, obs))
    plain = (want, *fn.folded_apply_plain(cfg, folded, obs))
    ref = (ref, *fn.folded_apply_plain(cfg, folded, obs, torch.float64))
    for name, k, p, r in zip(("tower", "logits", "value"), kernel, plain,
                             ref):
        k_err = float((k.double() - r.double()).abs().max())
        p_err = float((p.double() - r.double()).abs().max())
        scale = 1.0 if name == "value" else float(r.abs().max())
        step = 2.0 ** -8 * scale
        # the distances, shown by pytest -rP
        print(f"{name}: kernel {k_err:.3g}, plain {p_err:.3g} from float64; "
              f"bf16 step {step:.3g}")
        assert k_err <= max(2 * p_err, step), (name, k_err, p_err, step)
    assert torch.equal(fn.fused_tower(folded, obs), got)    # deterministic


def test_gumbel_search_kernels_equal_plain_and_count_launches():
    dev = _card()
    size, batch = 15, 16
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=128)
    folded = fn.fold_bn(cfg, *init_params(cfg, 0), device=dev)
    eval_fn = fn.make_fused_eval_fn(cfg)
    states = _random_states(env, batch, 4, 5, dev)
    _, phases = halving_schedule(24, 8)
    rounds = sum(visits for _, visits in phases)
    for parallel, walks in ((False, 24), (True, rounds)):
        mcfg = MCTSConfig(n_simulations=24, search="gumbel",
                          gumbel_max_considered=8, add_noise=False,
                          max_depth=56, gumbel_round_parallel=parallel)
        outs = []
        for ops in (tk.KERNELS, tk.PLAIN):
            tk.reset_launch_counts()
            fn.reset_launch_counts()
            g = torch.Generator(device=dev).manual_seed(7)
            outs.append(run_gumbel_mcts(env, mcfg, eval_fn, folded, states,
                                        g, ops=ops))
            if ops is tk.KERNELS:
                assert tk.gumbel_select_walk.launches == walks
                assert tk.backup_paths.launches == 24
                assert fn.fused_tower.launches == 1 + walks
        for x, y in zip(*outs):
            assert torch.equal(x, y)


def _int8_net(dev, size, blocks, channels, seed=0):
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=blocks, channels=channels)
    q = q8.quantize_int8(cfg, *init_params(cfg, seed),
                         q8.random_calib_obs(cfg, n=64, seed=1), device=dev)
    return cfg, q, t8.pack_tower_bundle(cfg, q)


@pytest.mark.parametrize("batch", TOWER_BATCHES)
@pytest.mark.parametrize("size", TOWER_BOARDS)
@pytest.mark.parametrize("channels", [32, 64, 128])
def test_int8_tower_kernel_equals_plain_and_int8_apply(channels, size,
                                                       batch):
    """Equal bit for bit: the integer sums are exact in any order and every
    float step is the same IEEE operation (``csrc/int8_tower.cu``).  The
    main path's net (6 blocks of 128) at 15x15; 2 blocks elsewhere."""
    dev = _card()
    blocks = 6 if (size, channels) == (15, 128) else 2
    cfg, q, packed = _int8_net(dev, size, blocks, channels)
    env = make_env("gomoku", size)
    obs = env.encode(_random_states(env, batch, 2 * size, 3, dev))
    _hold_int8(cfg, q, packed, obs)


@pytest.mark.parametrize("batch", (1, 11, 64, 256))
@pytest.mark.parametrize("size", TOWER_BOARDS)
def test_int8_tower_kernel_equals_plain_on_capture_planes(size, batch):
    """Pente's 5 planes (the stem's K 45 of 64 real columns), captured
    pairs k / 5 for k = 0..4, quantized on Pente boards with capture planes
    (so the planes' ``inv_obs`` is 127 / 0.8): equal bit for bit, on a 6x128
    net at 15x15 (Pente's bench config), 2x128 elsewhere."""
    dev = _card()
    blocks = 6 if size == 15 else 2
    cfg = NetConfig(board_size=size, action_size=size * size, in_channels=5,
                    n_res_blocks=blocks, channels=128)
    q = q8.quantize_int8(cfg, *init_params(cfg, 0),
                         _pente_obs(size, 64, 1, dev).cpu(), device=dev)
    assert float(q["inv_obs"][3]) == float(q["inv_obs"][4])
    _hold_int8(cfg, q, t8.pack_tower_bundle(cfg, q),
               _pente_obs(size, batch, 3, dev))


def _hold_int8(cfg, q, packed, obs):
    """``int8_tower`` equals its plain version and ``int8_apply``."""
    t8.reset_launch_counts()
    got = t8.int8_tower(packed, obs)
    assert t8.int8_tower.launches == 1
    torch.cuda.synchronize()
    assert torch.equal(got, t8.int8_tower_plain(packed, obs))
    assert torch.equal(got, q8.int8_tower_mm(q, obs))
    logits, value = t8.int8_tower_apply(cfg, packed, obs)
    want_logits, want_value = q8.int8_apply(cfg, q, obs)
    assert torch.equal(logits, want_logits)
    assert torch.equal(value, want_value)
    assert torch.equal(t8.int8_tower(packed, obs), got)     # deterministic


def test_int8_tower_wrapper_refuses_bad_cuda_inputs():
    dev = _card()
    cfg, q, packed = _int8_net(dev, 9, 1, 32)
    obs = torch.zeros((4, 9, 9, 3), device=dev)
    with pytest.raises(TypeError):
        t8.int8_tower(packed, obs.double())
    with pytest.raises(ValueError):
        t8.int8_tower(packed, obs[0])
    with pytest.raises(ValueError):
        t8.int8_tower(packed, obs.cpu())        # weights on the card
    with pytest.raises(ValueError, match="channels"):
        _, _, wide = _int8_net(dev, 9, 1, 48)
        t8.int8_tower(wide, obs)
    bad = dict(packed, block_w=packed["block_w"].float())
    with pytest.raises(TypeError):
        t8.int8_tower(bad, obs)


def test_tower_wrappers_refuse_what_the_tiles_cannot_take():
    """Limits of the padded-board tiles (``ops/conv_tile.py``): square
    boards up to 21x21; and the stems' K (int8 at most 128 columns, bf16
    9 * cin at most 64)."""
    dev = _card()
    for size, shape in ((22, (2, 22, 22, 3)), (9, (2, 9, 11, 3))):
        cfg, q, packed = _int8_net(dev, size, 1, 32)
        folded = fn.fold_bn(NetConfig(board_size=size,
                                      action_size=size * size,
                                      n_res_blocks=1, channels=64),
                            *init_params(NetConfig(
                                board_size=size, action_size=size * size,
                                n_res_blocks=1, channels=64), 0), device=dev)
        obs = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError, match="boards"):
            t8.int8_tower(packed, obs)
        with pytest.raises(ValueError, match="boards"):
            fn.fused_tower(folded, obs)
    wide = NetConfig(board_size=9, action_size=81, n_res_blocks=1,
                     channels=64, in_channels=8)
    folded = fn.fold_bn(wide, *init_params(wide, 0), device=dev)
    with pytest.raises(ValueError, match="stem"):
        fn.fused_tower(folded, torch.zeros((2, 9, 9, 8), device=dev))
    cfg, q, packed = _int8_net(dev, 9, 1, 32)
    big = dict(packed, stem_w=torch.zeros((32, 160), dtype=torch.int8,
                                          device=dev),
               inv_obs=torch.ones((16,), device=dev))
    with pytest.raises(ValueError, match="stem"):
        t8.int8_tower(big, torch.zeros((2, 9, 9, 16), device=dev))


# (board, batch, k): a small board, a batch that is not a multiple of
# anything, and the k-leaf path's shape
@pytest.mark.parametrize("size,batch,k", [(9, 11, 2), (15, 40, 4),
                                          (15, 256, 4)])
def test_backup_vl_and_finalize_kernels_equal_plain(size, batch, k):
    """k "vl" passes, then their k "finalize" passes, on a tree grown by a
    k-leaf search: after each, the kernel's whole tree equals the plain
    version's."""
    dev = _card()
    sims = 32
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, *init_params(cfg, 0), device=dev)
    mcfg = MCTSConfig(n_simulations=sims, max_nodes=sims + 2 + k,
                      max_depth=56, leaves_per_sim=k, add_noise=False)
    states = _random_states(env, batch, 6, 1, dev)
    moves = torch.full((batch,), 6, dtype=torch.int32, device=dev)
    _, _, tree = run_mcts_packed_with_tree(env, mcfg, make_eval_fn(), net,
                                           states, moves)
    packed = tree.packed
    layout = tk.packed_layout(size * size, mcfg.node_capacity)
    g = torch.Generator(device=dev).manual_seed(size + k)
    a = size * size
    tk.reset_launch_counts()
    passes = []
    for j in range(k):
        _, action, pnodes, pacts, plen = tk.select_walk(
            packed, layout, 1.0, mcfg.depth_limit)
        done = torch.rand(batch, generator=g, device=dev) < 0.2
        legal = torch.rand((batch, a), generator=g, device=dev) < 0.8
        placeholder = torch.where(legal, 1.0 / a, -1.0)
        inputs = (pnodes, pacts, plen)
        rest = (action >= 0, sims + 1 + j, layout)
        zeros = torch.zeros(batch, device=dev)
        want = tk.backup_paths_plain(packed.clone(), *inputs, zeros, *rest,
                                     placeholder, done, mode="vl")
        tk.backup_paths(packed, *inputs, zeros, *rest, placeholder, done,
                        mode="vl")
        torch.cuda.synchronize()
        assert torch.equal(packed, want), f"vl {j}"
        passes.append((inputs, rest, done))
    for inputs, rest, done in passes:
        values = torch.rand(batch, generator=g, device=dev) * 2 - 1
        priors = torch.rand((batch, a), generator=g, device=dev)
        want = tk.backup_paths_plain(packed.clone(), *inputs, values, *rest,
                                     priors, done, mode="finalize")
        tk.backup_paths(packed, *inputs, values, *rest, priors, done,
                        mode="finalize")
        torch.cuda.synchronize()
        assert torch.equal(packed, want), "finalize"
    assert tk.backup_paths.mode_launches == {"backup": 0, "vl": k,
                                             "finalize": k}
    assert tk.backup_paths.launches == 2 * k


def test_kleaf_and_reuse_searches_kernels_equal_plain():
    """A k-leaf PUCT search, and PUCT and Gumbel searches with reuse over
    two moves, on the kernels equal the same searches on the plain
    versions: pi, root_q, actions and every field of the carry."""
    dev = _card()
    size, batch = 15, 16
    env = make_env("gomoku", size)
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, *init_params(cfg, 0), device=dev)
    states = _random_states(env, batch, 4, 5, dev)
    moves = torch.full((batch,), 4, dtype=torch.int32, device=dev)
    kleaf = MCTSConfig(n_simulations=24, leaves_per_sim=4, max_depth=56,
                       dirichlet_alpha=0.05, dirichlet_epsilon=0.15)
    outs = []
    for ops in (tk.KERNELS, tk.PLAIN):
        tk.reset_launch_counts()
        g = torch.Generator(device=dev).manual_seed(7)
        pi, q, tree = run_mcts_packed_with_tree(env, kleaf, make_eval_fn(),
                                                net, states, moves, g,
                                                ops=ops)
        outs.append((pi, q, tree.packed))
        if ops is tk.KERNELS:
            assert tk.select_walk.launches == 24
            assert tk.backup_paths.mode_launches == {
                "backup": 0, "vl": 24, "finalize": 24}
    for x, y in zip(*outs):
        assert torch.equal(x, y)

    # the fused tower's kernel takes 64 or 128 channels
    cfg64 = dataclasses.replace(cfg, channels=64)
    folded = fn.fold_bn(cfg64, *init_params(cfg64, 0), device=dev)
    for search in ("puct", "gumbel"):
        if search == "puct":
            mcfg = MCTSConfig(n_simulations=24, reuse_budget=16,
                              max_depth=56, add_noise=False)
        else:
            mcfg = MCTSConfig(n_simulations=24, search="gumbel",
                              gumbel_max_considered=8, add_noise=False,
                              max_depth=56, reuse_budget=16)
        carries = []
        for ops in (tk.KERNELS, tk.PLAIN):
            g = torch.Generator(device=dev).manual_seed(9)
            st = states
            carry = tp.init_packed_carry(env, mcfg, st)
            trace = []
            for _ in range(2):
                if search == "puct":
                    pi, q, carry = run_mcts_packed_with_tree(
                        env, mcfg, make_eval_fn(), net, st, moves, g,
                        ops=ops, carry=carry)
                    act = pi.argmax(dim=1)
                else:
                    pi, q, act, carry = run_gumbel_packed_with_tree(
                        env, mcfg, fn.make_fused_eval_fn(cfg64), folded, st, g,
                        ops=ops, carry=carry)
                trace += [pi, q, act, *_carry_tensors(carry)]
                carry = tp.packed_advance_root(env, mcfg, carry, act)
                trace += _carry_tensors(carry)
                st = env.step_safe(st, act)
            carries.append(trace)
        for x, y in zip(*carries):
            assert torch.equal(x, y), search


def _carry_tensors(carry):
    return [carry.packed, *carry.states, carry.parent, carry.parent_action]


# the rate probe: row counts below a block, the JAX tool's and the towers';
# depths of one mma (int8), the per-tap K and the im2col K; 1, 4 and 9 row
# shifts
@pytest.mark.parametrize("m", [17, 2040, 57600])
@pytest.mark.parametrize("k", [32, 128, 1152])
@pytest.mark.parametrize("reps", [1, 4, 9])
def test_matmul_rate_kernel_equals_plain(m, k, reps):
    """int8 and bf16 on integer values in [-3, 3] exactly (every float32
    partial sum is an integer below 2^24), bf16 on normal values within
    ``mr.BF16_REL_TOL`` of ``sum |x| @ |w|``; after 1 and 5 steps."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m + k + reps)
    inputs = mr.make_inputs(m, k, reps, g, dev)
    xi, wi = inputs["int8"]
    xb, wb = inputs["bf16"]
    cases = [(xi, wi), (xi.to(torch.bfloat16), wi.to(torch.bfloat16))]
    bound = mr.bf16_bound(xb, wb, reps)
    for steps in (1, 5):
        for x, w in cases:
            got = mr.matmul_rate(x, w, reps, steps)
            torch.cuda.synchronize()
            assert torch.equal(got, mr.matmul_rate_plain(x, w, reps, 1))
        got = mr.matmul_rate(xb, wb, reps, steps)
        want = mr.matmul_rate_plain(xb, wb, reps, 1)
        err = (got.double() - want.double()).abs()
        assert (err <= bound).all(), float((err / bound).max())


def test_matmul_rate_counts_launches_per_dtype():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = mr.make_inputs(300, 64, 3, g, dev)
    mr.reset_launch_counts()
    mr.matmul_rate(*inputs["int8"], 3, 2)
    mr.matmul_rate(*inputs["bf16"], 3, 2)
    mr.matmul_rate(*inputs["bf16"], 3, 1)
    assert mr.matmul_rate.dtype_launches == {"int8": 1, "bf16": 2}
    assert mr.matmul_rate.launches == 3


def test_matmul_rate_wrapper_raises_on_bad_cuda_inputs():
    dev = _card()
    x = torch.zeros((140, 128), dtype=torch.int8, device=dev)
    w = torch.zeros((128, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        mr.matmul_rate(x.t().contiguous().t(), w, 9, 1)
    with pytest.raises(TypeError):
        mr.matmul_rate(x.float(), w.float(), 9, 1)
    with pytest.raises(TypeError):
        mr.matmul_rate(x, w.to(torch.bfloat16), 9, 1)
    with pytest.raises(ValueError, match="multiple"):     # int8 depth 32
        mr.matmul_rate(x[:, :48].contiguous(), w[:48].contiguous(), 9, 1)
    with pytest.raises(ValueError, match="multiple"):     # bf16 depth 16
        xb = torch.zeros((140, 24), dtype=torch.bfloat16, device=dev)
        mr.matmul_rate(xb, torch.zeros((24, 128), dtype=torch.bfloat16,
                                       device=dev), 9, 1)
    with pytest.raises(ValueError, match="multiple"):     # N of 128
        mr.matmul_rate(x, w[:, :64].contiguous(), 9, 1)
    with pytest.raises(ValueError):
        mr.matmul_rate(x, w.cpu(), 9, 1)


@pytest.mark.parametrize("ok", [False, True], ids=["width1", "segment"])
@pytest.mark.parametrize("shape,c", [
    ((ws.B, ws.G, ws.R), ws.C), ((3, 5, 256), 200),
    # rows whose byte count is not a multiple of 16: unaligned heads and
    # tails; C at both edges of the row
    ((2, 3, 1153), 0), ((2, 3, 1153), 1152), ((4, 5, 7), 0), ((4, 5, 7), 6),
    ((3, 3, 2), 1), ((1, 1, 1), 0), ((2, 2, 4), 3), ((1, 2, ws.MAX_ROW), 5),
])
def test_width1_slice_write_kernel_equals_plain(shape, c, ok):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, generator=g, device=dev)
    ws.reset_launch_counts()
    got = ws.width1_slice_write(x, c, ok)
    torch.cuda.synchronize()
    assert ws.width1_slice_write.launches == 1
    assert torch.equal(got, ws.width1_slice_write_plain(x, c, ok))
    assert not torch.equal(got, x)


def test_width1_slice_write_raises_on_bad_cuda_inputs():
    dev = _card()
    x = torch.zeros((2, 2, ws.MAX_ROW + 1), device=dev)   # a row too long
    with pytest.raises(ValueError, match="shared memory"):
        ws.width1_slice_write(x, 5)
    with pytest.raises(ValueError, match="16-byte"):
        ws.width1_slice_write(torch.zeros(17, device=dev)[1:].view(2, 2, 4),
                              1)
    with pytest.raises(TypeError):
        ws.width1_slice_write(x[:, :, :8].contiguous().double(), 5)
    with pytest.raises(ValueError):
        ws.width1_slice_write(x[:, :, :8].transpose(1, 2).contiguous()
                              .transpose(1, 2), 5)


def test_time_rate_refuses_a_run_that_ignores_its_steps():
    """The rate probe's construct: a run whose time does not grow with the
    step count (here one step whatever is asked) is refused."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x, w = mr.make_inputs(mr.M_CARD, mr.K, 9, g, dev)["int8"]
    with pytest.raises(RuntimeError, match="step count|elided"):
        mr.time_rate(lambda steps: mr.matmul_rate(x, w, 9, 1),
                     2.0 * mr.M_CARD * mr.K * mr.N * 9, "int8")


# ----------------------------------------------------------------------
# the training step and the replay mirror
# ----------------------------------------------------------------------
def _step_inputs(cfg, batch, seed, dev):
    params, stats = init_params(cfg, seed)
    p, s = split_state({k: v.to(dev) for k, v in
                        params_from_jax(params, stats).items()})
    g = torch.Generator(device=dev).manual_seed(seed)
    size = cfg.board_size
    cells = torch.randint(0, 3, (batch, size, size), generator=g, device=dev)
    x = torch.stack([cells == 1, cells == 2,
                     torch.ones_like(cells, dtype=torch.bool)], dim=-1).float()
    pi = torch.rand((batch, size * size), generator=g, device=dev)
    pi = torch.where(pi < 0.5, 0.0, pi)
    pi = pi / pi.sum(dim=1, keepdim=True)
    z = torch.randint(-1, 2, (batch, 1), generator=g, device=dev).float()
    return p, s, x, pi, z


def train_step_against_float64(cfg, batch, seed):
    """One float32 step on the card against the same step in float64 on
    the card, from a fresh optimizer state: Adam's first step is about
    ``-lr * g' / (|g'| + eps)``, ``g'`` its input (the clipped gradient plus
    the weight decay, read back from the first moment ``mu = 0.1 g'``).
    Where the two ``g'`` (a, b) agree in sign and ``|a| > |a - b| + 100
    eps``, the steps differ by ``lr * eps * |a - b| / ((|a| + eps)(|b| +
    eps)) < lr / 100``, plus float32's rounding of ``p + u`` (2.4e-7 for
    ``|p| < 2``); the others (within float32's error of zero, or across a
    ReLU's kink) by up to ``2 lr + 1e-5``.  Returns how many are the
    others."""
    dev = _card()
    p, s, x, pi, z = _step_inputs(cfg, batch, seed, dev)
    tx = Optimizer()
    o = tx.init(p)

    def f64(d):
        return {k: v.double() if v.is_floating_point() else v
                for k, v in d.items()}

    new32, _, o32, m32 = train_step(cfg, tx, p, s, o, x, pi, z)
    new64, _, o64, m64 = train_step(
        cfg, tx, f64(p), f64(s), AdamState(o.count, f64(o.mu), f64(o.nu)),
        x.double(), pi.double(), z.double())
    torch.cuda.synchronize()
    chaotic_n = 0
    for k in p:
        a32 = o32.mu[k].double() / (1 - tx.b1)
        a64 = o64.mu[k] / (1 - tx.b1)
        chaotic = a64.abs() <= (a32 - a64).abs() + 1e-6
        diff = (new32[k].double() - new64[k]).abs()
        assert float(torch.where(chaotic, 0.0, diff).max()) <= \
            tx.lr / 100 + 2.4e-7, k
        assert float(torch.where(chaotic, diff, 0.0).max()) <= \
            2 * tx.lr + 1e-5, k
        chaotic_n += int(chaotic.sum())
    assert abs(float(m32["total_loss"]) - float(m64["total_loss"])) <= 1e-4
    return chaotic_n


@pytest.mark.parametrize("blocks,channels,size,batch", [
    (2, 16, 9, 32), (6, 128, 15, 64)], ids=["2x16", "6x128"])
def test_train_step_on_the_card_matches_float64(blocks, channels, size,
                                                 batch):
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=blocks, channels=channels)
    train_step_against_float64(cfg, batch, seed=blocks)


def test_device_mirror_sampling_equals_the_host_ring():
    import numpy as np

    from alphazero_gomoku_tpu_torch.selfplay.buffer import (
        DeviceBufferMirror, ReplayBuffer, decode_states_f32)

    dev = _card()
    rng = np.random.default_rng(0)
    buf = ReplayBuffer(capacity=300, board_size=7, channel_scales=(1, 1, 5))
    mirror = DeviceBufferMirror(buf, device=dev)
    for n in (120, 120, 100):                    # wraps once
        planes = rng.integers(0, 2, (n, 7, 7, 2)).astype(np.float32)
        k = rng.integers(0, 5, (n, 1, 1, 1)).astype(np.float32) / 5
        states = np.concatenate(
            [planes, np.broadcast_to(k, (n, 7, 7, 1))], axis=-1)
        pis = rng.random((n, 49)).astype(np.float32)
        zs = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
        mirror.sync(states, pis, zs, buf.add(states, pis, zs))
    idx = np.random.default_rng(5).choice(len(buf), 64, replace=False)
    want = buf.sample(64, np.random.default_rng(5))
    ib = torch.as_tensor(idx, device=dev)
    got_s = mirror.states[ib].float() * mirror.inv_scales
    np.testing.assert_array_equal(got_s.cpu().numpy(), want[0])
    np.testing.assert_array_equal(
        got_s.cpu().numpy(),
        decode_states_f32(buf.states[idx], buf.inv_scales))
    np.testing.assert_array_equal(mirror.pis[ib].cpu().numpy(), want[1])
    np.testing.assert_array_equal(mirror.zs[ib].reshape(-1, 1).cpu().numpy(),
                                  want[2])


def test_player_searches_at_batch_1_kernels_equal_plain(tmp_path):
    """The PUCT player (a batch of one, 400 simulations, reuse 400, fpu
    parent) over three moves, the second and third resumed through
    ``packed_advance_root``, on the kernels equals the same player on the
    plain versions (``tree_ops``): every pi, every move and the carried
    tree."""
    import numpy as np

    from alphazero_gomoku_tpu_torch.models import AZModel
    from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer

    dev = _card()
    ckpt = str(tmp_path / "net.ckpt")
    AZModel(board_size=15, n_res_blocks=2, channels=32, seed=3,
            device=dev).save(ckpt)
    traces = []
    for ops in (tk.KERNELS, tk.PLAIN):
        player = AlphaZeroPlayer("gomoku", 15, n_simulations=400,
                                 model_path=ckpt, device=dev)
        player.tree_ops = ops
        searches = []

        def recorded(name, search):
            def run(*args):
                out = search(*args)
                searches.append((name, out[0]))
                return out
            return run

        for name in ("_search_fresh", "_search_resume"):
            setattr(player, name, recorded(name, getattr(player, name)))
        board = np.zeros((15, 15), np.int8)
        board[7, 7] = 1
        tk.reset_launch_counts()
        trace = []
        for turn, reply in ((1, (6, 6)), (3, (8, 9)), (5, (9, 5))):
            move = player.play(board.copy(), turn, None)
            board[move] = 2
            trace += [torch.tensor(move), *_carry_tensors(player._carry)]
            board[reply if board[reply] == 0 else (reply[0], 14)] = 1
        assert [n for n, _ in searches] == [
            "_search_fresh", "_search_resume", "_search_resume"]
        trace += [torch.from_numpy(pi) for _, pi in searches]
        if ops is tk.KERNELS:
            assert tk.select_walk.launches == 3 * 400
            assert tk.backup_paths.mode_launches["backup"] == 3 * 400
            assert tk.gumbel_select_walk.launches == 0
        traces.append(trace)
    for x, y in zip(*traces):
        assert torch.equal(x.cpu(), y.cpu())


def test_gumbel_player_at_batch_1_kernels_equal_plain(tmp_path):
    """The Gumbel player (a batch of one, 64 simulations, m = 16,
    round-parallel: fans 16 down to 2 on a 66-slot tree) over three moves
    on the kernels equals the same player on the plain versions: every pi
    and every move."""
    import numpy as np

    from alphazero_gomoku_tpu_torch.models import AZModel
    from alphazero_gomoku_tpu_torch.players.alpha_base import AlphaZeroPlayer

    dev = _card()
    ckpt = str(tmp_path / "net.ckpt")
    AZModel(board_size=15, n_res_blocks=2, channels=32, seed=3,
            device=dev).save(ckpt)
    traces = []
    for ops in (tk.KERNELS, tk.PLAIN):
        player = AlphaZeroPlayer("gomoku", 15, n_simulations=64,
                                 model_path=ckpt, search="gumbel",
                                 device=dev)
        player.tree_ops = ops
        pis = []
        search = player._search
        player._search = lambda *args: pis.append(search(*args)) or pis[-1]
        board = np.zeros((15, 15), np.int8)
        board[7, 7] = 1
        tk.reset_launch_counts()
        trace = []
        for turn, reply in ((1, (6, 6)), (3, (8, 9)), (5, (9, 5))):
            move = player.play(board.copy(), turn, None)
            board[move] = 2
            trace.append(torch.tensor(move))
            board[reply if board[reply] == 0 else (reply[0], 14)] = 1
        trace += [torch.from_numpy(pi) for pi in pis]
        if ops is tk.KERNELS:
            assert len(pis) == 3
            assert tk.gumbel_select_walk.launches == 3 * 15
            assert tk.backup_paths.mode_launches["backup"] == 3 * 64
            assert tk.select_walk.launches == 0
        traces.append(trace)
    for x, y in zip(*traces):
        assert torch.equal(x.cpu(), y.cpu())


def test_backup_paths_at_depth_10002_on_a_real_5000_simulation_tree():
    """``player_alpha2``'s search shape: 5000 simulations with reuse 5000,
    so the walks' and the backup's depth argument is the node capacity,
    10002, and the backup's per-hop entries (80016 bytes) take the
    shared-memory opt-in.  One walk and one backup on the grown tree, each
    kernel against its plain version."""
    dev = _card()
    env = make_env("gomoku", 15)
    cfg = NetConfig(board_size=15, action_size=225, n_res_blocks=2,
                    channels=32)
    net = bundle_of(cfg, *init_params(cfg, 0), device=dev)
    mcfg = MCTSConfig(n_simulations=5000, reuse_budget=5000,
                      fpu_mode="parent", add_noise=False)
    depth = mcfg.depth_limit
    assert depth == 10002
    states = _random_states(env, 1, 4, 3, dev)
    moves = torch.full((1,), 4, dtype=torch.int32, device=dev)
    _, _, carry = run_mcts_packed_with_tree(env, mcfg, make_eval_fn(), net,
                                            states, moves)
    layout = tk.packed_layout(225, mcfg.node_capacity)
    got = tk.select_walk(carry.packed, layout, 1.0, depth, True)
    want = tk.select_walk_plain(carry.packed, layout, 1.0, depth, True)
    for name, x, y in zip(("leaf", "action", "path_nodes", "path_actions",
                           "path_len"), got, want):
        assert torch.equal(x, y), name
    _, action, pnodes, pacts, plen = got
    assert pnodes.shape[0] == depth and int(plen[0]) > 1
    g = torch.Generator(device=dev).manual_seed(4)
    priors = torch.rand((1, 225), generator=g, device=dev)
    args = (pnodes, pacts, plen, torch.full((1,), 0.25, device=dev),
            action >= 0, 5001, layout, priors,
            torch.zeros(1, dtype=torch.bool, device=dev))
    tk.reset_launch_counts()
    kernel = tk.backup_paths(carry.packed.clone(), *args)
    assert tk.backup_paths.mode_launches["backup"] == 1
    plain = tk.backup_paths_plain(carry.packed.clone(), *args)
    torch.cuda.synchronize()
    assert torch.equal(kernel, plain)
    assert not torch.equal(kernel, carry.packed)


# ----------------------------------------------------------------------
# the envelope probes (repro/): one case per axis, kernels against plain
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,cap", parent_probe.MUST_CAP)
def test_capped_walks_in_a_whole_search_kernels_equal_plain(kind, cap):
    """A search whose walks reach the depth cap (K1, K3, K2 and K2' in
    modes vl and finalize at the capped branch) equals the plain one."""
    dev = _card()
    line = parent_probe.probe(kind, cap, 4, batch=32, device=dev)
    assert line["ok"] and line["match"] and line["capped_walks"] > 0, line


def test_done_roots_and_full_boards_kernels_equal_plain():
    """Games played to their end on 7x7: searches on done roots and on
    full boards equal the plain ones, and the host replay agrees."""
    dev = _card()
    env = make_env("gomoku", 7)
    net_cfg, eval_fn, bundle = ev.make_net("f32", 2, 32, 5, board_size=7,
                                           device=dev)
    cfg = ev.selfplay_config(32, 32, 49, fpu_mode="parent")
    line = ev.probe_selfplay(
        env, cfg, ev.make_sides("f32", net_cfg, eval_fn), bundle, 1000,
        net_cfg=net_cfg, expect=("won", "full_board", "done_root_plies"),
        device=dev).line
    assert line["ok"] and line["match"], line


def test_batch_1024_kernels_equal_plain():
    """1024 lanes: the walk and backup alone on random trees, and a PUCT
    move on the int8 tower (K5 at 1024 boards)."""
    dev = _card()
    line = ev.probe_kernels(1024, 64, 72, device=dev).line
    assert line["ok"] and line["match"], line
    env = make_env("gomoku", 15)
    net_cfg, eval_fn, bundle = ev.make_net("int8t", 2, 32, 0, device=dev)
    run = ev.probe_selfplay(env, ev.selfplay_config(1024, 16, 1),
                            ev.make_sides("int8t", net_cfg, eval_fn), bundle,
                            5, net_cfg=net_cfg, device=dev)
    assert run.line["ok"] and run.line["match"], run.line
