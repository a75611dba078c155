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
    init_params,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk
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


def test_exp_log_f32_on_the_card_equal_the_cpu():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    x = -torch.rand(100000, generator=g) * 110
    y = torch.rand(100000, generator=g) + 1e-30
    assert torch.equal(tk.exp_f32(x.to(dev)).cpu(), tk.exp_f32(x))
    assert torch.equal(tk.log_f32(y.to(dev)).cpu(), tk.log_f32(y))


@pytest.mark.parametrize("channels", [64, 128])
def test_fused_tower_kernel_close_to_plain(channels):
    """The kernel sums in another order than the plain version; a sum on the
    other side of a bf16 rounding boundary moves the next conv's input by a
    bf16 step (see ``chip_smoke.FUSED_TOWER_STEPS``)."""
    dev = _card()
    size, batch = 15, 40          # batch*225 is not a multiple of 64 pixels
    cfg = NetConfig(board_size=size, action_size=size * size,
                    n_res_blocks=2, channels=channels)
    folded = fn.fold_bn(cfg, *init_params(cfg, 1), device=dev)
    obs = make_env("gomoku", size).encode(_random_states(
        make_env("gomoku", size), batch, 30, 3, dev))
    fn.reset_launch_counts()
    got = fn.fused_tower(folded, obs)
    assert fn.fused_tower.launches == 1
    want = fn.fused_tower_plain(folded, obs)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-3 * max(scale, 1.0)
    logits, value = fn.fused_predict(cfg, folded, obs)
    plain_logits, plain_value = fn.folded_apply_plain(cfg, folded, obs)
    assert float((logits - plain_logits).abs().max()) <= 1e-2
    assert float((value - plain_value).abs().max()) <= 1e-3
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


# (board, blocks, channels, batch): a small net, a batch whose pixels are not
# a multiple of the kernel's 128-pixel tile, and the main path's shape
@pytest.mark.parametrize("size,blocks,channels,batch", [
    (9, 2, 32, 11), (15, 2, 64, 40), (15, 6, 128, 256)])
def test_int8_tower_kernel_equals_plain_and_int8_apply(size, blocks, channels,
                                                       batch):
    """Equal bit for bit: the integer sums are exact in any order and every
    float step is the same IEEE operation (``csrc/int8_tower.cu``)."""
    dev = _card()
    cfg, q, packed = _int8_net(dev, size, blocks, channels)
    env = make_env("gomoku", size)
    obs = env.encode(_random_states(env, batch, 2 * size, 3, dev))
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
@pytest.mark.parametrize("shape,c", [((ws.B, ws.G, ws.R), ws.C),
                                     ((3, 5, 256), 200)])
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
    x = torch.zeros((2, 64, 1024), device=dev)     # a 256 KB slab
    with pytest.raises(ValueError, match="shared memory"):
        ws.width1_slice_write(x, 5)
    with pytest.raises(TypeError):
        ws.width1_slice_write(x[:, :8].double(), 5)
    with pytest.raises(ValueError):
        ws.width1_slice_write(x[:, :8].transpose(1, 2).contiguous()
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
