"""Parity: the port's folded network (``ops/fused_net.py``) against the JAX
package's, and the slice (Gumbel self-play on the fused network) against the
JAX package's search.

Tolerances, from what the two computations share:

  - ``fold_bn``: the same float32 operations on the same numpy weights, then
    the same round-to-nearest-even bf16 cast: equal exactly.
  - ``folded_apply_plain`` against the JAX ``fused_predict`` (Pallas
    interpret mode): both round each conv input to bf16 and sum exact bf16
    products in float32, in different orders; a sum that lands on the other
    side of a bf16 rounding boundary moves the next conv's input by one bf16
    step.  Logits within 1e-4 and value within 1e-5 (measured: 2.4e-6 and
    9e-8 on these inputs, logits of size ~10).
  - ``folded_apply_plain`` against ``folded_apply_reference`` (float32
    activations, no bf16 rounding): the JAX package's own tolerances for its
    kernel against that reference (``tests/test_fused_net.py:60-71``).
  - ``folded_xla_apply`` against its JAX twin: both keep each conv's
    float32 output and add the bias before rounding to the storage dtype, and
    sum in different orders; float32 and bf16 storage within 1e-4 on logits
    and 1e-5 on value (measured: at most 2.4e-6 and 3e-7 on these inputs).
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alphazero_gomoku_tpu.games.gomoku import GomokuEnv as JaxEnv
from alphazero_gomoku_tpu.models.resnet import NetConfig as JaxNetConfig
from alphazero_gomoku_tpu.models.resnet import init_variables
from alphazero_gomoku_tpu.ops import fused_net as jfn
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import (
    run_gumbel_packed as jax_gumbel,
)
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.models import NetConfig, bundle_of
from alphazero_gomoku_tpu_torch.ops import fused_net as fn
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

# (board, blocks, channels)
NETS = [(9, 2, 32), (7, 1, 16)]


def _net(board, blocks, channels, seed=0):
    """Weights of the JAX ``init_variables`` with batch stats moved off their
    initial values, so that folding shows (``tests/test_fused_net.py``)."""
    jcfg = JaxNetConfig(board_size=board, action_size=board * board,
                        n_res_blocks=blocks, channels=channels)
    cfg = NetConfig(board_size=board, action_size=board * board,
                    n_res_blocks=blocks, channels=channels)
    v = init_variables(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.abs(x + rng.normal(0, 0.05, x.shape)).astype(np.float32),
        v["batch_stats"])
    return jcfg, cfg, params, stats


def _obs(board, b=16, seed=3):
    rng = np.random.default_rng(seed)
    stones = rng.integers(0, 3, (b, board, board))
    return np.stack([stones == 1, stones == 2, np.ones_like(stones)],
                    axis=-1).astype(np.float32)


@pytest.fixture(scope="module", params=NETS, ids=lambda n: f"{n}")
def net(request):
    jcfg, cfg, params, stats = _net(*request.param)
    obs = _obs(cfg.board_size)
    folded = fn.fold_bn(cfg, params, stats, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, stats=stats, obs=obs,
                folded=folded,
                plain=fn.folded_apply_plain(cfg, folded,
                                            torch.from_numpy(obs)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fold_bn_matches_jax_exactly(net, dtype):
    jfold = jfn.fold_bn(net["jcfg"], net["params"], net["stats"],
                        dtype=getattr(jnp, dtype))
    folded = fn.fold_bn(net["cfg"], net["params"], net["stats"],
                        dtype=getattr(torch, dtype), device="cpu")
    assert set(folded) == set(jfold)
    cin = net["cfg"].in_channels
    for name, want in jfold.items():
        want = np.asarray(want.astype(jnp.float32))
        got = folded[name].to(torch.float32).numpy()
        assert folded[name].dtype == (getattr(torch, dtype)
                                      if str(jfold[name].dtype) == dtype
                                      else torch.float32), name
        if name == "stem_w":
            # the JAX stem is padded to the tower width with zero rows
            assert not want[:, cin:].any()
            want = want[:, :cin]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_folded_apply_plain_matches_jax_fused_kernel(net):
    jfold = jfn.fold_bn(net["jcfg"], net["params"], net["stats"])
    with pltpu.force_tpu_interpret_mode():
        logits, value = jfn.fused_predict(net["jcfg"], jfold, 8,
                                          jnp.asarray(net["obs"]))
    got_logits, got_value = net["plain"]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_value.numpy(), np.asarray(value), rtol=0,
                               atol=1e-5)


def test_folded_apply_plain_close_to_folded_reference(net):
    jfold = jfn.fold_bn(net["jcfg"], net["params"], net["stats"])
    logits, value = jfn.folded_apply_reference(net["jcfg"], jfold,
                                               jnp.asarray(net["obs"]))
    got_logits, got_value = net["plain"]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               atol=0.1, rtol=0.02)
    np.testing.assert_allclose(got_value.numpy(), np.asarray(value),
                               atol=0.02)


def test_fused_predict_on_cpu_is_the_plain_version(net):
    fn.reset_launch_counts()
    cfg, folded = net["cfg"], net["folded"]
    obs = torch.from_numpy(net["obs"])
    logits, value = fn.fused_predict(cfg, folded, obs)
    assert torch.equal(logits, net["plain"][0])
    assert torch.equal(value, net["plain"][1])
    assert fn.fused_tower.launches == 0
    probs, v = fn.make_fused_eval_fn(cfg)(folded, obs)
    assert torch.equal(probs, torch.softmax(logits, dim=-1))
    np.testing.assert_allclose(probs.sum(dim=-1).numpy(), 1.0, atol=1e-5)
    assert v.shape == (obs.shape[0], 1) and v.dtype == torch.float32


def test_fused_close_to_the_float32_net(net):
    """bf16 weights and conv inputs against the float32 ``ResNet``, with the
    JAX package's tolerance for the same comparison
    (``tests/test_fused_net.py:75-85``)."""
    cfg = net["cfg"]
    resnet = bundle_of(cfg, net["params"], net["stats"], device="cpu")
    with torch.no_grad():
        logits, value = resnet(torch.from_numpy(net["obs"]))
    got_logits, got_value = net["plain"]
    np.testing.assert_allclose(torch.softmax(got_logits, -1).numpy(),
                               torch.softmax(logits, -1).numpy(), atol=0.05)
    np.testing.assert_allclose(got_value.numpy(), value.numpy(), atol=0.05)
    agree = (got_logits.argmax(-1) == logits.argmax(-1)).float().mean()
    assert agree >= 0.75


@pytest.mark.parametrize("dtype,atol_logits,atol_value", [
    ("float32", 1e-4, 1e-5),
    ("bfloat16", 1e-4, 1e-5),
])
def test_folded_xla_apply_matches_jax(net, dtype, atol_logits, atol_value):
    jcfg, cfg = net["jcfg"], net["cfg"]
    jfold = jfn.fold_bn_xla(jcfg, net["params"], net["stats"],
                            dtype=getattr(jnp, dtype))
    folded = fn.fold_bn_xla(cfg, net["params"], net["stats"],
                            dtype=getattr(torch, dtype), device="cpu")
    obs = net["obs"]
    logits, value = jfn.folded_xla_apply(jcfg, jfold, jnp.asarray(obs))
    got_logits, got_value = fn.folded_xla_apply(cfg, folded,
                                                torch.from_numpy(obs))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=0, atol=atol_logits)
    np.testing.assert_allclose(got_value.numpy(), np.asarray(value), rtol=0,
                               atol=atol_value)
    probs, v = fn.make_bf16_eval_fn(cfg)(folded, torch.from_numpy(obs))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    assert probs.dtype == torch.float32 and v.dtype == torch.float32


def test_fused_tower_checks_its_inputs(net):
    folded, obs = net["folded"], torch.from_numpy(net["obs"])
    with pytest.raises(TypeError):
        fn.fused_tower(folded, obs.double())
    with pytest.raises(ValueError):
        fn.fused_tower(folded, obs[..., :2].contiguous())     # wrong cin
    with pytest.raises(ValueError):
        fn.fused_tower(folded, obs[0])
    bad = dict(folded, block_w=folded["block_w"].to(torch.float32))
    with pytest.raises(TypeError):
        fn.fused_tower(bad, obs)
    meta = {k: v.to("meta") for k, v in folded.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fn.fused_tower(meta, obs.to("meta"))


def test_gumbel_selfplay_on_the_fused_net_matches_jax():
    """The slice: Gumbel@16 self-play in the port on the fused network, ply
    by ply against the JAX package's packed Gumbel search on the port's
    boards.  The JAX search calls the port's fused network (through
    ``jax.pure_callback``) and takes the port's root uniforms, so the two
    differ only in their search and self-play code: actions must be equal
    exactly, pi and root_q within 1e-5."""
    board, batch, moves, seed = 9, 8, 3, 1
    jcfg, cfg, params, stats = _net(board, 2, 32)
    folded = fn.fold_bn(cfg, params, stats, device="cpu")
    eval_fn = fn.make_fused_eval_fn(cfg)
    env, jenv = make_env("gomoku", board), JaxEnv(board)
    a = board * board
    kw = dict(n_simulations=16, search="gumbel", gumbel_max_considered=8,
              add_noise=False, max_depth=56)
    traj = play_games(env, SelfPlayConfig(batch_games=batch,
                                          mcts=MCTSConfig(**kw),
                                          max_moves=moves),
                      eval_fn, folded, torch.Generator().manual_seed(seed),
                      device="cpu")

    def port_net(obs):
        probs, value = eval_fn(folded, torch.from_numpy(np.array(obs)))
        return probs.numpy(), value.numpy()

    def jax_eval(params, obs):
        del params
        shapes = (jax.ShapeDtypeStruct((obs.shape[0], a), jnp.float32),
                  jax.ShapeDtypeStruct((obs.shape[0], 1), jnp.float32))
        return jax.pure_callback(port_net, shapes, obs)

    jmcfg = JaxMCTSConfig(backend="pallas", **kw)

    def jax_search(states, u):
        with mock.patch.object(jax.random, "uniform", lambda *a, **k: u):
            return jax_gumbel(jenv, jmcfg, jax_eval, None, states,
                              jax.random.PRNGKey(0), interpret=True)

    search = jax.jit(jax_search)
    gen = torch.Generator().manual_seed(seed)
    for t in range(moves):
        u = torch.clamp(torch.rand((batch, a), generator=gen), min=1e-12)
        states = jax.vmap(jenv.from_board)(
            jnp.asarray(traj.boards[t].numpy()),
            jnp.asarray(traj.players[t].numpy()),
            jnp.full((batch,), t, jnp.int32))
        pi, root_q, action = search(states, jnp.asarray(u.numpy()))
        np.testing.assert_array_equal(np.asarray(action),
                                      traj.actions[t].numpy(),
                                      err_msg=f"ply {t}")
        np.testing.assert_allclose(traj.pis[t].numpy(), np.asarray(pi),
                                   rtol=0, atol=1e-5, err_msg=f"ply {t}")
        np.testing.assert_allclose(traj.root_qs[t].numpy(),
                                   np.asarray(root_q), rtol=0, atol=1e-5)
    assert traj.active.all()


def _c4_criterion(kernel, plain, ref, scale=None):
    """The card test's criterion (``tests/test_torch_port_cuda.py::
    test_fused_tower_kernel_close_to_plain``) for one output: the kernel at
    most twice as far from the float64 reference as the plain version, or
    one bf16 step (2^-8) of the output's scale: the reference's largest
    magnitude, or 1 for the value (a tanh)."""
    k_err = float((kernel.double() - ref.double()).abs().max())
    p_err = float((plain.double() - ref.double()).abs().max())
    scale = float(ref.abs().max()) if scale is None else scale
    return k_err <= max(2 * p_err, 2.0 ** -8 * scale)


def test_float64_reference_holds_the_jax_kernel_by_the_card_criterion(net):
    """``folded_apply_plain(..., torch.float64)`` keeps the kernel's bf16
    storage points and sums to float64.  Another float32 order of the same
    sums, the JAX kernel's (Pallas interpret mode), meets the card test's
    criterion against it; the float64 tower is float32 and within a bf16
    step of the plain one."""
    cfg, folded = net["cfg"], net["folded"]
    obs = torch.from_numpy(net["obs"])
    jfold = jfn.fold_bn(net["jcfg"], net["params"], net["stats"])
    with pltpu.force_tpu_interpret_mode():
        jout = jfn.fused_predict(net["jcfg"], jfold, 8, jnp.asarray(obs))
    ref = fn.folded_apply_plain(cfg, folded, obs, torch.float64)
    for j, p, r, scale in zip(jout, net["plain"], ref, (None, 1.0)):
        assert _c4_criterion(torch.from_numpy(np.array(j)), p, r, scale)
    tower = fn.fused_tower_plain(folded, obs)
    tower64 = fn.fused_tower_plain(folded, obs, torch.float64)
    assert tower64.dtype == torch.float32
    assert float((tower - tower64).abs().max()) <= \
        2.0 ** -8 * float(tower64.abs().max())


@pytest.mark.parametrize("fault", ["dropped_tap", "wrong_bias"])
def test_card_criterion_catches_a_wrong_tower(net, fault):
    """A tower with one tap of a conv dropped, or a conv's bias on the wrong
    channels, fails the criterion on the tower."""
    folded, obs = net["folded"], torch.from_numpy(net["obs"])
    broken = dict(folded)
    if fault == "dropped_tap":
        broken["block_w"] = folded["block_w"].clone()
        broken["block_w"][0, 1, 4] = 0
    else:
        broken["stem_b"] = torch.roll(folded["stem_b"], 1)
    ref = fn.fused_tower_plain(folded, obs, torch.float64)
    assert _c4_criterion(fn.fused_tower_plain(folded, obs),
                         fn.fused_tower_plain(folded, obs), ref)
    assert not _c4_criterion(fn.fused_tower_plain(broken, obs),
                             fn.fused_tower_plain(folded, obs), ref)
