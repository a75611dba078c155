"""The port's training step (``models/losses.py``, the train-mode
``ResNet``, ``models/model.py``'s optimizer and ``train_step``) against the
JAX package's ``losses``, ``apply(train=True)`` and ``train_step_fn``.

Inputs are made with numpy from a seed and handed to both.  Tolerances:

  - losses, forward and statistics: float32 sums in two orders, 1e-5;
  - the step: each of three steps starts both frameworks from the same state
    (the JAX one, converted), so that a step's differences do not compound.
    Every parameter then agrees within 5e-5, except where Adam's inputs can
    differ in sign: its update is about ``-lr * g' / (|g'| + eps)``, ``g'``
    the clipped gradient plus the weight decay (read back from the moments:
    ``g' = (mu_new - b1 mu_old) / (1 - b1)``), so an element whose ``g'`` is
    within the frameworks' disagreement of zero (``|g'| <= |g'_port -
    g'_jax| + 100 eps``) may move by up to ``2 lr`` differently (the cause
    of the JAX package's P1 test failure); those are bounded by
    ``2 lr + 5e-5``, and nothing else is.
  - The step's inputs are continuous (standard normal) observations: on
    binary boards a pre-activation within an ulp of zero makes a ReLU pass
    the gradient in one framework and not the other, which moves one unit's
    upstream gradients by percents; that is the ReLU's kink, not the
    optimizer or autograd, and the losses over boards are compared instead.

``compute_dtype`` bfloat16: the JAX package's ``train_step_fn`` raises on
JAX 0.9.0 when the net computes in bfloat16 (the transpose of
``conv_general_dilated`` refuses its mixed bfloat16 / float32 operands), so
the bfloat16 step is held against the JAX bfloat16 forward: its logits,
value, statistics and loss at each step's parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu.models import losses as jl
from alphazero_gomoku_tpu.models import model as jm
from alphazero_gomoku_tpu.models import resnet as jr
from alphazero_gomoku_tpu_torch.models import losses as pl
from alphazero_gomoku_tpu_torch.models import model as pm
from alphazero_gomoku_tpu_torch.models import resnet as pr

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

BOARD, BLOCKS, CH, BATCH = 9, 2, 16, 32
LR, WD = 1e-3, 1e-4
EPS = 1e-8


def _cfgs(dtype=torch.float32):
    cfg = pr.NetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                       n_res_blocks=BLOCKS, channels=CH, compute_dtype=dtype)
    jcfg = jr.NetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                        n_res_blocks=BLOCKS, channels=CH,
                        compute_dtype=(jnp.bfloat16 if dtype == torch.bfloat16
                                       else jnp.float32))
    return cfg, jcfg


def _batch(seed, boards):
    rng = np.random.default_rng(seed)
    if boards:
        cells = rng.integers(0, 3, (BATCH, BOARD, BOARD))
        x = np.stack([cells == 1, cells == 2, np.ones_like(cells, bool)],
                     axis=-1).astype(np.float32)
    else:
        x = rng.standard_normal((BATCH, BOARD, BOARD, 3)).astype(np.float32)
    pi = rng.random((BATCH, BOARD * BOARD)).astype(np.float32)
    pi[pi < 0.5] = 0.0          # zeros in the target: 0 log 0 := 0
    pi /= pi.sum(axis=1, keepdims=True)
    z = rng.choice([-1.0, 0.0, 1.0], (BATCH, 1)).astype(np.float32)
    return x, pi, z


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _max_diff(a_tree, b_tree):
    return max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(a_tree), _leaves(b_tree)))


def _port_state(jp, js, jo):
    """The port's params, statistics and Adam state from the JAX ones."""
    p, s = pm.split_state(pr.params_from_jax(jax.device_get(jp),
                                             jax.device_get(js)))
    adam = jo[2]
    o = pm.AdamState(torch.tensor(int(adam.count), dtype=torch.int32),
                     pr.param_tree_to_torch(jax.device_get(adam.mu)),
                     pr.param_tree_to_torch(jax.device_get(adam.nu)))
    return p, s, o


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 25)).astype(np.float32) * 3
    pi = rng.random((6, 25)).astype(np.float32)
    pi[pi < 0.6] = 0.0
    pi[0] = 0.0
    pi[0, 3] = 1.0               # a one-hot row
    pi /= pi.sum(axis=1, keepdims=True)
    value = np.tanh(rng.standard_normal((6, 1))).astype(np.float32)
    z = rng.choice([-1.0, 0.0, 1.0], (6, 1)).astype(np.float32)
    tl, tp, tv, tz = _t(logits, pi, value, z)
    np.testing.assert_allclose(float(pl.policy_kl(tl, tp)),
                               float(jl.policy_kl(logits, pi)), rtol=1e-6)
    np.testing.assert_allclose(float(pl.value_mse(tv, tz)),
                               float(jl.value_mse(value, z)), rtol=1e-6)
    for w in (1.0, 0.25):
        total, parts = pl.alphazero_loss(tl, tv, tp, tz, w)
        jtotal, jparts = jl.alphazero_loss(logits, value, pi, z, w)
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
        for k in jparts:
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("boards", [True, False], ids=["boards", "normal"])
def test_train_mode_forward_and_running_stats_match_jax(dtype, boards):
    cfg, jcfg = _cfgs(dtype)
    params, stats = pr.init_params(cfg, seed=1)
    x, _, _ = _batch(2, boards)
    net = pr.ResNet(cfg)
    net.load_state_dict(pr.params_from_jax(params, stats))
    net.train()
    logits, value = net(torch.from_numpy(x))
    (jlogits, jvalue), jstats = jr.apply(jcfg, params, stats, x, train=True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = float(np.abs(np.asarray(jlogits)).max())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=tol * max(scale, 1.0))
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue),
                               atol=tol)
    _, got_stats = pr.params_to_jax(net.state_dict())
    assert jax.tree_util.tree_structure(got_stats) == \
        jax.tree_util.tree_structure(jstats)
    for g, w in zip(_leaves(got_stats), _leaves(jstats)):
        np.testing.assert_allclose(g, w, atol=tol * max(1.0, np.abs(w).max()))
    # the running statistics moved: momentum 0.1 toward the batch's
    assert _max_diff(got_stats, stats) > 1e-3
    # eval mode uses them, and equals the JAX eval forward
    net.eval()
    with torch.no_grad():
        elog, _ = net(torch.from_numpy(x))
    (jelog, _), _ = jr.apply(jcfg, *pr.params_to_jax(net.state_dict()), x,
                             train=False)
    np.testing.assert_allclose(elog.numpy(), np.asarray(jelog),
                               atol=tol * max(1.0, np.abs(jelog).max()))


@pytest.mark.parametrize("vlw,clip", [(1.0, True), (0.05, False)],
                         ids=["clipped", "unclipped"])
def test_train_step_matches_train_step_fn(vlw, clip):
    cfg, jcfg = _cfgs()
    params, stats = pr.init_params(cfg, seed=1)
    x, pi, z = _batch(0, boards=False)
    tx = jm.make_optimizer(LR, WD)
    opt = pm.Optimizer(LR, WD)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, stats)
    jo = tx.init(jp)
    norms = []
    b1 = opt.b1
    for _ in range(3):
        p, s, o = _port_state(jp, js, jo)
        mu_old = _leaves(jo[2].mu)

        def loss_fn(pp):
            (lg, v), _ = jr.apply(jcfg, pp, js, x, train=True)
            return jl.alphazero_loss(lg, v, pi, z, vlw)[0]

        gj = _leaves(jax.grad(loss_fn)(jp))
        norms.append(float(np.sqrt(sum((g * g).sum() for g in gj))))
        jp, js, jo, jmet = jm.train_step_fn(jcfg, tx, jp, js, jo, x, pi, z,
                                            vlw)
        p, s, o, met = pm.train_step(cfg, opt, p, s, o, *_t(x, pi, z), vlw)
        got_p, got_s = pr.params_to_jax({**p, **s})
        adam = jo[2]
        mu_j = _leaves(adam.mu)
        mu_p = _leaves(pr.param_tree_to_jax(o.mu))
        for g, w, old, mj, mp in zip(_leaves(got_p), _leaves(jp), mu_old,
                                     mu_j, mu_p):
            a_j = (mj - b1 * old) / (1 - b1)     # Adam's input g'
            a_p = (mp - b1 * old) / (1 - b1)
            chaotic = np.abs(a_j) <= np.abs(a_j - a_p) + 100 * EPS
            diff = np.abs(g - w)
            assert diff[~chaotic].max(initial=0.0) <= 5e-5
            assert diff[chaotic].max(initial=0.0) <= 2 * LR + 5e-5
        assert _max_diff(got_s, js) <= 1e-5
        assert int(o.count) == int(adam.count)
        assert _max_diff(pr.param_tree_to_jax(o.mu), adam.mu) <= 1e-6
        assert _max_diff(pr.param_tree_to_jax(o.nu), adam.nu) <= 1e-6
        for k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5)
    # the global-norm clip was (or was not) triggered on some step
    assert (max(norms) >= pm.GRAD_CLIP_NORM) == clip


def test_train_step_losses_over_boards_follow_jax():
    """Three chained steps on a batch of boards: the losses agree (the
    ReLU-kink caveat of the module docstring moves a few parameters, not
    the loss)."""
    cfg, jcfg = _cfgs()
    params, stats = pr.init_params(cfg, seed=3)
    x, pi, z = _batch(4, boards=True)
    tx = jm.make_optimizer(LR, WD)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, stats)
    jo = tx.init(jp)
    opt = pm.Optimizer(LR, WD)
    p, s, o = _port_state(jp, js, jo)
    for _ in range(3):
        jp, js, jo, jmet = jm.train_step_fn(jcfg, tx, jp, js, jo, x, pi, z)
        p, s, o, met = pm.train_step(cfg, opt, p, s, o, *_t(x, pi, z))
        np.testing.assert_allclose(float(met["total_loss"]),
                                   float(jmet["total_loss"]), rtol=1e-4)


def test_bf16_train_step_runs_the_bf16_forward():
    """bfloat16 steps: at each step's parameters, the port's loss equals the
    JAX package's bfloat16 forward's, and the loss falls."""
    cfg, jcfg = _cfgs(torch.bfloat16)
    params, stats = pr.init_params(cfg, seed=1)
    x, pi, z = _batch(0, boards=True)
    p, s = pm.split_state(pr.params_from_jax(params, stats))
    opt = pm.Optimizer(LR, WD)
    o = opt.init(p)
    losses = []
    for _ in range(3):
        jp, js = pr.params_to_jax({**p, **s})
        (lg, v), _ = jr.apply(jcfg, jp, js, x, train=True)
        want = float(jl.alphazero_loss(lg, v, pi, z)[0])
        p, s, o, met = pm.train_step(cfg, opt, p, s, o, *_t(x, pi, z))
        np.testing.assert_allclose(float(met["total_loss"]), want, rtol=2e-3)
        losses.append(want)
    assert losses[-1] < losses[0]


def test_optimizer_clip_formula():
    """optax's clip: ``g * 3 / ||g||`` at a norm of 3 or more, no epsilon;
    then weight decay, then Adam's first step ``-lr * g / (|g| + eps)``,
    up to the float32 rounding of its bias corrections (``0.1 g / 0.1``,
    ``sqrt(0.001 g^2 / 0.001)``: a few ulps, 2e-5 relative)."""
    opt = pm.Optimizer(lr=0.5, weight_decay=0.0)
    p = {"a": torch.zeros(4)}
    for scale in (1.0, 10.0):
        g = {"a": torch.tensor([3.0, -4.0, 0.0, 1e-9]) * scale / 5.0}
        upd, state = opt.update(g, opt.init(p), p)
        norm = float(torch.linalg.vector_norm(g["a"]))
        gc = g["a"] * (3.0 / norm if norm >= 3.0 else 1.0)
        want = -0.5 * gc / (gc.abs() + 1e-8)
        torch.testing.assert_close(upd["a"], want, rtol=2e-5, atol=0)
        assert int(state.count) == 1


def test_params_to_jax_inverts_params_from_jax():
    cfg, _ = _cfgs()
    params, stats = pr.init_params(cfg, seed=5)
    back_p, back_s = pr.params_to_jax(pr.params_from_jax(params, stats))
    for got, want in ((back_p, params), (back_s, stats)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for g, w in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(g, w)
    tree = pr.param_tree_to_jax(pr.param_tree_to_torch(params))
    for g, w in zip(_leaves(tree), _leaves(params)):
        np.testing.assert_array_equal(g, w)
