"""Parity: the port's ResNet (``params_from_jax``) against ``models/resnet.apply``.

Both frameworks compute in float32 on the CPU; convolutions and matrix
products sum in different orders, so logits and value agree within 1e-5,
not bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from alphazero_gomoku_tpu.models.resnet import NetConfig as JaxNetConfig
from alphazero_gomoku_tpu.models.resnet import apply, init_variables
from alphazero_gomoku_tpu_torch.models import (
    NetConfig,
    bundle_of,
    fit_batch_stats,
    init_params,
    make_eval_fn,
    params_from_jax,
)
from alphazero_gomoku_tpu_torch.models.resnet import ResNet
from alphazero_gomoku_tpu_torch.ops import int8_net as q8

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

BOARD = 9
TOL = 1e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _perturb(tree, rng, positive=False):
    """Non-trivial BN stats and affine parameters, so their mapping shows."""
    def f(x):
        noise = rng.uniform(0.5, 1.5, x.shape) if positive else \
            rng.normal(0, 0.2, x.shape)
        return (x * noise if positive else x + noise).astype(np.float32)
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxNetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                        n_res_blocks=2, channels=32)
    v = init_variables(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    params = _numpy_tree(v["params"])
    stats = _numpy_tree(v["batch_stats"])
    for bn in [params["stem_bn"], params["policy_bn"], params["value_bn"]] + \
            [blk[k] for blk in params["blocks"] for k in ("bn1", "bn2")]:
        bn["scale"] = _perturb(bn["scale"], rng, positive=True)
        bn["bias"] = _perturb(bn["bias"], rng)
    stats = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        if x.mean() == 0 else (x * rng.uniform(0.5, 2, x.shape)).astype(
            np.float32), stats)
    return jcfg, params, stats


def _obs(b, seed):
    rng = np.random.default_rng(seed)
    board = rng.choice([0, 1, 2], size=(b, BOARD, BOARD))
    obs = np.stack([board == 1, board == 2, np.ones_like(board)], -1)
    return obs.astype(np.float32)


@pytest.mark.parametrize("b", [1, 8])
def test_forward_matches_jax(weights, b):
    jcfg, params, stats = weights
    obs = _obs(b, b)
    (jl, jv), _ = apply(jcfg, params, stats, jnp.asarray(obs), train=False)
    cfg = NetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, params, stats, device="cpu")
    with torch.no_grad():
        tl, tv = net(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    probs, value = make_eval_fn()(net, torch.from_numpy(obs))
    np.testing.assert_allclose(probs.numpy(),
                               np.asarray(jax.nn.softmax(jl, axis=-1)),
                               rtol=0, atol=TOL)
    assert value.shape == (b, 1)


def test_init_params_has_the_jax_layout():
    """``init_params`` makes the JAX pytree (same structure and shapes), and
    its distributions have the scales of the JAX initialiser."""
    cfg = NetConfig.full()
    jcfg = JaxNetConfig.full()
    params, stats = init_params(cfg, seed=1)
    want = jax.eval_shape(lambda: init_variables(jax.random.PRNGKey(0), jcfg))
    got = {"params": params, "batch_stats": stats}
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
    conv = params["blocks"][0]["conv1"]["w"]
    assert abs(conv.std() - (2.0 / (9 * 128)) ** 0.5) < 2e-3
    fc = params["policy_fc"]["w"]
    assert abs(np.abs(fc).max() - (6.0 / fc.shape[0]) ** 0.5) < 1e-3
    # the whole state_dict loads strictly into the module
    ResNet(cfg).load_state_dict(params_from_jax(params, stats))


def test_policy_fc_rows_are_permuted_hwc_to_chw(weights):
    """Row ``(h*W + w)*C + c`` of the JAX matrix is column ``c*H*W + h*W + w``
    of the torch weight."""
    _, params, stats = weights
    sd = params_from_jax(params, stats)
    jw = params["policy_fc"]["w"]
    tw = sd["policy_fc.weight"].numpy()
    h, w, c = 3, 5, 1
    np.testing.assert_array_equal(tw[:, c * BOARD * BOARD + h * BOARD + w],
                                  jw[(h * BOARD + w) * 2 + c])


def test_training_mode_is_refused(weights):
    """Training mode is no longer refused: it normalises with batch
    statistics and moves the running ones, as the JAX ``apply(train=True)``
    does (``tests/test_torch_port_train_step.py`` holds it closely)."""
    _, params, stats = weights
    cfg = NetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                    n_res_blocks=2, channels=32)
    net = bundle_of(cfg, params, stats, device="cpu").train()
    obs = _obs(4, 0)
    logits, _ = net(torch.from_numpy(obs))
    (want, _), _ = apply(JaxNetConfig(board_size=BOARD,
                                      action_size=BOARD * BOARD,
                                      n_res_blocks=2, channels=32),
                         params, stats, obs, train=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    assert not torch.equal(net.stem_bn.running_mean,
                           torch.from_numpy(stats["stem_bn"]["mean"]))


def test_fit_batch_stats_normalizes_each_bn_input():
    """``fit_batch_stats`` gives each BN the mean and variance of its input
    on the boards: with them every BN's output has mean 0 and variance 1 per
    channel there (before its affine, which init_params leaves at 1 and 0),
    the folded biases are no longer zero, and the inputs are left as they
    were."""
    cfg = NetConfig(board_size=BOARD, action_size=BOARD * BOARD,
                    n_res_blocks=2, channels=16)
    params, stats = init_params(cfg, 3)
    before = jax.tree_util.tree_map(np.copy, stats)
    obs = q8.random_calib_obs(cfg, n=32, seed=4)
    fitted = fit_batch_stats(cfg, params, stats, obs, device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal, stats, before)
    assert jax.tree_util.tree_structure(fitted) == \
        jax.tree_util.tree_structure(stats)
    net = bundle_of(cfg, params, fitted, device="cpu")
    x = torch.from_numpy(obs).permute(0, 3, 1, 2)
    with torch.no_grad():
        h = net.stem_bn(net.stem(x))
        for y in (h, net.blocks[0].bn1(net.blocks[0].conv1(torch.relu(h)))):
            np.testing.assert_allclose(y.mean(dim=(0, 2, 3)).numpy(), 0,
                                       atol=1e-5)
            np.testing.assert_allclose(
                y.var(dim=(0, 2, 3), unbiased=False).numpy(), 1, atol=1e-3)
    assert np.abs(fitted["stem_bn"]["mean"]).max() > 0
