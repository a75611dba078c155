"""Nets of 5 input planes (Pente with capture planes) in the port: the int8
forward against the JAX package's, and the shipped ``best_pente.ckpt`` in
every inference mode.

The capture planes hold k / 5 (k = 0..4 captured pairs), the first inputs
of the int8 observation quantization that are not 0 or 1.  The int8 towers
are integer sums and single-rounding float steps, equal bit for bit (as
``test_torch_port_int8.py`` holds them on Gomoku's planes): the tower is
read through one-hot heads on the JAX side, and the JAX int8 tower kernel
(Pallas interpret mode) from its ``pallas_call``.  The observation ranges
are maxima, so the scales of the five planes are equal too.
"""

import numpy as np
import jax
import pytest
import torch

from alphazero_gomoku_tpu.models import AZModel as JaxModel
from alphazero_gomoku_tpu.models.resnet import NetConfig as JaxNetConfig
from alphazero_gomoku_tpu.models.resnet import init_variables
from alphazero_gomoku_tpu.ops import int8_net as jq
from alphazero_gomoku_tpu.ops import int8_tower as jt
from alphazero_gomoku_tpu_torch.models import NetConfig, make_inference
from alphazero_gomoku_tpu_torch.models.model import INFERENCE_MODES, AZModel
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8

from test_torch_port_checkpoint import ROOT, _boards
from test_torch_port_int8 import (
    CHANNELS,
    SIZE,
    _jax_int8_apply,
    _jax_kernel_tower,
    _probe_heads,
)
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

A = SIZE * SIZE
PENTE = str(ROOT / "checkpoints" / "best_pente.ckpt")


def _pente_obs(size, n, seed):
    """Boards with capture planes; every k = 0..4 on both planes."""
    obs = _boards(size, n, seed, cin=5)
    k = np.rint(obs[:, 0, 0, 3:] * 5)
    assert set(k.ravel()) == {0, 1, 2, 3, 4}
    return obs


@pytest.fixture(scope="module")
def small():
    """A 9x9, 2x32 net of 5 input planes, BN stats moved off their initial
    values, quantized by the JAX package on Pente boards with capture
    planes."""
    jcfg = JaxNetConfig(board_size=SIZE, action_size=A, n_res_blocks=2,
                        channels=CHANNELS, in_channels=5)
    cfg = NetConfig(board_size=SIZE, action_size=A, n_res_blocks=2,
                    channels=CHANNELS, in_channels=5)
    v = init_variables(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.abs(x + rng.normal(0, 0.05, x.shape)).astype(np.float32),
        v["batch_stats"])
    calib = _pente_obs(SIZE, 32, 5)
    jbundle = jax.tree_util.tree_map(np.asarray, jq.quantize_int8(
        jcfg, params, stats, calib))
    return dict(jcfg=jcfg, cfg=cfg, params=params, stats=stats, calib=calib,
                jq=jbundle, obs=_pente_obs(SIZE, 15, 6))


def test_int8_tower_on_capture_planes_equals_jax(small):
    q = q8.int8_bundle_from_jax(small["jq"], device="cpu")
    obs = small["obs"]
    tower = q8.int8_tower_mm(q, torch.from_numpy(obs)).numpy()
    tower = tower.reshape(-1, A, CHANNELS)
    for c in range(0, CHANNELS, 2):
        want, _ = _jax_int8_apply(small["jcfg"],
                                  _probe_heads(small["jq"], c, c + 1), obs)
        np.testing.assert_array_equal(
            tower[..., c:c + 2].reshape(-1, 2 * A), want,
            err_msg=f"channels {c}, {c + 1}")
    # the int8 tower's plain version against the JAX kernel
    packed = t8.pack_tower_bundle(small["cfg"], q)
    assert packed["stem_w"].shape == (CHANNELS, 64)      # 9 * 5 = 45 -> 64
    jtower, _, _ = _jax_kernel_tower(
        small["jcfg"], jt.pack_tower_bundle(small["jcfg"], small["jq"]), obs)
    got = t8.int8_tower_plain(packed, torch.from_numpy(obs)).numpy()
    np.testing.assert_array_equal(got, jtower)
    np.testing.assert_array_equal(got.reshape(tower.shape), tower)


def test_quantize_int8_obs_scales_equal_jax(small):
    """The port's own quantization of the same net on the same boards: the
    five observation scales equal (maxima), the capture planes' 0.8 / 127."""
    q = q8.quantize_int8(small["cfg"], small["params"], small["stats"],
                         small["calib"], device="cpu")
    for key in ("s_obs", "inv_obs"):
        np.testing.assert_array_equal(q[key].numpy(), small["jq"][key],
                                      err_msg=key)
    np.testing.assert_allclose(q["s_obs"].numpy()[3:], 0.8 / 127, rtol=1e-6)


@pytest.fixture(scope="module")
def pente():
    """``best_pente.ckpt`` (6x128, 5 planes) in both packages, and Pente
    boards of 15x15 with capture planes."""
    jm = JaxModel.from_checkpoint(PENTE)
    pm = AZModel.from_checkpoint(PENTE, device="cpu")
    assert pm.cfg.in_channels == jm.cfg.in_channels == 5
    return dict(jm=jm, pm=pm, calib=_pente_obs(15, 32, 1),
                obs=_pente_obs(15, 6, 2))


def test_best_pente_int8_tower_equals_jax(pente):
    """The shipped Pente net quantized by the JAX package: the port's tower
    equals JAX's bit for bit (six of its 128 channels read through one-hot
    heads), and the port's two int8 forwards agree exactly."""
    jm, pm = pente["jm"], pente["pm"]
    jbundle = jax.tree_util.tree_map(np.asarray, jq.quantize_int8(
        jm.cfg, jax.device_get(jm.params), jax.device_get(jm.batch_stats),
        pente["calib"]))
    q = q8.int8_bundle_from_jax(jbundle, device="cpu")
    obs = pente["obs"]
    tower = q8.int8_tower_mm(q, torch.from_numpy(obs))
    a, c_all = 15 * 15, pm.cfg.channels
    flat = tower.numpy().reshape(-1, a, c_all)
    for c in (0, 64, 126):
        probe = dict(jbundle, pol_w=np.zeros((1, 1, c_all, 2), np.float32),
                     pol_b=np.zeros(2, np.float32),
                     pol_fc_w=np.eye(2 * a, dtype=np.float32),
                     pol_fc_b=np.zeros(2 * a, np.float32))
        probe["pol_w"][0, 0, c, 0] = probe["pol_w"][0, 0, c + 1, 1] = 1.0
        want, _ = _jax_int8_apply(jm.cfg, probe, obs)
        np.testing.assert_array_equal(flat[..., c:c + 2].reshape(-1, 2 * a),
                                      want, err_msg=f"channels {c}, {c + 1}")
    packed = t8.pack_tower_bundle(pm.cfg, q)
    assert torch.equal(t8.int8_tower_plain(packed, torch.from_numpy(obs)),
                       tower)


def test_best_pente_serves_every_inference_mode(pente):
    """``make_inference`` on the shipped Pente net in each mode serves Pente
    boards: probabilities over the 225 points and values in [-1, 1].  The
    bf16 forwards within 0.05 of the float32 net (each conv's input stored
    in bf16, a relative step of 2^-8); the two int8 forwards equal each
    other bit for bit, calibrated on Pente boards with capture planes, and
    their probabilities correlate with the float32 net's above 0.98
    (``tests/test_int8_net.py``'s logit bound)."""
    pm = pente["pm"]
    obs = torch.from_numpy(pente["obs"])
    out = {}
    for mode in INFERENCE_MODES:
        fn, bundle = make_inference(mode, pm.cfg, *pm.jax_params(),
                                    device="cpu", calib_obs=pente["calib"])
        probs, value = fn(bundle, obs)
        value = value.reshape(-1)
        n = obs.shape[0]
        assert probs.shape == (n, 225) and value.shape == (n,)
        assert torch.isfinite(probs).all() and torch.isfinite(value).all()
        torch.testing.assert_close(probs.sum(-1), torch.ones(n), rtol=0,
                                   atol=1e-5)
        assert value.abs().max() <= 1.0
        out[mode] = (probs, value)
    ref_p, ref_v = out["f32"]
    for mode in ("bf16", "fused"):
        p, v = out[mode]
        assert float((p - ref_p).abs().max()) <= 0.05, mode
        assert float((v - ref_v).abs().max()) <= 0.05, mode
    assert torch.equal(out["int8"][0], out["int8t"][0])
    assert torch.equal(out["int8"][1], out["int8t"][1])
    corr = torch.corrcoef(torch.stack([out["int8"][0].flatten(),
                                       ref_p.flatten()]))[0, 1]
    assert float(corr) > 0.98
