"""Parity: the port's int8 inference (``ops/int8_net.py``, ``ops/int8_tower.py``)
against the JAX package's, and PUCT on it against the JAX package's search.

The JAX int8 tower kernel runs in Pallas interpret mode, as
``tests/test_int8_tower.py`` runs it.  Weights and boards are made from
seeds with numpy; the JAX bundle is handed to the port with
``int8_bundle_from_jax``, so that both run identical int8 weights.

Tolerances, from what the two computations share:

  - The towers (stem and residual blocks) on the same bundle: equal bit for
    bit, on the float32, bf16 and int8 skip tracks.  The integer sums are
    exact; ``_dequant`` rounds ``acc * scale + bias`` once, as XLA's fused
    multiply-add does, and the int8 track's skip dequant ``h_q * s_in`` is
    fused into its add the same way.  The JAX forward returns only logits and
    value, so its tower is read through one-hot heads (``_probe_heads``),
    whose dots have a single non-zero term and are exact in any order; the
    JAX kernel's tower is read from its ``pallas_call`` output.
  - Logits with the real heads: within 1e-5 (measured 2e-6, logits up to
    ~10), value within 1e-6.  XLA on the CPU sums the heads' narrow dots
    (``[N, C] x [C, 2]``) as four strided partial sums with fused
    multiply-adds, added pairwise; torch sums in another order, so about
    0.84 of the logits differ by an ulp or a few.
  - ``f32_last_blocks=1``: the float32 tail convs sum in another order than
    XLA's (about half of the tower's outputs differ by ulps); the same
    tolerance as the heads.
  - ``quantize_int8`` against the JAX one, from the same params and boards:
    the calibration conv sums in another order, so the ranges, and with them
    the scales, differ by ulps (relative 4e-6; measured 8e-7); biases after
    bias correction within 1e-5 (measured 2.5e-6); at most 0.1 % of the int8
    weights may differ, by one (measured: none).  Its forward is held to the
    float32 net at ``tests/test_int8_net.py:57-73``'s bounds.
  - PUCT on the int8 nets against the JAX search with ``make_int8_eval_fn``:
    priors differ by ulps (the heads and the softmax), which can flip a
    near-tie and move a visit, so pi may differ by two visits in a lane, as
    in ``test_torch_port_search_net.py``.
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
from alphazero_gomoku_tpu.models.resnet import apply as jax_apply
from alphazero_gomoku_tpu.models.resnet import init_variables
from alphazero_gomoku_tpu.ops import int8_net as jq
from alphazero_gomoku_tpu.ops import int8_tower as jt
from alphazero_gomoku_tpu.search.tree import MCTSConfig as JaxMCTSConfig
from alphazero_gomoku_tpu.search.tree_pallas import run_mcts_packed as jax_packed
from alphazero_gomoku_tpu_torch.games import make_env
from alphazero_gomoku_tpu_torch.games.gomoku import GomokuEnv
from alphazero_gomoku_tpu_torch.models import NetConfig, make_inference
from alphazero_gomoku_tpu_torch.ops import int8_net as q8
from alphazero_gomoku_tpu_torch.ops import int8_tower as t8
from alphazero_gomoku_tpu_torch.ops.fused_net import _conv_matrix, _im2col
from alphazero_gomoku_tpu_torch.search import MCTSConfig
from alphazero_gomoku_tpu_torch.selfplay import SelfPlayConfig, play_games

from test_torch_port_search import NOISE, _search_both
from torch_port_util import one_torch_thread, random_jax_states  # noqa: F401

SIZE, BLOCKS, CHANNELS = 9, 2, 32
A = SIZE * SIZE
LOGIT_TOL, VALUE_TOL = 1e-5, 1e-6


def _net(seed=0):
    """JAX ``init_variables`` weights with batch stats moved off their
    initial values, so that folding shows; numpy arrays."""
    jcfg = JaxNetConfig(board_size=SIZE, action_size=A, n_res_blocks=BLOCKS,
                        channels=CHANNELS)
    cfg = NetConfig(board_size=SIZE, action_size=A, n_res_blocks=BLOCKS,
                    channels=CHANNELS)
    v = init_variables(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    v["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.abs(x + rng.normal(0, 0.05, x.shape)).astype(np.float32),
        v["batch_stats"])
    return jcfg, cfg, params, stats


@pytest.fixture(scope="module")
def net():
    jcfg, cfg, params, stats = _net()
    calib = jq.random_calib_obs(jcfg, n=32, seed=1)
    obs = jq.random_calib_obs(jcfg, n=16, seed=2)
    return dict(jcfg=jcfg, cfg=cfg, params=params, stats=stats, calib=calib,
                obs=obs)


def _jax_bundle(net, **kw):
    return jax.tree_util.tree_map(np.asarray, jq.quantize_int8(
        net["jcfg"], net["params"], net["stats"], net["calib"], **kw))


def _jax_int8_apply(jcfg, q, obs):
    """The JAX ``int8_apply``, jitted unless the bundle has float32 tail
    blocks (their Python flag is not traceable)."""
    fn = lambda q, o: jq.int8_apply(jcfg, q, o)   # noqa: E731
    if not any(b.get("f32") for b in q["blocks"]):
        fn = jax.jit(fn)
    logits, value = fn(q, jnp.asarray(obs))
    return np.asarray(logits), np.asarray(value)


def _probe_heads(q, c0, c1):
    """``q`` with one-hot heads: the ``2 * A`` logits are the tower's
    channels ``c0`` and ``c1`` at every board point (point-major), exactly:
    each dot has one non-zero product."""
    pol_w = np.zeros((1, 1, CHANNELS, 2), np.float32)
    pol_w[0, 0, c0, 0] = pol_w[0, 0, c1, 1] = 1.0
    return dict(q, pol_w=pol_w, pol_b=np.zeros(2, np.float32),
                pol_fc_w=np.eye(2 * A, dtype=np.float32),
                pol_fc_b=np.zeros(2 * A, np.float32))


# ----------------------------------------------------------------------
# the forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("residual", ["f32", "bf16", "int8"])
def test_int8_tower_equals_jax_bit_for_bit(net, residual):
    jq_ = _jax_bundle(net, residual=residual)
    q = q8.int8_bundle_from_jax(jq_, device="cpu")
    tower = q8.int8_tower_mm(q, torch.from_numpy(net["obs"])).numpy()
    tower = tower.reshape(-1, A, CHANNELS)
    for c in range(0, CHANNELS, 2):
        want, _ = _jax_int8_apply(net["jcfg"], _probe_heads(jq_, c, c + 1),
                                  net["obs"])
        np.testing.assert_array_equal(
            tower[..., c:c + 2].reshape(-1, 2 * A), want,
            err_msg=f"channels {c}, {c + 1}")
    # through the port's own heads: the probe's logits are its tower
    probe = q8.int8_bundle_from_jax(_probe_heads(jq_, 0, 1), device="cpu")
    logits, _ = q8.int8_apply(net["cfg"], probe, torch.from_numpy(net["obs"]))
    np.testing.assert_array_equal(logits.numpy(),
                                  tower[..., :2].reshape(-1, 2 * A))


@pytest.mark.parametrize("kw", [dict(residual="f32"), dict(residual="bf16"),
                                dict(residual="int8"),
                                dict(f32_last_blocks=1)],
                         ids=lambda kw: str(kw))
def test_int8_apply_matches_jax(net, kw):
    jq_ = _jax_bundle(net, **kw)
    want_logits, want_value = _jax_int8_apply(net["jcfg"], jq_, net["obs"])
    q = q8.int8_bundle_from_jax(jq_, device="cpu")
    logits, value = q8.int8_apply(net["cfg"], q, torch.from_numpy(net["obs"]))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(value.numpy(), want_value, rtol=0,
                               atol=VALUE_TOL)
    probs, v = q8.make_int8_eval_fn(net["cfg"])(q, torch.from_numpy(
        net["obs"]))
    assert torch.equal(probs, torch.softmax(logits, dim=-1))
    assert torch.equal(v, value)


def _jax_kernel_tower(jcfg, packed, obs):
    """The JAX int8 tower kernel's output (interpret mode), read from its
    ``pallas_call``, with the logits and value of ``int8_tower_apply``."""
    real = jt.pl.pallas_call
    towers = []

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            towers.append(np.asarray(out))
            return out
        return run

    with mock.patch.object(jt.pl, "pallas_call", spy), \
            pltpu.force_tpu_interpret_mode():
        # unjitted, so that the spy sees concrete arrays
        logits, value = jt.int8_tower_apply.__wrapped__(
            jcfg, packed, 8, jnp.asarray(obs), True)
    (tower,) = towers
    b = obs.shape[0]
    p = SIZE + 2
    tower = tower.reshape(-1, SIZE, p, CHANNELS)[:b, :, :SIZE, :]
    return tower, np.asarray(logits), np.asarray(value)


@pytest.mark.parametrize("batch", [16, 11])
def test_int8_tower_plain_matches_jax_kernel(net, batch):
    """A full and a partial tile of the JAX kernel (tile 8)."""
    jq_ = _jax_bundle(net)
    obs = net["obs"][:batch]
    tower, want_logits, want_value = _jax_kernel_tower(
        net["jcfg"], jt.pack_tower_bundle(net["jcfg"], jq_), obs)
    q = q8.int8_bundle_from_jax(jq_, device="cpu")
    packed = t8.pack_tower_bundle(net["cfg"], q)
    got = t8.int8_tower_plain(packed, torch.from_numpy(obs))
    np.testing.assert_array_equal(got.numpy(), tower)
    t8.reset_launch_counts()
    logits, value = t8.int8_tower_apply(net["cfg"], packed,
                                        torch.from_numpy(obs))
    assert t8.int8_tower.launches == 0      # CPU tensors: the plain version
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(value.numpy(), want_value, rtol=0,
                               atol=VALUE_TOL)
    # the port's two int8 forwards agree exactly
    mm_logits, mm_value = q8.int8_apply(net["cfg"], q, torch.from_numpy(obs))
    assert torch.equal(logits, mm_logits) and torch.equal(value, mm_value)
    probs, _ = t8.make_int8_tower_eval_fn(net["cfg"])(packed,
                                                      torch.from_numpy(obs))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_pack_tower_bundle_matches_jax_layout(net):
    jq_ = _jax_bundle(net)
    want = jt.pack_tower_bundle(net["jcfg"], jq_)
    got = t8.pack_tower_bundle(net["cfg"],
                               q8.int8_bundle_from_jax(jq_, device="cpu"))
    c, cin = CHANNELS, 3
    # JAX [L, 2, 9, Cin, Cout] -> the port's [L, 2, Cout, 9 * Cin]
    jw = np.asarray(want["block_w9"])
    np.testing.assert_array_equal(
        got["block_w"].numpy(),
        jw.transpose(0, 1, 4, 2, 3).reshape(BLOCKS, 2, c, 9 * c))
    # JAX stem [9, C (cin real rows, zero-padded), C] -> [C, 32]
    js = np.asarray(want["stem_w9"])[:, :cin, :]
    stem = got["stem_w"].numpy()
    np.testing.assert_array_equal(stem[:, :9 * cin],
                                  js.transpose(2, 0, 1).reshape(c, 9 * cin))
    assert not stem[:, 9 * cin:].any() and stem.shape == (c, 32)
    for name, key in (("block_scale", "block_scale"), ("block_b", "block_b"),
                      ("inv_mid", "inv_mid"), ("inv_next", "inv_next"),
                      ("inv_first", "inv_first"), ("stem_scale", "stem_scale"),
                      ("stem_b", "stem_b"), ("inv_obs", "inv_obs")):
        np.testing.assert_array_equal(
            got[name].numpy(),
            np.asarray(want[key]).reshape(got[name].shape), err_msg=name)


@pytest.mark.parametrize("kw,match", [
    (dict(residual="int8"), "f32 skip"),
    (dict(residual="bf16"), "f32 skip"),
    (dict(f32_last_blocks=1), "f32_last_blocks"),
])
def test_pack_tower_bundle_refuses_what_jax_refuses(net, kw, match):
    with pytest.raises(ValueError, match=match):
        jt.pack_tower_bundle(net["jcfg"], _jax_bundle(net, **kw))
    q = q8.quantize_int8(net["cfg"], net["params"], net["stats"],
                         net["calib"], device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        t8.pack_tower_bundle(net["cfg"], q)


def test_int8_tower_wrapper_checks_its_inputs(net):
    q = q8.int8_bundle_from_jax(_jax_bundle(net), device="cpu")
    packed = t8.pack_tower_bundle(net["cfg"], q)
    obs = torch.from_numpy(net["obs"])
    with pytest.raises(TypeError):
        t8.int8_tower(packed, obs.double())
    with pytest.raises(ValueError):
        t8.int8_tower(packed, obs[..., :2].contiguous())     # wrong cin
    with pytest.raises(ValueError):
        t8.int8_tower(packed, obs[0])
    with pytest.raises(TypeError):
        t8.int8_tower(dict(packed, block_w=packed["block_w"].float()), obs)
    meta = {k: v.to("meta") for k, v in packed.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        t8.int8_tower(meta, obs.to("meta"))


# ----------------------------------------------------------------------
# the elementwise steps and the integer conv
# ----------------------------------------------------------------------
def test_dequant_equals_jax_qconv():
    """XLA fuses ``acc.astype(f32) * scale + bias`` into one multiply-add;
    ``_dequant`` rounds once too, so the int8 conv is equal bit for bit (a
    separate float32 multiply and add differ on about a quarter of the
    outputs)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (4, 15, 15, 128)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 128, 128)).astype(np.int8)
    scale = (rng.random(128) * 1e-3).astype(np.float32)
    bias = rng.normal(0, 1, 128).astype(np.float32)
    want = np.asarray(jax.jit(jq._qconv)(x, w, scale, bias))
    got = q8._qconv(torch.from_numpy(x),
                    _conv_matrix(torch.from_numpy(w), torch.int8),
                    torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mm_im2col_conv_equals_int32_reference():
    """``torch._int_mm`` on the im2col matrix is the exact integer conv,
    the stem's K = 27 zero-padded to 32 included."""
    rng = np.random.default_rng(1)
    for cin in (3, 32):
        x = rng.integers(-127, 128, (5, 7, 7, cin)).astype(np.int8)
        w = rng.integers(-127, 128, (3, 3, cin, 16)).astype(np.int8)
        wm = _conv_matrix(torch.from_numpy(w), torch.int8)
        assert wm.shape == (-(-9 * cin // 8) * 8, 16)
        got = torch._int_mm(_im2col(torch.from_numpy(x), wm.shape[0]), wm)
        pad = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        want = sum(np.einsum("bhwc,co->bhwo", pad[:, dy:dy + 7, dx:dx + 7],
                             w[dy, dx].astype(np.int64))
                   for dy in range(3) for dx in range(3))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


@pytest.mark.parametrize("n,cin,seed", [(32, 3, 1), (7, 4, 5)])
def test_random_calib_obs_equals_jax(n, cin, seed):
    jcfg, cfg, _, _ = _net()
    np.testing.assert_array_equal(q8.random_calib_obs(cfg, n, cin, seed),
                                  jq.random_calib_obs(jcfg, n, cin, seed))


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(residual="f32"), dict(residual="int8"),
                                dict(f32_last_blocks=1)],
                         ids=lambda kw: str(kw))
def test_quantize_int8_matches_jax(net, kw):
    want = q8.int8_bundle_from_jax(_jax_bundle(net, **kw), device="cpu")
    got = q8.quantize_int8(net["cfg"], net["params"], net["stats"],
                           net["calib"], device="cpu", **kw)
    assert set(got) == set(want)
    pairs = [(k, got[k], want[k]) for k in got if k != "blocks"]
    for i, (g, w) in enumerate(zip(got["blocks"], want["blocks"])):
        assert set(g) == set(w)
        pairs += [(f"b{i}.{k}", g[k], w[k]) for k in g if k != "f32"]
    off = total = 0
    for name, g, w in pairs:
        if g.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            assert int(d.max()) <= 1, name
            off, total = off + int((d > 0).sum()), total + d.numel()
        elif name.split(".")[-1] in ("stem_b", "b1", "b2") \
                or name.startswith("val") or name.startswith("pol"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
        else:           # scales and their reciprocals
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=4e-6,
                                       atol=0, err_msg=name)
    assert off <= total // 1000


def test_quantized_forward_close_to_the_float32_net(net):
    """The port's own quantization, at ``tests/test_int8_net.py:57-73``'s
    bounds against the float32 net."""
    jcfg, cfg = net["jcfg"], net["cfg"]
    q = q8.quantize_int8(cfg, net["params"], net["stats"], net["calib"],
                         device="cpu")
    obs = jq.random_calib_obs(jcfg, n=32, seed=2)
    logits, value = q8.int8_apply(cfg, q, torch.from_numpy(obs))
    (fl, fv), _ = jax_apply(jcfg, net["params"], net["stats"],
                            jnp.asarray(obs), train=False)
    cc = np.corrcoef(logits.numpy().ravel(), np.asarray(fl).ravel())[0, 1]
    assert cc > 0.98, f"logit correlation {cc}"
    assert np.max(np.abs(value.numpy() - np.asarray(fv))) < 0.1


def test_make_inference_modes(net):
    cfg, obs = net["cfg"], torch.from_numpy(net["obs"])
    outs = {}
    for mode in ("f32", "bf16", "fused", "int8", "int8t"):
        eval_fn, bundle = make_inference(mode, cfg, net["params"],
                                         net["stats"], device="cpu")
        probs, value = eval_fn(bundle, obs)
        assert probs.shape == (16, A) and value.shape == (16, 1)
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
        outs[mode] = (probs, value)
    assert torch.equal(outs["int8"][0], outs["int8t"][0])
    assert torch.equal(outs["int8"][1], outs["int8t"][1])
    with pytest.raises(ValueError, match="f32 skip"):
        make_inference("int8t", cfg, net["params"], net["stats"],
                       device="cpu", int8_skip="bf16")
    with pytest.raises(ValueError, match="unknown inference"):
        make_inference("fp8", cfg, net["params"], net["stats"], device="cpu")


# ----------------------------------------------------------------------
# PUCT on the int8 nets
# ----------------------------------------------------------------------
def _port_eval(net, mode, jq_):
    q = q8.int8_bundle_from_jax(jq_, device="cpu")
    if mode == "int8":
        return q8.make_int8_eval_fn(net["cfg"]), q
    return (t8.make_int8_tower_eval_fn(net["cfg"]),
            t8.pack_tower_bundle(net["cfg"], q))


@pytest.mark.parametrize("mode", ["int8", "int8t"])
def test_puct_search_on_int8_matches_jax(net, mode):
    """The JAX search on ``make_int8_eval_fn``, its root noise injected into
    the port; both on the same int8 bundle."""
    jq_ = _jax_bundle(net)
    eval_fn, bundle = _port_eval(net, mode, jq_)
    jenv, env = JaxEnv(SIZE), GomokuEnv(SIZE)
    sims = 32
    states = random_jax_states(jenv, 8, 6, seed=6)
    kw = dict(n_simulations=sims, cpuct=1.0, max_depth=56, **NOISE)
    pj, qj, pt, qt = _search_both(jenv, env, states, 6, jax.random.PRNGKey(1),
                                  kw, jq.make_int8_eval_fn(net["jcfg"]),
                                  eval_fn, jq_, bundle)
    visits_moved = np.abs(pj - pt).sum(axis=1) * sims / 2
    assert visits_moved.max() <= 2, visits_moved
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "int8t"])
def test_selfplay_on_int8_matches_jax(net, mode):
    """``play_games`` in the port, ply by ply against the JAX packed search
    with ``make_int8_eval_fn`` on the port's boards.  Root noise is gated off
    (the JAX search draws its own); from ``temp_threshold`` on the moves are
    greedy and must be the JAX search's argmax."""
    jq_ = _jax_bundle(net)
    eval_fn, bundle = _port_eval(net, mode, jq_)
    batch, sims, moves = 8, 16, 4
    env, jenv = make_env("gomoku", SIZE), JaxEnv(SIZE)
    kw = dict(n_simulations=sims, cpuct=1.0, add_noise=True,
              dirichlet_alpha=0.05, dirichlet_epsilon=0.15, dirichlet_moves=0,
              max_depth=56)
    cfg = SelfPlayConfig(batch_games=batch, mcts=MCTSConfig(**kw),
                         temp_threshold=2, max_moves=moves)
    traj = play_games(env, cfg, eval_fn, bundle,
                      torch.Generator().manual_seed(0), device="cpu")
    jcfg = JaxMCTSConfig(backend="pallas", **kw)
    jeval = jq.make_int8_eval_fn(net["jcfg"])
    search = jax.jit(lambda q, s, m: jax_packed(
        jenv, jcfg, jeval, q, s, m, jax.random.PRNGKey(0), interpret=True))
    for t in range(moves):
        states = jax.vmap(jenv.from_board)(
            jnp.asarray(traj.boards[t].numpy()),
            jnp.asarray(traj.players[t].numpy()),
            jnp.full((batch,), t, jnp.int32))
        pi, _ = search(jq_, states, jnp.full((batch,), t, jnp.int32))
        pi = np.asarray(pi)
        visits_moved = np.abs(pi - traj.pis[t].numpy()).sum(axis=1) * sims / 2
        assert visits_moved.max() <= 2, (t, visits_moved)
        if t >= cfg.temp_threshold:
            np.testing.assert_array_equal(pi.argmax(axis=1),
                                          traj.actions[t].numpy(),
                                          err_msg=f"ply {t}")
    assert traj.active[:moves].all()
