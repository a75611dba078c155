"""The port's rate probe (``tools/matmul_rate.py``) against the JAX tool.

The JAX tool's control ``xla_rate`` (``tools/mosaic_matmul_rate.py``, loaded
by path: ``tools/`` is not a package) computes the function of its Pallas
kernel with plain XLA ops; the port's plain version must equal it at the
tool's shape, ``M = 2040``, both ``(k, reps)`` and two step counts, on inputs
made as its ``main`` makes them.  int8 exactly; bf16 within
``matmul_rate.BF16_REL_TOL`` of ``sum |x| @ |w|`` per element, since XLA's
CPU dot and PyTorch's sum the same exact float32 products in different
orders.  The kernel itself runs on the card only
(``tests/test_torch_port_cuda.py``); here the wrapper must take the plain
version and launch nothing.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_gomoku_tpu_torch.tools import matmul_rate as mr

ROOT = Path(__file__).resolve().parent.parent


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "mosaic_matmul_rate", ROOT / "tools" / "mosaic_matmul_rate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TOOL = _load_jax_tool()


def _tool_inputs():
    """``{(k, reps): (xi, wi, xb, wb)}`` drawn as the JAX tool's ``main``
    draws them (one generator, seed 0, shape by shape); bf16 as JAX arrays,
    whose values the port receives exactly through float32."""
    rng = np.random.default_rng(0)
    out = {}
    for k, reps in mr.SHAPES:
        xi = jnp.asarray(rng.integers(-3, 4, (JAX_TOOL.M + reps, k)),
                         jnp.int8)
        wi = jnp.asarray(rng.integers(-3, 4, (k, JAX_TOOL.N)), jnp.int8)
        xb = jnp.asarray(rng.normal(size=(JAX_TOOL.M + reps, k)),
                         jnp.bfloat16)
        wb = jnp.asarray(rng.normal(size=(k, JAX_TOOL.N)), jnp.bfloat16)
        out[(k, reps)] = (xi, wi, xb, wb)
    return out


@pytest.fixture(scope="module")
def tool_inputs():
    return _tool_inputs()


def _to_torch(a) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_shapes_are_the_jax_tools():
    assert mr.M_PARITY == JAX_TOOL.M
    assert (mr.K, mr.N) == (JAX_TOOL.K, JAX_TOOL.N)
    assert mr.SHAPES == ((JAX_TOOL.K, 9), (9 * JAX_TOOL.K, 4))
    assert mr.M_CARD == 256 * 15 * 15


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("k,reps", list(mr.SHAPES))
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_equals_xla_rate(tool_inputs, dtype, k, reps, steps):
    xi, wi, xb, wb = tool_inputs[(k, reps)]
    x, w = (xi, wi) if dtype == "int8" else (xb, wb)
    in_dtype, acc_dtype = ((jnp.int8, jnp.int32) if dtype == "int8"
                           else (jnp.bfloat16, jnp.float32))
    run = JAX_TOOL.xla_rate(in_dtype, acc_dtype, k, reps, 0)
    want = np.asarray(run(x, w, jnp.asarray([steps], jnp.int32)))
    xt, wt = _to_torch(x), _to_torch(w)
    if dtype == "bf16":     # the port sees JAX's bf16 values exactly
        assert np.array_equal(xt.float().numpy(), np.asarray(x, np.float32))
    got = mr.matmul_rate_plain(xt, wt, reps, steps)
    assert got.shape == (JAX_TOOL.M, JAX_TOOL.N)
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        err = np.abs(got.double().numpy() - want.astype(np.float64))
        bound = mr.bf16_bound(xt, wt, reps).numpy()
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_wrapper_on_cpu_takes_the_plain_version(tool_inputs, dtype):
    xi, wi, xb, wb = tool_inputs[mr.SHAPES[0]]
    x, w = ((_to_torch(xi), _to_torch(wi)) if dtype == "int8"
            else (_to_torch(xb), _to_torch(wb)))
    mr.reset_launch_counts()
    got = mr.matmul_rate(x, w, 9, 2)
    assert torch.equal(got, mr.matmul_rate_plain(x, w, 9, 2))
    assert mr.matmul_rate.launches == 0
    assert mr.matmul_rate.dtype_launches == {"int8": 0, "bf16": 0}


def test_steps_restart_from_zero():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-3, 4, (40, 32), generator=g, dtype=torch.int8)
    w = torch.randint(-3, 4, (32, 128), generator=g, dtype=torch.int8)
    one = mr.matmul_rate(x, w, 4, 1)
    assert torch.equal(mr.matmul_rate(x, w, 4, 5), one)
    want = sum(x[r:r + 36].long() @ w.long() for r in range(4))
    assert torch.equal(one.long(), want)


def test_int8_library_sum_equals_plain(tool_inputs):
    """The control's int8 call on the CPU (``torch._int_mm``); the bf16
    call, ``torch.mm(..., out_dtype=float32)``, has no CPU kernel."""
    xi, wi, _, _ = tool_inputs[mr.SHAPES[0]]
    x, w = _to_torch(xi), _to_torch(wi)
    assert torch.equal(mr.library_sum(x, w, 9),
                       mr.matmul_rate_plain(x, w, 9, 1))


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros((20, 32), dtype=torch.int8)
    w = torch.zeros((32, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        mr.matmul_rate(x.float(), w, 4, 1)
    with pytest.raises(TypeError):
        mr.matmul_rate(x, w.to(torch.bfloat16), 4, 1)
    with pytest.raises(ValueError):
        mr.matmul_rate(x, w[:16], 4, 1)
    with pytest.raises(ValueError):
        mr.matmul_rate(x.t().contiguous().t(), w, 4, 1)
    with pytest.raises(ValueError):
        mr.matmul_rate(x, w, 20, 1)         # M = 0
    with pytest.raises(ValueError):
        mr.matmul_rate(x, w, 4, 0)
    with pytest.raises(RuntimeError, match="card"):
        mr.measure(device="cpu")
