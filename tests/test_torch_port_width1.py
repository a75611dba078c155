"""The port's width-1 slice write (``repro/width1_slice_write.py``) against
the JAX repro's Pallas kernel.

The kernel of ``repro/mosaic_width1_slice_hang.py`` is built here as its
``main`` builds it, with ``interpret=True`` so that it runs on the CPU, and
the port's plain version must equal it exactly in both variants (a copy and
one multiply and add per rewritten element, rounded as float32 on both
sides).  The CUDA kernel runs on the card only
(``tests/test_torch_port_cuda.py``); here the wrapper must take the plain
version and launch nothing.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from alphazero_gomoku_tpu_torch.repro import width1_slice_write as ws

ROOT = Path(__file__).resolve().parent.parent


def _load_jax_repro():
    spec = importlib.util.spec_from_file_location(
        "mosaic_width1_slice_hang",
        ROOT / "repro" / "mosaic_width1_slice_hang.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REPRO = _load_jax_repro()
SHAPE = (REPRO.B, REPRO.G, REPRO.R)


def _jax_kernel(ok: bool, x: np.ndarray) -> np.ndarray:
    f = pl.pallas_call(
        functools.partial(REPRO.kernel, ok),
        out_shape=jax.ShapeDtypeStruct(SHAPE, jnp.float32),
        scratch_shapes=[pltpu.VMEM(SHAPE, jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(x)))


def test_shape_is_the_repros():
    assert (ws.B, ws.G, ws.R, ws.C) == (REPRO.B, REPRO.G, REPRO.R, REPRO.C)


@pytest.mark.parametrize("ok", [False, True], ids=["width1", "segment"])
def test_plain_equals_the_pallas_kernel(ok):
    x = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    want = _jax_kernel(ok, x)
    got = ws.width1_slice_write_plain(torch.from_numpy(x), ws.C, ok)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rewrite is where the variant puts it, and nowhere else
    cols = slice(ws.C, None) if ok else slice(ws.C, ws.C + 1)
    changed = np.zeros(SHAPE, bool)
    changed[:, :, cols] = True
    np.testing.assert_array_equal(want != x, changed)


@pytest.mark.parametrize("ok", [False, True], ids=["width1", "segment"])
@pytest.mark.parametrize("shape,c", [((3, 5, 256), 200), ((1, 1, 7), 0),
                                     ((2, 3, 9), 8)])
def test_wrapper_on_cpu_takes_the_plain_version(shape, c, ok):
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=shape).astype(np.float32))
    ws.reset_launch_counts()
    got = ws.width1_slice_write(x, c, ok)
    want = x.numpy().copy()
    cols = slice(c, None) if ok else slice(c, c + 1)
    want[:, :, cols] = want[:, :, cols] * np.float32(0.5) + np.float32(1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ws.width1_slice_write.launches == 0


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(SHAPE)
    with pytest.raises(TypeError):
        ws.width1_slice_write(x.double())
    with pytest.raises(ValueError):
        ws.width1_slice_write(x[0])
    with pytest.raises(ValueError):
        ws.width1_slice_write(x, ws.R)
    with pytest.raises(ValueError):
        ws.width1_slice_write(x.transpose(0, 1))


@pytest.mark.parametrize("ok", [False, True], ids=["width1", "segment"])
def test_entry_point_prints_what_the_repro_prints(ok, capsys):
    assert ws.main(["--ok"] if ok else [], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"compiling (variant: {'ok' if ok else 'hang'} )...",
                     f"compiled and ran; out[0,0,{ws.C}] = 1.0"]
