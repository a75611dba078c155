"""Replay buffer: a preallocated host ring, its persistence, and its mirror
on the card.

Counterpart of ``alphazero_gomoku_tpu/selfplay/buffer.py:42-329``, the same
format and the same draws:

  - states are stored as ``uint8`` with an integer scale per channel
    (``u = round(x * scale)``), decoded by one float32 multiply by
    ``f32(1 / scale)`` (exact for the binary planes, scale 1, and for
    Pente's captured-pair planes, scale 5);
  - ``ReplayBuffer.add`` is a vectorised ring write, ``sample`` a uniform
    draw without replacement by ``rng.choice`` on a numpy ``Generator``, so
    the same seed gives the same draws as the JAX package;
  - ``save_replay_buffer`` / ``load_replay_buffer`` write and read the same
    ``.npz`` (oldest sample first), degrading to a fresh state on failure;
  - :class:`DeviceBufferMirror` keeps the ring's arrays as tensors on the
    card, written at the positions ``add`` returns, so that a training epoch
    gathers its batches there from an index tensor
    (``models/model.train_epoch_gather``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

ScaleLike = Union[Sequence[float], np.ndarray, None]


def _scales_array(channel_scales: ScaleLike, channels: int) -> np.ndarray:
    if channel_scales is None:
        return np.ones((channels,), np.float32)
    s = np.asarray(channel_scales, np.float32)
    if s.shape != (channels,):
        raise ValueError(
            f"channel_scales shape {s.shape} != ({channels},)")
    return s


def encode_states_u8(states: np.ndarray,
                     channel_scales: ScaleLike = None) -> np.ndarray:
    """f32 observation planes -> uint8 ring storage (exact, see module)."""
    if states.dtype == np.uint8:
        return states
    s = _scales_array(channel_scales, states.shape[-1])
    return np.clip(np.round(states.astype(np.float32) * s),
                   0.0, 255.0).astype(np.uint8)


def inv_scales_f32(channel_scales: ScaleLike, channels: int) -> np.ndarray:
    """The decode multipliers ``f32(1/scale)`` (1/5 -> exactly f32(0.2))."""
    return np.float32(1.0) / _scales_array(channel_scales, channels)


def decode_states_f32(states_u8: np.ndarray,
                      inv_scales: np.ndarray) -> np.ndarray:
    """uint8 ring storage -> f32 planes (one correctly-rounded multiply)."""
    if states_u8.dtype != np.uint8:
        return states_u8
    return states_u8.astype(np.float32) * inv_scales


class ReplayBuffer:
    """Uniform-sampling ring buffer of (state, pi, z) training samples."""

    def __init__(self, capacity: int = 20000, board_size: int = 15,
                 channels: int = 3, channel_scales: ScaleLike = None):
        self.capacity = int(capacity)
        self.board_size = board_size
        self.channels = channels
        self.channel_scales = _scales_array(channel_scales, channels)
        self.inv_scales = inv_scales_f32(self.channel_scales, channels)
        a = board_size * board_size
        self.states = np.zeros(
            (self.capacity, board_size, board_size, channels), np.uint8
        )
        self.pis = np.zeros((self.capacity, a), np.float32)
        self.zs = np.zeros((self.capacity,), np.float32)
        self._write = 0
        self._size = 0

    # ------------------------------------------------------------------
    def add(self, states: np.ndarray, pis: np.ndarray, zs: np.ndarray
            ) -> np.ndarray:
        """Vectorized ring insert of N samples (newest overwrite oldest).

        Returns the ring positions written (for device-mirror sync)."""
        n = len(zs)
        if n == 0:
            return np.zeros((0,), np.int64)
        states = encode_states_u8(np.asarray(states), self.channel_scales)
        if n >= self.capacity:
            # only the newest `capacity` samples survive
            keep = slice(n - self.capacity, n)
            self.states[:] = states[keep]
            self.pis[:] = pis[keep]
            self.zs[:] = zs[keep]
            self._write = 0
            self._size = self.capacity
            return np.arange(self.capacity)
        idx = (self._write + np.arange(n)) % self.capacity
        self.states[idx] = states
        self.pis[idx] = pis
        self.zs[idx] = zs
        self._write = int((self._write + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        return idx

    def sample(self, batch_size: int, rng: Optional[np.random.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Uniform sample without replacement (reference ``random.sample``).

        Samples WITH replacement when the buffer holds fewer than
        ``batch_size`` samples, as the JAX buffer does.
        """
        if self._size == 0:
            raise ValueError("sample() on an empty replay buffer")
        rng = rng or np.random.default_rng()
        idx = rng.choice(self._size, size=batch_size,
                         replace=self._size < batch_size)
        return (
            decode_states_f32(self.states[idx], self.inv_scales),
            self.pis[idx],
            self.zs[idx].reshape(-1, 1),
        )

    def sample_many(self, n_batches: int, batch_size: int,
                    rng: Optional[np.random.Generator] = None):
        """Stack ``n_batches`` independent samples: [n, b, ...] arrays."""
        rng = rng or np.random.default_rng()
        outs = [self.sample(batch_size, rng) for _ in range(n_batches)]
        return (
            np.stack([o[0] for o in outs]),
            np.stack([o[1] for o in outs]),
            np.stack([o[2] for o in outs]),
        )

    def __len__(self) -> int:
        return self._size


# ----------------------------------------------------------------------
# persistence (reference train.py:299-354 semantics)
# ----------------------------------------------------------------------
def save_replay_buffer(buffer: ReplayBuffer, filepath: str) -> bool:
    try:
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        order = (np.arange(len(buffer)) + (
            buffer._write - len(buffer))) % buffer.capacity
        tmp = filepath + ".tmp.npz"
        np.savez_compressed(
            tmp,
            states=buffer.states[order],
            pis=buffer.pis[order],
            zs=buffer.zs[order],
            capacity=np.int64(buffer.capacity),
            channel_scales=buffer.channel_scales,
        )
        # np.savez appends .npz when missing; our tmp already ends with it
        os.replace(tmp, filepath)
        print(f"[Buffer] saved: {filepath} ({len(buffer)} samples)")
        return True
    except Exception as e:  # degrade, don't crash training
        print(f"[Buffer] save failed: {e}")
        return False


def load_replay_buffer(filepath: str, capacity: int,
                       board_size: int = 15,
                       channel_scales: ScaleLike = None
                       ) -> Optional[ReplayBuffer]:
    """``channel_scales`` is the caller's (env's) encoding contract; a
    scale vector stored in the file wins (uint8-format saves carry it —
    legacy f32 saves don't, and re-encode with the caller's on add)."""
    if not os.path.exists(filepath):
        print(f"[Buffer] no saved buffer at: {filepath}")
        return None
    try:
        with np.load(filepath) as data:
            saved_cap = int(data["capacity"])
            if saved_cap != capacity:
                print(f"[Buffer] warning: saved capacity ({saved_cap}) != "
                      f"configured ({capacity})")
            if "channel_scales" in data:
                channel_scales = data["channel_scales"]
            buf = ReplayBuffer(capacity=capacity, board_size=board_size,
                               channels=data["states"].shape[-1],
                               channel_scales=channel_scales)
            buf.add(data["states"], data["pis"], data["zs"])
        print(f"[Buffer] loaded: {filepath} ({len(buf)} samples)")
        return buf
    except Exception as e:
        print(f"[Buffer] load failed: {e}")
        return None


class DeviceBufferMirror:
    """The ring arrays of a :class:`ReplayBuffer` as tensors on a device.

    Counterpart of the JAX ``DeviceBufferMirror``: states ride as uint8 (the
    ring's encoding) and are decoded inside the gather epoch; each
    iteration's new samples are written at the ring positions
    ``ReplayBuffer.add`` returned (:meth:`sync`), so only they cross to the
    card.  The caller draws the same numpy index batches as the host path,
    so the two paths train on the same samples.
    """

    def __init__(self, buffer: ReplayBuffer, device=None):
        import torch

        from alphazero_gomoku_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.capacity = buffer.capacity
        self.channel_scales = buffer.channel_scales
        self.inv_scales = torch.as_tensor(buffer.inv_scales,
                                          device=self.device)
        # a loaded buffer's samples ship once; an empty ring is zeros
        self.states = torch.as_tensor(buffer.states, device=self.device)
        self.pis = torch.as_tensor(buffer.pis, device=self.device)
        self.zs = torch.as_tensor(buffer.zs, device=self.device)

    def sync(self, states: np.ndarray, pis: np.ndarray, zs: np.ndarray,
             positions: np.ndarray) -> None:
        """Write this iteration's new samples at their ring positions."""
        if len(positions) == 0:
            return
        import torch

        pos = torch.as_tensor(np.asarray(positions, np.int64),
                              device=self.device)
        enc = encode_states_u8(np.asarray(states), self.channel_scales)
        self.states[pos] = torch.as_tensor(enc, device=self.device)
        self.pis[pos] = torch.as_tensor(np.asarray(pis, np.float32),
                                        device=self.device)
        self.zs[pos] = torch.as_tensor(np.asarray(zs, np.float32),
                                       device=self.device)
