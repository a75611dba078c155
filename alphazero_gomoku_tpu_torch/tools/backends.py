"""The two backends of the probe tools: the kernels and their plain versions.

The JAX repo's probes flip ``backend="pallas"`` (its Mosaic kernels) against
``backend="xla"``.  Here ``"pallas"`` is the kernel path (``tk.KERNELS``, and
the tower kernel of the inference mode: K4 for ``fused``, K5 for
``int8t``), and ``"xla"`` the same search and forward on the plain versions
(``tk.PLAIN``, ``fused_tower_plain``, ``int8_tower_plain``), forced plain on
any device: never a second run of the kernels.
"""

from __future__ import annotations

import torch

from alphazero_gomoku_tpu_torch.ops import fused_net, int8_net, int8_tower
from alphazero_gomoku_tpu_torch.ops import tree_kernels as tk

BACKENDS = ("pallas", "xla")


def plain_eval_fn(infer: str, cfg, eval_fn):
    """The eval function of inference mode ``infer`` with its tower kernel
    replaced by the plain version; ``eval_fn`` itself for the modes that
    run no kernel of the port (``f32``, ``bf16``, ``int8``)."""
    if infer == "fused":
        def plain(folded, obs):
            logits, value = fused_net.folded_apply_plain(cfg, folded, obs)
            return torch.softmax(logits, dim=-1), value
        return plain
    if infer == "int8t":
        def plain(packed, obs):
            with torch.no_grad():
                tower = int8_tower.int8_tower_plain(
                    packed, obs.to(torch.float32))
                logits, value = int8_net.int8_heads(cfg, packed, tower)
            return torch.softmax(logits, dim=-1), value
        return plain
    return eval_fn


def backend(name: str, infer: str, cfg, eval_fn):
    """``(eval_fn, tree ops)`` of backend ``name`` for mode ``infer``."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}: expected one of "
                         f"{BACKENDS}")
    if name == "pallas":
        return eval_fn, tk.KERNELS
    return plain_eval_fn(infer, cfg, eval_fn), tk.PLAIN
