"""One-way importer for reference torch snapshots (``.pt``).

Counterpart of ``alphazero_gomoku_tpu/models/torch_import.py``.  The
reference persists ``{"net": state_dict, "opt": ..., "board_size",
"action_size"}`` via ``torch.save``.  This module turns that into an
:class:`AZModel`, so that nets trained with the reference play and train
on in the port.

The port's :class:`ResNet` has the reference's layers in its layout, so the
import is a direct ``state_dict`` load under the port's names (``conv`` ->
``stem``, ``bn`` -> ``stem_bn``, ``res_blocks`` -> ``blocks``):

  - conv weights stay OIHW, linear weights ``[out, in]`` (the JAX importer
    permutes both to its HWIO / ``[in, out]``);
  - the policy FC's input columns stay as they are: both nets flatten the
    2-channel policy-head activations CHW (the JAX importer permutes them to
    its NHWC forward's HWC order, and ``params_from_jax`` permutes them
    back, so the two imports hold the same net);
  - BN running stats import as-is; torch's Adam moments are NOT imported
    (as in the JAX importer): the optimizer restarts fresh, which only
    matters if you continue training.

Architecture (channels, blocks, in_channels, board size) is inferred from
the state-dict shapes; a snapshot whose tensors do not fit the inferred
``ResNet`` is refused by ``load_state_dict``.  Native checkpoints are the
AZTPU1 container (``models/checkpoint.py``).

CLI: ``python -m alphazero_gomoku_tpu_torch.models.torch_import in.pt
out.ckpt``
"""

from __future__ import annotations

import pickle
import sys

import torch

#: reference state-dict prefixes and the port's names for them
_RENAMES = (("conv.", "stem."), ("bn.", "stem_bn."),
            ("res_blocks.", "blocks."))


def _is_torch_file(path: str) -> bool:
    """Cheap sniff: torch>=1.6 saves are zipfiles; legacy ones are pickle."""
    if path.endswith((".pt", ".pth")):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(2) in (b"PK", b"\x80\x02")
    except OSError:
        return False


def _load_state(path: str):
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # older saves with optimizer state hold objects the weights-only
        # reader refuses; any other failure (a corrupt file) is raised
        print(f"[torch_import] {path}: not loadable weights-only; "
              f"unpickling it in full, which runs code it names: load only "
              f"snapshots you trust", file=sys.stderr)
        state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "net" in state:
        return state["net"], state
    return state, {}


def _port_name(key: str) -> str:
    for old, new in _RENAMES:
        if key.startswith(old):
            return new + key[len(old):]
    return key


def import_torch_checkpoint(path: str, lr: float = 1e-3,
                            weight_decay: float = 1e-4, device=None):
    """Load a reference ``.pt`` snapshot into a fresh :class:`AZModel` on
    ``device`` (None: the card)."""
    from alphazero_gomoku_tpu_torch.models.model import AZModel, split_state
    from alphazero_gomoku_tpu_torch.models.resnet import ResNet

    sd, extra = _load_state(path)
    stem = sd["conv.weight"]                      # [C, in, 3, 3]
    channels, in_channels = int(stem.shape[0]), int(stem.shape[1])
    n_blocks = len({k.split(".")[1] for k in sd
                    if k.startswith("res_blocks.")})
    action_size = int(sd["policy_fc.weight"].shape[0])
    board_size = int(extra.get("board_size", round(action_size ** 0.5)))
    if board_size * board_size != action_size:
        raise ValueError(
            f"non-square action_size {action_size} (board_size {board_size})"
        )

    model = AZModel(board_size=board_size, action_size=action_size,
                    n_res_blocks=n_blocks, channels=channels,
                    in_channels=in_channels, lr=lr,
                    weight_decay=weight_decay, device=device)
    net = ResNet(model.cfg)
    net.load_state_dict({_port_name(k): v.detach().to(torch.float32)
                         if v.is_floating_point() else v
                         for k, v in sd.items()})
    model.params, model.batch_stats = split_state(
        {k: v.to(model.device) for k, v in net.state_dict().items()})
    model.opt_state = model.tx.init(model.params)
    return model


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference torch .pt snapshot to a native "
                    "AZTPU1 checkpoint")
    ap.add_argument("src", help="reference .pt snapshot")
    ap.add_argument("dst", help="output .ckpt path")
    ap.add_argument("--device", default=None,
                    help="where the weights are loaded (default: the CUDA "
                         "card; 'cpu' converts without one)")
    args = ap.parse_args(argv)
    model = import_torch_checkpoint(args.src, device=args.device)
    model.save(args.dst)
    print(f"imported {args.src} -> {args.dst} "
          f"({model.cfg.n_res_blocks}x{model.cfg.channels}, "
          f"board {model.board_size}, in_channels {model.cfg.in_channels})")


if __name__ == "__main__":
    main()
