"""Multi-process bring-up: one process per card over ``torch.distributed``.

Counterpart of ``alphazero_gomoku_tpu/parallel/distributed.py:50-96``.  JAX
runs one controller per host over all its chips and joins hosts with
``jax.distributed.initialize``; PyTorch's idiom is one process per card, so
every rank calls :func:`initialize_distributed` before it touches a card,
and ``parallel/mesh.py`` builds its data-parallel mesh on the process group.

  - ``auto=True`` is the ``env://`` rendezvous that ``torchrun`` sets up
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; JAX's
    ``auto`` is a TPU pod's auto-discovery, this is its counterpart);
  - an explicit ``coordinator_address`` (``host:port`` of rank 0) with
    ``num_processes`` and ``process_id`` is a ``tcp://`` rendezvous;
  - with neither, one process is a no-op that returns False, as in JAX.

Each rank's card is ``local_device_ids[0]`` when given, else its local rank
(``LOCAL_RANK``, else the process id) modulo the cards the host has, set as
the current device before anything touches a card: the kernel wrappers
launch on the current device's stream, and ``device=None`` everywhere in
the port means the current card.  The backend is NCCL on the cards and gloo
on the CPU (``device="cpu"``, the tests).  Ranks that share a card need
gloo, as NCCL refuses two ranks on one device: it is taken when asked for
(``backend="gloo"``) or when ``torchrun``'s ``LOCAL_WORLD_SIZE`` exceeds
the host's cards, and never guessed otherwise (an explicit rendezvous does
not say how many ranks a host holds, and a guess that fell back to gloo
would move every collective of a multi-host job through host memory).
The chosen backend is printed.

Usage, one process per card::

    torchrun --nproc_per_node 4 -m alphazero_gomoku_tpu_torch.cli.train \\
        --distributed ...

or, with explicit flags on each rank::

    python -m alphazero_gomoku_tpu_torch.cli.train \\
        --coordinator-address localhost:29500 --num-processes 2 \\
        --process-id 0 ...
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the card (or the CPU) this process's rank runs on, set once by
# initialize_distributed, as the process group itself is set once
_rank_device: Optional[torch.device] = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank_device() -> Optional[torch.device]:
    """The device :func:`initialize_distributed` chose for this rank, or
    None when it did not run (the port's ``device=None`` default then)."""
    return _rank_device


def _choose_device(device, local_rank: int,
                   local_device_ids: Optional[Sequence[int]]):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the ranks "
            "on the CPU over gloo")
    index = (local_device_ids[0] if local_device_ids
             else local_rank % torch.cuda.device_count())
    return torch.device("cuda", index)


def choose_backend(dev: torch.device, backend: Optional[str] = None) -> str:
    """``backend`` when given; else gloo on the CPU, or on cards that
    ``torchrun`` says the host's ranks outnumber (``LOCAL_WORLD_SIZE``),
    and NCCL otherwise."""
    if backend is not None:
        return backend
    if dev.type != "cuda":
        return "gloo"
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    if local_world is not None and \
            int(local_world) > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    auto: bool = False,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group (idempotent).

    Returns True when a group of processes was (or already is) formed,
    False single-process (no arguments: a no-op).  ``device`` (e.g.
    ``"cpu"``) overrides the rank's card; ``backend`` (``"nccl"``,
    ``"gloo"``) overrides :func:`choose_backend`.  Raises when ``auto``
    finds no ``torchrun`` environment, or when an explicit rendezvous lacks
    one of its three values.
    """
    global _rank_device
    if is_initialized():
        return True
    if not auto and coordinator_address is None and num_processes in (None,
                                                                       1):
        return False
    if auto and coordinator_address is None:
        missing = [k for k in _TORCHRUN_VARS if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize_distributed(auto=True) reads torchrun's "
                f"environment; {', '.join(missing)} not set (launch with "
                f"torchrun, or pass coordinator_address, num_processes "
                f"and process_id)")
        init_method = "env://"
        rank = int(os.environ["RANK"]) if process_id is None else process_id
        world = (int(os.environ["WORLD_SIZE"]) if num_processes is None
                 else num_processes)
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "an explicit rendezvous needs coordinator_address (host:port "
                "of rank 0), num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank, world = process_id, num_processes
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _choose_device(device, local_rank, local_device_ids)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, backend)
    print(f"[distributed] rank {rank} of {world}: backend {backend}, "
          f"device {dev}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _rank_device = dev
    return True


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes: rank 0,
    or the only process."""
    return not is_initialized() or dist.get_rank() == 0
