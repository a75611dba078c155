"""Data parallelism over ``torch.distributed``, a process per card: sharded
self-play, arena and training (counterpart of
``alphazero_gomoku_tpu/parallel``)."""

from alphazero_gomoku_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    form_global_batches,
    gather_trajectories,
    global_buffer_len,
    local_trajectory_shards,
    make_mesh,
    make_sharded_arena,
    make_sharded_gather_epoch,
    make_sharded_selfplay,
    make_sharded_selfplay_continuous,
    make_sharded_train_epoch,
    min_local_buffer_len,
)
from alphazero_gomoku_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    is_primary,
)
