"""The PyTorch / CUDA port of ``alphazero_gomoku_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against.  It imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package: what it needs from there is copied in, and each module's
docstring names its counterpart.

Ported: every module of the JAX package (the self-play main paths: PUCT@400,
bench config #3, on the float32 net or the int8 tower, and Gumbel@64 on the
fused bf16 tower, config #6's search; the training iteration around them,
on one card or data parallel over several; and the players that play a
position at a time on the same searches):

  - ``games``    : batched Gomoku and Pente transition functions on tensors,
                   and the NumPy host engines (``make_host_game``).
  - ``models``   : the residual policy/value net as an ``nn.Module`` (train
                   and eval), ``make_inference``, which picks an inference
                   mode, the losses, the optimizer and ``train_step``,
                   ``AZModel`` and AZTPU1 checkpoints; the reference ``.pt``
                   importer (``torch_import``).
  - ``search``   : PUCT and Gumbel sequential halving on the packed
                   node-tile tree, at any batch size (the players' batch of
                   one too); the heuristic pure-MCTS baseline
                   (``pure_mcts``) on the host C scans of ``native``.
  - ``players``  : the AlphaZero players (PUCT with tree reuse, or Gumbel;
                   the tactical guard), the pure-MCTS and human players,
                   ``load_player`` and ``request_move``.
  - ``ops``      : the tree kernels (``csrc/tree_kernels.cu``: PUCT walk,
                   Gumbel walk, backup), the fused bf16 tower
                   (``csrc/fused_net.cu``) and the int8 tower
                   (``csrc/int8_tower.cu``) with their plain PyTorch
                   versions, BN folding, int8 quantization, and the ``nvcc``
                   build.
  - ``selfplay`` : the lockstep self-play loop, the replay buffer, the arena,
                   the training loop (``train_alphazero``) and its memory
                   preflight (``budget``).
  - ``parallel`` : data parallelism over ``torch.distributed``, one process
                   per card: sharded self-play, arena and training.
  - ``utils``    : the phase timer and the ``torch.profiler`` trace.
  - ``cli``      : the training CLI (``python -m
                   alphazero_gomoku_tpu_torch.cli.train``), the match and
                   the tournament CLIs (``cli.play``, ``cli.play_loop``).
  - ``gui``      : the terminal engine with its pygame mirror
                   (``python -m alphazero_gomoku_tpu_torch.gui.engine``).
  - ``tools``    : the tensor-core rate probe (``csrc/matmul_rate.cu``), the
                   counterpart of the JAX repo's ``tools/mosaic_matmul_rate.py``.
  - ``repro``    : the width-1 slice write through a scratch
                   (``csrc/width1_slice.cu``), the counterpart of
                   ``repro/mosaic_width1_slice_hang.py``.

The training step differentiates the ``ResNet`` with autograd (cuDNN's
convolutions): no Pallas kernel of the JAX package has a backward, and its
train step is plain XLA.

Entry points take ``device=None``, which means the CUDA card; with no card
they raise.  Tests pass ``device="cpu"``, where every kernel wrapper runs its
plain version.
"""

__version__ = "0.1.0"
