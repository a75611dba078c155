"""The PyTorch / CUDA port of ``alphazero_gomoku_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against.  It imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package: what it needs from there is copied in, and each module's
docstring names its counterpart.

Ported so far (the self-play main paths: PUCT@400 on the float32 net, bench
config #3, and Gumbel@64 on the fused bf16 tower, config #6's search):

  - ``games``    : batched Gomoku transition functions on tensors.
  - ``models``   : the residual policy/value net as an ``nn.Module`` (eval).
  - ``search``   : PUCT and Gumbel sequential halving on the packed
                   node-tile tree.
  - ``ops``      : the tree kernels (``csrc/tree_kernels.cu``: PUCT walk,
                   Gumbel walk, backup) and the fused network tower
                   (``csrc/fused_net.cu``) with their plain PyTorch versions,
                   BN folding, and the ``nvcc`` build.
  - ``selfplay`` : the lockstep self-play loop.

Entry points take ``device=None``, which means the CUDA card; with no card
they raise.  Tests pass ``device="cpu"``, where every kernel wrapper runs its
plain version.
"""

__version__ = "0.1.0"
