"""The PyTorch / CUDA port of ``alphazero_gomoku_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against.  It imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package: what it needs from there is copied in, and each module's
docstring names its counterpart.

Ported so far (the self-play main paths: PUCT@400, bench config #3, on the
float32 net or the int8 tower, and Gumbel@64 on the fused bf16 tower, config
#6's search):

  - ``games``    : batched Gomoku transition functions on tensors.
  - ``models``   : the residual policy/value net as an ``nn.Module`` (eval),
                   and ``make_inference``, which picks an inference mode.
  - ``search``   : PUCT and Gumbel sequential halving on the packed
                   node-tile tree.
  - ``ops``      : the tree kernels (``csrc/tree_kernels.cu``: PUCT walk,
                   Gumbel walk, backup), the fused bf16 tower
                   (``csrc/fused_net.cu``) and the int8 tower
                   (``csrc/int8_tower.cu``) with their plain PyTorch
                   versions, BN folding, int8 quantization, and the ``nvcc``
                   build.
  - ``selfplay`` : the lockstep self-play loop.

Entry points take ``device=None``, which means the CUDA card; with no card
they raise.  Tests pass ``device="cpu"``, where every kernel wrapper runs its
plain version.
"""

__version__ = "0.1.0"
