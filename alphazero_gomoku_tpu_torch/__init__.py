"""The PyTorch / CUDA port of ``alphazero_gomoku_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against.  It imports ``torch`` and numpy, never ``jax`` and nothing of the
JAX package: what it needs from there is copied in, and each module's
docstring names its counterpart.

Ported so far (the self-play main path, bench config #3):

  - ``games``    : batched Gomoku transition functions on tensors.
  - ``models``   : the residual policy/value net as an ``nn.Module`` (eval).
  - ``search``   : PUCT on the packed node-tile tree.
  - ``ops``      : the two tree kernels (``csrc/tree_kernels.cu``) with their
                   plain PyTorch versions, and the ``nvcc`` build.
  - ``selfplay`` : the lockstep self-play loop.

Entry points take ``device=None``, which means the CUDA card; with no card
they raise.  Tests pass ``device="cpu"``, where every kernel wrapper runs its
plain version.
"""

__version__ = "0.1.0"
