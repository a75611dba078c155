"""The residual policy/value network (eval mode) and its eval function.

``make_eval_fn`` runs the float32 ``ResNet``.  The fused bf16 tower's eval
function and the BN folding it takes are in ``ops/fused_net.py``
(``make_fused_eval_fn``, ``fold_bn``), beside their CUDA kernel.
"""

from alphazero_gomoku_tpu_torch.models.model import (  # noqa: F401
    bundle_of,
    make_eval_fn,
)
from alphazero_gomoku_tpu_torch.models.resnet import (  # noqa: F401
    NetConfig,
    ResNet,
    init_params,
    params_from_jax,
)
