"""The residual policy/value network, its eval function and its training.

``make_eval_fn`` runs the float32 ``ResNet``; ``make_inference`` picks an
inference mode (float32, bf16, the fused bf16 tower, int8, the int8 tower)
and builds its bundle; for an ``NbtConfig``, KataGo's nested-bottleneck
net (``nbt.py``), float32 or bf16.  ``net_config_of`` reads either
configuration from a dict.  The folded and quantized forwards are in ``ops/``
(``fused_net.py``, ``int8_net.py``, ``int8_tower.py``), beside their CUDA
kernels.  ``train_step`` and ``Optimizer`` train the net; ``AZModel`` holds
it with its optimizer state and reads and writes AZTPU1 checkpoints
(``checkpoint.py``).
"""

from alphazero_gomoku_tpu_torch.models.model import (  # noqa: F401
    INFERENCE_MODES,
    AZModel,
    Optimizer,
    train_step,
    bundle_of,
    fit_batch_stats,
    make_eval_fn,
    make_inference,
    net_config_of,
)
from alphazero_gomoku_tpu_torch.models.nbt import (  # noqa: F401
    NbtConfig,
    NbtNet,
)
from alphazero_gomoku_tpu_torch.models.resnet import (  # noqa: F401
    NetConfig,
    ResNet,
    init_params,
    params_from_jax,
    params_to_jax,
)
