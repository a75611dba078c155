"""The residual policy/value network (eval mode) and its eval function."""

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
