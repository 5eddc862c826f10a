from .losses import (
    LossConfig,
    forward_cd_loss,
    forward_preserve_loss,
    reverse_cd_loss,
    reverse_preserve_loss,
)
from .trainer import (
    ICDTrainState,
    TrainConfig,
    init_train_state,
    make_optimizer,
    make_train_step,
    sample_w,
)

__all__ = [
    "LossConfig",
    "forward_cd_loss",
    "forward_preserve_loss",
    "reverse_cd_loss",
    "reverse_preserve_loss",
    "ICDTrainState",
    "TrainConfig",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "sample_w",
]
