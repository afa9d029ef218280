"""AdamW, its schedule and clipping, and the train step (the port of the
JAX package's ``repro.optim``)."""
from repro_torch.optim.adamw import (
    OptConfig,
    TrainState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_train_state,
    loss_and_grads,
    lr_at,
    make_train_step,
)

__all__ = ["OptConfig", "TrainState", "init_train_state", "make_train_step",
           "lr_at", "global_norm", "clip_by_global_norm", "loss_and_grads",
           "apply_updates"]
