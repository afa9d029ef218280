from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    all_steps,
    latest_step,
    restore,
    save,
)

__all__ = ["CheckpointManager", "save", "restore", "latest_step",
           "all_steps"]
