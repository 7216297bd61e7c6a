from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    committed_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "Checkpointer",
    "committed_steps",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
