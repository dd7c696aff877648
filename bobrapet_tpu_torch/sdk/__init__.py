"""The SDK side of the port: model checkpoints in the blob store
(checkpoint.py)."""

from .checkpoint import (
    StorageMismatch,
    checkpoint_steps,
    delete_checkpoint,
    latest_checkpoint_step,
    latest_restorable_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["StorageMismatch", "checkpoint_steps", "delete_checkpoint", "latest_checkpoint_step",
           "latest_restorable_checkpoint_step", "restore_checkpoint", "save_checkpoint"]
