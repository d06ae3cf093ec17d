"""Checkpoints of the port, in the reference's on-disk format."""
from .manager import (all_steps, latest_step, restore_checkpoint,
                      save_checkpoint)

__all__ = ["all_steps", "latest_step", "restore_checkpoint", "save_checkpoint"]
