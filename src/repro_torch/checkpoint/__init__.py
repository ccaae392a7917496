"""Checkpoints with elastic restore (``checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
