"""The optimizer of the training step: AdamW with a warmup + cosine
schedule and global-norm clipping (``adamw``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule"]
