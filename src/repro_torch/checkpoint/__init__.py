"""Atomic checkpoints of nested dicts of tensors, and segment-brick
checkpoints for serving warm starts (on-disk format shared with
`repro.checkpoint`)."""
from repro_torch.checkpoint.checkpointer import (
    BRICKS_SUBDIR,
    Checkpointer,
    latest_step,
    load_segment_bricks,
    save_segment_bricks,
)

__all__ = ["BRICKS_SUBDIR", "Checkpointer", "latest_step",
           "load_segment_bricks", "save_segment_bricks"]
