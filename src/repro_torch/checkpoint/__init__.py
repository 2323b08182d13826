"""Atomic checkpoints in the reference's on-disk format (the port of
``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step, read_leaves,
                                               restore, save)

__all__ = ["save", "restore", "latest_step", "read_leaves",
           "CheckpointManager"]
