"""Checkpoints of the port, in the reference's on-disk format (the
counterpart of ``repro.checkpoint``)."""
from .ckpt import (CheckpointManager, latest_step,  # noqa: F401
                   restore_checkpoint, save_checkpoint)
