"""Atomic, asynchronous checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
