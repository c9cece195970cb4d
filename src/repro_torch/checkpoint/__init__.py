"""Checkpointing: npz-based tree save/restore, the JAX package's format."""
from repro_torch.checkpoint.io import (
    CheckpointCorruptError,
    CheckpointManager,
    atomic_write_text,
    load_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = [
    "save_checkpoint", "load_checkpoint", "verify_checkpoint",
    "CheckpointManager", "CheckpointCorruptError", "atomic_write_text",
]
