"""Checkpoints (``repro.ckpt`` counterpart)."""

from repro_torch.ckpt.checkpoint import (
    Checkpointer,
    ckpt_path,
    latest_step,
    restore_pytree,
    save_pytree,
)

__all__ = ["Checkpointer", "ckpt_path", "latest_step", "restore_pytree", "save_pytree"]
