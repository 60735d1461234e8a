"""Checkpoints of the port: PINN parameters and training carry, fields."""

from airpollution_tpu_torch.io.checkpoint import (
    load_field,
    load_pinn,
    load_pytree,
    read_meta,
    save_field,
    save_pinn,
    save_pytree,
    train_with_checkpoints,
)

__all__ = [
    "load_field", "load_pinn", "load_pytree",
    "save_field", "save_pinn", "save_pytree", "read_meta",
    "train_with_checkpoints",
]
