"""Named block meshes, PyTorch counterpart of
``airpollution_tpu/parallel/device_mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over its TPU chips and runs
one shard per chip. Here a mesh names its axis sizes and holds the one
device every block of every axis lives on: the CUDA card by default
(``device.resolve_device``), the CPU when asked. The block-sharded solvers
(parallel/hbm_shard.py) keep an axis' blocks side by side in one tensor on
that device; placing them on several cards is ``torch.distributed`` work
that this package does not have yet.
"""

from __future__ import annotations

import torch

from airpollution_tpu_torch.device import resolve_device


class BlockMesh:
    """Axis name -> number of blocks, and the device of every block."""

    def __init__(self, axis_sizes: dict, device: torch.device):
        self.shape = dict(axis_sizes)
        self.device = device


def make_mesh(axis_sizes: dict, device=None) -> BlockMesh:
    """Build a named mesh, e.g. ``make_mesh({'mp': 4})``: four row blocks
    on the CUDA card (``device=None``) or on ``device``."""
    for name, size in axis_sizes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"axis {name!r} needs a positive block count, "
                             f"got {size!r}")
    return BlockMesh(axis_sizes, resolve_device(device))


def dp_tp_split(n_devices: int) -> tuple[int, int]:
    """Default (dp, tp) factorization: tp=2 when even, else pure dp."""
    if n_devices % 2 == 0 and n_devices >= 2:
        return n_devices // 2, 2
    return n_devices, 1
