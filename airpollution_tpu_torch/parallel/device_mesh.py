"""Named meshes, PyTorch counterpart of
``airpollution_tpu/parallel/device_mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over its TPU chips and runs
one shard per chip under one controller. Here a mesh takes one of two
forms:

- :class:`ProcessMesh`: one process per rank of a ``torch.distributed``
  group, as the JAX mesh has one device per shard. The ranks are laid out
  row-major over the axes, as JAX's device array is (rank = dp_index * 2 +
  tp_index for ``{"dp": 4, "tp": 2}``); each axis line (the ranks that
  share every other index) has a process group of its own, and the
  collectives of ``parallel/collectives.py`` run on those groups.
- :class:`BlockMesh`: every block of every axis on one device, in one
  process: the solvers that take it keep an axis' blocks side by side in
  one tensor and move halos by slice copies.

:func:`make_mesh` gives a ProcessMesh when a process group is initialized
(``parallel/launch.py``) and a BlockMesh when none is.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device


class BlockMesh:
    """Axis name -> number of blocks, and the device of every block."""

    def __init__(self, axis_sizes: dict, device: torch.device):
        self.shape = dict(axis_sizes)
        self.device = device


class ProcessMesh:
    """Axis name -> number of ranks over an initialized process group of
    exactly that many ranks, laid out row-major: this rank's coordinates
    (``coords``), one ``dist.new_group`` per line of each axis (``group``),
    the backend and the rank's device."""

    def __init__(self, axis_sizes: dict, device: torch.device):
        import torch.distributed as dist

        self.shape = dict(axis_sizes)
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        names = list(self.shape)
        sizes = [self.shape[a] for a in names]
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        here = np.unravel_index(self.rank, sizes)
        self.coords = {a: int(i) for a, i in zip(names, here)}
        self._lines = {}
        self._groups = {}
        # Every rank creates every group, in one order (new_group's rule).
        for ax, name in enumerate(names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._lines[name] = ranks
                    self._groups[name] = group

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        return self._groups[self._axis(axis)]

    def ranks(self, axis) -> list:
        """The global ranks of this rank's line along ``axis``, by index."""
        return self._lines[self._axis(axis)]

    def index(self, axis) -> int:
        return self.coords[self._axis(axis)]

    def _axis(self, axis):
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        return axis


def check_mesh(mesh, axis=None):
    """Refuse anything that is not a mesh of this module (TypeError) or a
    mesh without ``axis`` (ValueError)."""
    if not isinstance(mesh, (BlockMesh, ProcessMesh)):
        raise TypeError(f"expected a BlockMesh or ProcessMesh "
                        f"(parallel.make_mesh), got {type(mesh).__name__}")
    if axis is not None and axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    return mesh


def same_device(a, b) -> bool:
    """Whether two devices are one: ``cuda`` is the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device
        return (cur() if a.index is None else a.index) == (
            cur() if b.index is None else b.index)
    return True


def _rank_device(backend: str, device):
    """A ProcessMesh's device: the caller's, else ``cuda:LOCAL_RANK``
    under NCCL and the CPU under gloo."""
    if device is not None:
        return torch.device(device)
    if backend == "nccl":
        import torch.distributed as dist

        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local)
    return torch.device("cpu")


def make_mesh(axis_sizes: dict, device=None):
    """Build a named mesh, e.g. ``make_mesh({'dp': 4, 'tp': 2})``.

    With a process group initialized, a :class:`ProcessMesh` over its
    ranks, whose axis sizes must multiply to the world size. With none, a
    :class:`BlockMesh`: the blocks on the CUDA card (``device=None``) or on
    ``device``."""
    for name, size in axis_sizes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"axis {name!r} needs a positive block count, "
                             f"got {size!r}")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = int(np.prod(list(axis_sizes.values())))
        if n != world:
            raise ValueError(
                f"mesh {axis_sizes} has {n} ranks, the process group "
                f"{world}: a process mesh spans the whole group (a "
                f"BlockMesh puts blocks on one device)")
        return ProcessMesh(axis_sizes, _rank_device(dist.get_backend(),
                                                    device))
    return BlockMesh(axis_sizes, resolve_device(device))


def dp_tp_split(n_devices: int) -> tuple[int, int]:
    """Default (dp, tp) factorization: tp=2 when even, else pure dp."""
    if n_devices % 2 == 0 and n_devices >= 2:
        return n_devices // 2, 2
    return n_devices, 1
