"""The collectives of the multi-process meshes (parallel/device_mesh.py's
ProcessMesh): the counterparts of the JAX package's ``jax.lax.psum``,
``all_gather(..., tiled=True)`` and ``ppermute`` under ``shard_map``, over
the process group of one mesh axis.

- :func:`psum` sums over an axis and is differentiable to any order: its
  transpose is :func:`pvary` (identity forward, sum backward) and
  :func:`pvary`'s is :func:`psum`, the pair JAX's ``shard_map`` uses when
  it tracks which values vary over an axis. The result of a psum is the
  same on every rank and every rank computes the same function of it, so
  its cotangent goes back unsummed; a value that is the same on every rank
  but feeds a computation that differs by rank (the input of a
  column-parallel layer, a parameter replicated over the data axis) goes
  through :func:`pvary`, whose backward sums the ranks' cotangents.
  (``torch.distributed.nn.functional.all_reduce`` sums the cotangents of
  the psum itself, the transpose for consumers that differ by rank: on a
  replicated loss it would scale the gradients by the axis size.)
- :func:`all_gather_rows` concatenates every rank's block along a
  dimension, in rank order along the axis.
- :func:`halo_exchange` swaps boundary rows with both chain neighbours in
  one ``batch_isend_irecv``, zeros at the chain ends (``ppermute``'s fill).

On a gloo group each collective copies CUDA tensors to the host and back,
explicitly: gloo is a host backend. On NCCL device tensors go straight.

:class:`RowChain` writes the row-sharded solvers once for both mesh kinds:
its tensors carry a leading block dimension, all of a BlockMesh axis'
blocks in one process, or this rank's one block of a ProcessMesh.
"""

from __future__ import annotations

import torch

from airpollution_tpu_torch.parallel.device_mesh import (
    BlockMesh, ProcessMesh, check_mesh)


def _staged(x, mesh):
    """A copy of ``x`` for the backend to work on: on the host for gloo."""
    x = x.detach()
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x.clone()


def all_reduce(x, mesh: ProcessMesh, axis):
    """The sum of ``x`` over the ranks of ``axis`` (a new tensor, no
    gradient)."""
    import torch.distributed as dist

    buf = _staged(x, mesh).contiguous()
    dist.all_reduce(buf, group=mesh.group(axis))
    return buf.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _Pvary.apply(g, ctx.mesh, ctx.axis), None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.mesh, ctx.axis), None, None


def psum(x, mesh: ProcessMesh, axis):
    """``jax.lax.psum(x, axis)``: the sum over the ranks of ``axis`` on
    every rank, differentiable (module docstring)."""
    return _Psum.apply(x, mesh, axis)


def pvary(x, mesh: ProcessMesh, axis):
    """``x`` unchanged, its cotangent summed over the ranks of ``axis``:
    marks a value that is the same on every rank as the input of a
    computation that differs by rank (module docstring)."""
    return _Pvary.apply(x, mesh, axis)


def all_gather_rows(x, mesh: ProcessMesh, axis, dim=0):
    """``jax.lax.all_gather(x, axis, tiled=True)`` along ``dim``: every
    rank's ``x`` (one shape on all of them) concatenated in rank order
    along the axis. No gradient."""
    import torch.distributed as dist

    buf = _staged(x, mesh).contiguous()
    parts = [torch.empty_like(buf) for _ in mesh.ranks(axis)]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(x.device)


def halo_exchange(first_rows, last_rows, mesh: ProcessMesh, axis):
    """Swap rows with the chain neighbours along ``axis``: returns
    ``(from_below, from_above)``, the previous rank's ``last_rows`` and
    the next rank's ``first_rows`` (``jax.lax.ppermute`` both ways), zeros
    at the chain ends. The two shapes may differ; every rank gives the
    same two. One ``batch_isend_irecv``."""
    import torch.distributed as dist

    ranks, d = mesh.ranks(axis), mesh.index(axis)
    group = mesh.group(axis)
    first, last = (_staged(t, mesh).contiguous()
                   for t in (first_rows, last_rows))
    below, above = torch.zeros_like(last), torch.zeros_like(first)
    ops = []
    if d > 0:
        ops += [dist.P2POp(dist.isend, first, ranks[d - 1], group),
                dist.P2POp(dist.irecv, below, ranks[d - 1], group)]
    if d < len(ranks) - 1:
        ops += [dist.P2POp(dist.isend, last, ranks[d + 1], group),
                dist.P2POp(dist.irecv, above, ranks[d + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return below.to(last_rows.device), above.to(first_rows.device)


class RowChain:
    """The blocks of one mesh axis this process holds, for solvers written
    on tensors with a leading block dimension: every block of a
    BlockMesh axis (slice copies and sums in one process), or this rank's
    block of a ProcessMesh axis (the collectives above)."""

    def __init__(self, mesh, axis):
        check_mesh(mesh, axis)
        self.mesh, self.axis = mesh, axis
        self.n_blocks = mesh.shape[axis]
        self.ids = (list(range(self.n_blocks)) if isinstance(mesh, BlockMesh)
                    else [mesh.index(axis)])

    @property
    def local(self) -> bool:
        return isinstance(self.mesh, BlockMesh)

    def neighbours(self, first, last):
        """``(from_below, from_above)`` of (blocks, ...) tensors: block d
        gets block d-1's ``last`` and block d+1's ``first``, zeros at the
        chain ends."""
        if self.local:
            zl, zf = torch.zeros_like(last[:1]), torch.zeros_like(first[:1])
            return (torch.cat([zl, last[:-1]]), torch.cat([first[1:], zf]))
        below, above = halo_exchange(first[0], last[0], self.mesh, self.axis)
        return below[None], above[None]

    def total(self, parts):
        """The sum over every block of the axis of (blocks,) partial sums:
        in block order in one process, over the group on ranks."""
        if self.local:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return all_reduce(parts[0], self.mesh, self.axis)

    def gather(self, x, dim):
        """(blocks, ...) -> every block of the axis concatenated along
        ``dim`` (of a block's own dimensions), in block order."""
        if self.local:
            return torch.cat(list(x.unbind(0)), dim=dim)
        return all_gather_rows(x[0], self.mesh, self.axis, dim=dim)
