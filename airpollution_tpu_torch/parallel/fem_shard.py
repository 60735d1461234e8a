"""Row-sharded CRBE solve, the FEM operator's rows over a mesh axis,
PyTorch counterpart of ``airpollution_tpu/parallel/fem_shard.py``.

The system operator's ELL rows are cut into ``mesh.shape[axis]`` blocks
(padded to a multiple of it); vectors stay whole on every rank. Each rank
computes its row block of ``A @ x`` on kernel B7a (local rows, global
columns: ``ops/gather.rows_matvec``) and one ``all_gather_rows`` gives
every rank the whole product, so BiCGStab's scalar recurrences run
identically everywhere with no reduction of their own. The time loop is
the serial ``models/crbe.run_time_loop`` with that matvec.

This is the general-mesh tier (any ELL operator, unstructured meshes
included); the all_gather moves the whole vector per matvec, so it
relieves memory and does not scale weakly. Structured meshes have the
halo-exchange tiers: ``stencil_shard.build_halo_solver`` and
``hbm_shard.build_hbm_halo_solver``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from airpollution_tpu_torch.models.crbe import (GlobalOperators,
                                                reject_obstacles,
                                                reject_robin, run_time_loop)
from airpollution_tpu_torch.ops import gather, sparse
from airpollution_tpu_torch.parallel.collectives import (RowChain,
                                                         all_gather_rows)
from airpollution_tpu_torch.parallel.device_mesh import (ProcessMesh,
                                                         check_mesh,
                                                         same_device)


def _pad_rows(arr, n_pad, fill=0):
    if n_pad == 0 or arr is None:
        return arr
    return F.pad(arr, (0, 0) * (arr.dim() - 1) + (0, n_pad), value=fill)


def _pad_ell(A, n_pad):
    return sparse.EllMatrix(vals=_pad_rows(A.vals, n_pad, 0.0),
                            cols=_pad_rows(A.cols, n_pad, 0),
                            cols32=_pad_rows(A.cols32, n_pad, 0))


def pad_operators(ops: GlobalOperators, n_seg: int, n_devices: int):
    """Pad the operator rows to a multiple of the mesh size: ``(padded
    ops, n_pad)``. A padded row has zero values on column 0 and a Jacobi
    diagonal of 1, so its product is 0 and it couples to nothing."""
    n_pad_total = (-n_seg) % n_devices
    if n_pad_total == 0:
        return ops, 0
    return GlobalOperators(
        mass_diag=_pad_rows(ops.mass_diag, n_pad_total, 0.0),
        stiffness=ops.stiffness,
        advection=ops.advection,
        ka=_pad_ell(ops.ka, n_pad_total),
        system=_pad_ell(ops.system, n_pad_total),
        system_diag=_pad_rows(ops.system_diag, n_pad_total, 1.0),
    ), n_pad_total


def _row_block(A, r0, r1):
    """Rows [r0, r1) of an EllMatrix with kernel B7's index of their own
    (int32 columns into the whole vector)."""
    cols = A.cols[r0:r1]
    c32 = cols.to(torch.int32).contiguous()
    return sparse.EllMatrix(vals=A.vals[r0:r1].contiguous(), cols=cols,
                            cols32=c32, b7=gather.KernelIndex(c32))


def sharded_matvec(vals_local, cols_local, x, mesh: ProcessMesh, axis="mp",
                   index=None):
    """This rank's row block of ``A @ x`` (``vals_local`` and
    ``cols_local`` its rows, ``index`` their gather.KernelIndex on the
    card) and an all_gather: every rank ends with the whole (padded) y."""
    if not isinstance(mesh, ProcessMesh):
        raise TypeError("sharded_matvec runs one row block per rank of a "
                        "ProcessMesh")
    y_local = gather.rows_matvec(vals_local, cols_local, index, x)
    return all_gather_rows(y_local, mesh, axis)


def build_sharded_solver(mesh, mesh_data, problem, dt, *, order=1, tol=1e-7,
                         maxiter=200, axis="mp", store_solutions=False):
    """Row-sharded solve: ``solve(ops, u0) -> solutions``, the serial
    ``run_time_loop`` (BiCGStab) with the collective matvec, so the
    numerics are the single-process solve's. ``ops`` may be padded by
    :func:`pad_operators` or not; ``u0`` and every vector are whole. The
    (nt, n_seg) solutions, or (1, n_seg) the final state, on every
    rank."""
    reject_robin(problem, "the row-sharded solver")
    reject_obstacles(problem, "the row-sharded solver")
    check_mesh(mesh, axis)
    if not same_device(mesh.device, mesh_data.device):
        raise ValueError(f"mesh device {mesh.device} differs from the mesh "
                         f"data's {mesh_data.device}")
    chain = RowChain(mesh, axis)
    n_seg = mesh_data.number_of_segments

    def solve(ops: GlobalOperators, u0):
        padded, _ = pad_operators(ops, ops.system.vals.shape[0],
                                  chain.n_blocks)
        n_loc = padded.system.vals.shape[0] // chain.n_blocks
        rows = [_row_block(padded.system, d * n_loc, (d + 1) * n_loc)
                for d in chain.ids]

        def matvec(x):
            y = torch.stack([gather.rows_matvec(A.vals, A.cols, A.b7, x)
                             for A in rows])
            return chain.gather(y, dim=0)[:n_seg]

        whole = ops._replace(
            mass_diag=ops.mass_diag[:n_seg],
            ka=(ops.ka if ops.ka.vals.shape[0] == n_seg
                else _row_block(ops.ka, 0, n_seg)),
            system_diag=ops.system_diag[:n_seg])
        sols, _ = run_time_loop(
            whole, u0[:n_seg], mesh_data=mesh_data, problem=problem, dt=dt,
            order=order, tol=tol, maxiter=maxiter,
            store_solutions=store_solutions, matvec=matvec)
        return sols

    return solve
