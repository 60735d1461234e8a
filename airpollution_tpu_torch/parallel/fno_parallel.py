"""Data-parallel FNO training over a mesh axis, PyTorch counterpart of
``airpollution_tpu/parallel/fno_parallel.py``.

The FNO's per-sample losses are independent, so the minibatch is split
over the ``'data'`` axis of a ProcessMesh (parallel/device_mesh.py):

- every rank draws the SAME global index sequence as the serial
  ``models/fno.train_fno`` from a generator seeded alike, and takes its
  contiguous slice of each step's batch;
- the global relative-L2^2 loss is the sum over ranks of the local sums
  divided by the global batch (the JAX module's one ``psum``), and the
  gradients, of parameters replicated over 'data', are summed over it
  in one all-reduce of their concatenation; the AdamW state stays
  replicated and identical on every rank (``models/fno.adamw_steps``,
  the rates in float32 as there).

So N ranks train as ``train_fno`` does, up to the order of the sums. The
dataset is replicated on every rank.
"""

from __future__ import annotations

import torch

from airpollution_tpu_torch.models.fno import (FNOParams, _loss,
                                               adamw_steps, batch_indices)
from airpollution_tpu_torch.parallel.collectives import all_reduce
from airpollution_tpu_torch.parallel.device_mesh import (ProcessMesh,
                                                         check_mesh)

__all__ = ["build_fno_dp_trainer", "train_fno_dp"]


def build_fno_dp_trainer(mesh, *, epochs: int, batch: int,
                         axis: str = "data"):
    """A multi-epoch FNO trainer with the minibatch split over
    ``mesh[axis]``: ``train(params, opt_state, X, Y, generator, lr, wd)
    -> (params, opt_state, losses)``, ``opt_state`` None for a fresh one
    or the previous chunk's (models/fno.train_fno's), the global losses
    (epochs,) and the same parameters on every rank."""
    check_mesh(mesh, axis)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError("the data-parallel FNO trainer runs on a "
                        "ProcessMesh (a process group: parallel/launch.py)")
    n_dev = mesh.shape[axis]
    if batch % n_dev != 0:
        raise ValueError(f"batch {batch} not divisible by {axis}={n_dev}")
    b_local = batch // n_dev
    first = mesh.index(axis) * b_local

    def train(params, opt_state, X, Y, generator, lr, wd):
        idx = batch_indices(generator, X.shape[0], batch, epochs, X.device)

        def loss_and_grads(p, step):
            rows = idx[step, first:first + b_local]
            # This rank's share of the global batch mean.
            local = _loss(FNOParams(*p), X[rows], Y[rows]) * (b_local / batch)
            grads = torch.autograd.grad(local, p)
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                              mesh, axis)
            summed = [g.view_as(t) for g, t in zip(
                torch.split(flat, [t.numel() for t in p]), p)]
            return all_reduce(local.detach(), mesh, axis), summed

        return adamw_steps(params, opt_state, epochs, lr, wd,
                           loss_and_grads, X)

    return train


def train_fno_dp(mesh, params, X, Y, *, epochs=2000, batch=16, lr=1e-3,
                 weight_decay=0.0, generator=None, opt_state=None,
                 axis="data"):
    """``models.fno.train_fno``'s signature plus a mesh: one call, returns
    ``(params, opt_state, losses)``. ``generator`` (on X's device) must
    be seeded alike on every rank; seed 0 when None."""
    train = build_fno_dp_trainer(mesh, epochs=int(epochs), batch=int(batch),
                                 axis=axis)
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    return train(params, opt_state, X, Y, generator, lr, weight_decay)
