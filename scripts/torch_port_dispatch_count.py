#!/usr/bin/env python3
"""Host dispatches of the differentiable loop, per time step: the aten
operations one Adam step of ``inverse.fit_source`` dispatches on the fused
engine, counted with a ``TorchDispatchMode`` on the CPU and divided by the
step's time steps. The raw Chebyshev sweeps (one launch of kernel B4's raw
mode each on the card) and the Chebyshev interval (estimated once per fit
while the operator carries no gradient) are left out, and so are the
CPU-only rectangle masks of the sweeps' plain version, so that the count
is what the card's host dispatches. ``--checkpoint`` re-runs every step in the
backward (``crbe.checkpoint_steps`` always true), as on the CPU and as on
the card when the steps' saved tensors would not fit.

    python3 scripts/torch_port_dispatch_count.py             # ~10 s
    python3 scripts/torch_port_dispatch_count.py --checkpoint

Prints one JSON line. Runs on the CPU only: a count, not a time.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse  # noqa: E402
from airpollution_tpu_torch.models import crbe  # noqa: E402
from airpollution_tpu_torch.ops import (  # noqa: E402
    fused_hbm, fused_solver, linalg)


class Count(TorchDispatchMode):
    """Counts aten operations by name, except inside :meth:`skipping`."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.skip = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.skip:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))

    def skipping(self, fn):
        def wrapped(*a, **k):
            self.skip += 1
            try:
                return fn(*a, **k)
            finally:
                self.skip -= 1
        return wrapped


def run(mesh_size=33, nt=17, checkpoint=False):
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), apt.Domain(), nt=nt,
                      device="cpu")
    idx = list(range(nt // 4, nt, nt // 4))
    source = dict(q=2.0, xs=-4.0, ys=2.5, sigma_s=1.5)
    with torch.no_grad():
        obs = inverse.solve_snapshots(apt.GaussianSourceProblem(**source), md,
                                      indices=idx, engine="fused_hbm")
    count = Count()
    fused_hbm.plain_canvas_raw = count.skipping(fused_hbm.plain_canvas_raw)
    fused_solver.rect_masks = count.skipping(fused_solver.rect_masks)
    linalg.power_bounds = count.skipping(linalg.power_bounds)
    crbe.checkpoint_steps = lambda *a: checkpoint

    def fit():
        return inverse.fit_source(obs, md, snapshot_indices=idx,
                                  sigma_s=source["sigma_s"], q0=0.5,
                                  steps=1, lr=0.1, engine="fused_hbm")

    fit()  # first calls build patterns and caches
    with count:
        fit()
    total = sum(count.ops.values())
    return {"mesh_size": mesh_size, "nt": nt, "checkpoint": checkpoint,
            "ops_per_adam_step": total,
            "ops_per_time_step": total / (nt - 1),
            "top": count.ops.most_common(12), "platform": "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=33)
    ap.add_argument("--nt", type=int, default=17)
    ap.add_argument("--checkpoint", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.mesh_size, args.nt, args.checkpoint)))


if __name__ == "__main__":
    main()
