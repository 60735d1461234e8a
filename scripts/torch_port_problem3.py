#!/usr/bin/env python3
"""Problem 3 case study on the PyTorch + CUDA port: square-pulse release,
CRBE against a PINN (the JAX package's scripts/problem3.py).

The square pulse on [8, 12]^2 with zero boundary and source, v = (1, 0),
D = 0.1, on the standard (20, 20, 10) domain; a CRBE solve, then a
[3, 30, 30, 30, 1] PINN with lambda = (1, 8, 1), lr 1e-3 and IC / BC
budget fractions 0.35 / 0.05 of the mesh's collocation budget; the loss
history and snapshot figures at steps [0, n/2, n-1] (skipped, one line
each, without matplotlib), and the PINN-against-CRBE L2 and max
discrepancy at t = T (no closed form exists). Runs on the card, or on the
CPU under ``APT_PLATFORM=cpu``:

    python3 -m scripts.torch_port_problem3 [--epochs N] [--m_size M]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.experiments import common  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402


def batch_sizes(n_dofs):
    """Problem 3's collocation budget: the mesh's PDE points, 35% of them
    on the initial condition and 5% on the boundary."""
    n_col = round(n_dofs / 1.4)
    return {"pde": n_col, "ic": round(0.35 * n_col),
            "bc": round(0.05 * n_col)}


def solve_both(problem, domain, mesh_data, epochs, device):
    """The CRBE solve (every step stored) and the trained PINN."""
    solver = CRBESolver(domain, problem, mesh_data,
                        stiffness_convention="reference", device=device)
    solver.solve()
    model = PINN([3] + [30] * 3 + [1], problem, domain, seed=common.SEED,
                 device=device)
    model.train(batch_sizes(mesh_data.number_of_segments), epochs, 1e-3,
                {"pde": 1.0, "ic": 8.0, "bc": 1.0},
                early_stopping_patience=10, early_stopping_min_delta=1e-6,
                restore_best_weights=True)
    return solver, model


def discrepancy(solver, model, mesh_data, domain):
    """(L2, max) of |PINN - CRBE| over the edge midpoints at t = T."""
    mid = mesh_data.midpoints
    xyt = torch.cat([mid, torch.full((mid.shape[0], 1), float(domain.T),
                                     dtype=mid.dtype, device=mid.device)],
                    dim=1)
    u_pinn = model.forward(xyt).reshape(-1).double().cpu().numpy()
    u_crbe = solver.solutions[-1].double().cpu().numpy()
    error = np.abs(u_pinn - u_crbe)
    return float(np.linalg.norm(error)), float(np.max(error))


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="Problem 3 case study.")
    parser.add_argument("--epochs", type=int, default=3000)
    parser.add_argument("--m_size", type=int, default=64)
    parser.add_argument("--n_steps", type=int, default=128)
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)
    problem = apt.SquarePulseProblem()
    domain = apt.Domain(Lx=20, Ly=20, T=10)
    mesh_data = apt.MeshData(apt.create_mesh(args.m_size, domain_size=20.0),
                             domain, nt=args.n_steps, device=dev)
    solver, model = solve_both(problem, domain, mesh_data, args.epochs, dev)
    model.plot_history(name="pinn3")
    for it in [0, args.n_steps // 2, args.n_steps - 1]:
        solver.plot_interpolated_solution(time_index=it, name="crbe3")
        t = float(mesh_data.time_discr[it])
        model.plot_interpolated_solution(t, mesh_data, name="pinn3")
    l2_error, max_error = discrepancy(solver, model, mesh_data, domain)
    print()
    print("L2 error: ", l2_error)
    print("Max error: ", max_error)
    return l2_error, max_error


if __name__ == "__main__":
    main()
