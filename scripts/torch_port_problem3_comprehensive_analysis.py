#!/usr/bin/env python3
"""Problem 3's physics diagnostics on the PyTorch + CUDA port (the JAX
package's scripts/problem3_comprehensive_analysis.py).

Runs CRBE and a PINN on the square pulse (scripts/torch_port_problem3.py),
then ``diagnostics.ComprehensiveAnalysis``: mass conservation, the
centre of mass against ``(10, 10) + v t``, the spreading against
``sigma0^2 + 2 D t``, peaks, transects, the five figures (skipped, one
line each, without matplotlib) and the summary statistics; with
``--quadrature segment`` the segment-length weights of the first
reference variant. Runs on the card, or on the CPU under
``APT_PLATFORM=cpu``:

    python3 -m scripts.torch_port_problem3_comprehensive_analysis \\
        [--quadrature triangle|segment] [--epochs N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import ComprehensiveAnalysis  # noqa: E402
from airpollution_tpu_torch.experiments import common  # noqa: E402
from scripts.torch_port_problem3 import discrepancy, solve_both  # noqa: E402

N_STEPS = 128


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="Problem 3 comprehensive physics diagnostics.")
    parser.add_argument("--epochs", type=int, default=3000)
    parser.add_argument("--m_size", type=int, default=64)
    parser.add_argument("--quadrature", type=str, default="triangle",
                        choices=["triangle", "segment"],
                        help="triangle: area/3 per incident triangle; "
                             "segment: segment-length weights")
    parser.add_argument("--save_dir", type=str,
                        default="section5_analysis_plots")
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)
    problem = apt.SquarePulseProblem()
    domain = apt.Domain()
    mesh_data = apt.MeshData(apt.create_mesh(args.m_size, domain_size=20.0),
                             domain, nt=N_STEPS, device=dev)
    solver, model = solve_both(problem, domain, mesh_data, args.epochs, dev)
    l2_error, max_error = discrepancy(solver, model, mesh_data, domain)
    print(f"Original L2 error: {l2_error}")
    print(f"Original Max error: {max_error}")

    print("\n=== Starting Comprehensive Analysis ===")
    analyzer = ComprehensiveAnalysis(problem, domain, mesh_data, solver,
                                     model, quadrature=args.quadrature)
    results = analyzer.run_all_analyses()
    analyzer.plot_all_results(args.save_dir)

    print("\n=== Analysis Summary ===")
    stats = analyzer.summary_statistics()
    print(f"Mass conservation - CRBE loss: "
          f"{stats['mass_loss_crbe_pct']:.2f}%, "
          f"PINN loss: {stats['mass_loss_pinn_pct']:.2f}%")
    print(f"Center of mass error (final) - CRBE: "
          f"{stats['com_error_x_crbe']:.2f}m, "
          f"PINN: {stats['com_error_x_pinn']:.2f}m")
    print(f"Peak concentration decay - CRBE: "
          f"{stats['peak_decay_crbe_pct']:.1f}%, "
          f"PINN: {stats['peak_decay_pinn_pct']:.1f}%")
    for it in [0, N_STEPS // 2, N_STEPS - 1]:
        solver.plot_interpolated_solution(time_index=it, name="crbe3")
        t = float(mesh_data.time_discr[it])
        model.plot_interpolated_solution(t, mesh_data, name="pinn3")
    return results, stats


if __name__ == "__main__":
    main()
