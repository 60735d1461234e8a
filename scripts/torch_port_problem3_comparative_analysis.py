#!/usr/bin/env python3
"""Problem 3's per-mesh CRBE-against-PINN table on the PyTorch + CUDA
port (the JAX package's scripts/problem3_comparative_analysis.py).

For each mesh size of the schedule (4-128; --mesh_sizes picks some):
the CRBE solve of the square pulse (``stiffness_convention="reference"``,
nt=128) and a PINN's training (layers [3, n, n, n, 1] with the
schedule's width, lambda (1, 8, 1), IC and BC 0.25 / 0.15 of the
collocation budget, early stopping after 500 epochs without a 1e-6
gain, the best weights restored), each timed and with its memory
delta (``utils.profiling.memory_delta``: host RSS and the card's
allocator), then the PINN-against-CRBE L2 and max discrepancy at t = T.
Writes ``problem3_analysis_results/problem3_comparative_analysis_by_mesh_size.csv``
with the reference's columns (``reporting/frames.write_csv``, as
``DataFrame.to_csv(index=False)``). The reference's epoch schedule is
the default; --epochs overrides it. Runs on the card, or on the CPU with
--device cpu (or ``APT_PLATFORM=cpu``):

    python3 -m scripts.torch_port_problem3_comparative_analysis \\
        [--mesh_sizes 4 8] [--epochs N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.experiments import common  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402
from airpollution_tpu_torch.reporting import frames  # noqa: E402
from airpollution_tpu_torch.utils.profiling import memory_delta  # noqa: E402

LR_LIST = [1e-3, 1e-3, 1e-3, 1e-4, 2e-4, 3e-4]
EPOCHS_LIST = [500, 1000, 2000, 4000, 8000, 16000]
LAMBDA_WEIGHTS = {"pde": 1.0, "ic": 8.0, "bc": 1.0}
OUT_NAME = "problem3_comparative_analysis_by_mesh_size.csv"
N_STEPS = 128


def compare_mesh(i, m_size, epochs, dev):
    """One mesh size's row of the table."""
    problem = apt.SquarePulseProblem()
    domain = apt.Domain()
    current = {"m_size": m_size}
    mesh_data = apt.MeshData(apt.create_mesh(m_size, domain_size=20.0),
                             domain, nt=N_STEPS, device=dev)

    crbe_solver = CRBESolver(domain, problem, mesh_data,
                             stiffness_convention="reference", device=dev)
    with memory_delta(dev if dev.type == "cuda" else "cpu") as mem:
        start = time.time()
        crbe_solver.solve()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        crbe_time = time.time() - start
    u_crbe = crbe_solver.solutions[-1].double().cpu().numpy()
    current.update({"crbe_time_solve_s": crbe_time,
                    "crbe_cpu_mem_diff_MB": mem["cpu_memory_usage_MB"],
                    "crbe_gpu_mem_peak_MB": mem["gpu_memory_usage_MB"]})
    print(f"CRBE solve (m_size={m_size}): {crbe_time:.2f}s")

    layers = [3] + [common.N_NEURONS[i]] * 3 + [1]
    n_col = int(round(mesh_data.number_of_segments / 1.4))
    batch_sizes = {"pde": n_col, "ic": int(round(0.25 * n_col)),
                   "bc": int(round(0.15 * n_col))}
    model = PINN(layers, problem, domain, seed=common.SEED, device=dev)
    with memory_delta(dev if dev.type == "cuda" else "cpu") as mem:
        start = time.time()
        history = model.train(batch_sizes, epochs, LR_LIST[i],
                              LAMBDA_WEIGHTS, early_stopping_patience=500,
                              early_stopping_min_delta=1e-6,
                              restore_best_weights=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        pinn_time = time.time() - start
    current.update({"pinn_time_train_s": pinn_time,
                    "pinn_cpu_mem_diff_MB": mem["cpu_memory_usage_MB"],
                    "pinn_gpu_mem_peak_MB": mem["gpu_memory_usage_MB"],
                    "pinn_epochs_run": len(history["pde_loss"])})
    print(f"PINN training (m_size={m_size}): {pinn_time:.2f}s "
          f"({len(history['pde_loss'])} epochs)")

    mid = mesh_data.midpoints
    xyt = torch.cat([mid, torch.full((mid.shape[0], 1), float(domain.T),
                                     dtype=mid.dtype, device=mid.device)],
                    dim=1)
    u_pinn = model.forward(xyt).reshape(-1).double().cpu().numpy()
    diff = np.abs(u_pinn - u_crbe)
    current.update({"l2_error_diff": float(np.linalg.norm(diff)),
                    "max_error_diff": float(np.max(diff))})
    print(f"Error (m_size={m_size}): L2 Diff = "
          f"{current['l2_error_diff']:.4e}, Max Diff = "
          f"{current['max_error_diff']:.4e}")
    return current


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="Problem 3 comparative analysis by mesh size.")
    parser.add_argument("--epochs", type=int, default=0,
                        help="Override the per-mesh epoch schedule")
    parser.add_argument("--mesh_sizes", type=int, nargs="*",
                        default=common.MESH_SIZES)
    parser.add_argument("--device", default=device,
                        help="cpu, or the CUDA card when not given")
    args = parser.parse_args(argv)
    unknown = set(args.mesh_sizes) - set(common.MESH_SIZES)
    if unknown:
        raise SystemExit(
            f"--mesh_sizes {sorted(unknown)} not in the schedule "
            f"{common.MESH_SIZES} (hyperparameters are per-size)")
    np.random.seed(common.SEED)
    dev = common.print_device(args.device)
    print("Starting comparative analysis for Problem 3...")
    exp_dir = "problem3_analysis_results"
    os.makedirs(exp_dir, exist_ok=True)
    epochs_list = (EPOCHS_LIST if not args.epochs
                   else [args.epochs] * len(common.MESH_SIZES))

    rows = []
    for i, m_size in enumerate(common.MESH_SIZES):
        if m_size not in args.mesh_sizes:
            continue
        print(f"\n--- Processing Mesh Size: {m_size} ---")
        rows.append(compare_mesh(i, m_size, epochs_list[i], dev))

    out = os.path.join(exp_dir, OUT_NAME)
    frames.write_csv(out, rows, index=False)
    print(f"\nResults saved to {out}")
    for row in rows:
        print(row)
    print("\nComparative analysis script finished.")
    return rows


if __name__ == "__main__":
    main()
