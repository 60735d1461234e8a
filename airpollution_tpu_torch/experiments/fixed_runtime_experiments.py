"""Fixed-runtime CRBE-vs-PINN comparison on the port: the JAX package's
``experiments/fixed_runtime_experiments.py``.

For each mesh size [4..64] and time budget [30, 60, 120, 180] s ([10] s
with --run_for_testing): train the PINN in epoch chunks until the budget
is spent, then run CRBE once (with a warning when it overruns). Writes
``experimental_results/fixed_runtime/fixed_runtime_comparison.csv`` and
``fixed_runtime_summary_stats.csv``: per (method, time_budget), the mean
and standard deviation of rel_l2_error and actual_runtime and the mean of
epochs_completed, in flat columns ``<column>_<statistic>``.

By default Adam's state continues across chunks (``--warm_start=True``);
``--warm_start=False`` restarts it each chunk, as the reference's loop
did. Chunks are ``--epochs_per_chunk`` epochs (default 50).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import airpollution_tpu_torch as apt
from airpollution_tpu_torch.experiments import common
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.models.pinn import PINN, count_parameters
from airpollution_tpu_torch.reporting import frames
from airpollution_tpu_torch.utils import memory_delta

BASE_NEURONS = [2, 4, 8, 16, 32]
FR_MESH_SIZES = [4, 8, 16, 32, 64]
TIME_BUDGETS = [30, 60, 120, 180]
TESTING_BUDGETS = [10]  # --run_for_testing
SUMMARY = [("rel_l2_error", "mean"), ("rel_l2_error", "std"),
           ("actual_runtime", "mean"), ("actual_runtime", "std"),
           ("epochs_completed", "mean")]


def run_pinn_with_time_budget(domain, problem, mesh_data, time_budget,
                              n_neurons, lr, warm_start, epochs_per_chunk):
    dev = mesh_data.device
    layers = [3] + [n_neurons] * 4 + [1]
    batch_sizes = common.collocation_budget(mesh_data.number_of_segments)
    model = PINN(layers, problem, domain, seed=common.SEED, device=dev)

    print(f"PINN training with {time_budget}s budget...")
    start_time = time.time()
    epoch = 0
    with memory_delta(dev) as mem:
        first = True
        while (time.time() - start_time) < time_budget:
            model.train(
                batch_sizes, epochs=epochs_per_chunk, lr=lr,
                lambda_weights=common.LAMBDA_WEIGHTS,
                warm_start=warm_start and not first,
            )
            first = False
            epoch += epochs_per_chunk
            if epoch % 1000 < epochs_per_chunk:
                elapsed = time.time() - start_time
                print(f"  Epoch {epoch}, Elapsed: {elapsed:.1f}s, "
                      f"Loss: {model.history['total_loss'][-1]:.6f}")
    history = model.history
    actual_runtime = time.time() - start_time

    rel_l2_error, l2_error, max_error = model.compute_errors(
        mesh_data, problem.analytical_solution)
    return {
        "method": "PINN",
        "actual_runtime": actual_runtime,
        "epochs_completed": epoch,
        "final_loss": history["total_loss"][-1] if history["total_loss"]
        else float("inf"),
        "rel_l2_error": rel_l2_error,
        "l2_error": l2_error,
        "max_error": max_error,
        "n_parameters": count_parameters(layers),
        "gpu_memory_usage_MB": mem["gpu_memory_usage_MB"],
        "cpu_memory_usage_MB": mem["cpu_memory_usage_MB"],
        "convergence_history": history["total_loss"],
    }


def run_crbe_with_time_budget(domain, problem, mesh_data, time_budget):
    dev = mesh_data.device
    print("CRBE solving...")
    start_time = time.time()
    with memory_delta(dev) as mem:
        solver = CRBESolver(domain, problem, mesh_data,
                            stiffness_convention="reference", device=dev)
        solver.solve()
    actual_runtime = time.time() - start_time
    if actual_runtime > time_budget:
        print(f"  Warning: CRBE took {actual_runtime:.1f}s, exceeding "
              f"budget of {time_budget}s")
    rel_l2_error, l2_error, max_error = solver.compute_errors(
        problem.analytical_solution)
    return {
        "method": "CRBE",
        "actual_runtime": actual_runtime,
        "epochs_completed": 1,
        "final_loss": None,
        "rel_l2_error": rel_l2_error,
        "l2_error": l2_error,
        "max_error": max_error,
        "n_parameters": mesh_data.number_of_segments,
        "gpu_memory_usage_MB": mem["gpu_memory_usage_MB"],
        "cpu_memory_usage_MB": mem["cpu_memory_usage_MB"],
        "convergence_history": None,
    }


def summary_rows(results):
    """The summary table's rows: per (method, time_budget) in sorted
    order, the statistics of :data:`SUMMARY`, rounded to 6 digits."""
    frame = {k: np.array([r[k] for r in results])
             for k in ("method", "time_budget", "rel_l2_error",
                       "actual_runtime", "epochs_completed")}
    stats = frames.group_mean(frame, ["method", "time_budget"], SUMMARY)
    names = list(stats)
    return [{k: (stats[k][i].item() if k in ("method", "time_budget")
                 else round(float(stats[k][i]), 6)) for k in names}
            for i in range(frames.length(stats))]


def run_cell(domain, problem, mesh_data, mesh_idx, time_budget,
             warm_start=True, epochs_per_chunk=50):
    """One (mesh, budget) cell: the PINN's and CRBE's rows, each with the
    cell's mesh_size, time_budget, n_dofs and n_boundary_dofs. The mesh
    is ``FR_MESH_SIZES[mesh_idx]``'s, which fixes the PINN's width and
    lr."""
    meta = {
        "mesh_size": FR_MESH_SIZES[mesh_idx],
        "time_budget": time_budget,
        "n_dofs": mesh_data.number_of_segments,
        "n_boundary_dofs": int(mesh_data.boundary_segments.numel()),
    }
    pinn_result = run_pinn_with_time_budget(
        domain, problem, mesh_data, time_budget, BASE_NEURONS[mesh_idx],
        common.LR_LIST[mesh_idx], warm_start, epochs_per_chunk)
    pinn_result.update(meta)
    crbe_result = run_crbe_with_time_budget(domain, problem, mesh_data,
                                            time_budget)
    crbe_result.update(meta)
    print(f"PINN  - Runtime: {pinn_result['actual_runtime']:.1f}s, "
          f"Epochs: {pinn_result['epochs_completed']}, "
          f"Rel L2 Error: {pinn_result['rel_l2_error']:.6f}")
    print(f"CRBE  - Runtime: {crbe_result['actual_runtime']:.1f}s, "
          f"Rel L2 Error: {crbe_result['rel_l2_error']:.6f}")
    return [pinn_result, crbe_result]


def save_results(all_results, save_dir):
    """Write the rows to ``<save_dir>/fixed_runtime_comparison.csv`` and
    their summary to ``fixed_runtime_summary_stats.csv``; returns the
    summary rows."""
    frames.write_csv(f"{save_dir}/fixed_runtime_comparison.csv",
                     all_results, index=False)
    summary = summary_rows(all_results)
    frames.write_csv(f"{save_dir}/fixed_runtime_summary_stats.csv", summary,
                     index=False)
    return summary


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="Fixed-runtime CRBE vs PINN comparison.")
    parser.add_argument("--run_for_testing", type=common.str2bool,
                        default=False)
    parser.add_argument("--warm_start", type=common.str2bool, default=True,
                        help="Continue Adam state across chunks; False "
                             "restarts it every chunk, as the reference")
    parser.add_argument("--epochs_per_chunk", type=int, default=50)
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)

    save_dir = "experimental_results/fixed_runtime"
    os.makedirs(save_dir, exist_ok=True)

    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    time_budgets = TESTING_BUDGETS if args.run_for_testing else TIME_BUDGETS

    all_results = []
    for mesh_idx, mesh_size in enumerate(FR_MESH_SIZES):
        print(f"\n{'=' * 50}\nMESH SIZE: {mesh_size}\n{'=' * 50}")
        mesh = apt.create_mesh(mesh_size, domain_size=common.DOMAIN_SIZE)
        mesh_data = apt.MeshData(mesh, domain, nt=common.N_STEPS, device=dev)
        for time_budget in time_budgets:
            print(f"\nTime Budget: {time_budget}s\n" + "-" * 30)
            all_results += run_cell(domain, problem, mesh_data, mesh_idx,
                                    time_budget, args.warm_start,
                                    args.epochs_per_chunk)

    summary = save_results(all_results, save_dir)
    print(f"\n{'=' * 50}\nEXPERIMENT COMPLETED\n{'=' * 50}")
    print(f"Results saved to: {save_dir}/fixed_runtime_comparison.csv")
    print(f"Total experiments: {len(all_results)}")
    print("\nSUMMARY:")
    for row in summary:
        print(row)
    print("\nExperiment completed successfully!")
    return all_results


if __name__ == "__main__":
    main()
