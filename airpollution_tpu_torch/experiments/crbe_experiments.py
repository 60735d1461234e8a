"""CRBE h-refinement sweep on the port: the JAX package's
``experiments/crbe_experiments.py``.

Runs the CR FEM solver over mesh sizes [4, 8, 16, 32, 64, 128] with nt=128
on the Gaussian plume, records errors, times and memory, and writes
``experimental_results/crbe/df_crbe_training_results<suffix>.csv`` with
the reference's columns (and ``solve_time``, ``steps_per_sec``):
``_unstructured`` for ``--mesh_kind unstructured`` (jittered Delaunay
meshes, whose ELL products run kernel B7a on the card), ``_cn`` for
``--time_scheme_order 2``. Prints the empirical convergence rates.

    python -m airpollution_tpu_torch.experiments.crbe_experiments
    APT_PLATFORM=cpu python -m airpollution_tpu_torch.experiments.crbe_experiments \\
        --mesh_sizes 4 8 --dtype float64
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import airpollution_tpu_torch as apt
from airpollution_tpu_torch.experiments import common
from airpollution_tpu_torch.models.crbe import CRBESolver, ElementCR
from airpollution_tpu_torch.reporting.frames import write_csv
from airpollution_tpu_torch.utils import memory_delta, profiler_trace


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="CRBE mesh-refinement sweep.")
    parser.add_argument("--mesh_sizes", type=int, nargs="*",
                        default=common.MESH_SIZES)
    parser.add_argument("--n_steps", type=int, default=common.N_STEPS)
    parser.add_argument("--stiffness_convention", type=str,
                        default="reference", choices=["reference", "correct"])
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "float64"])
    parser.add_argument("--time_scheme_order", type=int, default=1)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="Write a torch.profiler trace of the solves here")
    parser.add_argument("--mesh_kind", type=str, default="structured",
                        choices=["structured", "unstructured"],
                        help="unstructured = jittered-Delaunay meshes; "
                             "results go to a _unstructured-suffixed CSV")
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)

    exp_dir = "experimental_results/crbe"
    os.makedirs(exp_dir, exist_ok=True)

    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    dtype = getattr(torch, args.dtype)
    cr_element = ElementCR()

    crbe_results = []
    for mesh_size in args.mesh_sizes:
        print(f"Training for mesh size = {mesh_size} ...")
        start_time = time.time()
        if args.mesh_kind == "unstructured":
            mesh = apt.create_unstructured_mesh(
                mesh_size, domain_size=common.DOMAIN_SIZE, seed=common.SEED)
        else:
            mesh = apt.create_mesh(mesh_size, domain_size=common.DOMAIN_SIZE)
        mesh_data = apt.MeshData(mesh, domain, nt=args.n_steps, dtype=dtype,
                                 device=dev)
        solver = CRBESolver(
            domain, problem, mesh_data, cr_element,
            time_scheme_order=args.time_scheme_order,
            stiffness_convention=args.stiffness_convention, device=dev,
        )
        with memory_delta(dev) as mem, \
                profiler_trace(args.profile_dir or None):
            solver.solve()
        train_time = time.time() - start_time
        # solve_time and steps_per_sec come from a warm second solve;
        # train_time keeps the reference's everything-included meaning.
        solver.solve()

        rel_l2_error, l2_error, max_error = solver.compute_errors(
            problem.analytical_solution)
        solver.plot_interpolated_solution(
            analytical_sol_fn=problem.analytical_solution, save_dir=exp_dir,
            name=f"ms{mesh_size}_crbe")

        crbe_results.append({
            "mesh_size": mesh_size,
            "n_dofs": mesh_data.number_of_segments,
            "n_boundary_dofs": int(mesh_data.boundary_segments.numel()),
            "l2_error": l2_error,
            "rel_l2_error": rel_l2_error,
            "max_error": max_error,
            "train_time": train_time,
            "gpu_memory_usage_MB": mem["gpu_memory_usage_MB"],
            "cpu_memory_usage_MB": mem["cpu_memory_usage_MB"],
            "number_of_collocation_points": mesh_data.number_of_segments,
            "solve_time": solver.solve_time,
            "steps_per_sec": (args.n_steps - 1) / solver.solve_time,
        })
        print(f"Mesh size: {mesh_size}")
        print(f"CPU Memory Used: {mem['cpu_memory_usage_MB']:.2f} MB")
        print("-" * 40)

    suffix = "_unstructured" if args.mesh_kind == "unstructured" else ""
    if args.time_scheme_order == 2:
        suffix += "_cn"
    write_csv(f"{exp_dir}/df_crbe_training_results{suffix}.csv",
              crbe_results)
    for row in crbe_results:
        print(row)
    if len(crbe_results) > 1:
        # Empirical convergence rates: the slope of log error against
        # log h, h ~ 1/ms.
        h = np.log(1.0 / np.array([r["mesh_size"] for r in crbe_results]))
        for col, label in (("rel_l2_error", "L2"), ("max_error", "Linf")):
            err = np.array([r[col] for r in crbe_results])
            rate = np.polyfit(h, np.log(err), 1)[0]
            print(f"empirical {label} convergence rate: O(h^{rate:.2f})")
    return crbe_results


if __name__ == "__main__":
    main()
