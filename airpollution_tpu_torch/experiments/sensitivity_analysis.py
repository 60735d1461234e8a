"""Diffusion-coefficient sensitivity sweep on the port: the JAX package's
``experiments/sensitivity_analysis.py``.

For D in [0.001, 0.01, 0.1, 1.0, 10] at the fixed mesh index 4 (ms=64):
train a PINN and run CRBE per D, record both rel-L2 and max errors, and
write ``experimental_results/sensibility/df_sensitivity_data.csv`` (the
reference's directory spelling) with the columns mesh_size,
diffusion_coef, pinn_l2_error, max_error, cr_l2_error, cr_max_error,
after every D. Early-stopping patience defaults to the reference's 500.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

import airpollution_tpu_torch as apt
from airpollution_tpu_torch.experiments import common
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.models.pinn import PINN
from airpollution_tpu_torch.reporting.frames import write_csv

D_LIST = [0.001, 0.01, 0.1, 1.0, 10]
IDX_MESH_SIZE = 4  # ms = 64


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        description="PINN/CRBE sensitivity to the diffusion coefficient.")
    parser.add_argument("--width", type=int, default=4)
    parser.add_argument("--activation", type=str, default="tanh")
    parser.add_argument("--epochs", type=int, default=0)
    parser.add_argument("--early_stopping_patience", type=int, default=500)
    parser.add_argument("--restore_best_weights", type=common.str2bool,
                        default=True)
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)

    exp_dir = "experimental_results/sensibility"
    os.makedirs(exp_dir, exist_ok=True)
    filename = f"{exp_dir}/df_sensitivity_data.csv"

    domain = apt.Domain()
    j = IDX_MESH_SIZE
    mesh_size = common.MESH_SIZES[j]
    layers = [3] + [common.N_NEURONS[j]] * args.width + [1]
    lr = common.LR_LIST[j]
    epochs = args.epochs or common.EPOCHS_LIST[j]

    print(f"Training for mesh size {mesh_size} ...")
    mesh = apt.create_mesh(mesh_size, domain_size=common.DOMAIN_SIZE)
    mesh_data = apt.MeshData(mesh, domain, nt=common.N_STEPS, device=dev)
    batch_sizes = common.collocation_budget(mesh_data.number_of_segments)

    sensitivity_data = []
    for D in D_LIST:
        print(f"Running for D = {D}")
        pproblem = apt.Problem(D=D, sigma=1.0)
        model = PINN(layers, pproblem, domain, activation=args.activation,
                     seed=common.SEED, device=dev)
        model.train(
            batch_sizes, epochs, lr, common.LAMBDA_WEIGHTS,
            early_stopping_patience=args.early_stopping_patience,
            early_stopping_min_delta=1e-6,
            restore_best_weights=args.restore_best_weights,
        )
        pinn_rel_l2, _, pinn_max = model.compute_errors(
            mesh_data, pproblem.analytical_solution)

        cproblem = apt.Problem(D=D, sigma=1.0)
        solver = CRBESolver(domain, cproblem, mesh_data,
                            stiffness_convention="reference", device=dev)
        solver.solve()
        crbe_rel_l2, _, crbe_max = solver.compute_errors(
            cproblem.analytical_solution)

        sensitivity_data.append({
            "mesh_size": mesh_size,
            "diffusion_coef": D,
            "pinn_l2_error": pinn_rel_l2,
            "max_error": pinn_max,
            "cr_l2_error": crbe_rel_l2,
            "cr_max_error": crbe_max,
        })
        write_csv(filename, sensitivity_data)
        print("=" * 50)

    print(f"Sensitivity analysis ended and results are saved at {filename}")
    return sensitivity_data


if __name__ == "__main__":
    main()
