"""PINN hyperparameter search on the port: the JAX package's
``experiments/optimal_hyperparams_search.py``.

Searches lr in [1e-4, 5e-1] (log), lambda_pde and lambda_ic_bc in [0.1,
10] (log) for a width-32 depth-4 tanh PINN on the ms=64 mesh; the
objective is ``(l2 - 1e-5)^2 + (max - 1e-5)^2``, and a trial that raises
scores inf. Trials run through the port's search engine
(``airpollution_tpu_torch.hpo``), ``--n_jobs`` threads at once (on one
card, they share it). Writes ``optuna_pinn_results_{width}.csv`` with the
study's trials table.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import airpollution_tpu_torch as apt
from airpollution_tpu_torch.experiments import common
from airpollution_tpu_torch.hpo import search
from airpollution_tpu_torch.models.pinn import PINN
from airpollution_tpu_torch.reporting.frames import write_csv

ACTIVATION = "tanh"
DEPTH = 4
MESH_SIZE = 64


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="PINN experiment.")
    parser.add_argument("--width", type=int, default=32,
                        help="Neural network width")
    parser.add_argument("--n_trials", type=int, default=10)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--n_jobs", type=int, default=0,
                        help="0 = os.cpu_count() threads")
    parser.add_argument("--search_levers", type=common.str2bool,
                        default=False,
                        help="Also search the accuracy levers "
                             "(fourier_features, adaptive_oversample)")
    args = parser.parse_args(argv)

    np.random.seed(common.SEED)
    dev = common.print_device(device)

    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    mesh = apt.create_mesh(MESH_SIZE, domain_size=common.DOMAIN_SIZE)
    mesh_data = apt.MeshData(mesh, domain, nt=common.N_STEPS, device=dev)
    batch_sizes = common.collocation_budget(mesh_data.number_of_segments)

    def objective(trial):
        lr = trial.suggest_float("lr", 1e-4, 5e-1, log=True)
        lambda_pde = trial.suggest_float("lambda_pde", 0.1, 10.0, log=True)
        lambda_ic_bc = trial.suggest_float("lambda_ic_bc", 0.1, 10.0,
                                           log=True)
        layers = [3] + [args.width] * DEPTH + [1]
        lambda_weights = {"pde": lambda_pde, "ic": lambda_ic_bc,
                          "bc": lambda_ic_bc}
        fourier, oversample = 0, 0.0
        if args.search_levers:
            fourier = trial.suggest_categorical(
                "fourier_features", [0, 32, 64, 128])
            oversample = trial.suggest_categorical(
                "adaptive_oversample", [0.0, 2.0, 3.0])
        model = PINN(layers, problem, domain, activation=ACTIVATION,
                     seed=common.SEED + trial.number,
                     fourier_features=fourier, device=dev)
        try:
            start_time = time.time()
            model.train(
                batch_sizes, args.epochs, lr, lambda_weights,
                early_stopping_patience=1000,
                early_stopping_min_delta=1e-7,
                restore_best_weights=True,
                adaptive_oversample=oversample,
            )
            _, l2_error, max_error = model.compute_errors(
                mesh_data, problem.analytical_solution)
            trial.set_user_attr("train_time", time.time() - start_time)
            return (l2_error - 1e-5) ** 2 + (max_error - 1e-5) ** 2
        except Exception as e:  # a failed trial scores inf, as in JAX
            print(f"Trial failed: {type(e).__name__}: {e}")
            return float("inf")

    n_jobs = args.n_jobs or (os.cpu_count() or 1)
    start_ = time.time()
    study = search.create_study(direction="minimize")
    study.optimize(objective, n_trials=args.n_trials, n_jobs=n_jobs)
    print(f"\nMinimization ended in {time.time() - start_:0.2f}")

    rows = study.trials_dataframe()
    write_csv(f"optuna_pinn_results_{args.width}.csv", rows, index=False)
    finite = [t for t in study.trials if np.isfinite(t.value)]
    if finite:
        print("Best trial:")
        print(study.best_trial.params)
    return rows


if __name__ == "__main__":
    main()
