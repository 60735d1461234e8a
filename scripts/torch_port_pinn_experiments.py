#!/usr/bin/env python3
"""The PINN mesh-coupled sweep on the PyTorch + CUDA port, the port's
counterpart of experiments/pinn_experiments.py.

Per mesh size [4..128]: hidden width [2, 4, 8, 16, 32, 64] neurons x
``--width`` hidden layers, the epoch, patience and learning-rate
schedules, lambda = (180, 80, 80) and the collocation budget of the mesh
(``n_col = round(n_dofs / 1.4)``, ``n_ic = n_bc = round(0.2 n_col)``), on
the Gaussian plume; optional accuracy levers (Fourier features, causal
weighting, RAD, grad-norm weights, an L-BFGS polish). Writes
``<out_dir>/df_pinn_training_results<suffix>.csv`` with the columns of
results_snapshot/df_pinn_training_results.csv (epochs/s included) and
prints one JSON line per mesh with the card's name and power limit.

    python3 scripts/torch_port_pinn_experiments.py --mesh_sizes 128 \\
        --epochs 2000                      # the widest cell, on the card
    python3 scripts/torch_port_pinn_experiments.py --mesh_sizes 64 \\
        --fourier_features 64 --causal_eps 1.0 --neurons 64 \\
        --finetune_lbfgs 1000 --out_suffix _levers   # the levers row
    python3 scripts/torch_port_pinn_experiments.py --device cpu \\
        --mesh_sizes 4 8 --epochs 50

No plots: the port has no reporting/plots.py yet.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.pinn import (  # noqa: E402
    count_parameters, count_trainable_parameters)

# The schedules of experiments/common.py (the reference's drivers).
MESH_SIZES = [4, 8, 16, 32, 64, 128]
N_NEURONS = [2, 4, 8, 16, 32, 64]
EPOCHS_LIST = [500, 1000, 2000, 4000, 8000, 16000]
EARLY_STOPPING_PATIENCE_LIST = [500, 500, 500, 1000, 1000, 1000]
LR_LIST = [3e-4, 3e-4, 2e-4, 4e-5, 1e-4, 1e-4]
LAMBDA_WEIGHTS = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
N_STEPS = 128
DOMAIN_SIZE = 20.0
SEED = 1234

COLUMNS = ["mesh_size", "n_dofs", "n_boundary_dofs", "rel_l2_error",
           "l2_error", "max_error", "train_time", "final_loss",
           "number_of_collocation_points", "n_parameters",
           "gpu_memory_usage_MB", "cpu_memory_usage_MB", "epochs_run",
           "epochs_per_sec", "seed", "diverged_seeds"]


def collocation_budget(n_dofs: int):
    """The reference's mesh-derived PINN batch sizes."""
    n_col = round(n_dofs / 1.4)
    n_ic = round(0.2 * n_col)
    return {"pde": n_col, "ic": n_ic, "bc": n_ic}


def str2bool(value):
    if isinstance(value, bool):
        return value
    return str(value).lower() in ("1", "true", "yes", "y")


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def cpu_rss_mb() -> float:
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * resource.getpagesize() / 1e6


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=4,
                   help="number of hidden layers")
    p.add_argument("--activation", default="tanh")
    p.add_argument("--restore_best_weights", type=str2bool, default=True)
    p.add_argument("--epochs", type=int, default=0,
                   help="override the per-mesh epoch schedule")
    p.add_argument("--mesh_sizes", type=int, nargs="*", default=MESH_SIZES)
    p.add_argument("--fourier_features", type=int, default=0)
    p.add_argument("--fourier_scale", type=float, default=1.0)
    p.add_argument("--adaptive_oversample", type=float, default=0.0)
    p.add_argument("--adaptive_weights_every", type=int, default=0)
    p.add_argument("--causal_eps", type=float, default=0.0)
    p.add_argument("--finetune_lbfgs", type=int, default=0,
                   help="full-batch L-BFGS steps after Adam (0 = off)")
    p.add_argument("--neurons", type=int, default=0)
    p.add_argument("--lr", type=float, default=0.0)
    p.add_argument("--patience", type=int, default=-1,
                   help="override the patience schedule (-1: schedule)")
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--out_dir", default="experimental_results/pinn")
    p.add_argument("--out_suffix", default="")
    args = p.parse_args(argv)
    unknown = set(args.mesh_sizes) - set(MESH_SIZES)
    if unknown:
        p.error(f"--mesh_sizes {sorted(unknown)} not in the schedule "
                f"{MESH_SIZES} (hyperparameters are per size)")
    return args


def run_mesh(args, i, domain, problem, device, dtype):
    """One row of the table: train the mesh's schedule, then the errors
    at t = T on the mesh's edge midpoints."""
    mesh_size = MESH_SIZES[i]
    neurons = args.neurons or N_NEURONS[i]
    layers = [3] + [neurons] * args.width + [1]
    epochs = args.epochs or EPOCHS_LIST[i]
    patience = (args.patience if args.patience >= 0
                else EARLY_STOPPING_PATIENCE_LIST[i])
    lr = args.lr or LR_LIST[i]
    md = apt.MeshData(apt.create_mesh(mesh_size, DOMAIN_SIZE), domain,
                      nt=N_STEPS, dtype=dtype, device=device)
    sizes = collocation_budget(md.number_of_segments)
    # Causal weighting needs a point per bin (32 bins): off at ms=4, as in
    # the levers table.
    causal = args.causal_eps if sizes["pde"] >= 32 else 0.0
    model = apt.PINN(layers, problem, domain, activation=args.activation,
                     seed=args.seed, dtype=dtype,
                     fourier_features=args.fourier_features,
                     fourier_scale=args.fourier_scale, device=device)
    on_card = model.device.type == "cuda"
    cpu0 = cpu_rss_mb()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev0 = torch.cuda.memory_allocated()
    start = time.perf_counter()
    history = model.train(
        sizes, epochs, lr, LAMBDA_WEIGHTS, early_stopping_patience=patience,
        restore_best_weights=args.restore_best_weights,
        adaptive_oversample=args.adaptive_oversample,
        adaptive_weights_every=args.adaptive_weights_every,
        causal_eps=causal)
    adam_epochs = len(history["total_loss"])
    if on_card:
        torch.cuda.synchronize()
    adam_s = time.perf_counter() - start
    if args.finetune_lbfgs:
        history = model.finetune_lbfgs(sizes, args.finetune_lbfgs,
                                       LAMBDA_WEIGHTS)
    if on_card:
        torch.cuda.synchronize()
    train_time = time.perf_counter() - start
    gpu_mb = ((torch.cuda.max_memory_allocated() - dev0) / 1e6
              if on_card else 0.0)
    rel_l2, l2, max_err = model.compute_errors(md, problem.analytical_solution)
    n_run = len(history["total_loss"])
    return {
        "mesh_size": mesh_size,
        "n_dofs": md.number_of_segments,
        "n_boundary_dofs": int(md.boundary_segments.numel()),
        "rel_l2_error": rel_l2,
        "l2_error": l2,
        "max_error": max_err,
        "train_time": train_time,
        "final_loss": history["total_loss"][-1],
        "number_of_collocation_points": md.number_of_segments,
        "n_parameters": (count_trainable_parameters(model.mlp)
                         if args.fourier_features
                         else count_parameters(layers)),
        "gpu_memory_usage_MB": max(0.0, gpu_mb),
        "cpu_memory_usage_MB": cpu_rss_mb() - cpu0,
        "epochs_run": n_run,
        "epochs_per_sec": n_run / train_time if train_time else 0.0,
        "seed": args.seed,
        "diverged_seeds": int(not np.isfinite(rel_l2)),
    }, {"adam_epochs": adam_epochs, "adam_s": adam_s,
        "adam_epochs_per_s": adam_epochs / adam_s if adam_s else 0.0,
        "loss_first": history["total_loss"][0], "batch_sizes": sizes,
        "layers": layers, "lr": lr, "patience": patience,
        "causal_eps": causal}


def main(argv=None):
    args = parse(argv)
    dtype = getattr(torch, args.dtype)
    device = None if args.device is None else torch.device(args.device)
    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    card = card_line() if device is None or device.type == "cuda" else None
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir,
                       f"df_pinn_training_results{args.out_suffix}.csv")
    rows = []
    for i, mesh_size in enumerate(MESH_SIZES):
        if mesh_size not in args.mesh_sizes:
            continue
        row, extra = run_mesh(args, i, domain, problem, device, dtype)
        rows.append(row)
        print(json.dumps({**row, **extra, "card": card}), flush=True)
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + COLUMNS)
            for k, r in enumerate(rows):
                w.writerow([k] + [r[c] for c in COLUMNS])
    return rows


if __name__ == "__main__":
    main()
