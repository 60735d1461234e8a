"""PINN mesh-coupled sweep on the port: the JAX package's
``experiments/pinn_experiments.py``.

Per mesh size [4..128]: hidden width [2, 4, 8, 16, 32, 64] neurons x
``--width`` hidden layers (the reference's --width counts layers), the
epoch, patience and learning-rate schedules, lambda = (180, 80, 80) and
the collocation budget of the mesh, on the Gaussian plume; the accuracy
levers (Fourier features, RAD, grad-norm weights, causal weighting, an
L-BFGS polish); a best-of-N-seeds protocol (``--seed_retries``,
``--diverged_threshold``). Writes
``experimental_results/pinn/df_pinn_training_results<suffix>.csv`` with
the reference's columns (and ``epochs_run``, ``epochs_per_sec``, ``seed``,
``diverged_seeds``), and each mesh's solution and loss figures. Causal
weighting needs a point per time bin (32): it is off on a mesh whose
budget has fewer PDE points (ms=4).

    python -m airpollution_tpu_torch.experiments.pinn_experiments \\
        --mesh_sizes 128 --epochs 2000              # the widest cell
    python -m airpollution_tpu_torch.experiments.pinn_experiments \\
        --mesh_sizes 64 --fourier_features 64 --causal_eps 1.0 \\
        --neurons 64 --finetune_lbfgs 1000 --out_suffix _levers
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import airpollution_tpu_torch as apt
from airpollution_tpu_torch.experiments import common
from airpollution_tpu_torch.models.pinn import (PINN, count_parameters,
                                                count_trainable_parameters)
from airpollution_tpu_torch.reporting.frames import write_csv
from airpollution_tpu_torch.utils import memory_delta, profiler_trace

CAUSAL_BINS = 32


def parse(argv=None):
    parser = argparse.ArgumentParser(
        description="PINN experiment with configurable network width.")
    parser.add_argument("--width", type=int, default=4,
                        help="Number of hidden layers in the neural network")
    parser.add_argument("--activation", type=str, default="tanh",
                        help="Type of activation (tanh, sine, swish)")
    parser.add_argument("--restore_best_weights", type=common.str2bool,
                        default=True)
    parser.add_argument("--epochs", type=int, default=0,
                        help="Override the per-mesh epoch schedule")
    parser.add_argument("--mesh_sizes", type=int, nargs="*",
                        default=common.MESH_SIZES)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="Write a torch.profiler trace of training here")
    parser.add_argument("--fourier_features", type=int, default=0,
                        help="Random Fourier embedding size (0 = off)")
    parser.add_argument("--fourier_scale", type=float, default=1.0)
    parser.add_argument("--adaptive_oversample", type=float, default=0.0,
                        help="RAD collocation oversampling ratio (>1 = on)")
    parser.add_argument("--adaptive_weights_every", type=int, default=0,
                        help="Grad-norm adaptive loss weights period (0 = off)")
    parser.add_argument("--causal_eps", type=float, default=0.0,
                        help="Respect-temporal-causality PDE weighting "
                             "strength (0 = off)")
    parser.add_argument("--finetune_lbfgs", type=int, default=0,
                        help="Full-batch L-BFGS polish steps after Adam "
                             "(0 = off)")
    parser.add_argument("--neurons", type=int, default=0,
                        help="Override the per-size hidden-width schedule "
                             "(0 = reference schedule [2,4,...,64])")
    parser.add_argument("--lr", type=float, default=0.0,
                        help="Override the per-size lr schedule (0 = "
                             "reference schedule)")
    parser.add_argument("--patience", type=int, default=0,
                        help="Override the per-size early-stopping patience "
                             "schedule (0 = reference schedule)")
    parser.add_argument("--out_suffix", type=str, default="",
                        help="Suffix for the results CSV (e.g. '_levers')")
    parser.add_argument("--seed", type=int, default=common.SEED,
                        help="Init/collocation PRNG seed")
    parser.add_argument("--seed_overrides", type=str, default="",
                        help="Per-mesh seed overrides 'ms:seed,ms:seed'")
    parser.add_argument("--seed_retries", type=int, default=1,
                        help="Best-of-N-seeds protocol: try up to N seeds "
                             "(base, base+1, ...), stop at the first "
                             "convergent run, keep the best row; the "
                             "diverged_seeds column counts failed attempts")
    parser.add_argument("--diverged_threshold", type=float, default=10.0,
                        help="rel-L2 above which a run counts as diverged "
                             "for the seed-retry protocol")
    args = parser.parse_args(argv)
    unknown = set(args.mesh_sizes) - set(common.MESH_SIZES)
    if unknown:
        raise SystemExit(
            f"--mesh_sizes {sorted(unknown)} not in the schedule "
            f"{common.MESH_SIZES} (hyperparameters are per-size)")
    return args


def schedule(args, i):
    """Mesh index ``i``'s (layers, epochs, patience, lr) under ``args``'
    overrides."""
    n_neurons = args.neurons or common.N_NEURONS[i]
    layers = [3] + [n_neurons] * args.width + [1]
    epochs = args.epochs or common.EPOCHS_LIST[i]
    patience = args.patience or common.EARLY_STOPPING_PATIENCE_LIST[i]
    lr = args.lr or common.LR_LIST[i]
    return layers, epochs, patience, lr


def _rank(rel):
    """A NaN rel-L2 ranks worst, so any finite later seed replaces it."""
    return rel if np.isfinite(rel) else np.inf


def main(argv=None, device=None):
    args = parse(argv)
    np.random.seed(common.SEED)
    dev = common.print_device(device)

    exp_dir = "experimental_results/pinn"
    os.makedirs(exp_dir, exist_ok=True)
    out = f"{exp_dir}/df_pinn_training_results{args.out_suffix}.csv"

    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    seed_overrides = dict(
        (int(p.split(":")[0]), int(p.split(":")[1]))
        for p in args.seed_overrides.split(",") if p)
    pinn_results = []
    for i, mesh_size in enumerate(common.MESH_SIZES):
        if mesh_size not in args.mesh_sizes:
            continue
        layers, epochs, patience, lr = schedule(args, i)
        mesh = apt.create_mesh(mesh_size, domain_size=common.DOMAIN_SIZE)
        mesh_data = apt.MeshData(mesh, domain, nt=common.N_STEPS, device=dev)
        batch_sizes = common.collocation_budget(mesh_data.number_of_segments)
        causal = (args.causal_eps if batch_sizes["pde"] >= CAUSAL_BINS
                  else 0.0)
        print(f"Training for mesh size {mesh_size} ...")

        def run_one(seed):
            model = PINN(layers, problem, domain, activation=args.activation,
                         seed=seed, fourier_features=args.fourier_features,
                         fourier_scale=args.fourier_scale, device=dev)
            start_time = time.time()
            with memory_delta(dev) as mem, \
                    profiler_trace(args.profile_dir or None):
                history = model.train(
                    batch_sizes, epochs, lr, common.LAMBDA_WEIGHTS,
                    early_stopping_patience=patience,
                    restore_best_weights=args.restore_best_weights,
                    adaptive_oversample=args.adaptive_oversample,
                    adaptive_weights_every=args.adaptive_weights_every,
                    causal_eps=causal,
                )
                if args.finetune_lbfgs:
                    history = model.finetune_lbfgs(
                        batch_sizes, args.finetune_lbfgs,
                        common.LAMBDA_WEIGHTS)
            train_time = time.time() - start_time
            errors = model.compute_errors(mesh_data,
                                          problem.analytical_solution)
            return model, history, errors, train_time, mem

        # Best of N seeds: stop at the first convergent seed, keep the
        # best row, count the attempts that diverged (--seed_retries 1 is
        # the reference's single seed).
        base_seed = seed_overrides.get(mesh_size, args.seed)
        retries = max(1, args.seed_retries)
        best = None
        diverged = 0
        for attempt in range(retries):
            seed = base_seed + attempt
            result = run_one(seed) + (seed,)
            rel = result[2][0]
            if best is None or _rank(rel) < _rank(best[2][0]):
                best = result
            if np.isfinite(rel) and rel <= args.diverged_threshold:
                break
            diverged += 1
            if attempt + 1 < retries:
                print(f"  seed {seed} diverged (rel_l2={rel:.3g}); "
                      f"retrying with seed {seed + 1}")
        model, history, errors, train_time, mem, used_seed = best
        rel_l2_error, l2_error, max_error = errors
        model.plot_interpolated_solution(
            10.0, mesh_data, analytical_sol_fn=problem.analytical_solution,
            save_dir=exp_dir, name=f"ms{mesh_size}_pinn")
        model.plot_history(save_dir=exp_dir, name=f"ms{mesh_size}_pinn")

        n_epochs_run = len(history["total_loss"])
        pinn_results.append({
            "mesh_size": mesh_size,
            "n_dofs": mesh_data.number_of_segments,
            "n_boundary_dofs": int(mesh_data.boundary_segments.numel()),
            "rel_l2_error": rel_l2_error,
            "l2_error": l2_error,
            "max_error": max_error,
            "train_time": train_time,
            "final_loss": history["total_loss"][-1],
            "number_of_collocation_points": mesh_data.number_of_segments,
            # The reference's count; the Fourier embedding widens the first
            # dense layer, so then the network's own trainable count.
            "n_parameters": (count_trainable_parameters(model.mlp)
                             if args.fourier_features
                             else count_parameters(layers)),
            "gpu_memory_usage_MB": mem["gpu_memory_usage_MB"],
            "cpu_memory_usage_MB": mem["cpu_memory_usage_MB"],
            "epochs_run": n_epochs_run,
            "epochs_per_sec": n_epochs_run / train_time if train_time else 0.0,
            "seed": used_seed,
            "diverged_seeds": diverged,
        })
        print(f"Mesh size: {mesh_size}")
        print(f"GPU Memory: {mem['gpu_memory_usage_MB']:.2f} MB")
        print(f"CPU Memory: {mem['cpu_memory_usage_MB']:.2f} MB")
        print("-" * 40)
        # The table so far, after each large mesh.
        if mesh_size >= 32:
            write_csv(out, pinn_results)

    write_csv(out, pinn_results)
    for row in pinn_results:
        print(row)
    return pinn_results


if __name__ == "__main__":
    main()
