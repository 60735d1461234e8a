"""The PINN on the variable-wind ``RotatingPlumeProblem`` on the PyTorch
port, the counterpart of ``scripts/pinn_rotating_demo.py``.

The mesh-free solver trains against the spatially varying residual (v(x,
y) evaluated per collocation point) and is scored against the
rotating plume's closed form at t = T on the mesh's edge midpoints.
Fourier features, causal weighting and a 64 x 4 tanh network, lambda
(10, 1, 1), the mesh-coupled collocation budget (n_col = n_dofs / 1.4,
IC and BC 0.2 n_col), float32, seed 1234. No kernel of the port: the
epoch is PyTorch on the card.

    python3 scripts/torch_port_pinn_rotating_demo.py [--device cpu]
        [--mesh_size 32 --epochs 500] [--out pinn_rotating.csv]

Without --device it runs on the CUDA card and raises without one; the
CSV is written only where --out points.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402

COLUMNS = ["mesh_size", "n_dofs", "n_col", "width", "depth", "fourier",
           "epochs", "lr", "rel_l2", "max_error", "train_time_s",
           "epochs_per_s", "final_loss", "platform"]


def run(mesh_size=32, epochs=16000, lr=2e-3, width=64, depth=4, fourier=64,
        device=None, dtype=torch.float32):
    """The demo's row (the CSV's fields, unrounded) with the loss
    ``history``."""
    domain = apt.Domain()
    problem = apt.RotatingPlumeProblem()  # omega=0.1, D=0.05, puff (5, 0)
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), domain, nt=128,
                      dtype=dtype, device=device)
    n_col = round(md.number_of_segments / 1.4)
    n_ic = round(0.2 * n_col)
    print(f"eval mesh {mesh_size}^2 ({md.number_of_segments} DOFs), "
          f"n_col={n_col}, net {width}x{depth}, fourier={fourier}, "
          f"epochs={epochs}", file=sys.stderr, flush=True)
    layers = [3] + [width] * depth + [1]
    model = PINN(layers, problem, domain, activation="tanh", seed=1234,
                 fourier_features=fourier, dtype=dtype, device=md.device)
    synchronize(md.device)
    t0 = time.perf_counter()
    history = model.train({"pde": n_col, "ic": n_ic, "bc": n_ic},
                          epochs=epochs, lr=lr,
                          lambda_weights={"pde": 10.0, "ic": 1.0, "bc": 1.0},
                          causal_eps=1.0)
    synchronize(md.device)
    train_t = time.perf_counter() - t0
    rel, l2, mx = model.compute_errors(md, problem.analytical_solution)
    print(f"rel_l2={rel:.4f} max={mx:.4e} [{train_t:.1f}s = "
          f"{epochs / train_t:.0f} epochs/s]", file=sys.stderr, flush=True)
    return {"mesh_size": mesh_size, "n_dofs": md.number_of_segments,
            "n_col": n_col, "width": width, "depth": depth,
            "fourier": fourier, "epochs": epochs, "lr": lr, "rel_l2": rel,
            "max_error": mx, "train_time_s": train_t,
            "epochs_per_s": epochs / train_t,
            "final_loss": history["total_loss"][-1],
            "platform": md.device.type, "history": history}


def write_csv(path, row):
    """The JAX script's CSV: one row, its formatting."""
    cells = dict(row)
    cells.update(rel_l2=f"{row['rel_l2']:.6f}",
                 max_error=f"{row['max_error']:.4e}",
                 train_time_s=round(row["train_time_s"], 1),
                 epochs_per_s=round(row["epochs_per_s"], 1),
                 final_loss=f"{row['final_loss']:.3e}")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerow([cells[c] for c in COLUMNS])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=32,
                    help="evaluation grid (collocation budget = ndof/1.4)")
    ap.add_argument("--epochs", type=int, default=16000)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--fourier", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    row = run(args.mesh_size, args.epochs, args.lr, args.width, args.depth,
              args.fourier, args.device)
    if args.out:
        write_csv(args.out, row)
        print(f"wrote {args.out}", file=sys.stderr)
    return row


if __name__ == "__main__":
    main()
