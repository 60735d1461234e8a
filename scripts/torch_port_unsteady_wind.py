"""Quasi-static chunks against a frozen wind on the turning-wind oracle, on
the PyTorch port: the error table of scripts/unsteady_wind_demo.py (the
JAX package's; this script imports no JAX). For each ``reassemble_every``
that divides nt - 1 (nt - 1 itself being the wind frozen at T/2), the
scan chunks (BiCGStab to 1e-11, float64) and rel_l2 against the closed
form at T. Writes the table as CSV.

    python3 scripts/torch_port_unsteady_wind.py --device cpu \\
        --out results/torch_port_unsteady_wind.csv
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.unsteady import (  # noqa: E402
    solve_time_varying,
)

HEADER = ["mesh_size", "n_dofs", "nt", "order", "reassemble_every", "mode",
          "rel_l2", "solve_time_s", "platform"]


def rows(mesh_size, nt, order, device=None):
    """The table's rows, one per reassembly interval."""
    domain = apt.Domain()
    p = apt.TurningWindProblem(speed=1.0, omega_t=0.5, D=0.1)
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), domain, nt=nt,
                      dtype=torch.float64, device=device)
    t_col = torch.full((md.number_of_segments, 1), domain.T,
                       dtype=md.midpoints.dtype, device=md.device)
    ex = p.analytical_solution(torch.cat([md.midpoints, t_col], dim=1))
    n_steps = nt - 1
    out = []
    for k in (k for k in (n_steps, 16, 8, 4, 2, 1) if n_steps % k == 0):
        t0 = time.perf_counter()
        u = solve_time_varying(p, md, reassemble_every=k,
                               time_scheme_order=order, tol=1e-11,
                               maxiter=800, store_solutions=False)
        rel = float(torch.linalg.norm(u[0] - ex) / torch.linalg.norm(ex))
        solve_t = time.perf_counter() - t0
        label = "frozen" if k == n_steps else "chunked"
        out.append([mesh_size, md.number_of_segments, nt, order, k, label,
                    f"{rel:.6f}", round(solve_t, 2), md.device.type])
        print(f"reassemble_every={k:4d} ({label}): rel_l2={rel:.4f} "
              f"[{solve_t:.1f}s]", file=sys.stderr, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh_size", type=int, default=32)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="results/torch_port_unsteady_wind.csv")
    args = ap.parse_args()
    table = rows(args.mesh_size, args.nt, args.order, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(table)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
