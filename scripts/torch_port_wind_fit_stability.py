#!/usr/bin/env python3
"""Where the differentiable fused engine's Chebyshev solve holds for the
rotating plume that ``inverse.fit_wind`` fits: forward solves of
``RotatingPlumeProblem(omega, D)`` (sigma 1.5, puff at (5, 0)) through
``inverse.solve_final_state(engine="fused_hbm")`` at each rate, with
max|u| at T, rel_l2 against the closed form, and the two numbers that set
the Chebyshev polynomial's reach: the corner Courant number
``dt omega r_max / h`` (r_max the box's half-diagonal) and ``D dt / h^2``.

    python3 scripts/torch_port_wind_fit_stability.py            # 513^2, the card
    python3 scripts/torch_port_wind_fit_stability.py --device cpu \\
        --mesh_size 257 --nt 64 --D 0.16     # the same two numbers, the CPU

Prints one JSON line per rate (and the card's name and power limit on a
GPU). Writes no file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse  # noqa: E402


def run(mesh_size=513, nt=128, D=0.08, omegas=(0.05, 0.1, 0.12, 0.15),
        chebyshev_iters=12, device=None, dtype=torch.float32):
    """One row per rate: the solve's max|u| and rel_l2 at T."""
    domain = apt.Domain()
    md = apt.MeshData(apt.create_mesh(mesh_size, domain.Lx), domain, nt=nt,
                      dtype=dtype, device=device)
    dt = float(domain.T) / (nt - 1)
    h = 2.0 * domain.Lx / (mesh_size - 1)
    t_col = torch.full((md.number_of_segments, 1), float(domain.T),
                       dtype=md.dtype, device=md.device)
    xyt = torch.cat([md.midpoints, t_col], dim=1)
    rows = []
    for om in omegas:
        p = apt.RotatingPlumeProblem(omega=om, D=D, sigma=1.5, x0=5.0,
                                     y0=0.0)
        with torch.no_grad():
            u = inverse.solve_final_state(p, md, engine="fused_hbm",
                                          chebyshev_iters=chebyshev_iters)
        exact = p.analytical_solution(xyt)
        rows.append({
            "mesh_size": mesh_size, "nt": nt, "D": D, "omega": om,
            "k": chebyshev_iters, "dtype": str(dtype).split(".")[-1],
            "corner_courant": dt * om * math.sqrt(2.0) * domain.Lx / h,
            "diffusion_number": D * dt / h ** 2,
            "max_abs_u": float(u.abs().max()),
            "rel_l2": float(torch.linalg.norm(u - exact)
                            / torch.linalg.norm(exact)),
            "platform": md.device.type})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=513)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--D", type=float, default=0.08)
    ap.add_argument("--omegas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.12, 0.15])
    ap.add_argument("--chebyshev_iters", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card by default")
    args = ap.parse_args(argv)
    rows = run(args.mesh_size, args.nt, args.D, tuple(args.omegas),
               args.chebyshev_iters, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    if rows and rows[0]["platform"] == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
