"""h-refinement convergence of the CRBE solver on a variable-wind problem
on the PyTorch port, the counterpart of ``scripts/rotating_convergence.py``.

``RotatingPlumeProblem`` (rigid rotation, omega 0.1, D 0.05: a closed
form, since rotation commutes with diffusion) or the strongly
anisotropic ``AnisotropicPlumeProblem(Dx=0.2, Dy=0.02)``, in float64,
backward Euler and Crank-Nicolson, BiCGStab to 1e-11 on the default
route: rel_l2 and max error against the closed form per mesh size, and
the observed L2 rate between consecutive sizes.

    python3 scripts/torch_port_rotating_convergence.py [--device cpu]
        [--mesh_sizes 8 16 32 64 128] [--problem rotating|anisotropic]
        [--out convergence.csv]

Without --device it runs on the CUDA card and raises without one; the
CSV is written only where --out points.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402

COLUMNS = ["time_scheme_order", "mesh_size", "n_dofs", "nt", "h", "rel_l2",
           "max_error", "l2_rate", "solve_time_s", "platform"]


def make_problem(name):
    if name == "rotating":
        return apt.RotatingPlumeProblem()  # omega=0.1, D=0.05, puff (5, 0)
    # Strongly anisotropic: along-wind 10x the cross-wind mixing.
    return apt.AnisotropicPlumeProblem(Dx=0.2, Dy=0.02)


def run(mesh_sizes=(8, 16, 32, 64, 128), nt=128, problem="rotating",
        device=None):
    """One row per (order, mesh size): a dict of the CSV's columns,
    unrounded."""
    domain = apt.Domain()
    p = make_problem(problem)
    rows = []
    for order in (1, 2):
        errs, hs = [], []
        for ms in mesh_sizes:
            md = apt.MeshData(apt.create_mesh(ms, 20.0), domain, nt=nt,
                              dtype=torch.float64, device=device)
            s = CRBESolver(domain, p, md, time_scheme_order=order,
                           solver_tol=1e-11, solver_maxiter=800,
                           device=md.device)
            synchronize(md.device)
            t0 = time.perf_counter()
            s.solve(store_solutions=False)
            synchronize(md.device)
            solve_t = time.perf_counter() - t0
            rel, l2, mx = s.compute_errors(p.analytical_solution)
            h = float(md.diameter)
            hs.append(h)
            errs.append(rel)
            rate = (math.log(errs[-2] / errs[-1]) / math.log(hs[-2] / hs[-1])
                    if len(errs) > 1 else float("nan"))
            rows.append({"time_scheme_order": order, "mesh_size": ms,
                         "n_dofs": md.number_of_segments, "nt": nt, "h": h,
                         "rel_l2": rel, "max_error": mx, "l2_rate": rate,
                         "solve_time_s": solve_t,
                         "platform": md.device.type})
            print(f"order={order} ms={ms:4d}: rel_l2={rel:.6f} max={mx:.3e} "
                  f"rate={rate:.3f} [{solve_t:.2f}s]", file=sys.stderr,
                  flush=True)
    return rows


def write_csv(path, rows):
    """The JAX script's CSV and its rounding."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        for r in rows:
            rate = r["l2_rate"]
            w.writerow([r["time_scheme_order"], r["mesh_size"], r["n_dofs"],
                        r["nt"], round(r["h"], 5), f"{r['rel_l2']:.6f}",
                        f"{r['max_error']:.3e}",
                        round(rate, 3) if rate == rate else "",
                        round(r["solve_time_s"], 2), r["platform"]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_sizes", type=int, nargs="*",
                    default=[8, 16, 32, 64, 128])
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--problem", default="rotating",
                    choices=("rotating", "anisotropic"))
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    rows = run(args.mesh_sizes, args.nt, args.problem, args.device)
    if args.out:
        write_csv(args.out, rows)
        print(f"wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
