"""Stability of the fixed-k, extrapolated Chebyshev solve on C1's problem.

RotatingPlumeProblem(omega, D) on an ms^2 mesh, nt steps over [0, T],
extrapolated warm start, float32. For each Chebyshev count k and scheme
(BE, CN) it runs the fused path (matvec_impl="fused_hbm": kernel B4 on the
card, its plain version on the CPU) and, with ``--scan``, the scan path
(matvec_impl="stencil") on the same interval, and prints one JSON line:
the interval, the skew estimate, the worst-case factor the applicability
check gates on, the diffusion number D dt / h^2, and either the final
rel_l2 or the step at which the divergence guard tripped. ``--jax`` runs
the JAX package's scan path on the same configuration as well (CPU only).

C1 on the card (1025^2, nt=1001, omega=0.05, D=0.3):

    python3 scripts/torch_port_chebyshev_stability.py --scan

The same diffusion number (~2) at 257^2 on the CPU, in both packages:

    JAX_PLATFORMS=cpu python scripts/torch_port_chebyshev_stability.py \\
        --device cpu --ms 257 --nt 401 --T 4 --D 4.8828125 --ks 6 8 \\
        --orders 1 --scan --jax
"""

import argparse
import json
import os
import re
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402


def outcome(solver, problem):
    """rel_l2 of a finished solve, or the step the guard reported."""
    try:
        solver.solve(store_solutions=False)
    except FloatingPointError as e:
        step = re.search(r"step ~(\d+)", str(e))
        return {"diverged_at_step": int(step.group(1)) if step else None}
    return {"rel_l2": solver.compute_errors(problem.analytical_solution)[0]}


def jax_scan(args, order, k):
    import airpollution_tpu as japt
    from airpollution_tpu.models.crbe import CRBESolver
    from airpollution_tpu.problems import RotatingPlumeProblem

    domain = japt.Domain(T=args.T)
    md = japt.MeshData(japt.create_mesh(args.ms, 20.0), domain, nt=args.nt)
    problem = RotatingPlumeProblem(omega=args.omega, D=args.D)
    s = CRBESolver(domain, problem, md, time_scheme_order=order,
                   matvec_impl="stencil", solver_method="chebyshev",
                   chebyshev_iters=k, extrapolate_warm_start=True)
    return dict(outcome(s, problem), factor=s._cheb_factor)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--ms", type=int, default=1025)
    parser.add_argument("--nt", type=int, default=1001)
    parser.add_argument("--T", type=float, default=10.0)
    parser.add_argument("--omega", type=float, default=0.05)
    parser.add_argument("--D", type=float, default=0.3)
    parser.add_argument("--ks", type=int, nargs="*",
                        default=[6, 8, 10, 12, 14])
    parser.add_argument("--orders", type=int, nargs="*", default=[1, 2])
    parser.add_argument("--scan", action="store_true")
    parser.add_argument("--jax", action="store_true")
    args = parser.parse_args()
    warnings.simplefilter("ignore")
    domain = apt.Domain(T=args.T)
    md = apt.MeshData(apt.create_mesh(args.ms, 20.0), domain, nt=args.nt,
                      device=args.device)
    problem = apt.RotatingPlumeProblem(omega=args.omega, D=args.D)
    dt = args.T / (args.nt - 1)
    h = 40.0 / (args.ms - 1)
    for order in args.orders:
        for k in args.ks:
            kw = dict(time_scheme_order=order, solver_method="chebyshev",
                      chebyshev_iters=k, extrapolate_warm_start=True,
                      device=args.device)
            fused = apt.CRBESolver(domain, problem, md,
                                   matvec_impl="fused_hbm", **kw)
            row = {"ms": args.ms, "nt": args.nt, "order": order, "k": k,
                   "diffusion_number": args.D * dt / h ** 2,
                   "fused": outcome(fused, problem),
                   "bounds": fused._cheb_bounds, "skew": fused._cheb_skew,
                   "factor": fused._cheb_factor}
            if args.scan:
                scan = apt.CRBESolver(domain, problem, md,
                                      matvec_impl="stencil",
                                      cheb_bounds=fused._cheb_bounds, **kw)
                row["scan_same_interval"] = outcome(scan, problem)
            if args.jax:
                row["jax_scan"] = jax_scan(args, order, k)
            print(json.dumps(row), flush=True)
    if md.device.type == "cuda":
        import chip_smoke

        print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
