"""The default solve route past 6M DOFs and its Chebyshev interval, on the
PyTorch + CUDA port.

``python -m airpollution_tpu_torch solve --mesh_size 2049 --nt 1001``
takes 'auto' -> the uniform operator with patch assembly -> the
large-mesh policy (``CRBESolver._apply_large_mesh_solver_policy``, as in
the JAX package), which swaps BiCGStab for Chebyshev with k from the
convergence factor of the interval that ``linalg.power_bounds`` estimates
(48 power iterations at each end). This script measures how the final
state depends on that choice, on kernel B2 (``matvec_impl="fused_hbm"``,
patch assembly, float32, the CLI's default problem, BE):

- the interval's ends from 48 and from ``--long_iters`` power iterations,
  and the Rayleigh quotient of the smoothest mode (cos(pi x / 2L)
  cos(pi y / 2L), zero on the box's walls) of the Jacobi-scaled
  operator, an upper bound on its least eigenvalue;
- rel_l2 against the closed form at T for k in ``--ks``, with and without
  the extrapolated warm start, on each interval;
- with ``--reference``, the float64 uniform scan route with BiCGStab to
  1e-9 (the policy leaves float64 alone): what backward Euler gives on
  this mesh.

Run on the card (one JSON line per row; ``--out`` keeps them):

    python3 scripts/torch_port_large_mesh_policy.py --reference \\
        --out large_mesh_policy.jsonl

or on the CPU at a small size through B2's plain version:

    python3 scripts/torch_port_large_mesh_policy.py --device cpu \\
        --mesh_size 33 --nt 101 --ks 4 8
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.ops import linalg  # noqa: E402
from airpollution_tpu_torch.ops import uniform as uniform_mod  # noqa: E402


def emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def card(device):
    if device.type != "cuda":
        return f"{device} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def scaled_operator(solver):
    """(matvec, scale, family-layout midpoints) of the patch route's
    Jacobi-scaled system, as the applicability check builds it."""
    md = solver.mesh_data
    spec, consts, _, _, diag_c = solver._patch_pieces()
    perm, _ = solver._family_perm_tensors()
    diag = uniform_mod.family_diag_vector(spec, diag_c,
                                          md.boundary_mask[perm])
    return (partial(uniform_mod.uniform_matvec, spec, consts),
            1.0 / torch.sqrt(diag), md.midpoints[perm])


def smooth_rayleigh(matvec, scale, mid, half_width):
    """v.(S A S v) / v.v for v = cos(pi x / 2L) cos(pi y / 2L) on the box
    of half-width L (zero on its walls): >= the least eigenvalue of the
    scaled operator's symmetric part."""
    w = math.pi / (2.0 * half_width)
    v = torch.cos(w * mid[:, 0]) * torch.cos(w * mid[:, 1])
    return float(torch.dot(v, scale * matvec(scale * v)) / torch.dot(v, v))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    p.add_argument("--mesh_size", type=int, default=2049)
    p.add_argument("--nt", type=int, default=1001)
    p.add_argument("--ks", type=int, nargs="+", default=[10, 24, 48])
    p.add_argument("--long_iters", type=int, default=400)
    p.add_argument("--reference", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    device = torch.device(args.device) if args.device else torch.device(
        "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    domain, problem = apt.Domain(), apt.Problem()
    t0 = time.perf_counter()
    md = apt.MeshData(apt.create_mesh(args.mesh_size, 20.0), domain,
                      nt=args.nt, device=device)
    base = dict(matvec_impl="fused_hbm", assembly="patch",
                solver_method="chebyshev", chebyshev_policy="warn",
                device=device)
    probe = CRBESolver(domain, problem, md, **base)
    probe._check_chebyshev_applicable(None, warn=False)
    matvec, scale, mid = scaled_operator(probe)
    example = torch.zeros_like(scale)
    lo, hi = linalg.power_bounds(matvec, example, scale=scale,
                                 iters=args.long_iters)
    intervals = {"default_48": probe._cheb_bounds,
                 f"long_{args.long_iters}": (float(lo), float(hi))}
    emit(args.out, {
        "row": "interval", "card": card(device), "ms": args.mesh_size,
        "nt": args.nt, "dofs": md.number_of_segments,
        "setup_s": time.perf_counter() - t0,
        "intervals": intervals, "factor_default": probe._cheb_factor,
        "policy_k": int(min(24.0, max(8, math.ceil(
            math.log(1e-4) / math.log(max(probe._cheb_factor, 1e-6)))))),
        "smooth_mode_rayleigh": smooth_rayleigh(
            matvec, scale, mid, float(md.points[:, 0].max()))})
    for name, bounds in intervals.items():
        for k in args.ks:
            for ext in (False, True):
                s = CRBESolver(domain, problem, md, chebyshev_iters=k,
                               extrapolate_warm_start=ext,
                               cheb_bounds=bounds, **base)
                s.solve(store_solutions=False)
                rel = s.compute_errors(problem.analytical_solution)[0]
                emit(args.out, {
                    "row": "fused", "interval": name, "k": k,
                    "extrapolate": ext, "rel_l2": rel,
                    "steps_per_s": (args.nt - 1) / s.solve_time})
                del s
    if args.reference:
        del md, probe
        md64 = apt.MeshData(apt.create_mesh(args.mesh_size, 20.0), domain,
                            nt=args.nt, dtype=torch.float64, device=device)
        ref = CRBESolver(domain, problem, md64, matvec_impl="uniform",
                         solver_tol=1e-9, device=device)
        ref.solve(store_solutions=False, collect_iters=True)
        emit(args.out, {
            "row": "reference_f64_bicgstab", "solver_tol": 1e-9,
            "matvec_impl": ref.matvec_impl,
            "assembly": "patch" if ref._use_patch() else "full",
            "mean_iters": sum(ref.solver_iterations)
            / len(ref.solver_iterations),
            "rel_l2": ref.compute_errors(problem.analytical_solution)[0],
            "steps_per_s": (args.nt - 1) / ref.solve_time})


if __name__ == "__main__":
    main()
