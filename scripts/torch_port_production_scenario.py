"""Production air-quality scenario on the PyTorch + CUDA port.

The combination a real dispersion run needs, in one solve:

- a sheared boundary-layer wind (variable coefficients): the neutral
  surface-layer log profile u = (u*/kappa) ln(1 + z/z0), z the height
  above the bottom wall, crosswind component zero;
- a steady stack emission: a Gaussian source of total rate q near the
  ground, its load built once per solve (ops/loads.EmissionLoads);
- ground surface exchange: a Robin wall at the bottom, pure dry
  deposition ``-D dc/dn = v_d c`` by default, or the bidirectional
  compensation-point model ``-D dc/dn = v_d (c - c_comp)`` (alpha = v_d,
  g = v_d c_comp through the elementwise ``robin_g_xy`` hook, loaded on
  the wall line, ops/loads.RobinFluxLoads); a no-flux lid (alpha = 0) at
  the top and clean-air Dirichlet inflow and outflow left and right;
- Crank-Nicolson with strided snapshots, on the per-step canvas kernel B4
  (``matvec_impl="fused_hbm"``).

The physics check is the lumped-mass budget: d(mass)/dt = q + re-emission
- deposition - outflow. ``budget`` integrates the deposition flux
sum(alpha |e| c) over the snapshots with the trapezoid rule and reports
the closure; the rest is outflow through the Dirichlet walls plus the
trapezoid's error.

The same flags and defaults as scripts/production_scenario.py (the JAX
package's; this script imports no JAX): three runs, 513^2 / 1025^2 /
513^2, nt 1001 / 2001 / 1001, a snapshot every 100 / 200 / 100 steps,
Chebyshev-8, c_comp 0 / 0 / 0.005. Run on the CUDA card:

    python3 scripts/torch_port_production_scenario.py

or on the CPU through the kernels' plain versions at a small size:

    python3 scripts/torch_port_production_scenario.py --device cpu \\
        --mesh_sizes 33 --nt 101 --snapshot_every 10 --iters 8 --c_comp 0
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.mesh.data import boundary_side_masks  # noqa: E402
from airpollution_tpu_torch.models.crbe import (  # noqa: E402
    CRBESolver,
    robin_terms,
)
from airpollution_tpu_torch.problems import AdDifProblem  # noqa: E402


def log(*a):
    print(*a, flush=True)


class BoundaryLayerEmitter(AdDifProblem):
    """Neutral surface-layer wind + steady stack emission + ground
    deposition. y is height above the bottom wall (the "ground")."""

    zero_source = False
    steady_source = True
    variable_coefficients = True

    def __init__(self, ustar=0.2, kappa=0.4, z0=1.0, q=1.0,
                 xs=-10.0, ys=-16.0, sigma_s=1.2, D=0.2, v_d=0.05,
                 c_comp=0.0, ground=-20.0):
        super().__init__(None, D, 0.0)
        self.ustar = ustar
        self.kappa = kappa
        self.z0 = z0
        self.q = q
        self.xs = xs
        self.ys = ys
        self.sigma_s = sigma_s
        self.ground = ground
        self.v_d = v_d
        self.c_comp = c_comp
        self.robin_sides = {"bottom": v_d, "top": 0.0}
        if c_comp:
            # Compensation-point exchange on the ground: g = v_d c_comp
            # (re-emission where the air is cleaner than the surface).
            # Assigned on the instance only when active, so that a
            # pure-deposition run keeps the load-free program.
            def _g(x, y, t, side, _g0=v_d * c_comp):
                x, y = torch.broadcast_tensors(torch.as_tensor(x),
                                               torch.as_tensor(y))
                if side == "bottom":
                    return torch.full_like(x, _g0)
                return torch.zeros_like(x)

            self.robin_g_xy = _g

    def _u(self, y):
        z = torch.clamp(y - self.ground, min=0.0)
        return (self.ustar / self.kappa) * torch.log1p(z / self.z0)

    def velocity_at(self, xy, t=None):
        u = self._u(xy[..., 1])
        return torch.stack([u, torch.zeros_like(u)], dim=-1)

    def initial_condition_fn(self, xy):
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)

    def boundary_fn(self, xyt):
        return torch.zeros_like(xyt[..., 0])

    def source_xy(self, x, y, t):
        r2 = (x - self.xs) ** 2 + (y - self.ys) ** 2
        s2 = self.sigma_s ** 2
        return self.q * torch.exp(-r2 / (2.0 * s2)) / (2.0 * math.pi * s2)

    def source_term(self, xyt):
        return self.source_xy(xyt[..., 0], xyt[..., 1], xyt[..., 2])


def make_solver(ms, nt, every, iters, q=1.0, v_d=0.05, c_comp=0.0, *,
                T=10.0, device=None, dtype=torch.float32, cheb_bounds=None,
                matvec_impl="fused_hbm"):
    """The scenario's CRBESolver on [0, T]: CN, Chebyshev-``iters`` with
    the extrapolated warm start, a snapshot every ``every`` steps, on
    kernel B4 (``matvec_impl="fused_hbm"``; ``"stencil"`` gives the scan
    path)."""
    domain = apt.Domain(T=T)
    problem = BoundaryLayerEmitter(q=q, v_d=v_d, c_comp=c_comp)
    md = apt.MeshData(apt.create_mesh(ms, domain_size=20.0), domain, nt=nt,
                      dtype=dtype, device=device)
    return CRBESolver(domain, problem, md, matvec_impl=matvec_impl,
                      solver_method="chebyshev", chebyshev_iters=iters,
                      time_scheme_order=2, extrapolate_warm_start=True,
                      snapshot_every=every, cheb_bounds=cheb_bounds,
                      device=device)


def budget(solver, U, every):
    """The lumped-mass budget of the (n_rows, n_seg) strided snapshots
    ``U`` (row j at t = j * every * dt), summed in float64 on the host."""
    problem, md = solver.problem, solver.mesh_data
    m = solver._require_ops().mass_diag.detach().cpu().double().numpy()
    Un = U.detach().cpu().double().numpy()
    mass = Un @ m
    _, _, alpha = robin_terms(md, problem)
    dep_rate = Un @ alpha.detach().cpu().double().numpy()
    t_snap = np.arange(U.shape[0]) * every * solver.dt
    emitted = problem.q * t_snap[-1]
    bot = boundary_side_masks(md)["bottom"].cpu().numpy()
    lengths = md.segment_lengths.detach().cpu().double().numpy()
    wall_len = float(lengths[bot].sum())
    reemit_rate = problem.v_d * problem.c_comp * wall_len
    # The trapezoid rule, written out (np.trapezoid needs numpy >= 2).
    deposited = float((np.diff(t_snap) * (dep_rate[1:] + dep_rate[:-1])
                       / 2.0).sum())
    reemitted = reemit_rate * float(t_snap[-1])
    accumulated = float(mass[-1] - mass[0])
    outflow = emitted + reemitted - deposited - accumulated
    return {
        "mass_final": float(mass[-1]),
        "emitted": float(emitted),
        "reemitted": reemitted,
        "accumulated": accumulated,
        "deposited": deposited,
        "outflow_plus_residual": float(outflow),
        "deposited_frac_of_emitted": deposited / emitted,
        "net_surface_uptake": deposited - reemitted,
        "peak_final": float(Un[-1].max()),
        "ground_mean_final": float(Un[-1][bot].mean()),
    }


def run(ms, nt, every, iters, q=1.0, v_d=0.05, c_comp=0.0, warm=True, *,
        device=None, dtype=torch.float32, cheb_bounds=None):
    """One scenario run: a first solve, a warm timed one, and the budget.
    Returns ``(row, solver)``."""
    solver = make_solver(ms, nt, every, iters, q, v_d, c_comp, device=device,
                         dtype=dtype, cheb_bounds=cheb_bounds)
    md = solver.mesh_data
    t0 = time.perf_counter()
    U = solver.solve(store_solutions=True)
    log(f"[{ms}^2] first solve {time.perf_counter() - t0:.1f}s; "
        f"snapshots {tuple(U.shape)}; kernel {solver.fused_kernel}")
    dt_solve = None
    if warm:
        U = solver.solve(store_solutions=True)
        dt_solve = solver.solve_time
        log(f"[{ms}^2] warm solve {dt_solve:.3f}s -> "
            f"{(nt - 1) / dt_solve:.0f} steps/s")
    row = {
        "mesh_size": ms, "n_dofs": int(md.number_of_segments),
        "nt": nt, "snapshot_every": every, "chebyshev_iters": iters,
        "scheme": "crank-nicolson", "q": q, "v_d": v_d, "c_comp": c_comp,
        "device": str(solver.device), "dtype": str(dtype).split(".")[-1],
        "warm_solve_s": dt_solve,
        "steps_per_sec": None if dt_solve is None else (nt - 1) / dt_solve,
    }
    row.update(budget(solver, U, every))
    log(f"[{ms}^2] budget: emitted {row['emitted']:.4f} + re-emitted "
        f"{row['reemitted']:.4f}, accumulated {row['accumulated']:.4f}, "
        f"deposited {row['deposited']:.4f}, outflow+residual "
        f"{row['outflow_plus_residual']:.4f}")
    return row, solver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh_sizes", type=int, nargs="+",
                    default=[513, 1025, 513])
    ap.add_argument("--nt", type=int, nargs="+",
                    default=[1001, 2001, 1001])
    ap.add_argument("--snapshot_every", type=int, nargs="+",
                    default=[100, 200, 100])
    ap.add_argument("--iters", type=int, nargs="+", default=[8, 8, 8])
    # Surface compensation point per run: 0 = pure deposition; the third
    # default run re-emits where ground air is cleaner than the surface.
    ap.add_argument("--c_comp", type=float, nargs="+",
                    default=[0.0, 0.0, 0.005])
    ap.add_argument("--no_warm", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    rows = []
    for ms, nt, every, iters, cc in zip(args.mesh_sizes, args.nt,
                                        args.snapshot_every, args.iters,
                                        args.c_comp, strict=True):
        row, solver = run(ms, nt, every, iters, c_comp=cc,
                          warm=not args.no_warm, device=args.device)
        if solver.device.type == "cuda":
            row["device_name"] = torch.cuda.get_device_name(0)
        rows.append(row)
    for r in rows:
        log(json.dumps(r))


if __name__ == "__main__":
    main()
