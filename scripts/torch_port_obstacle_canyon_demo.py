"""Street canyon on the PyTorch port: two solid buildings in a sheared
boundary layer, the counterpart of ``scripts/obstacle_canyon_demo.py``.

One solve carries every term of the urban case (``CanyonEmitter``):

- two buildings rooted at the ground, carved out of the domain by masked
  assembly (their DOFs dead, pinned to exactly 0);
- a sheared log-profile wind u(z) (variable coefficients);
- a steady street-level Gaussian source between the buildings;
- ground dry deposition (a Robin bottom wall), a no-flux lid, clean-air
  Dirichlet inflow and outflow;
- Crank-Nicolson with strided snapshots.

``--matvec_impl stencil`` runs the per-DOF scan (BiCGStab); ``fused_hbm``
runs kernel B4 per step with the dead DOFs masked and the source and the
Robin rows in its load plane (Chebyshev, the extrapolated warm start).
Each row solves the canyon and the flat terrain, and reports the
lumped-mass budget (emitted = accumulated + ground-deposited + facade
and outflow), the street and shadow means, the shielding ratio and the
facade dose. The JAX script's gates stand as they are: a non-finite
solve stops the run (SystemExit), the fused row's k against 2k must stay
below 5e-3, and the solid interiors are reported (exactly 0).

    python3 scripts/torch_port_obstacle_canyon_demo.py [--device cpu]
        [--mesh_sizes 257 --nt 1001 --snapshot_every 100]
        [--matvec_impl fused_hbm] [--out canyon.json]

Without --device it runs on the CUDA card and raises without one. The
rows print as JSON; --write merges them into --out (by default
experimental_results/obstacle_canyon.json).
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.crbe import (  # noqa: E402
    CRBESolver,
    obstacle_masks,
    robin_terms,
)
from airpollution_tpu_torch.problems import AdDifProblem  # noqa: E402

GROUND = -20.0
ROOF = -8.0
# Buildings: (xmin, xmax, ymin, ymax), rooted at the ground; the canyon
# is the gap x in (-4, 4).
BUILDINGS = ((-8.0, -4.0, GROUND, ROOF), (4.0, 8.0, GROUND, ROOF))
DEFAULT_OUT = os.path.join("experimental_results", "obstacle_canyon.json")


def log(*a):
    print(*a, flush=True)


class CanyonEmitter(AdDifProblem):
    """Log-profile cross-canyon wind + street-level source + ground
    deposition; ``buildings=True`` adds the two solid blocks."""

    zero_source = False
    steady_source = True
    variable_coefficients = True

    def __init__(self, buildings=True, ustar=0.3, kappa=0.4, z0=0.5,
                 q=1.0, xs=0.0, ys=-18.0, sigma_s=1.2, D=0.3, v_d=0.02):
        super().__init__(None, D, 0.0)
        self.ustar = ustar
        self.kappa = kappa
        self.z0 = z0
        self.q = q
        self.xs = xs
        self.ys = ys
        self.sigma_s = sigma_s
        self.v_d = v_d
        self.robin_sides = {"bottom": v_d, "top": 0.0}
        if buildings:
            self.obstacles = BUILDINGS

    def velocity_at(self, xy, t=None):
        z = torch.clamp(xy[..., 1] - GROUND, min=0.0)
        u = (self.ustar / self.kappa) * torch.log1p(z / self.z0)
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


def _host(x):
    return x.detach().cpu().double().numpy()


def run(ms, nt, every, warm=True, matvec_impl="stencil", chebyshev_iters=8,
        *, device=None, dtype=torch.float32, cheb_bounds=None,
        mesh_data=None):
    """One row of the demo (both problems) as a dict of the JAX script's
    keys, plus each problem's first-solve seconds and the fused row's
    solvers under ``"solvers"``. ``cheb_bounds``: {"canyon": (lo, hi),
    "flat": ...} for the fused row (default: each solver's estimate; the
    2k solve reuses the k solve's operator and interval). ``mesh_data``
    skips building the mesh data (its domain must be ``Domain()``)."""
    domain = apt.Domain()
    md = mesh_data if mesh_data is not None else apt.MeshData(
        apt.create_mesh(ms, domain_size=20.0), domain, nt=nt, dtype=dtype,
        device=device)
    mids = md.midpoints.cpu().numpy()
    street = mids[:, 1] < GROUND + 3.0  # street-level band z < 3
    canyon = street & (np.abs(mids[:, 0]) < 4.0)
    shadow = street & (mids[:, 0] > 8.0) & (mids[:, 0] < 16.0)
    fused = matvec_impl == "fused_hbm"

    out = {"mesh_size": ms, "n_dofs": int(md.number_of_segments),
           "nt": nt, "snapshot_every": every, "scheme": "crank-nicolson",
           "matvec_impl": matvec_impl,
           "chebyshev_iters": chebyshev_iters if fused else None}
    solvers = {}
    for name, buildings in (("canyon", True), ("flat", False)):
        problem = CanyonEmitter(buildings=buildings)
        kw = dict(matvec_impl=matvec_impl, time_scheme_order=2,
                  extrapolate_warm_start=True, snapshot_every=every,
                  device=md.device)
        if fused:
            kw.update(solver_method="chebyshev",
                      chebyshev_iters=chebyshev_iters,
                      cheb_bounds=(cheb_bounds or {}).get(name))
        solver = CRBESolver(domain, problem, md, **kw)
        solvers[name] = solver
        t0 = time.perf_counter()
        U = solver.solve(store_solutions=True)
        out[f"{name}_first_solve_s"] = time.perf_counter() - t0
        log(f"[{ms}^2 {name}] first solve {out[f'{name}_first_solve_s']:.1f}"
            f"s; snapshots {tuple(U.shape)}")
        if warm:
            U = solver.solve(store_solutions=True)
            out[f"{name}_warm_solve_s"] = solver.solve_time
            out[f"{name}_steps_per_sec"] = (nt - 1) / solver.solve_time
            log(f"[{ms}^2 {name}] warm {solver.solve_time:.3f}s -> "
                f"{(nt - 1) / solver.solve_time:.0f} steps/s")
        Un = _host(U)
        if not np.isfinite(Un).all():
            raise SystemExit(
                f"[{ms}^2 {name}] solve diverged (NaN) — rerun with more "
                f"time steps (balanced dt) or more chebyshev_iters")

        m = _host(solver.global_mass_diag)
        _, _, alpha = robin_terms(md, problem)
        alpha = _host(alpha)
        t_snap = np.arange(U.shape[0]) * every * solver.dt
        if buildings:
            _, dead = obstacle_masks(md, problem)
            dead = dead.cpu().numpy()
            out["solid_max_abs"] = float(np.abs(Un[:, dead]).max())
            # Exclude the identity rows' unit mass from the budget.
            m = np.where(dead, 0.0, m)
        if fused and name == "canyon":
            # The iteration-adequacy check: a 2k rerun of the final state.
            s2k = CRBESolver(domain, problem, md, **{
                **kw, "chebyshev_iters": 2 * chebyshev_iters,
                "snapshot_every": None, "cheb_bounds": solver._cheb_bounds})
            s2k.set_operators(solver._require_ops())
            W = _host(s2k.solve(store_solutions=False))[0]
            d2k = float(np.abs(Un[-1] - W).max() / np.abs(W).max())
            out["k_vs_2k_rel_maxdiff"] = d2k
            solvers["canyon_2k"] = s2k
            log(f"[{ms}^2] k={chebyshev_iters} vs 2k rel maxdiff {d2k:.2e}")
            assert d2k < 5e-3, d2k

        mass = Un @ m
        dep = Un @ alpha
        emitted = problem.q * float(t_snap[-1])
        # The trapezoid rule, written out (np.trapezoid needs numpy >= 2).
        deposited = float((np.diff(t_snap) * (dep[1:] + dep[:-1])
                           / 2.0).sum())
        accumulated = float(mass[-1] - mass[0])
        out[f"{name}_emitted"] = emitted
        out[f"{name}_accumulated"] = accumulated
        out[f"{name}_ground_deposited"] = deposited
        out[f"{name}_facade_plus_outflow"] = emitted - deposited - accumulated
        out[f"{name}_street_canyon_mean"] = float(Un[-1][canyon].mean())
        out[f"{name}_shadow_mean"] = float(Un[-1][shadow].mean())
        log(f"[{ms}^2 {name}] budget: emitted {emitted:.4f} = accumulated "
            f"{accumulated:.4f} + ground-dep {deposited:.4f} + "
            f"facade/outflow {out[f'{name}_facade_plus_outflow']:.4f}; "
            f"canyon mean {out[f'{name}_street_canyon_mean']:.4f}, shadow "
            f"mean {out[f'{name}_shadow_mean']:.4f}")

    # Shadow shielding, floored at 1e-4 of the flat value.
    out["shadow_shielding_ratio"] = (
        out["flat_shadow_mean"]
        / max(out["canyon_shadow_mean"], 1e-4 * out["flat_shadow_mean"]))
    # Facade dose beyond the flat run's plain outflow.
    out["facade_dose_frac"] = max(
        0.0, (out["canyon_facade_plus_outflow"]
              - out["flat_facade_plus_outflow"]) / out["canyon_emitted"])
    log(f"[{ms}^2] downwind shielding x{out['shadow_shielding_ratio']:.0f}"
        f", facade dose ~{100 * out['facade_dose_frac']:.0f}% of emissions")
    out["solvers"] = solvers
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_sizes", type=int, nargs="+", default=[257])
    ap.add_argument("--nt", type=int, nargs="+", default=[1001])
    ap.add_argument("--snapshot_every", type=int, nargs="+", default=[100])
    ap.add_argument("--matvec_impl", default="stencil",
                    choices=("stencil", "ell", "fused_hbm"),
                    help="fused_hbm = kernel B4 per step (Chebyshev)")
    ap.add_argument("--chebyshev_iters", type=int, default=8)
    ap.add_argument("--no_warm", action="store_true")
    ap.add_argument("--write", action="store_true",
                    help="merge the rows into --out")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    args = ap.parse_args(argv)
    rows = []
    for ms, nt, ev in zip(args.mesh_sizes, args.nt, args.snapshot_every,
                          strict=True):
        row = run(ms, nt, ev, warm=not args.no_warm,
                  matvec_impl=args.matvec_impl,
                  chebyshev_iters=args.chebyshev_iters, device=args.device)
        row.pop("solvers")
        rows.append(row)
        log(json.dumps(row))
    if args.write:
        old = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                old = json.load(f)

        def key(r):
            return (r["mesh_size"], r.get("matvec_impl", "stencil"))

        merged = {key(r): r for r in old}
        merged.update({key(r): r for r in rows})
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(sorted(merged.values(),
                             key=lambda r: (r["mesh_size"],
                                            r.get("matvec_impl", ""))),
                      f, indent=1)
        log(f"wrote {os.path.abspath(args.out)}")
    return rows


if __name__ == "__main__":
    main()
