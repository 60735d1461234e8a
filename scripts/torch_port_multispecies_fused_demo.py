"""Fused multispecies chemistry-transport at scale on the PyTorch port:
the counterpart of ``scripts/multispecies_fused_demo.py``.

A K-species decay chain A1 -> A2 -> ... -> AK whose first species is
emitted by a steady Gaussian source (sources break the exact 'commute'
factorization, so every step interleaves the chemistry with K implicit
transport solves), on ``MultiSpeciesSolver(matvec_impl="fused_hbm",
splitting="strang")``: one launch of kernel B6 per step with the (K, K)
chemistry mixes applied in the kernel (``fuse_chemistry=True``), or K
launches of kernel B4 with the chemistry in PyTorch
(``fuse_chemistry=False``, the per-row A/B).

Per mesh size: warm steps/s, the chain masses, the k-vs-2k iteration
check (< 5e-3), the same-k fuse A/B (< 5e-3), and below
--scan_check_below the stencil scan's cross-check (< 5e-3). The 2k and
the unfused solves reuse the fused solve's operator and Chebyshev
interval (what each would estimate again). There is no compile on the
card: a warm solve is timed by the solver's own clock (``solve_time``,
the time loop alone, synchronised), after a first solve that includes
assembly and the interval estimate; the solvers on the fused solve's
operator and interval have nothing to set up, and their one solve is
the timed one. --oracle re-solves in float64 on the
stencil scan with tight BiCGStab (on the CPU with --device cpu) and
gives the masses each row is held to. --sweep_K runs the chain lengths
given at every --mesh_sizes entry.

    python3 scripts/torch_port_multispecies_fused_demo.py [--device cpu]
        [--mesh_sizes 257 513 1025 --nt 1001 2001 4001
         --chebyshev_iters 6 8 8] [--sweep_K 6 8] [--oracle] [--write]

Without --device it runs on the CUDA card and raises without one. Rows
print as JSON; --write merges them into --out (by default
experimental_results/multispecies_fused.json; the K sweep's into
--k_out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.multispecies import (  # noqa: E402
    MultiSpeciesSolver,
)

DEFAULT_OUT = os.path.join("experimental_results", "multispecies_fused.json")
DEFAULT_K_OUT = os.path.join("experimental_results",
                             "multispecies_K_sweep.json")
ORACLE_KEYS = ("mass_oracle_A", "mass_oracle_B", "mass_oracle_C")


def log(*a):
    print(*a, flush=True)


def chain_R(K):
    """The chain's (K, K) rates: 0.4 and 0.2 for K = 3, then
    0.2 * 0.85^i (no rate for K = 1)."""
    rates = [0.4, 0.2][:K - 1] + [0.2 * 0.85 ** i
                                  for i in range(1, K - 2 + 1)][:max(0, K - 3)]
    R = np.zeros((K, K))
    for i, r in enumerate(rates):
        R[i, i] += r
        R[i + 1, i] -= r
    return R


class CleanSpecies(apt.Problem):
    """A downstream species: zero initial and boundary values, so that
    everything it holds came through the chain."""

    def initial_condition_fn(self, xy):
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)

    def boundary_fn(self, xyt):
        return torch.zeros_like(xyt[..., 0])


def make_problem(K=3):
    """The K-species chain, species 1 emitted by a Gaussian source; all
    with v = (1, 0.2), D = 0.3."""
    if K < 2:
        raise ValueError("chain needs K >= 2")
    R = chain_R(K)
    src = apt.GaussianSourceProblem(q=2.0, xs=-6.0, ys=0.0, sigma_s=1.5,
                                    v=(1.0, 0.2), D=0.3)
    others = [CleanSpecies(v=(1.0, 0.2), D=0.3, sigma=1.0)
              for _ in range(K - 1)]
    return apt.MultiSpeciesProblem((src, *others), R)


def _solver(domain, msp, md, iters, fuse_chemistry=True, impl="fused_hbm",
            **kw):
    return MultiSpeciesSolver(domain, msp, md, time_scheme_order=2,
                              matvec_impl=impl, splitting="strang",
                              solver_method="chebyshev",
                              chebyshev_iters=iters,
                              fuse_chemistry=fuse_chemistry,
                              device=md.device, **kw)


def sharing(solver, **kw):
    """A solver built by ``kw`` on ``solver``'s operator."""
    other = _solver(**kw)
    other.set_operators(solver._require_ops())
    return other


def _timed_warm(solver, nt, label, first=True):
    """A first solve (assembly, interval, run), then a warm one timed by
    the solver's own clock. ``first=False`` for a solver on another's
    operator and interval, which has nothing to set up: its one solve is
    the timed one. Returns the final state and the warm seconds."""
    if first:
        t0 = time.perf_counter()
        solver.solve(store_solutions=False)
        log(f"[{label}] first solve {time.perf_counter() - t0:.1f}s")
    U = solver.solve(store_solutions=False)
    dt = solver.solve_time
    log(f"[{label}] warm {dt:.3f}s -> {(nt - 1) / dt:.0f} steps/s")
    return U, dt


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def run(ms, nt, iters, scan_check, fuse_chemistry=True, ab=True, warm=True,
        K=3, *, device=None, dtype=torch.float32, cheb_bounds=None,
        scan_on_fused_interval=False, mesh_data=None):
    """One row as a dict of the JAX script's keys, with the row's solvers
    under ``"solvers"``. ``cheb_bounds`` fixes the fused solve's interval
    (default: its estimate); ``scan_on_fused_interval`` runs the scan
    cross-check on the fused solve's operator and interval (default: its
    own estimate, as the JAX script). ``mesh_data`` skips building the
    mesh data (``Domain()``, nt equal to ``nt``)."""
    domain = apt.Domain()
    md = mesh_data if mesh_data is not None else apt.MeshData(
        apt.create_mesh(ms, domain.Lx), domain, nt=nt, dtype=dtype,
        device=device)
    msp = make_problem(K)
    out = {"mesh_size": ms, "n_dofs": int(md.number_of_segments),
           "n_species": K, "nt": nt, "chebyshev_iters": iters,
           "scheme": "crank-nicolson",
           "chemistry": "kernel" if fuse_chemistry else "jax"}
    base = dict(domain=domain, msp=msp, md=md)

    fused = _solver(**base, iters=iters, fuse_chemistry=fuse_chemistry,
                    cheb_bounds=cheb_bounds)
    solvers = {"fused": fused}
    if warm:
        U, dt_f = _timed_warm(fused, nt, f"{ms}^2 fused")
        out["fused_warm_solve_s"] = dt_f
        out["fused_steps_per_sec"] = (nt - 1) / dt_f
    else:
        U = fused.solve(store_solutions=False)
    U = U[0].clone()
    if not bool(torch.isfinite(U).all()):
        raise AssertionError("fused solve diverged")
    bounds = fused._fused_bounds_cache[1]
    m = fused._require_ops().mass_diag.double()
    masses = (U.double() * m).sum(-1).cpu().tolist()
    if K == 3:
        out["mass_A"], out["mass_B"], out["mass_C"] = masses
    out["masses"] = masses
    log(f"[{ms}^2 K={K}] chain masses = "
        + "/".join(f"{x:.4f}" for x in masses))

    # The iteration-adequacy check: a 2k rerun of the same row.
    fused2k = sharing(fused, **base, iters=2 * iters,
                      fuse_chemistry=fuse_chemistry, cheb_bounds=bounds)
    solvers["fused_2k"] = fused2k
    W = fused2k.solve(store_solutions=False)[0]
    out["k_vs_2k_rel_maxdiff"] = d2k = _rel(U, W)
    log(f"[{ms}^2] k={iters} vs 2k={2 * iters} rel maxdiff {d2k:.2e}")
    assert d2k < 5e-3, d2k

    if ab and fuse_chemistry and warm:
        # The same-k fuse on/off A/B: K B4 launches per step with the
        # chemistry in PyTorch, an independent path to the same result.
        unf = sharing(fused, **base, iters=iters, fuse_chemistry=False,
                      cheb_bounds=bounds)
        solvers["unfused"] = unf
        V, dt_u = _timed_warm(unf, nt, f"{ms}^2 unfused-chem", first=False)
        out["unfused_warm_solve_s"] = dt_u
        out["unfused_steps_per_sec"] = (nt - 1) / dt_u
        out["fuse_chemistry_speedup"] = dt_u / out["fused_warm_solve_s"]
        out["fused_vs_unfused_rel_maxdiff"] = dab = _rel(U, V[0])
        log(f"[{ms}^2] fuse A/B at k={iters}: "
            f"{out['fuse_chemistry_speedup']:.2f}x, rel maxdiff {dab:.2e}")
        assert dab < 5e-3, dab

    if scan_check:
        kw = dict(**base, iters=iters, impl="stencil")
        if scan_on_fused_interval:
            scan = sharing(fused, **kw, cheb_bounds=bounds)
        else:
            scan = _solver(**kw)
        solvers["scan"] = scan
        if warm:
            V, dt_s = _timed_warm(scan, nt, f"{ms}^2 scan",
                                  first=not scan_on_fused_interval)
            out["scan_warm_solve_s"] = dt_s
            out["scan_steps_per_sec"] = (nt - 1) / dt_s
            out["fused_speedup_vs_scan"] = dt_s / out["fused_warm_solve_s"]
        else:
            V = scan.solve(store_solutions=False)
        out["fused_vs_scan_rel_maxdiff"] = diff = _rel(U, V[0])
        log(f"[{ms}^2] fused vs scan rel maxdiff {diff:.2e}")
        # Both sides run fixed-k Chebyshev against a sourced field; this
        # is the at-scale divergence guard.
        assert diff < 5e-3, diff
    out["solvers"] = solvers
    return out


def run_oracle(ms, nt, *, device=None):
    """Float64 masses of the K = 3 chain: the stencil scan, tight
    BiCGStab, CN."""
    domain = apt.Domain()
    md = apt.MeshData(apt.create_mesh(ms, domain.Lx), domain, nt=nt,
                      dtype=torch.float64, device=device)
    solver = MultiSpeciesSolver(domain, make_problem(), md,
                                time_scheme_order=2, matvec_impl="stencil",
                                splitting="strang", solver_method="bicgstab",
                                device=md.device)
    t0 = time.perf_counter()
    U = solver.solve(store_solutions=False)[0]
    log(f"[{ms}^2 oracle] f64 solve {time.perf_counter() - t0:.1f}s")
    m = solver._require_ops().mass_diag
    masses = (U * m).sum(-1).cpu().tolist()
    log(f"[{ms}^2 oracle] masses A/B/C = " + "/".join(f"{x:.6f}"
                                                      for x in masses))
    return dict(zip(ORACLE_KEYS, masses))


def oracle_rel(row):
    """max relative mass gap of ``row`` to its oracle masses, or None."""
    if not all(k in row for k in ORACLE_KEYS) or "mass_A" not in row:
        return None
    return max(abs(row[f"mass_{s}"] - row[f"mass_oracle_{s}"])
               / abs(row[f"mass_oracle_{s}"]) for s in "ABC")


def merge_rows(path, rows, key, annotate=False):
    """Merge ``rows`` into the JSON list at ``path`` by ``key``: a
    measured row replaces its old one (keeping only the old oracle
    masses, the relative gap recomputed); with ``annotate`` the new keys
    are added to the old row."""
    old = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    merged = {key(r): r for r in old}
    for row in rows:
        prev = merged.get(key(row), {})
        if annotate:
            new = {**prev, **row}
        else:
            new = {**{k: prev[k] for k in ORACLE_KEYS if k in prev}, **row}
        new.pop("mass_vs_f64_oracle_rel", None)
        if oracle_rel(new) is not None:
            new["mass_vs_f64_oracle_rel"] = oracle_rel(new)
        merged[key(row)] = new
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump([merged[k] for k in sorted(merged)], f, indent=1)
    log(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_sizes", type=int, nargs="+",
                    default=[257, 513, 1025])
    ap.add_argument("--nt", type=int, nargs="+",
                    default=[1001, 2001, 4001])
    ap.add_argument("--chebyshev_iters", type=int, nargs="+",
                    default=[6, 8, 8],
                    help="per-size k (a single value broadcasts)")
    ap.add_argument("--scan_check_below", type=int, default=600)
    ap.add_argument("--no_warm", action="store_true")
    ap.add_argument("--no_ab", action="store_true",
                    help="skip the same-k fuse_chemistry=False baseline")
    ap.add_argument("--write", action="store_true",
                    help="merge the rows into --out (--k_out)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--k_out", default=DEFAULT_K_OUT)
    ap.add_argument("--chemistry", choices=["kernel", "jax"],
                    default="kernel",
                    help="'kernel': one B6 launch per step; 'jax' (the JAX "
                    "script's name): K B4 launches with the chemistry "
                    "outside the kernel, in PyTorch")
    ap.add_argument("--oracle", action="store_true",
                    help="the float64 stencil-scan masses of each size")
    ap.add_argument("--sweep_K", type=int, nargs="+", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    args = ap.parse_args(argv)
    iters = args.chebyshev_iters
    if len(iters) == 1:
        iters = iters * len(args.mesh_sizes)
    fuse = args.chemistry == "kernel"
    rows = []
    for ms, nt, k in zip(args.mesh_sizes, args.nt, iters, strict=True):
        if args.sweep_K:
            for K in args.sweep_K:
                row = run(ms, nt, k, scan_check=False, K=K,
                          fuse_chemistry=fuse, ab=not args.no_ab,
                          warm=not args.no_warm, device=args.device)
                row.pop("solvers")
                rows.append(row)
        elif args.oracle:
            rows.append({"mesh_size": ms,
                         **run_oracle(ms, nt, device=args.device)})
        else:
            row = run(ms, nt, k, scan_check=ms < args.scan_check_below,
                      fuse_chemistry=fuse, ab=not args.no_ab,
                      warm=not args.no_warm, device=args.device)
            row.pop("solvers")
            rows.append(row)
    for r in rows:
        log(json.dumps(r))
    if args.write and args.sweep_K:
        merge_rows(args.k_out, rows,
                   lambda r: (r["mesh_size"], r["n_species"]))
    elif args.write:
        merge_rows(args.out, rows, lambda r: r["mesh_size"],
                   annotate=args.oracle)
    return rows


if __name__ == "__main__":
    main()
