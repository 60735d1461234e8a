"""Ensemble forecast demo of the PyTorch port: exceedance probabilities
under uncertain transport parameters, the counterpart of
``scripts/ensemble_demo.py``.

Integrates a K-member ensemble of Gaussian-plume problems with perturbed
wind and eddy diffusivity (lognormal D around 0.1 with sigma 0.3,
Gaussian v around (1.0, 0.5) with sigma 0.15, drawn with numpy from
--seed exactly as the JAX script draws them) as one member batch
(``diagnostics/ensemble.ensemble_forecast``: CN, every member's ELL
products in one launch of kernel B7 on the card), float64, and checks the
products against the closed form: each member has an exact solution, so
the true ensemble mean and exceedance maps are known. Reports the
FEM-against-analytic discrepancy and the wall time of the batched solve
(first and warm call) against a sequential loop of serial
``CRBESolver(matvec_impl="ell")`` solves (--sequential members of it;
all by default).

    python3 scripts/torch_port_ensemble_demo.py [--device cpu]
        [--members 64 --mesh_size 64 --nt 129] [--out ensemble.csv]

Without --device it runs on the CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.diagnostics import ensemble_forecast  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402

THRESHOLDS = (0.01, 0.03, 0.06)
COLUMNS = ["members", "mesh_size", "nt", "threshold", "fem_exceedance_mean",
           "analytic_exceedance_mean", "max_prob_disagreement",
           "ensemble_mean_rel_l2", "t_batched_warm_s", "t_sequential_s",
           "speedup"]


def setup(members=32, mesh_size=32, nt=65, seed=1234, device=None):
    """The demo's domain, float64 mesh data and member problems, drawn
    from ``seed``."""
    rng = np.random.default_rng(seed)
    domain = apt.Domain(T=5.0)
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), domain, nt=nt,
                      dtype=torch.float64, device=device)
    Ds = np.exp(rng.normal(np.log(0.1), 0.3, members))
    Vs = rng.normal([1.0, 0.5], 0.15, (members, 2))
    problems = [apt.Problem(v=tuple(v), D=float(d)) for v, d in zip(Vs, Ds)]
    return domain, md, problems


def time_sequential(domain, md, problems):
    """Seconds of serial ``CRBESolver(matvec_impl="ell")`` solves of
    ``problems``, one after another, after one warm-up solve."""
    CRBESolver(domain, problems[0], md, time_scheme_order=2,
               matvec_impl="ell", device=md.device).solve(
        store_solutions=False)
    synchronize(md.device)
    t0 = time.perf_counter()
    for p in problems:
        CRBESolver(domain, p, md, time_scheme_order=2, matvec_impl="ell",
                   device=md.device).solve(store_solutions=False)
    synchronize(md.device)
    return time.perf_counter() - t0


def run(members=32, mesh_size=32, nt=65, seed=1234, sequential=None,
        device=None):
    """The demo's measurements as a dict: ``rows`` (one per threshold),
    ``ensemble_mean_rel_l2``, the batched times (``t_batched_s``, first
    call; ``t_batched_warm_s``), ``t_sequential_s`` over
    ``n_sequential`` serial solves (``sequential``, default all), the
    per-member seconds of both, and the output of the warm call."""
    domain, md, problems = setup(members, mesh_size, nt, seed, device)
    times = []
    for _ in range(2):  # first call, then the warm one
        synchronize(md.device)
        t0 = time.perf_counter()
        out = ensemble_forecast(md, domain, problems, order=2,
                                thresholds=THRESHOLDS)
        synchronize(md.device)
        times.append(time.perf_counter() - t0)

    n_seq = members if sequential is None else min(int(sequential), members)
    t_seq = time_sequential(domain, md, problems[:n_seq]) if n_seq else 0.0

    xyt = torch.cat([md.midpoints,
                     torch.full((md.number_of_segments, 1), domain.T,
                                dtype=md.midpoints.dtype,
                                device=md.device)], dim=1)
    exact = torch.stack([p.analytical_solution(xyt) for p in problems])
    mean_err = float(torch.linalg.norm(out["mean"] - exact.mean(0))
                     / torch.linalg.norm(exact.mean(0)))
    rows = []
    for i, tau in enumerate(THRESHOLDS):
        exc_fem = out["exceedance"][i]
        exc_true = (exact > tau).to(exact.dtype).mean(0)
        rows.append({
            "threshold": tau,
            "fem_exceedance_mean": float(exc_fem.mean()),
            "analytic_exceedance_mean": float(exc_true.mean()),
            "max_prob_disagreement": float((exc_fem - exc_true).abs().max()),
        })
    return {
        "members": members, "mesh_size": mesh_size, "nt": nt,
        "n_dofs": md.number_of_segments, "rows": rows,
        "ensemble_mean_rel_l2": mean_err, "t_batched_s": times[0],
        "t_batched_warm_s": times[1],
        "s_per_member_batched": times[1] / members,
        "n_sequential": n_seq, "t_sequential_s": t_seq,
        "s_per_member_sequential": t_seq / n_seq if n_seq else None,
        "out": out,
    }


def write_csv(path, res):
    """The JAX script's CSV: one row per threshold. ``t_sequential_s``
    is the whole member loop's, extrapolated from its measured members
    when --sequential ran fewer (the speedup likewise)."""
    t_seq = res["t_sequential_s"] * res["members"] / max(res["n_sequential"],
                                                         1)
    warm = res["t_batched_warm_s"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        for r in res["rows"]:
            w.writerow([res["members"], res["mesh_size"], res["nt"],
                        r["threshold"], f"{r['fem_exceedance_mean']:.6f}",
                        f"{r['analytic_exceedance_mean']:.6f}",
                        f"{r['max_prob_disagreement']:.6f}",
                        f"{res['ensemble_mean_rel_l2']:.6f}", f"{warm:.3f}",
                        f"{t_seq:.3f}", f"{t_seq / warm:.2f}"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=32)
    ap.add_argument("--mesh_size", type=int, default=32)
    ap.add_argument("--nt", type=int, default=65)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--sequential", type=int, default=None,
                    help="members of the sequential loop (default all)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    res = run(args.members, args.mesh_size, args.nt, args.seed,
              args.sequential, args.device)
    print(f"ensemble of {args.members}: mean-field rel-L2 vs analytic "
          f"ensemble {res['ensemble_mean_rel_l2']:.6f}")
    for r in res["rows"]:
        print(f"  tau={r['threshold']}: P_exc fem "
              f"{r['fem_exceedance_mean']:.6f} vs analytic "
              f"{r['analytic_exceedance_mean']:.6f} (max pointwise prob "
              f"diff {r['max_prob_disagreement']:.6f})")
    print(f"batched warm {res['t_batched_warm_s']:.3f} s "
          f"({res['s_per_member_batched']:.4f} s a member; first call "
          f"{res['t_batched_s']:.3f} s); sequential "
          f"{res['t_sequential_s']:.3f} s over {res['n_sequential']} members")
    if args.out:
        write_csv(args.out, res)
        print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
