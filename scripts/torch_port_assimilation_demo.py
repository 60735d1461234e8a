"""Twin-experiment data assimilation on the PyTorch port: an ensemble
forecast and one stochastic EnKF analysis, the counterpart of
``scripts/assimilation_demo.py``.

A truth run (``CRBESolver(matvec_impl="ell")``, CN, float64; its ELL
products on kernel B7a) is observed at a station network sited where the
plume lives; a wide-prior ensemble of diffusivities is integrated as one
member batch (``diagnostics/ensemble.ensemble_forecast``: every ELL
product one launch of B7a's stacked mode over the members) and pulled
toward the noisy readings by ``enkf_update``. Reports the forecast and
analysis errors of the ensemble mean, the station spread and the Brier
score of the exceedance map. The members, stations and readings are
numpy draws from --seed in the JAX script's order; the EnKF noise comes
from a ``torch.Generator`` seeded from --seed (the JAX script's key).

    python3 scripts/torch_port_assimilation_demo.py [--device cpu]
        [--members 24 --mesh_size 24 --nt 33] [--out enkf.csv]

Without --device it runs on the CUDA card and raises without one; the
CSV is written only where --out points.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import (  # noqa: E402
    enkf_update,
    ensemble_forecast,
)
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402

TAU = 0.02
COLUMNS = ["members", "mesh_size", "nt", "stations", "obs_std",
           "rel_err_forecast_mean", "rel_err_analysis_mean",
           "station_spread_forecast", "station_spread_analysis",
           "brier_forecast", "brier_analysis"]


def run(members=24, mesh_size=24, nt=33, stations=48, obs_std=0.002,
        truth_D=0.25, prior_D=0.18, prior_spread=0.5, seed=1234,
        device=None, mesh=None):
    """The demo's figures as a dict (the CSV's columns, unrounded), with
    the forecast ``members`` and the ``analysis`` as tensors. ``mesh``
    (a ``create_mesh(mesh_size, 20.0)``) skips building the mesh."""
    rng = np.random.default_rng(seed)
    domain = apt.Domain(T=5.0)
    mesh = mesh if mesh is not None else apt.create_mesh(mesh_size, 20.0)
    md = apt.MeshData(mesh, domain, nt=nt, dtype=torch.float64,
                      device=device)

    truth_p = apt.Problem(v=(1.0, 0.5), D=truth_D)
    s = CRBESolver(domain, truth_p, md, time_scheme_order=2,
                   matvec_impl="ell", device=md.device)
    truth = s.solve(store_solutions=False)[0].cpu().numpy()

    Ds = np.exp(rng.normal(np.log(prior_D), prior_spread, members))
    out = ensemble_forecast(
        md, domain, [apt.Problem(v=(1.0, 0.5), D=float(d)) for d in Ds],
        order=2, thresholds=(TAU,))
    X = out["members"]

    # Stations where the plume lives (the JAX script's siting).
    mid = md.midpoints.cpu().numpy()
    center = np.asarray([1.0, 0.5]) * domain.T
    near = np.flatnonzero((np.abs(mid[:, 0] - center[0]) < 8.0)
                          & (np.abs(mid[:, 1] - center[1]) < 8.0))
    sensors = np.sort(rng.choice(near, min(stations, near.size),
                                 replace=False))
    y = truth[sensors] + rng.normal(0.0, obs_std, sensors.shape)
    gen = torch.Generator(device=md.device).manual_seed(seed)
    Xa = enkf_update(X, y, [int(i) for i in sensors], obs_std, gen)

    Xn, Xan = X.cpu().numpy(), Xa.cpu().numpy()
    norm = np.linalg.norm(truth)
    exc_true = (truth > TAU).astype(float)
    res = {
        "members": members, "mesh_size": mesh_size, "nt": nt,
        "stations": stations, "obs_std": obs_std,
        "rel_err_forecast_mean": float(np.linalg.norm(Xn.mean(0) - truth)
                                       / norm),
        "rel_err_analysis_mean": float(np.linalg.norm(Xan.mean(0) - truth)
                                       / norm),
        "station_spread_forecast": float(Xn.std(0)[sensors].mean()),
        "station_spread_analysis": float(Xan.std(0)[sensors].mean()),
        "brier_forecast": float(np.mean(((Xn > TAU).mean(0)
                                         - exc_true) ** 2)),
        "brier_analysis": float(np.mean(((Xan > TAU).mean(0)
                                         - exc_true) ** 2)),
    }
    res.update(sensors=sensors, members_forecast=X, analysis=Xa,
               n_dofs=md.number_of_segments)
    return res


def write_csv(path, res):
    """The JAX script's CSV: one row, its formatting."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerow([res[c] for c in COLUMNS[:5]]
                   + [f"{res[c]:.6f}" for c in COLUMNS[5:]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=24)
    ap.add_argument("--mesh_size", type=int, default=24)
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--stations", type=int, default=48)
    ap.add_argument("--obs_std", type=float, default=0.002)
    ap.add_argument("--truth_D", type=float, default=0.25)
    ap.add_argument("--prior_D", type=float, default=0.18)
    ap.add_argument("--prior_spread", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    res = run(args.members, args.mesh_size, args.nt, args.stations,
              args.obs_std, args.truth_D, args.prior_D, args.prior_spread,
              args.seed, args.device)
    err_f, err_a = res["rel_err_forecast_mean"], res["rel_err_analysis_mean"]
    print(f"forecast mean rel-err {err_f:.6f} -> analysis {err_a:.6f} "
          f"({100 * (1 - err_a / err_f):.1f}% reduction)")
    print(f"station spread {res['station_spread_forecast']:.6f} -> "
          f"{res['station_spread_analysis']:.6f}")
    print(f"Brier score (tau={TAU}) {res['brier_forecast']:.6f} -> "
          f"{res['brier_analysis']:.6f}")
    if args.out:
        write_csv(args.out, res)
        print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
