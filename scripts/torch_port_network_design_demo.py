"""Monitoring-network design on the PyTorch port: greedy EnSRF sensor
placement against random networks, scored by EnKF analysis skill, the
counterpart of ``scripts/network_design_demo.py``.

An uncertain-transport ensemble is forecast as one member batch
(``diagnostics/ensemble.ensemble_forecast``: every ELL product one launch
of kernel B7a's stacked mode over the members); ``place_sensors`` sites
stations greedily where observing the ensemble buys the most expected
variance reduction; each network (the greedy one and --random_trials
random ones per size) then assimilates noisy truth readings through
``enkf_update``, and the analysis-mean errors are compared. The truth is
a serial ``CRBESolver(matvec_impl="ell")`` solve (B7a). float32, as the
JAX script. Members, random networks and readings are numpy draws from
seed 0 in the JAX script's order; the greedy network's EnKF noise comes
from a ``torch.Generator`` seeded 0 and random trial k's from one seeded
k + 1 (the JAX script's keys).

    python3 scripts/torch_port_network_design_demo.py [--device cpu]
        [--mesh_size 24 --sizes 4 8 16 32] [--out network_design.csv]

Without --device it runs on the CUDA card and raises without one; the
CSV is written only where --out points.
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
from airpollution_tpu_torch.diagnostics import (  # noqa: E402
    enkf_update,
    ensemble_forecast,
    place_sensors,
)
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402

EXTRA = ["mesh_size", "n_dofs", "members", "obs_std", "platform"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(mesh_size=24, nt=33, members=32, sizes=(4, 8, 16, 32),
        random_trials=5, obs_std=0.002, device=None, dtype=torch.float32,
        mesh=None):
    """The demo's rows (one per network size, the CSV's fields
    unrounded) and its seconds as a dict. ``mesh`` (a
    ``create_mesh(mesh_size, 20.0)``) skips building it."""
    rng = np.random.default_rng(0)
    domain = apt.Domain()
    mesh = mesh if mesh is not None else apt.create_mesh(mesh_size, 20.0)
    md = apt.MeshData(mesh, domain, nt=nt, dtype=dtype, device=device)
    n = md.number_of_segments
    truth = CRBESolver(domain, apt.Problem(v=(1.0, 0.5), D=0.25), md,
                       matvec_impl="ell", device=md.device).solve(
        store_solutions=False)[0].cpu().numpy()

    synchronize(md.device)
    t0 = time.perf_counter()
    probs = [apt.Problem(v=(1.0 + 0.15 * rng.standard_normal(),
                            0.5 + 0.15 * rng.standard_normal()),
                         D=float(np.exp(rng.normal(np.log(0.18), 0.5))))
             for _ in range(members)]
    X = ensemble_forecast(md, domain, probs)["members"]
    synchronize(md.device)
    forecast_s = time.perf_counter() - t0
    log(f"mesh {mesh_size}^2 ({n} DOFs), K={members} forecast: "
        f"{forecast_s:.1f}s")
    err_prior = float(np.linalg.norm(X.cpu().numpy().mean(0) - truth))

    def analysis_err(sensors, seed):
        y = truth[np.asarray(sensors)] + rng.normal(0, obs_std, len(sensors))
        gen = torch.Generator(device=md.device).manual_seed(seed)
        Xa = enkf_update(X, y, [int(i) for i in sensors], obs_std, gen)
        return float(np.linalg.norm(Xa.cpu().numpy().mean(0) - truth))

    rows = []
    greedy_all, reds = place_sensors(X, max(sizes), obs_std=obs_std)
    for m in sizes:
        e_greedy = analysis_err(greedy_all[:m], 0)
        e_rand = [analysis_err(rng.choice(n, m, replace=False), k + 1)
                  for k in range(random_trials)]
        rows.append({
            "n_sensors": m, "err_prior": err_prior, "err_greedy": e_greedy,
            "err_random_mean": float(np.mean(e_rand)),
            "err_random_best": float(np.min(e_rand)),
            "greedy_over_random": float(np.mean(e_rand)) / e_greedy,
            "expected_var_reduction": float(np.sum(reds[:m])),
        })
        log(f"m={m}: greedy {e_greedy:.5f} vs random {np.mean(e_rand):.5f} "
            f"(best {np.min(e_rand):.5f}) [prior {err_prior:.5f}]")
    return {"rows": rows, "n_dofs": n, "forecast_s": forecast_s,
            "stations": list(greedy_all), "platform": md.device.type}


ROUNDING = {"greedy_over_random": 3}


def write_csv(path, res, mesh_size, members, obs_std):
    """The JAX script's CSV: floats rounded to 6 places (the ratio to
    3)."""
    rows = [{k: (round(v, ROUNDING.get(k, 6)) if isinstance(v, float)
                 else v) for k, v in r.items()} for r in res["rows"]]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]) + EXTRA)
        w.writeheader()
        for r in rows:
            r.update(mesh_size=mesh_size, n_dofs=res["n_dofs"],
                     members=members, obs_std=obs_std,
                     platform=res["platform"])
            w.writerow(r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=24)
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--members", type=int, default=32)
    ap.add_argument("--sizes", type=int, nargs="+", default=[4, 8, 16, 32])
    ap.add_argument("--random_trials", type=int, default=5)
    ap.add_argument("--obs_std", type=float, default=0.002)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    res = run(args.mesh_size, args.nt, args.members, args.sizes,
              args.random_trials, args.obs_std, args.device)
    if args.out:
        write_csv(args.out, res, args.mesh_size, args.members, args.obs_std)
        log(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
