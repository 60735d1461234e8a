"""Cycling data assimilation on the PyTorch port: an EnKF forecast and
analysis loop over sequential windows against a free-running ensemble,
the counterpart of ``scripts/da_cycling_demo.py``.

A square-pulse release (``SquarePulseProblem``) evolves under the true
wind in one serial solve over the whole horizon. The forecast ensemble
runs with perturbed winds, diffusivities and initial pulses; every
--window_T time units a station network along the plume track reports
noisy readings and the ensemble is pulled toward them by ``enkf_update``
(with multiplicative inflation), while a twin ensemble runs free. Each
window is two member batches restarted from the previous states
(``ensemble_forecast(u0_members=, t0=)``: every ELL product one launch of
kernel B7a's stacked mode over the members). float32, as the JAX script;
a float32 member batch can break down (NaN): such a row is reported as
it is, not re-run wider. Members, shifts, stations and readings are numpy
draws from seed 0 in the JAX script's order; the EnKF noise comes from a
``torch.Generator`` seeded 7 (the JAX script's key), drawn on in each
cycle.

    python3 scripts/torch_port_da_cycling_demo.py [--device cpu]
        [--mesh_size 24] [--out da_cycling.csv]

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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.diagnostics import (  # noqa: E402
    enkf_update,
    ensemble_forecast,
)
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402

FIELDS = ["cycle", "t", "rmse_forecast", "rmse_analysis", "rmse_free",
          "mean_spread"]
EXTRA = ["mesh_size", "n_dofs", "members", "sensors", "obs_std",
         "platform"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pulse_field(midpoints, lo, hi, amplitude):
    x, y = midpoints[:, 0], midpoints[:, 1]
    inside = (x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
    return np.where(inside, amplitude, 0.0)


def run(mesh_size=32, members=40, cycles=6, window_T=1.0, window_nt=11,
        sensors=64, obs_std=0.02, inflation=1.1, device=None,
        dtype=torch.float32, mesh=None):
    """The demo's per-cycle rows and its seconds as a dict: ``rows`` (the
    CSV's fields, unrounded), ``n_dofs``, ``truth_s`` and ``cycles_s``.
    ``mesh`` (a ``create_mesh(mesh_size, 20.0)``) skips building it."""
    rng = np.random.default_rng(0)
    true_problem = apt.SquarePulseProblem(v=(1.0, 0.5), D=0.1)
    mesh = mesh if mesh is not None else apt.create_mesh(mesh_size, 20.0)

    steps_per_window = window_nt - 1
    dom_full = apt.Domain(T=cycles * window_T)
    md_full = apt.MeshData(mesh, dom_full, nt=cycles * steps_per_window + 1,
                           dtype=dtype, device=device)
    n = md_full.number_of_segments
    log(f"mesh {mesh_size}^2: {n} DOFs, {cycles} windows x "
        f"{steps_per_window} steps, K={members}, m={sensors} sensors")
    t0 = time.perf_counter()
    truth = CRBESolver(dom_full, true_problem, md_full, solver_tol=1e-7,
                       solver_maxiter=200, device=md_full.device).solve(
        store_solutions=True).cpu().numpy()
    truth_s = time.perf_counter() - t0
    log(f"truth solve: {truth_s:.1f}s")

    dom_w = apt.Domain(T=window_T)
    md_w = apt.MeshData(mesh, dom_w, nt=window_nt, dtype=dtype,
                        device=device)
    mids = md_w.midpoints.cpu().numpy()

    probs = [
        apt.SquarePulseProblem(
            v=(1.0 + 0.25 * rng.standard_normal(),
               0.5 + 0.25 * rng.standard_normal()),
            D=0.1 * np.exp(0.3 * rng.standard_normal()))
        for _ in range(members)
    ]
    shifts = 1.5 * rng.standard_normal((members, 2))
    amps = 1.0 + 0.2 * rng.standard_normal(members)
    X0 = np.stack([
        pulse_field(mids, np.array([8.0, 8.0]) + shifts[k],
                    np.array([12.0, 12.0]) + shifts[k], amps[k])
        for k in range(members)])

    track = ((mids[:, 0] >= 5.0) & (mids[:, 0] <= 19.0)
             & (mids[:, 1] >= 5.0) & (mids[:, 1] <= 17.0))
    stations = np.sort(rng.choice(np.flatnonzero(track), sensors,
                                  replace=False))
    gen = torch.Generator(device=md_w.device).manual_seed(7)

    X = torch.as_tensor(X0, dtype=dtype, device=md_w.device)
    X_free = X
    rows = []
    synchronize(md_w.device)
    t0 = time.perf_counter()
    for c in range(cycles):
        t_start = c * window_T
        out = ensemble_forecast(md_w, dom_w, probs, u0_members=X,
                                t0=t_start)
        out_free = ensemble_forecast(md_w, dom_w, probs,
                                     u0_members=X_free, t0=t_start)
        X_f, X_free = out["members"], out_free["members"]
        u_true = truth[(c + 1) * steps_per_window]
        y = u_true[stations] + obs_std * rng.standard_normal(sensors)
        X = enkf_update(X_f, y, stations, obs_std, gen, inflation=inflation)

        def rmse(m):
            return float(np.sqrt(np.mean(
                (m.cpu().numpy().mean(axis=0) - u_true) ** 2)))

        spread = float(out["std"].mean())
        rows.append({"cycle": c + 1, "t": (c + 1) * window_T,
                     "rmse_forecast": rmse(X_f), "rmse_analysis": rmse(X),
                     "rmse_free": rmse(X_free), "mean_spread": spread})
        r = rows[-1]
        if not all(math.isfinite(r[k]) for k in FIELDS[2:]):
            log(f"cycle {c + 1}: a non-finite figure (a float32 member "
                f"batch broke down), reported as it is")
        log(f"cycle {c + 1}: forecast {r['rmse_forecast']:.5f} -> analysis "
            f"{r['rmse_analysis']:.5f} (free {r['rmse_free']:.5f}, spread "
            f"{spread:.5f})")
    synchronize(md_w.device)
    cycles_s = time.perf_counter() - t0
    log(f"{cycles} cycles ({2 * cycles} ensemble forecasts + {cycles} "
        f"analyses): {cycles_s:.1f}s")
    return {"rows": rows, "n_dofs": n, "truth_s": truth_s,
            "cycles_s": cycles_s, "sensors": stations,
            "platform": md_w.device.type}


def write_csv(path, res, mesh_size, members, sensors, obs_std):
    """The JAX script's CSV: one row per cycle, floats rounded to 6
    places."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS + EXTRA)
        w.writeheader()
        for r in res["rows"]:
            r = {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in r.items()}
            r.update(mesh_size=mesh_size, n_dofs=res["n_dofs"],
                     members=members, sensors=sensors, obs_std=obs_std,
                     platform=res["platform"])
            w.writerow(r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=32)
    ap.add_argument("--members", type=int, default=40)
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--window_T", type=float, default=1.0)
    ap.add_argument("--window_nt", type=int, default=11)
    ap.add_argument("--sensors", type=int, default=64)
    ap.add_argument("--obs_std", type=float, default=0.02,
                    help="absolute observation noise (pulse amplitude 1)")
    ap.add_argument("--inflation", type=float, default=1.1,
                    help="multiplicative prior inflation (enkf_update)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    res = run(args.mesh_size, args.members, args.cycles, args.window_T,
              args.window_nt, args.sensors, args.obs_std, args.inflation,
              args.device)
    if args.out:
        write_csv(args.out, res, args.mesh_size, args.members, args.sensors,
                  args.obs_std)
        log(f"wrote {args.out}")
    last = res["rows"][-1]
    log(f"final-cycle error ratio free/analysis = "
        f"{last['rmse_free'] / max(last['rmse_analysis'], 1e-12):.2f}x")
    return res


if __name__ == "__main__":
    main()
