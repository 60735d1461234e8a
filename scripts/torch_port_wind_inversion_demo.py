"""Wind-field estimation on the PyTorch port: recover the rotation rate of
a spatially varying wind and the diffusion coefficient from a sparse
sensor network, the counterpart of ``scripts/wind_inversion_demo.py``.

The ``RotatingPlumeProblem``'s wind v(x, y) = omega (-y, x) enters the
operator through the centroid-sampled assembly, so the misfit's gradient
runs through the coefficient field into every implicit step
(``inverse.fit_wind`` on the default engine: the per-DOF stencil scan at
the default 64^2, kernel B4's raw mode over the canvases from
``inverse.FUSED_ENGINE_MIN_N`` up). A 13-point omega grid picks the
basin (the misfit is not convex in omega), then Adam fits omega and D
jointly. float32, as the JAX script; the sensors and the noise are numpy
draws from seed 0.

    python3 scripts/torch_port_wind_inversion_demo.py [--device cpu]
        [--mesh_size 32 --nt 64 --steps 50] [--out wind_inversion.csv]

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
from airpollution_tpu_torch.diagnostics import inverse  # noqa: E402

TRUE = dict(omega=0.15, D=0.08)
RELEASE = dict(sigma=1.5, x0=5.0, y0=0.0)
COLUMNS = ["mesh_size", "n_dofs", "nt", "n_sensors", "n_snapshots",
           "noise_rel", "true_omega", "true_D", "est_omega", "est_D",
           "omega_rel_err", "D_rel_err", "loss_first", "loss_last", "steps",
           "fit_time_s", "s_per_step", "platform"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(mesh_size=64, nt=128, sensors=64, steps=250, lr=0.02, noise=0.01,
        *, device=None, dtype=torch.float32):
    """The demo's row (the CSV's fields, unrounded) with the fit's
    ``losses`` and its start ``omega0``."""
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), apt.Domain(), nt=nt,
                      dtype=dtype, device=device)
    n = md.number_of_segments
    log(f"mesh {mesh_size}^2: {n} DOFs, nt={nt}, {sensors} sensors")
    idx = list(range(nt // 8, nt, nt // 8)) + [nt - 1]
    full = inverse.solve_snapshots(
        apt.RotatingPlumeProblem(**TRUE, **RELEASE), md, indices=idx,
        tol=1e-8, maxiter=60)
    rng = np.random.default_rng(0)
    stations = np.sort(rng.choice(n, sensors, replace=False))
    obs = full[:, torch.as_tensor(stations, device=md.device)]
    obs = obs.detach().cpu().numpy()
    scale = float(np.abs(obs).max())
    obs = obs + noise * scale * rng.standard_normal(obs.shape)

    grid = np.linspace(0.0, 0.3, 13)
    synchronize(md.device)
    t0 = time.perf_counter()
    result, losses = inverse.fit_wind(
        torch.as_tensor(obs, dtype=md.dtype, device=md.device), md,
        snapshot_indices=idx, sensor_indices=stations, omega_grid=grid,
        D=0.05, fit_diffusion=True, steps=steps, lr=lr, tol=1e-8,
        maxiter=60, **RELEASE)
    synchronize(md.device)
    fit_time = time.perf_counter() - t0
    log(f"grid start: omega0={result['omega0']:.4f} (13-candidate coarse "
        f"search)")
    err_om = abs(result["omega"] - TRUE["omega"]) / TRUE["omega"]
    err_d = abs(result["D"] - TRUE["D"]) / TRUE["D"]
    log(f"recovered omega={result['omega']:.5f} (true {TRUE['omega']}, rel "
        f"err {err_om:.2%}), D={result['D']:.5f} (true {TRUE['D']}, rel err "
        f"{err_d:.2%}) [{fit_time:.1f} s / {steps} steps]")
    return {"mesh_size": mesh_size, "n_dofs": n, "nt": nt,
            "n_sensors": sensors, "n_snapshots": len(idx),
            "noise_rel": noise, "true_omega": TRUE["omega"],
            "true_D": TRUE["D"], "est_omega": result["omega"],
            "est_D": result["D"], "omega_rel_err": err_om,
            "D_rel_err": err_d, "loss_first": losses[0],
            "loss_last": losses[-1], "steps": steps,
            "fit_time_s": fit_time, "s_per_step": fit_time / steps,
            "platform": md.device.type, "losses": losses,
            "omega0": result["omega0"]}


def write_csv(path, row):
    """The JAX script's CSV: one row, its rounding."""
    cells = dict(row)
    cells.update(est_omega=round(row["est_omega"], 6),
                 est_D=round(row["est_D"], 6),
                 omega_rel_err=round(row["omega_rel_err"], 5),
                 D_rel_err=round(row["D_rel_err"], 5),
                 loss_first=f"{row['loss_first']:.3e}",
                 loss_last=f"{row['loss_last']:.3e}",
                 fit_time_s=round(row["fit_time_s"], 2),
                 s_per_step=round(row["s_per_step"], 4))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerow([cells[c] for c in COLUMNS])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=64)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--sensors", type=int, default=64)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--noise", type=float, default=0.01,
                    help="relative Gaussian sensor noise (1%% default)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    row = run(args.mesh_size, args.nt, args.sensors, args.steps, args.lr,
              args.noise, device=args.device)
    if args.out:
        write_csv(args.out, row)
        log(f"wrote {args.out}")
    return row


if __name__ == "__main__":
    main()
