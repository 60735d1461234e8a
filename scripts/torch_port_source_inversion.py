#!/usr/bin/env python3
"""Emission-source identification with the PyTorch + CUDA port: localize
and quantify a Gaussian emitter from a sparse sensor network.

The port's counterpart of scripts/source_inversion_demo.py, with the
per-Adam-step timing of scripts/extrapolate_ab.py. A monitoring network of
``--sensors`` stations (numpy ``default_rng(0)``, as the demo draws them)
reports concentrations at 8 times, with ``--noise`` relative Gaussian
noise; transport (v, D) is known; Adam on the exact discrete adjoint of
the full CRBE solve recovers the rate q and the location (xs, ys) of a
GaussianSourceProblem, and the Gauss-Newton posterior gives their error
bars. ``--engine auto`` runs meshes of 320 points per axis or more on the
differentiable fused engine (kernel B4's raw mode, forward and adjoint).

    python3 scripts/torch_port_source_inversion.py --mesh_size 513 \\
        --nt 128 --sensors 96 --steps 120          # the results row, GPU
    python3 scripts/torch_port_source_inversion.py --device cpu \\
        --mesh_size 17 --nt 17 --sensors 24 --steps 5

Prints one JSON line: the columns of the demo's CSV, the time of each
Adam step (best and median after 2 warm-up steps), kernel B4's raw-mode
launches and, on a GPU, the card's name and power limit. Writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402

TRUE = dict(q=2.0, xs=-4.0, ys=2.5, sigma_s=1.5)
WARM_UP_STEPS = 2


def snapshot_indices(nt: int):
    """The demo's 8 observation times: every nt // 8 steps, and the last."""
    return list(range(nt // 8, nt, nt // 8)) + [nt - 1]


def observations(md, sensors: int, noise: float, engine: str,
                 chebyshev_iters: int):
    """``(obs, sensor_indices)``: the true emitter's snapshots at the
    sensors, from the same engine as the fit, with the demo's draws."""
    idx = snapshot_indices(md.nt)
    with torch.no_grad():
        full = inverse.solve_snapshots(
            apt.GaussianSourceProblem(**TRUE), md, indices=idx, tol=1e-8,
            maxiter=60, engine=engine, chebyshev_iters=chebyshev_iters)
    rng = np.random.default_rng(0)
    sens = np.sort(rng.choice(md.number_of_segments, sensors, replace=False))
    obs = full[:, torch.as_tensor(sens, device=full.device)].cpu().numpy()
    scale = float(np.abs(obs).max())
    obs = obs + noise * scale * rng.standard_normal(obs.shape)
    return obs, sens


def run(mesh_size=64, nt=128, sensors=64, steps=300, lr=0.1, noise=0.01,
        engine="auto", chebyshev_iters=12, device=None,
        dtype=torch.float32):
    """One source inversion; returns the result row (a dict)."""
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), apt.Domain(), nt=nt,
                      dtype=dtype, device=device)
    idx = snapshot_indices(nt)
    fused_hbm.CANVAS_RAW_KERNEL.launches = 0
    obs, sens = observations(md, sensors, noise, engine, chebyshev_iters)
    obs_launches = fused_hbm.CANVAS_RAW_KERNEL.launches
    stamps = []
    sync = (torch.cuda.synchronize if md.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    result, losses = inverse.fit_source(
        obs, md, snapshot_indices=idx, sensor_indices=sens,
        sigma_s=TRUE["sigma_s"], q0=0.5, xy0=(0.0, 0.0), steps=steps,
        lr=lr, tol=1e-8, maxiter=60, engine=engine,
        chebyshev_iters=chebyshev_iters,
        on_step=lambda i, loss: stamps.append(time.perf_counter()))
    fit_time = time.perf_counter() - t0
    fit_launches = fused_hbm.CANVAS_RAW_KERNEL.launches - obs_launches
    per_step = np.diff([t0] + stamps)

    def make_problem(params):
        return apt.GaussianSourceProblem(
            q=torch.exp(params["log_q"]), xs=params["xy"][0],
            ys=params["xy"][1], sigma_s=TRUE["sigma_s"])

    map_params = {"log_q": np.log(result["q"]),
                  "xy": np.asarray([result["xs"], result["ys"]])}
    t1 = time.perf_counter()
    uq = inverse.posterior_covariance(
        md, make_problem, map_params, snapshot_indices=idx,
        sensor_indices=[int(i) for i in sens], observed=obs, tol=1e-8,
        maxiter=60)
    sync()
    posterior_s = time.perf_counter() - t1
    std = uq["std"]
    err_q = abs(result["q"] - TRUE["q"]) / TRUE["q"]
    row = {
        "mesh_size": mesh_size, "n_dofs": md.number_of_segments, "nt": nt,
        "n_sensors": sensors, "n_snapshots": len(idx), "noise_rel": noise,
        "true_q": TRUE["q"], "true_xs": TRUE["xs"], "true_ys": TRUE["ys"],
        "est_q": result["q"], "est_xs": result["xs"],
        "est_ys": result["ys"], "q_rel_err": err_q,
        "location_offset": float(np.hypot(result["xs"] - TRUE["xs"],
                                          result["ys"] - TRUE["ys"])),
        "std_log_q": std["log_q"], "std_xs": std["xy[0]"],
        "std_ys": std["xy[1]"],
        "z_q": abs(np.log(result["q"] / TRUE["q"])) / std["log_q"],
        "z_xs": abs(result["xs"] - TRUE["xs"]) / std["xy[0]"],
        "z_ys": abs(result["ys"] - TRUE["ys"]) / std["xy[1]"],
        "est_obs_std": uq["obs_std"], "loss_first": losses[0],
        "loss_last": losses[-1], "steps": steps, "fit_time_s": fit_time,
        "s_per_step": fit_time / steps,
        "platform": "gpu" if md.device.type == "cuda" else "cpu",
        "engine": engine, "chebyshev_iters": chebyshev_iters,
        "dtype": str(dtype).split(".")[-1], "posterior_s": posterior_s,
        "b4_raw_launches_observations": obs_launches,
        "b4_raw_launches_fit": fit_launches,
        "b4_raw_launches_posterior": (fused_hbm.CANVAS_RAW_KERNEL.launches
                                      - obs_launches - fit_launches),
    }
    timed = per_step[WARM_UP_STEPS:]
    if len(timed):
        row["s_per_step_best"] = float(timed.min())
        row["s_per_step_median"] = float(statistics.median(timed))
    return row


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh_size", type=int, default=64)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--sensors", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--noise", type=float, default=0.01,
                    help="relative Gaussian sensor noise (1%% default)")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "scan", "fused_hbm"))
    ap.add_argument("--chebyshev_iters", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args()
    row = run(args.mesh_size, args.nt, args.sensors, args.steps, args.lr,
              args.noise, args.engine, args.chebyshev_iters, args.device,
              getattr(torch, args.dtype))
    if row["platform"] == "gpu":
        row["card"] = card_line()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
