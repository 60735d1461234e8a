"""The extrapolated warm start of the differentiable fused engine on the
PyTorch port, A/B: the counterpart of ``scripts/extrapolate_ab.py``.

At the source inversion's configuration (513^2, nt=128, a Gaussian
emitter, 96 sensors, 8 snapshots, 1% noise) it measures, for
(extrapolate, k) in {False, True} x {12, 8}:

- the primal accuracy of ``inverse.solve_final_state(engine="fused_hbm")``
  (fixed-k Chebyshev, each step one launch of kernel B4's raw mode)
  against a tight scan solve (BiCGStab to 1e-8), relative to its max;
- the seconds per Adam step of ``inverse.fit_source`` on the same engine,
  after two untimed steps.

The tight scan solve reads the host once per BiCGStab iteration; it is
timed on its own (``tight_s``) and kept out of the timed Adam steps.

    python3 scripts/torch_port_extrapolate_ab.py [--device cpu]
        [--mesh_size 33 --nt 16 --timed_steps 2] [--out extrapolate_ab.csv]

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

TRUE = dict(q=2.0, xs=-4.0, ys=2.5, sigma_s=1.5)
COLUMNS = ["mesh_size", "nt", "extrapolate", "chebyshev_iters",
           "primal_rel_maxdiff_vs_tight", "s_per_adam_step", "loss_last",
           "platform"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(mesh_size=513, nt=128, sensors=96, timed_steps=20, *, device=None,
        dtype=torch.float32, mesh_data=None):
    """The four A/B rows (unformatted) and the tight solve's seconds as a
    dict. ``mesh_data`` skips building the mesh data (``Domain()``, nt
    equal to ``nt``)."""
    md = mesh_data if mesh_data is not None else apt.MeshData(
        apt.create_mesh(mesh_size, 20.0), apt.Domain(), nt=nt, dtype=dtype,
        device=device)
    n = md.number_of_segments
    log(f"mesh {mesh_size}^2: {n} DOFs, nt={nt}")
    p = apt.GaussianSourceProblem(**TRUE)

    synchronize(md.device)
    t0 = time.perf_counter()
    tight = inverse.solve_final_state(p, md, engine="scan", tol=1e-8,
                                      maxiter=200)
    synchronize(md.device)
    tight_s = time.perf_counter() - t0
    log(f"tight scan reference: {tight_s:.1f}s")
    tight_n = tight.detach().cpu().double().numpy()
    scale = np.abs(tight_n).max()

    idx = list(range(nt // 8, nt, nt // 8)) + [nt - 1]
    full = inverse.solve_snapshots(p, md, indices=idx, engine="fused_hbm",
                                   chebyshev_iters=12)
    rng = np.random.default_rng(0)
    stations = np.sort(rng.choice(n, sensors, replace=False))
    obs = full[:, torch.as_tensor(stations, device=md.device)]
    obs = obs.detach().cpu().numpy()
    obs = obs + 0.01 * np.abs(obs).max() * rng.standard_normal(obs.shape)
    obs = torch.as_tensor(obs, dtype=md.dtype, device=md.device)

    rows = []
    for ex in (False, True):
        for k in (12, 8):
            u = inverse.solve_final_state(p, md, engine="fused_hbm",
                                          chebyshev_iters=k, extrapolate=ex)
            acc = float(np.abs(u.detach().cpu().double().numpy() - tight_n)
                        .max() / scale)
            kw = dict(snapshot_indices=idx, sensor_indices=stations,
                      sigma_s=TRUE["sigma_s"], q0=0.5, xy0=(0.0, 0.0),
                      lr=0.1, tol=1e-8, maxiter=60, engine="fused_hbm",
                      chebyshev_iters=k, extrapolate=ex)
            # Two untimed steps first, as the JAX script warms its compile.
            inverse.fit_source(obs, md, steps=2, **kw)
            synchronize(md.device)
            t0 = time.perf_counter()
            _, losses = inverse.fit_source(obs, md, steps=timed_steps, **kw)
            synchronize(md.device)
            spas = (time.perf_counter() - t0) / timed_steps
            rows.append({
                "mesh_size": mesh_size, "nt": nt, "extrapolate": ex,
                "chebyshev_iters": k, "primal_rel_maxdiff_vs_tight": acc,
                "s_per_adam_step": spas, "loss_last": float(losses[-1]),
                "losses": [float(x) for x in losses],
                "platform": md.device.type,
            })
            log(f"extrapolate={ex} k={k}: primal {acc:.2e}, {spas:.3f} "
                f"s/Adam-step")
    return {"rows": rows, "tight_s": tight_s, "n_dofs": n}


def write_csv(path, rows):
    """The JAX script's CSV and its formatting."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        for r in rows:
            w.writerow({**{k: r[k] for k in COLUMNS},
                        "primal_rel_maxdiff_vs_tight":
                            f"{r['primal_rel_maxdiff_vs_tight']:.3e}",
                        "s_per_adam_step": round(r["s_per_adam_step"], 4),
                        "loss_last": f"{r['loss_last']:.3e}"})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=513)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--sensors", type=int, default=96)
    ap.add_argument("--timed_steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    res = run(args.mesh_size, args.nt, args.sensors, args.timed_steps,
              device=args.device)
    if args.out:
        write_csv(args.out, res["rows"])
        log(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
