"""PINN against FEM on an obstacle problem on the PyTorch port, the
counterpart of ``scripts/canyon_pinn_fem.py``.

A diffusion-dominated release (sigma 2, D 0.5, v (1, 0.2)) drifts past a
block beside the plume path, T = 3. The FEM (``CRBESolver`` on the
per-DOF stencil scan, CN; the block carved out by masked assembly) is
the authority; each PINN configuration ([3, 48, 48, 48, 1] tanh, Fourier
features, causal weighting, the facade's no-flux residual) trains on the
same problem and is scored by its discrepancy to the FEM on the live
DOFs and by the wake deficit: the free-stream band's mean minus the band
behind the block, PINN over FEM (target: its sign and ~30%). The
configurations are the JAX script's lever sweep: a separate facade
weight, the trainable output scale, a longer L-BFGS polish, their
combination and a 3x Adam budget. float32 (as the JAX script), seed 0.

    python3 scripts/torch_port_canyon_pinn_fem.py [--device cpu]
        [--epochs 200 --lbfgs 20 --configs base] [--out canyon.json]

Without --device it runs on the CUDA card and raises without one. The
document is written to --out (by default
experimental_results/canyon_pinn_fem.json), merged per config as the JAX
script merges it.
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
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.models.crbe import (  # noqa: E402
    CRBESolver,
    obstacle_masks,
)
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402

DEFAULT_OUT = os.path.join("experimental_results", "canyon_pinn_fem.json")
OBSTACLE = (2.0, 5.0, 0.5, 3.5)

# The lever sweep: 'facade_lambda' a separate no-flux weight on the
# building walls, 'output_scale' the trainable output amplitude
# (problem-derived start), 'lbfgs' a 3x polish, 'epochs_mult' the Adam
# budget.
CONFIGS = {
    "base": {},
    "facade20": {"facade_lambda": 20.0},
    "scale": {"output_scale": "auto"},
    "lbfgs3k": {"lbfgs": 3000},
    "combined": {"facade_lambda": 20.0, "output_scale": "auto",
                 "lbfgs": 3000},
    "scale_long": {"output_scale": "auto", "epochs_mult": 3,
                   "lbfgs": 3000},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_problem():
    p = apt.Problem(v=(1.0, 0.2), D=0.5, sigma=2.0)
    p.obstacles = (OBSTACLE,)
    return p


def fem_field(mesh_size=49, nt=49, T=3.0, *, device=None,
              dtype=torch.float32):
    """The FEM's final field and the bands: ``(domain, problem, mesh
    data, u_fem (numpy, float64), (live, wake, free), seconds)``."""
    domain = apt.Domain(T=T)
    p = make_problem()
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), domain, nt=nt,
                      dtype=dtype, device=device)
    fem = CRBESolver(domain, p, md, matvec_impl="stencil",
                     time_scheme_order=2, device=md.device)
    synchronize(md.device)
    t0 = time.perf_counter()
    u_fem = fem.solve(store_solutions=False)[-1].cpu().double().numpy()
    synchronize(md.device)
    fem_s = time.perf_counter() - t0
    log(f"FEM ({md.number_of_segments} DOFs): {fem_s:.1f}s")
    _, dead = obstacle_masks(md, p)
    live = ~dead.cpu().numpy()
    mids = md.midpoints.cpu().numpy()
    x, y = mids[:, 0], mids[:, 1]
    wake = live & (x > 5.5) & (x < 8.5) & (y > 0.5) & (y < 3.5)
    free = live & (x > 5.5) & (x < 8.5) & (y > -3.5) & (y < -0.5)
    return domain, p, md, u_fem, (live, wake, free), fem_s


def run_config(tag, cfg, *, epochs, lr, fourier, causal_eps, lbfgs, domain,
               p, md, u_fem, bands, lbfgs_cap=None, dtype=torch.float32):
    """One configuration's row (the JAX script's keys) and its history;
    ``lbfgs_cap`` cuts its L-BFGS steps."""
    live, wake, free = bands
    lam = {"pde": 1.0, "ic": 10.0, "bc": 10.0}
    if cfg.get("facade_lambda"):
        lam["facade"] = float(cfg["facade_lambda"])
    n_lbfgs = cfg.get("lbfgs", lbfgs)
    if lbfgs_cap is not None:
        n_lbfgs = min(n_lbfgs, lbfgs_cap)
    n_epochs = epochs * cfg.get("epochs_mult", 1)
    model = PINN([3, 48, 48, 48, 1], p, domain, activation="tanh", seed=0,
                 fourier_features=fourier,
                 output_scale=cfg.get("output_scale"), dtype=dtype,
                 device=md.device)
    synchronize(md.device)
    t0 = time.perf_counter()
    hist = model.train({"pde": 4096, "ic": 1024, "bc": 1024}, n_epochs, lr,
                       lam, causal_eps=causal_eps)
    if n_lbfgs:
        model.finetune_lbfgs({"pde": 8192, "ic": 2048, "bc": 2048},
                             n_lbfgs, lam)
    synchronize(md.device)
    train_t = time.perf_counter() - t0
    final_loss = hist["total_loss"][-1]  # the polish's, when it ran
    log(f"[{tag}] {n_epochs} Adam + {n_lbfgs} L-BFGS in {train_t:.1f}s, "
        f"final loss {final_loss:.3e}")

    mids = md.midpoints
    xyt = torch.cat([mids, torch.full((mids.shape[0], 1), float(domain.T),
                                      dtype=mids.dtype, device=mids.device)],
                    dim=1)
    pred = model.forward(xyt).reshape(-1).cpu().double().numpy()
    d = (pred - u_fem)[live]
    rel_l2 = float(np.linalg.norm(d) / np.linalg.norm(u_fem[live]))
    fem_def = float(u_fem[free].mean() - u_fem[wake].mean())
    pinn_def = float(pred[free].mean() - pred[wake].mean())
    row = {
        "config": tag, **cfg, "epochs": n_epochs, "lbfgs": n_lbfgs,
        "pinn_final_loss": float(final_loss), "train_s": train_t,
        "rel_l2_discrepancy_live": rel_l2,
        "fem_wake_mean": float(u_fem[wake].mean()),
        "pinn_wake_mean": float(pred[wake].mean()),
        "fem_free_mean": float(u_fem[free].mean()),
        "pinn_free_mean": float(pred[free].mean()),
        "fem_wake_deficit": fem_def, "pinn_wake_deficit": pinn_def,
        "wake_deficit_ratio": pinn_def / fem_def,
    }
    if cfg.get("output_scale"):
        row["amp_init"] = model.output_scale
        row["amp_final"] = float(model.params[-1]["amp"].detach())
    log(f"[{tag}] rel_l2 {rel_l2:.3f}; wake deficit FEM {fem_def:.5f} PINN "
        f"{pinn_def:.5f} (ratio {row['wake_deficit_ratio']:.3f})")
    return row, hist


ROUNDING = {"train_s": 1, "rel_l2_discrepancy_live": 4,
            "wake_deficit_ratio": 3}


def run(mesh_size=49, nt=49, T=3.0, epochs=20000, lr=2e-3, fourier=64,
        causal_eps=1.0, lbfgs=1000, configs=tuple(CONFIGS), *, device=None,
        lbfgs_cap=None, dtype=torch.float32):
    """The FEM solve, then each configuration: ``{"problem": the shared
    block, "rows": rows (unrounded), "histories": {tag: history},
    "fem_s": seconds, "u_fem": the FEM field}``. ``lbfgs_cap`` cuts every
    configuration's L-BFGS steps (depth only, for a quick run)."""
    domain, p, md, u_fem, bands, fem_s = fem_field(
        mesh_size, nt, T, device=device, dtype=dtype)
    shared = {"mesh_size": mesh_size, "nt": nt, "T": T,
              "n_dofs": int(md.number_of_segments),
              "obstacle": list(p.obstacles[0]),
              "fourier_features": fourier, "causal_eps": causal_eps}
    rows, histories = [], {}
    for tag in configs:
        row, hist = run_config(
            tag, CONFIGS[tag], epochs=epochs, lr=lr, fourier=fourier,
            causal_eps=causal_eps, lbfgs=lbfgs, domain=domain, p=p, md=md,
            u_fem=u_fem, bands=bands, lbfgs_cap=lbfgs_cap, dtype=dtype)
        rows.append(row)
        histories[tag] = hist
    return {"problem": shared, "rows": rows, "histories": histories,
            "fem_s": fem_s, "u_fem": u_fem}


def write(path, res):
    """Merge the rows into the document at ``path`` per config tag; an
    old document with another problem block starts afresh."""
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if old.get("problem") == res["problem"]:
            tags = {r["config"] for r in res["rows"]}
            rows = [r for r in old.get("configs", [])
                    if r.get("config") not in tags]
    rows += [{k: (round(v, ROUNDING[k]) if k in ROUNDING else v)
              for k, v in r.items()} for r in res["rows"]]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"problem": res["problem"],
                   "configs": sorted(rows, key=lambda r: r["config"])},
                  f, indent=1)
    log(f"wrote {path} ({len(rows)} configs)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=49)
    ap.add_argument("--nt", type=int, default=49)
    ap.add_argument("--T", type=float, default=3.0)
    ap.add_argument("--epochs", type=int, default=20000)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--fourier", type=int, default=64)
    ap.add_argument("--causal_eps", type=float, default=1.0)
    ap.add_argument("--lbfgs", type=int, default=1000)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS),
                    choices=list(CONFIGS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    args = ap.parse_args(argv)
    res = run(args.mesh_size, args.nt, args.T, args.epochs, args.lr,
              args.fourier, args.causal_eps, args.lbfgs, args.configs,
              device=args.device)
    write(args.out, res)
    return res


if __name__ == "__main__":
    main()
