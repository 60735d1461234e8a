"""Multi-species coupled chemistry on the PyTorch port: a decay-chain
convergence table and chemistry-rate identification from noisy
observations, the counterpart of ``scripts/multispecies_demo.py``.

A 3-species chain A -> B -> C with removal on C, solved by
``MultiSpeciesSolver`` (its default route, CN) in float64 at each mesh
size and held against the expm-mixture closed form (rel_l2 per species
and the L2 rate); then the inverse direction: the chain's three rates
recovered from 1%-noisy trajectory observations by Adam on the coupled
discrete adjoint (``inverse.fit_chemistry``, rates in log space). The
noise is a numpy draw from seed 0.

    python3 scripts/torch_port_multispecies_demo.py [--device cpu]
        [--mesh_sizes 8 16 32 --steps 50] [--out multispecies.csv]

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
from airpollution_tpu_torch.models import MultiSpeciesSolver  # noqa: E402

RATES_TRUE = (0.25, 0.10, 0.05)


def chain_R(r1, r2, r3, module=np):
    """A -> B -> C chain with removal r3 on C (rows: species equations)."""
    z = 0.0 * r1
    return module.stack([
        module.stack([r1, z, z]),
        module.stack([-r1, r2, z]),
        module.stack([z, -r2, r3]),
    ])


def make_problem():
    # Three plumes of distinct widths, shared (v, D): an exact oracle.
    species = (apt.Problem(sigma=1.0), apt.Problem(sigma=2.0),
               apt.Problem(sigma=3.0))
    return apt.MultiSpeciesProblem(species, chain_R(*RATES_TRUE))


def convergence_rows(mesh_sizes, nt, device=None):
    rows = []
    domain = apt.Domain()
    msp = make_problem()
    for ms in mesh_sizes:
        md = apt.MeshData(apt.create_mesh(ms, domain.Lx), domain, nt=nt,
                          dtype=torch.float64, device=device)
        solver = MultiSpeciesSolver(domain, msp, md, time_scheme_order=2,
                                    device=md.device)
        synchronize(md.device)
        t0 = time.perf_counter()
        solver.solve(store_solutions=False)
        synchronize(md.device)
        wall = time.perf_counter() - t0
        err = solver.compute_errors()
        per = [e["rel_l2_error"] for e in err["per_species"]]
        print(f"ms={ms:4d} dofs={md.number_of_segments:7d} "
              f"rel_l2={err['rel_l2_error']:.4f} "
              f"per-species={[round(e, 4) for e in per]} ({wall:.1f}s)",
              flush=True)
        rows.append({
            "kind": "convergence", "mesh_size": ms,
            "n_dofs": md.number_of_segments, "h": float(md.diameter),
            "nt": nt, "rel_l2_total": err["rel_l2_error"],
            "rel_l2_A": per[0], "rel_l2_B": per[1], "rel_l2_C": per[2],
            "max_error_total": err["max_error"], "solve_time_s": wall,
        })
    # The log-log L2 rate over the swept sizes.
    hs = np.array([r["h"] for r in rows])
    es = np.array([r["rel_l2_total"] for r in rows])
    rate = float(np.polyfit(np.log(hs), np.log(es), 1)[0])
    print(f"measured L2 rate: O(h^{rate:.2f})", flush=True)
    for r in rows:
        r["l2_rate"] = rate
    return rows


def inversion_row(ms, nt, noise, steps, lr, device=None):
    domain = apt.Domain(T=4.0)
    msp = make_problem()
    md = apt.MeshData(apt.create_mesh(ms, domain.Lx), domain, nt=nt,
                      dtype=torch.float64, device=device)
    idx = list(range(nt // 4, nt, nt // 4))
    obs = inverse.solve_multispecies_snapshots(msp, md, indices=idx)
    obs = obs.detach().cpu().numpy()
    rng = np.random.default_rng(0)
    obs = obs * (1 + noise * rng.standard_normal(obs.shape))

    def make_R(p):
        return chain_R(torch.exp(p["log_r1"]), torch.exp(p["log_r2"]),
                       torch.exp(p["log_r3"]), module=torch)

    init = {k: torch.log(torch.tensor(v, dtype=torch.float64))
            for k, v in (("log_r1", 0.05), ("log_r2", 0.5),
                         ("log_r3", 0.02))}
    synchronize(md.device)
    t0 = time.perf_counter()
    _, params, losses = inverse.fit_chemistry(
        torch.as_tensor(obs, device=md.device), md, msp.species,
        make_R=make_R, init_params=init, snapshot_indices=idx, steps=steps,
        lr=lr)
    synchronize(md.device)
    wall = time.perf_counter() - t0
    fit = [float(torch.exp(params[k])) for k in ("log_r1", "log_r2",
                                                 "log_r3")]
    errs = [abs(f - t) / t for f, t in zip(fit, RATES_TRUE)]
    print(f"inversion: truth {RATES_TRUE} -> fit {[round(f, 4) for f in fit]}"
          f" (rel errs {[f'{e:.2%}' for e in errs]}, {wall:.0f}s, loss "
          f"{losses[0]:.2e}->{losses[-1]:.2e})", flush=True)
    return {
        "kind": "inversion", "mesh_size": ms, "nt": nt, "noise": noise,
        "adam_steps": steps, "r1_true": RATES_TRUE[0],
        "r2_true": RATES_TRUE[1], "r3_true": RATES_TRUE[2],
        "r1_fit": fit[0], "r2_fit": fit[1], "r3_fit": fit[2],
        "r1_rel_err": errs[0], "r2_rel_err": errs[1], "r3_rel_err": errs[2],
        "fit_time_s": wall, "losses": losses,
    }


def write_csv(path, rows):
    """The JAX script's CSV: the columns sorted, every row's keys (the
    inversion's losses aside)."""
    rows = [{k: v for k, v in r.items() if k != "losses"} for r in rows]
    fields = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_sizes", type=int, nargs="*",
                    default=[8, 16, 32, 64])
    ap.add_argument("--nt", type=int, default=129)
    ap.add_argument("--inv_mesh_size", type=int, default=16)
    ap.add_argument("--inv_nt", type=int, default=33)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the CSV here")
    args = ap.parse_args(argv)
    rows = convergence_rows(args.mesh_sizes, args.nt, args.device)
    rows.append(inversion_row(args.inv_mesh_size, args.inv_nt, args.noise,
                              args.steps, args.lr, args.device))
    if args.out:
        write_csv(args.out, rows)
        print(f"wrote {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
