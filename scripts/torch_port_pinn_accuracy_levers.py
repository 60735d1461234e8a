"""PINN accuracy levers on the PyTorch port, the counterpart of
``scripts/pinn_accuracy_levers.py``.

Trains the mesh-64 reference configuration (32 x 4 tanh, lr 1e-4,
lambda (180, 80, 80), n_col = n_dofs / 1.4, IC and BC 0.2 n_col) under
the JAX script's variants of the levers the framework adds over the
reference:

- fourier: random Fourier features (``fourier_features``, ``scale``);
- rad: residual-based adaptive collocation (``adaptive_oversample``);
- adaptive: grad-norm loss weights (``adaptive_weights_every``);
- hardic: the hard initial-condition ansatz;
- causal: causal weighting; wider and deeper nets, sine, larger
  batches, tuned loss weights, longer schedules and an L-BFGS polish.

Each row: rel_l2, l2 and max error at t = T on the mesh's edge
midpoints, the epochs run and epochs/s. float32, seed 1234. There is no
compile on the card, so no warm-up model trains first: each variant's
clock starts on its own fresh model. --out merges the rows into a CSV by
(variant, mesh size).

    python3 scripts/torch_port_pinn_accuracy_levers.py [--device cpu]
        [--epochs 4000] [--variants base fourier] [--out levers.csv]

Without --device it runs on the CUDA card and raises without one (as
``experiments.common.driver_device``: the CPU also under
``APT_PLATFORM=cpu``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.device import synchronize  # noqa: E402
from airpollution_tpu_torch.experiments.common import driver_device  # noqa: E402
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402

LAMBDAS = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
LAYERS = [3] + [32] * 4 + [1]
FLAT = {"pde": 1.0, "ic": 1.0, "bc": 1.0}

# The JAX script's variants: name -> options ("ff" Fourier features,
# "scale" their scale, "rad" RAD oversampling, "aw" grad-norm weights
# every k epochs, "hic" hard IC, "ce" causal eps, "act", "layers", "lr",
# "epochs", "patience", "min_delta", "lbfgs" steps, "lambdas",
# "batch_mult").
VARIANTS = {
    "base": {},
    "fourier": {"ff": 64},
    "rad": {"rad": 3.0},
    "adaptive": {"aw": 100},
    "fourier+rad": {"ff": 64, "rad": 3.0},
    "all": {"ff": 64, "rad": 3.0, "aw": 100},
    "hardic": {"hic": True},
    "fourier+hardic": {"ff": 64, "hic": True},
    "fourier+rad+hardic": {"ff": 64, "rad": 3.0, "hic": True},
    "causal": {"ce": 1.0},
    "fourier+causal": {"ff": 64, "ce": 1.0},
    "fourier+causal10": {"ff": 64, "ce": 10.0},
    "fourier+causal+hardic": {"ff": 64, "ce": 1.0, "hic": True},
    "fourier+causal+wide": {"ff": 64, "ce": 1.0,
                            "layers": [3] + [64] * 4 + [1],
                            "lr": 1e-3},
    "fourier+wide": {"ff": 64, "layers": [3] + [64] * 4 + [1],
                     "lr": 1e-3},
    "fourier+wide128": {"ff": 128, "layers": [3] + [128] * 4 + [1],
                        "lr": 1e-3},
    "fourier+wide-long": {"ff": 64, "layers": [3] + [64] * 4 + [1],
                          "lr": 1e-3, "epochs": 16000, "patience": 2000},
    "fourier+causal+wide-long": {"ff": 64, "ce": 1.0,
                                 "layers": [3] + [64] * 4 + [1],
                                 "lr": 1e-3, "epochs": 16000,
                                 "patience": 2000},
    "fourier+rad+wide-long": {"ff": 64, "rad": 3.0,
                              "layers": [3] + [64] * 4 + [1],
                              "lr": 1e-3, "epochs": 16000,
                              "patience": 2000},
    "fourier+causal+wide128-long": {"ff": 128, "ce": 1.0,
                                    "layers": [3] + [128] * 4 + [1],
                                    "lr": 1e-3, "epochs": 32000,
                                    "patience": 4000},
    "fourier+causal+wide-xlong": {"ff": 64, "ce": 1.0,
                                  "layers": [3] + [64] * 4 + [1],
                                  "lr": 1e-3, "epochs": 64000,
                                  "patience": 8000},
    "fourier+causal+rad+wide-long": {"ff": 64, "ce": 1.0, "rad": 3.0,
                                     "layers": [3] + [64] * 4 + [1],
                                     "lr": 1e-3, "epochs": 16000,
                                     "patience": 2000},
    "fourier+causal+wide+lbfgs": {"ff": 64, "ce": 1.0,
                                  "layers": [3] + [64] * 4 + [1],
                                  "lr": 1e-3, "epochs": 16000,
                                  "patience": 2000, "lbfgs": 1000},
    # min_delta matters: the default 1e-6 exceeds these runs' final
    # losses (~2e-7), so "patience" fires as soon as the easy phase
    # ends and the long schedules never actually run long.
    "fourier+causal+wide-64k": {"ff": 64, "ce": 1.0,
                                "layers": [3] + [64] * 4 + [1],
                                "lr": 1e-3, "epochs": 64000,
                                "patience": 8000, "min_delta": 1e-9,
                                "lbfgs": 1000},
    "fourier+wide+lbfgs": {"ff": 64,
                           "layers": [3] + [64] * 4 + [1],
                           "lr": 1e-3, "epochs": 16000,
                           "patience": 2000, "lbfgs": 1000},
    # Untuned-weights pair: the annealing scheme's intended use case.
    "base-flat-lambdas": {"lambdas": FLAT},
    "adaptive-flat-lambdas": {"aw": 100, "lambdas": FLAT},
    # E6 --search_levers best trial (optuna_pinn_results_64.csv #11):
    # plain wide net, lr 2.19e-3, lambda_pde 10 / lambda_ic_bc 0.14 —
    # the loss-weight ratio matters more than any single lever at a
    # fixed budget.
    "hpo-tuned": {"layers": [3] + [64] * 4 + [1], "lr": 2.19e-3,
                  "lambdas": {"pde": 10.0, "ic": 0.14, "bc": 0.14}},
    "hpo-tuned-64k": {"layers": [3] + [64] * 4 + [1], "lr": 2.19e-3,
                      "lambdas": {"pde": 10.0, "ic": 0.14, "bc": 0.14},
                      "epochs": 64000, "patience": 8000,
                      "min_delta": 1e-9, "lbfgs": 1000},
    "hpo-tuned+fourier+causal-64k": {
        "ff": 64, "ce": 1.0,
        "layers": [3] + [64] * 4 + [1], "lr": 2.19e-3,
        "lambdas": {"pde": 10.0, "ic": 0.14, "bc": 0.14},
        "epochs": 64000, "patience": 8000, "min_delta": 1e-9,
        "lbfgs": 1000},
    "hpo-tuned+fourier+causal+wide128-64k": {
        "ff": 128, "ce": 1.0,
        "layers": [3] + [128] * 4 + [1], "lr": 1e-3,
        "lambdas": {"pde": 10.0, "ic": 0.14, "bc": 0.14},
        "epochs": 64000, "patience": 8000, "min_delta": 1e-9,
        "lbfgs": 1000},
    # A second screening around the 0.407 winner (fourier+causal+wide):
    # fourier_scale, activation, depth, and collocation-batch levers at
    # a 16k-epoch budget; winners get promoted to the 64k schedule.
    "fcw-scale0.5-16k": {"ff": 64, "ce": 1.0, "scale": 0.5,
                         "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                         "epochs": 16000, "patience": 2000,
                         "min_delta": 1e-9},
    "fcw-scale2-16k": {"ff": 64, "ce": 1.0, "scale": 2.0,
                       "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                       "epochs": 16000, "patience": 2000,
                       "min_delta": 1e-9},
    "fcw-scale4-16k": {"ff": 64, "ce": 1.0, "scale": 4.0,
                       "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                       "epochs": 16000, "patience": 2000,
                       "min_delta": 1e-9},
    "fcw-sine-16k": {"ff": 64, "ce": 1.0, "act": "sine",
                     "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                     "epochs": 16000, "patience": 2000,
                     "min_delta": 1e-9},
    "sine-wide-16k": {"ce": 1.0, "act": "sine",
                      "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                      "epochs": 16000, "patience": 2000,
                      "min_delta": 1e-9},
    "fcw-deep6-16k": {"ff": 64, "ce": 1.0,
                      "layers": [3] + [64] * 6 + [1], "lr": 1e-3,
                      "epochs": 16000, "patience": 2000,
                      "min_delta": 1e-9},
    "fcw-batch2x-16k": {"ff": 64, "ce": 1.0, "batch_mult": 2,
                        "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                        "epochs": 16000, "patience": 2000,
                        "min_delta": 1e-9},
    "fcw-batch4x-16k": {"ff": 64, "ce": 1.0, "batch_mult": 4,
                        "layers": [3] + [64] * 4 + [1], "lr": 1e-3,
                        "epochs": 16000, "patience": 2000,
                        "min_delta": 1e-9},
}


def train_variant(name, cfg, md, mesh_size, problem, domain, epochs, *,
                  epoch_cap=None, lbfgs_cap=None, dtype=torch.float32):
    """One variant on a fresh model: its row (unrounded), the model, its
    Adam epochs and the seconds of its Adam part."""
    n_col = round(md.number_of_segments / 1.4)
    n_ic = round(0.2 * n_col)
    bm = cfg.get("batch_mult", 1)
    batch = {"pde": n_col * bm, "ic": n_ic * bm, "bc": n_ic * bm}
    n_epochs = cfg.get("epochs", epochs)
    n_lbfgs = cfg.get("lbfgs", 0)
    if epoch_cap is not None:
        n_epochs = min(n_epochs, epoch_cap)
    if lbfgs_cap is not None:
        n_lbfgs = min(n_lbfgs, lbfgs_cap)
    lams = cfg.get("lambdas", LAMBDAS)
    model = PINN(cfg.get("layers", LAYERS), problem, domain,
                 activation=cfg.get("act", "tanh"), seed=1234,
                 fourier_features=cfg.get("ff", 0),
                 fourier_scale=cfg.get("scale", 1.0),
                 hard_ic=cfg.get("hic", False), dtype=dtype,
                 device=md.device)
    synchronize(md.device)
    t0 = time.perf_counter()
    h = model.train(
        batch, n_epochs, cfg.get("lr", 1e-4), lams,
        adaptive_oversample=cfg.get("rad", 0.0),
        adaptive_weights_every=cfg.get("aw", 0),
        causal_eps=cfg.get("ce", 0.0),
        early_stopping_patience=cfg.get("patience", 0),
        early_stopping_min_delta=cfg.get("min_delta", 1e-6))
    n_adam = len(h["total_loss"])
    synchronize(md.device)
    adam_s = time.perf_counter() - t0
    if n_lbfgs:
        h = model.finetune_lbfgs(batch, n_lbfgs, lams)
    synchronize(md.device)
    wall = time.perf_counter() - t0
    rel, l2, mx = model.compute_errors(md, problem.analytical_solution)
    row = {"variant": name, "mesh_size": mesh_size,
           "epochs": len(h["total_loss"]), "warm_train_time_s": wall,
           "warm_epochs_per_sec": len(h["total_loss"]) / wall,
           "final_loss": h["total_loss"][-1], "rel_l2": rel, "l2": l2,
           "max_error": mx}
    return row, model, n_adam, adam_s


def run(epochs=4000, mesh_size=64, variants=None, *, device=None,
        epoch_cap=None, lbfgs_cap=None, dtype=torch.float32, done=()):
    """The rows of the chosen ``variants`` (default all; those in
    ``done``, (variant, mesh size) pairs, skipped), each with its loss
    ``history``, ``adam_epochs`` and ``adam_s`` (the Adam part's
    seconds)."""
    dev = driver_device(device)
    domain, problem = apt.Domain(), apt.Problem()
    md = apt.MeshData(apt.create_mesh(mesh_size, 20.0), domain, nt=128,
                      dtype=dtype, device=dev)
    chosen = dict(VARIANTS)
    if variants:
        unknown = set(variants) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"unknown variants {sorted(unknown)}")
        chosen = {k: v for k, v in VARIANTS.items() if k in variants}
    skipped = [k for k in chosen if (k, str(mesh_size)) in set(done)]
    if skipped:
        print(f"skip_existing: {skipped}", file=sys.stderr, flush=True)
    rows = []
    for name, cfg in chosen.items():
        if name in skipped:
            continue
        row, model, n_adam, adam_s = train_variant(
            name, cfg, md, mesh_size, problem, domain, epochs,
            epoch_cap=epoch_cap, lbfgs_cap=lbfgs_cap, dtype=dtype)
        row.update(history=model.history, adam_epochs=n_adam,
                   adam_s=adam_s)
        rows.append(row)
        print({k: v for k, v in row.items() if k not in EXTRA},
              file=sys.stderr, flush=True)
    return rows


ROUNDING = {"warm_train_time_s": 2, "warm_epochs_per_sec": 1}
EXTRA = ("history", "adam_epochs", "adam_s")  # run()'s keys beyond the CSV's


def write_merged(out_path, rows):
    """Merge ``rows`` into the CSV at ``out_path`` (key: variant and mesh
    size), as the JAX script does after each variant."""
    by_key = {}
    if os.path.exists(out_path):
        with open(out_path, newline="") as f:
            for old in csv.DictReader(f):
                by_key[(old["variant"], old.get("mesh_size") or "64")] = old
    for row in rows:
        row = {k: (round(v, ROUNDING[k]) if k in ROUNDING else v)
               for k, v in row.items()
               if k not in EXTRA}
        by_key[(row["variant"], str(row["mesh_size"]))] = row
    merged = list(by_key.values())
    fieldnames = list(dict.fromkeys(k for r in merged for k in r))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
        w.writeheader()
        w.writerows(merged)
    os.replace(tmp, out_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4000)
    ap.add_argument("--mesh_size", type=int, default=64)
    ap.add_argument("--variants", type=str, nargs="*", default=None,
                    help="Subset of variant names to run (default: all)")
    ap.add_argument("--out", default="",
                    help="merge the rows into this CSV")
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip variants already in --out at this mesh size")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    args = ap.parse_args(argv)
    done = ()
    if args.skip_existing and args.out and os.path.exists(args.out):
        with open(args.out, newline="") as f:
            done = [(r["variant"], r.get("mesh_size") or "64")
                    for r in csv.DictReader(f)]
    rows = run(args.epochs, args.mesh_size, args.variants,
               device=args.device, done=done)
    if args.out:
        write_merged(args.out, rows)
        print(f"saved {args.out}", file=sys.stderr, flush=True)
    return rows


if __name__ == "__main__":
    main()
