"""Train the PyTorch port's FNO surrogate on solver-manufactured plume
data, the counterpart of ``scripts/fno_surrogate_demo.py`` with its
defaults.

The port's member-batched FEM ensemble manufactures the ground truth
(``models/fno.make_plume_dataset``: every sample's solve in one member
batch, its ELL products on kernel B7's stacked mode), the FNO trains on
it with AdamW and a stepped learning rate (halved --lr_decay_chunks
times), and the result answers new (D, v, sigma, center) queries in one
forward pass. Every sample keeps a closed form (ShiftedPlumeProblem), so
the surrogate is scored against the FEM field and the exact solution on
held-out problems. With --n_times K the surrogate is time-conditioned
(``make_plume_time_dataset``, scored at every snapshot time);
--superres_mesh scores the trained parameters zero-shot on a finer mesh.

The JAX script's --scan_chunk (epochs per compiled scan) has no
counterpart: the port's trainer is a loop of eager steps.

    python3 scripts/torch_port_fno_surrogate.py [--device cpu]
        [--epochs 12000 ...] [--out fno.json]

Without --device it runs on the CUDA card and raises without one; it
prints one JSON line and, with --out, writes it to that file.
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
from airpollution_tpu_torch.models import fno  # noqa: E402


def log(*a):
    print(*a, flush=True)


def predict(params, X, batch=32):
    """The FNO's fields for X, in batches, with no graph."""
    with torch.no_grad():
        return torch.cat([fno.fno_apply(params, X[i:i + batch])
                          for i in range(0, X.shape[0], batch)])


def _rel(a, b):
    num = torch.sqrt(((a - b) ** 2).sum(dim=(1, 2, 3)))
    den = torch.sqrt((b ** 2).sum(dim=(1, 2, 3)))
    return float((num / torch.clamp(den, min=1e-12)).mean())


def _exact_fields(md, problems, times, dtype):
    """(len(problems) * len(times), c, c, 1) closed-form fields on the
    cell-center grid, rows in the dataset's order."""
    coords = torch.as_tensor(fno.grid_coordinates(md), dtype=dtype,
                             device=md.device)
    c = coords.shape[0]
    cc = coords.reshape(-1, 2)
    out = []
    for p in problems:
        for t in times:
            xyt = torch.cat([cc, torch.full((cc.shape[0], 1), float(t),
                                            dtype=dtype, device=md.device)],
                            dim=1)
            out.append(p.analytical_solution(xyt).reshape(c, c))
    return torch.stack(out)[..., None]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_size", type=int, default=65)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--n_train", type=int, default=640)
    ap.add_argument("--n_test", type=int, default=128)
    ap.add_argument("--modes", type=int, default=16)
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--weight_decay", type=float, default=0.0,
                    help="decoupled AdamW decay")
    ap.add_argument("--lr_decay_chunks", type=int, default=4,
                    help="halve the LR this many times over training")
    ap.add_argument("--n_times", type=int, default=0,
                    help="train a time-conditioned surrogate on this many "
                    "trajectory snapshots per problem (0 = final state)")
    ap.add_argument("--superres_mesh", type=int, default=0,
                    help="also evaluate zero-shot on this finer mesh "
                    "(final-state mode only)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card when not given")
    ap.add_argument("--out", default="", help="write the JSON line here")
    args = ap.parse_args(argv)

    domain = apt.Domain()
    md = apt.MeshData(apt.create_mesh(args.mesh_size, 20.0), domain,
                      nt=args.nt, device=args.device)
    device = md.device
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    n_all = args.n_train + args.n_test
    t0 = time.perf_counter()
    if args.n_times:
        X, Y, probs, snap_times = fno.make_plume_time_dataset(
            md, domain, torch.Generator().manual_seed(0), n_all,
            n_times=args.n_times)
        rows_per = args.n_times
    else:
        X, Y, probs = fno.make_plume_dataset(
            md, domain, torch.Generator().manual_seed(0), n_all)
        snap_times, rows_per = None, 1
    synchronize(device)
    t_data = time.perf_counter() - t0
    log(f"dataset: {n_all} FEM solves ({md.number_of_segments} DOFs, "
        f"nt={args.nt}) in {t_data:.1f}s -> X{tuple(X.shape)}")
    n_tr_rows = args.n_train * rows_per
    Xtr, Ytr = X[:n_tr_rows], Y[:n_tr_rows]
    Xte, Yte = X[n_tr_rows:], Y[n_tr_rows:]

    params = fno.init_fno_params(
        torch.Generator(device=device).manual_seed(1), in_ch=X.shape[-1],
        modes=args.modes, width=args.width, depth=args.depth, dtype=X.dtype,
        device=device)
    n_params = sum(p.numel() for p in params)
    log(f"FNO: modes={args.modes} width={args.width} depth={args.depth} "
        f"-> {n_params / 1e6:.2f}M params")

    chunks = max(1, args.lr_decay_chunks)
    per = -(-args.epochs // chunks)
    opt_state, lr, losses_all = None, args.lr, []
    gen = torch.Generator(device=device).manual_seed(100)
    t0 = time.perf_counter()
    for _ in range(chunks):
        params, opt_state, losses = fno.train_fno(
            params, Xtr, Ytr, epochs=per, batch=args.batch, lr=lr,
            weight_decay=args.weight_decay, generator=gen,
            opt_state=opt_state)
        losses_all.append(losses.numpy())
        lr *= 0.5
    t_train = time.perf_counter() - t0
    losses_all = np.concatenate(losses_all)
    epochs_run = int(losses_all.shape[0])
    log(f"train: {epochs_run} steps in {t_train:.1f}s "
        f"({epochs_run / t_train:.0f} steps/s); loss "
        f"{losses_all[0]:.3f} -> {losses_all[-1]:.5f}")

    rel_tr = fno.relative_l2(params, Xtr, Ytr)
    rel_te = fno.relative_l2(params, Xte, Yte)
    eval_times = [domain.T] if snap_times is None else list(snap_times)
    exact = _exact_fields(md, probs[args.n_train:], eval_times, X.dtype)
    rel_exact = _rel(predict(params, Xte), exact)
    rel_fem = _rel(Yte, exact)
    log(f"rel-L2 vs FEM: train {rel_tr:.4f}, holdout {rel_te:.4f}; "
        f"holdout vs closed form {rel_exact:.4f} (FEM itself "
        f"{rel_fem:.4f})")

    bs = min(128, args.n_test)
    reps = 20
    with torch.no_grad():
        fno.fno_apply(params, Xte[:bs])
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fno.fno_apply(params, Xte[:bs])
        synchronize(device)
    fields_per_s = bs / ((time.perf_counter() - t0) / reps)
    log(f"inference: {fields_per_s:.0f} fields/s (batch {bs})")

    sr = {}
    if args.superres_mesh and not args.n_times:
        md_sr = apt.MeshData(apt.create_mesh(args.superres_mesh, 20.0),
                             domain, nt=args.nt, device=args.device)
        Xsr, Ysr, probs_sr = fno.make_plume_dataset(
            md_sr, domain, torch.Generator().manual_seed(7), 64)
        pred_sr = predict(params, Xsr)
        exact_sr = _exact_fields(md_sr, probs_sr, [domain.T], Xsr.dtype)
        sr = {
            "superres_mesh": args.superres_mesh,
            "superres_grid": int(Xsr.shape[1]),
            "superres_rel_l2_vs_fem": _rel(pred_sr, Ysr),
            "superres_rel_l2_vs_exact": _rel(pred_sr, exact_sr),
            "superres_fem_vs_exact": _rel(Ysr, exact_sr),
        }
        log(f"zero-shot at {Xsr.shape[1]}^2: {sr}")

    out = {
        "mesh_size": args.mesh_size, "grid": int(X.shape[1]),
        "nt": args.nt, "n_train": args.n_train, "n_test": args.n_test,
        "n_times": args.n_times,
        "snapshot_times": None if snap_times is None
        else [float(t) for t in snap_times],
        "modes": args.modes, "width": args.width, "depth": args.depth,
        "n_params": n_params, "epochs": epochs_run,
        "batch": args.batch, "lr": args.lr, "weight_decay": args.weight_decay,
        "dataset_gen_s": t_data, "train_s": t_train,
        "train_steps_per_sec": epochs_run / t_train,
        "loss_first": float(losses_all[0]),
        "loss_last": float(losses_all[-1]),
        "rel_l2_train_vs_fem": rel_tr,
        "rel_l2_holdout_vs_fem": rel_te,
        "rel_l2_holdout_vs_exact": rel_exact,
        "rel_l2_fem_vs_exact": rel_fem,
        "inference_fields_per_sec": fields_per_s,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        **sr,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
        log(f"wrote {args.out}")
    log(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
