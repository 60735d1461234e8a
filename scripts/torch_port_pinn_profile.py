#!/usr/bin/env python3
"""Where a PINN epoch's time goes on the card: the widest cell of
chip_smoke.py ([3, 64 x 4, 1] tanh, the ms=128 collocation budget
{34744, 6949, 6949}, f32) or the levers cell (``--cell levers``: Fourier 64
and causal weighting at the ms=64 budget).

Trains ``--warm`` epochs, times ``--epochs`` more (wall ms per epoch on
the host clock, ending in torch.cuda.synchronize), then profiles as many
with torch.profiler (CUDA activity): device busy ms per epoch (the union
of the kernels' intervals, user annotations left out), the idle share of
the unprofiled epoch (1 - busy / wall) and of the profiled one, kernels
per epoch and the kernels that take most of the device time. Also times
finetune_lbfgs's steps after a first one. Prints one JSON line with the
card's name and power limit.

    python3 scripts/torch_port_pinn_profile.py
    python3 scripts/torch_port_pinn_profile.py --cell levers --out chiprun_out
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402

LAYERS = [3, 64, 64, 64, 64, 1]
LAMBDA = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
CELLS = {
    "widest": dict(batch={"pde": 34744, "ic": 6949, "bc": 6949}, model={},
                   train={}),
    "levers": dict(batch={"pde": 8595, "ic": 1719, "bc": 1719},
                   model={"fourier_features": 64},
                   train={"causal_eps": 1.0}),
}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def busy_ms(events):
    """Length of the union of the kernels' device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    start = None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=sorted(CELLS), default="widest")
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lbfgs_steps", type=int, default=10)
    ap.add_argument("--out", default="", help="directory for the trace")
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    cell = CELLS[args.cell]
    model = apt.PINN(LAYERS, apt.Problem(sigma=1.0), apt.Domain(),
                     activation="tanh", seed=1234, **cell["model"])

    def train(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(cell["batch"], n, 1e-4, LAMBDA, warm_start=True,
                    early_stopping_patience=1000, **cell["train"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    train(args.warm)
    plain_ms = train(args.epochs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = train(args.epochs)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_ms(kernels) / args.epochs
    by_name = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"pinn_{args.cell}_trace.json"))
    model.finetune_lbfgs(cell["batch"], 1, LAMBDA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.finetune_lbfgs(cell["batch"], args.lbfgs_steps, LAMBDA)
    torch.cuda.synchronize()
    lbfgs_ms = (time.perf_counter() - t0) / args.lbfgs_steps * 1e3
    print(json.dumps({
        "cell": args.cell, "card": card_line(), "batch": cell["batch"],
        "epoch_ms": plain_ms, "epochs_per_s": 1e3 / plain_ms,
        "epoch_ms_profiled": prof_ms, "device_busy_ms_per_epoch": busy,
        "idle_share": max(0.0, 1.0 - busy / plain_ms),
        "idle_share_profiled": max(0.0, 1.0 - busy / prof_ms),
        "kernels_per_epoch": len(kernels) / args.epochs,
        "top_kernels": [{"name": n[:90], "per_epoch": c / args.epochs,
                         "ms_per_epoch": ms / args.epochs}
                        for n, (c, ms) in top],
        "lbfgs_step_ms": lbfgs_ms,
    }), flush=True)


if __name__ == "__main__":
    main()
