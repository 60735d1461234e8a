"""Checks behind the time-varying cells' gates (chip_smoke.py W1 and W3),
on the PyTorch port; imports no JAX.

1. ``rounding``: the turning wind's fused chunks (CN, Chebyshev-8,
   extrapolated) at 257^2 (nt=501, every 25) and 513^2 (nt=1001, every
   50) in f32 and f64; each chunk's interval in f32 against f64; the f32
   run on the f64 intervals against the f64 run (rounding alone); the
   scan-Chebyshev chunks on the fused chunks' intervals in f32 and f64
   (chip_smoke.IntervalTape).
2. ``interval``: one 1025^2 chunk's interval estimate as the chunks take
   it (fused_hbm.canvas_interval: B3 and B3 on the transposed grids on
   the card) against power_bounds over the plain stencil with its
   autograd transpose, seconds each, both intervals, and W1's row
   (nt=2001, every 100) in steps/s with each.
3. ``w3``: the W3 row at nt=65 and nt=257 (max|u| at T: nt=65 diverges)
   and, at 129^2, nt=33, every 8 in f64, d/d omega_t of sum(u_T^2) and of
   the W3 misfit through the differentiable fused chunks against a
   central difference (step 1e-3) of the forward chunks.

    python3 scripts/torch_port_unsteady_checks.py [--device cpu]
        [--only rounding interval w3]

One JSON line per check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.models.crbe import assemble_canvas  # noqa: E402
from airpollution_tpu_torch.models.unsteady import (  # noqa: E402
    solve_time_varying,
)
from airpollution_tpu_torch.ops import fused_hbm, linalg  # noqa: E402
from airpollution_tpu_torch.ops import stencil as stencil_mod  # noqa: E402
from chip_smoke import IntervalTape, card_line  # noqa: E402
from scripts import torch_port_unsteady_scale as sc  # noqa: E402


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def rounding(device):
    p = sc.problem()
    for ms, nt, every in ((257, 501, 25), (513, 1001, 50)):
        kw = sc.chunk_kwargs(every, 8)
        scan_kw = dict(kw, matvec_impl="scan", solver="chebyshev")
        runs = {}
        for dtype in (torch.float32, torch.float64):
            md = sc.mesh_data(ms, nt, device=device, dtype=dtype)
            tape = IntervalTape()
            with tape.record():
                fused = solve_time_varying(p, md, **kw)
            with tape.replay():
                scan = solve_time_varying(p, md, **scan_kw)
            runs[dtype] = (md, tape, fused, scan)
        md32, tape32, f32, s32 = runs[torch.float32]
        _, tape64, f64, s64 = runs[torch.float64]
        it = iter(tape64.bounds)
        real = fused_hbm.canvas_interval
        fused_hbm.canvas_interval = lambda *a: next(it)
        try:
            f32_on64 = solve_time_varying(p, md32, **kw)
        finally:
            fused_hbm.canvas_interval = real
        lo = max(abs(a[0] - b[0]) / abs(b[0])
                 for a, b in zip(tape32.bounds, tape64.bounds))
        hi = max(abs(a[1] - b[1]) / abs(b[1])
                 for a, b in zip(tape32.bounds, tape64.bounds))
        print(json.dumps({
            "check": "rounding", "ms": ms, "nt": nt, "every": every,
            "interval_f32_vs_f64_rel": [lo, hi],
            "fused_f32_vs_f64": rel(f32, f64),
            "fused_f32_on_f64_intervals_vs_f64": rel(f32_on64, f64),
            "scan_vs_fused_same_intervals_f32": rel(s32, f32),
            "scan_vs_fused_same_intervals_f64": rel(s64, f64)}), flush=True)


def interval(device):
    md = sc.mesh_data(1025, 2001, device=device)
    p = sc.problem()
    dt = 10.0 / 2000
    pattern = stencil_mod.family_pattern(md)
    with torch.no_grad():
        coeffs, _, diag = assemble_canvas(md, p, dt, 2, coeff_time=5.0)
    fused_hbm.canvas_interval(pattern, coeffs, diag)  # warm-up
    b3, s_b3 = sc.timed(lambda: fused_hbm.canvas_interval(
        pattern, coeffs, diag), md.device)

    def autograd_transpose():
        lo, hi = linalg.power_bounds(
            lambda x: stencil_mod.stencil_matvec(pattern, coeffs, x),
            torch.zeros_like(diag), scale=1.0 / torch.sqrt(diag))
        return float(lo), float(hi)

    autograd_transpose()
    plain, s_plain = sc.timed(autograd_transpose, md.device)
    # The whole W1 row (20 chunks) with each estimate.
    kw = sc.chunk_kwargs(100, 8)
    _, s_w1 = sc.timed(lambda: solve_time_varying(p, md, **kw), md.device)
    real = fused_hbm.canvas_interval
    fused_hbm.canvas_interval = lambda *a: autograd_transpose()
    try:
        _, s_w1_plain = sc.timed(lambda: solve_time_varying(p, md, **kw),
                                 md.device)
    finally:
        fused_hbm.canvas_interval = real
    print(json.dumps({"check": "interval", "ms": 1025,
                      "b3_both_ways_s": s_b3, "b3_interval": b3,
                      "autograd_transpose_s": s_plain,
                      "autograd_interval": plain,
                      "w1_steps_per_s": 2000 / s_w1,
                      "w1_steps_per_s_autograd_interval": 2000 / s_w1_plain}),
          flush=True)


def w3(device):
    out = {"check": "w3"}
    for nt in (65, 257):
        md = sc.mesh_data(257, nt, device=device)
        u = solve_time_varying(sc.problem(), md, **sc.chunk_kwargs(16, 8))
        out[f"max_u_nt{nt}"] = float(u.abs().max())
    md = sc.mesh_data(129, 33, device=device, dtype=torch.float64)
    t_col = torch.full((md.number_of_segments, 1), 10.0,
                       dtype=torch.float64, device=md.device)
    obs = apt.TurningWindProblem(speed=1.0, omega_t=0.4, D=0.3)\
        .analytical_solution(torch.cat([md.midpoints, t_col], dim=1))
    kw = sc.chunk_kwargs(8, 8)
    losses = {"sum_u2": lambda u: (u[-1] ** 2).sum(),
              "misfit": lambda u: ((u[-1] - obs) ** 2).sum()}
    for name, loss in losses.items():
        om = torch.tensor(0.5, dtype=torch.float64, device=md.device,
                          requires_grad=True)
        u = solve_time_varying(apt.TurningWindProblem(
            speed=1.0, omega_t=om, D=0.3), md, differentiable=True, **kw)
        (g,) = torch.autograd.grad(loss(u), om)

        def forward(w):
            with torch.no_grad():
                return float(loss(solve_time_varying(apt.TurningWindProblem(
                    speed=1.0, omega_t=w, D=0.3), md, **kw)))

        fd = (forward(0.501) - forward(0.499)) / 2e-3
        out[f"{name}_grad"] = float(g)
        out[f"{name}_central_difference"] = fd
        out[f"{name}_rel"] = abs(float(g) - fd) / abs(fd)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--only", nargs="+", default=["rounding", "interval",
                                                  "w3"])
    args = ap.parse_args()
    t0 = time.perf_counter()
    for name in args.only:
        {"rounding": rounding, "interval": interval, "w3": w3}[name](
            args.device)
    if torch.cuda.is_available() and args.device in (None, "cuda"):
        print(card_line(), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
