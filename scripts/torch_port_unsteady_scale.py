"""Time-varying wind at production scale on the PyTorch + CUDA port.

The counterpart of scripts/unsteady_scale_demo.py (the JAX package's;
this script imports no JAX). A veering wind (TurningWindProblem: speed 1,
direction turning at 0.5 rad per unit time, D = 0.3) makes the operator
change with time, so models/unsteady.solve_time_varying reassembles it at
each chunk's midpoint (models/crbe.assemble_canvas), re-estimates the
Chebyshev interval (ops/fused_hbm.canvas_interval) and runs the chunk on
kernel B4, one launch per step (``matvec_impl="fused_hbm"``). Crank-
Nicolson, Chebyshev-8, extrapolated warm start, float32.

Per row: the first and a warm solve's time and steps/s (the per-chunk
reassembly included), one middle chunk's seconds in assembly, interval
and the B4 sweep, final_max, rel_l2 against the closed form at T, and the
relative max change when ``reassemble_every`` is halved. Rows 513^2
(nt=1001, every 50) and 1025^2 (nt=2001, every 100). Run on the card:

    python3 scripts/torch_port_unsteady_scale.py [--out rows.json]

or on the CPU through B4's plain version at a small size:

    python3 scripts/torch_port_unsteady_scale.py --device cpu \\
        --mesh_sizes 33 --nt 101 --reassemble_every 10
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
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402
from airpollution_tpu_torch.ops import stencil as stencil_mod  # noqa: E402


def log(*a):
    print(*a, flush=True)


def problem():
    """The storm-passage wind of the JAX script."""
    return apt.TurningWindProblem(speed=1.0, omega_t=0.5, D=0.3)


def mesh_data(ms, nt, *, device=None, dtype=torch.float32):
    return apt.MeshData(apt.create_mesh(ms, 20.0), apt.Domain(), nt=nt,
                        dtype=dtype, device=device)


def chunk_kwargs(every, iters, **kw):
    """solve_time_varying's arguments of the script's fused chunks."""
    return dict(reassemble_every=every, time_scheme_order=2,
                chebyshev_iters=iters, extrapolate_warm_start=True,
                store_solutions=False, matvec_impl="fused_hbm", **kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """``(result, seconds)`` of ``fn()`` on the host clock, ending in a
    synchronisation."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def rel_l2(u, md, p):
    """rel_l2 of the (n,) state ``u`` against the closed form at T."""
    t = torch.full((md.number_of_segments, 1), float(md.domain.T),
                   dtype=md.midpoints.dtype, device=md.device)
    ex = p.analytical_solution(torch.cat([md.midpoints, t], dim=1))
    return float(torch.linalg.norm(u - ex) / torch.linalg.norm(ex))


def chunk_breakdown(md, p, every, iters):
    """Host seconds of the middle chunk's three parts, each ending in a
    synchronisation: assemble_canvas at its midpoint, the interval
    estimate, and its ``every`` steps on B4 from the initial state (the
    sweep's cost does not depend on the state). Returns a dict."""
    n_steps = md.nt - 1
    dt = float(md.domain.T) / n_steps
    t0 = (n_steps // every // 2) * every * dt
    pattern = stencil_mod.family_pattern(md)
    perm = torch.as_tensor(pattern.perm.astype("int64"), device=md.device)
    with torch.no_grad():
        (coeffs, mass, diag), s_asm = timed(lambda: assemble_canvas(
            md, p, dt, 2, coeff_time=t0 + 0.5 * every * dt), md.device)
        bounds, s_int = timed(lambda: fused_hbm.canvas_interval(
            pattern, coeffs, diag), md.device)
        mass = torch.where(md.boundary_mask[perm], torch.zeros_like(mass),
                           mass)
        u0 = p.initial_condition_fn(md.midpoints)[perm]
        _, s_sweep = timed(lambda: fused_hbm.fused_solve_canvas_hbm(
            pattern, coeffs, mass, 1.0 / diag, u0, n_steps=every,
            n_iters=iters, bounds=bounds, use_ka=True, extrapolate=True,
            t0=t0), md.device)
    return {"assembly_s": s_asm, "interval_s": s_int, "b4_sweep_s": s_sweep,
            "outside_kernel_s": s_asm + s_int}


def run(ms, nt, every, iters, *, warm=True, device=None,
        dtype=torch.float32):
    md = mesh_data(ms, nt, device=device, dtype=dtype)
    p = problem()
    n_steps = nt - 1
    kw = chunk_kwargs(every, iters)
    out = {"mesh_size": ms, "n_dofs": int(md.number_of_segments), "nt": nt,
           "reassemble_every": every, "chebyshev_iters": iters,
           "scheme": "crank-nicolson", "device": str(md.device),
           "dtype": str(dtype).split(".")[-1]}
    if md.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    u, first = timed(lambda: solve_time_varying(p, md, **kw), md.device)
    out["first_solve_s"] = first
    log(f"[{ms}^2] first solve {first:.2f} s ({n_steps // every} chunks)")
    if warm:
        u, secs = timed(lambda: solve_time_varying(p, md, **kw), md.device)
        out["warm_solve_s"] = secs
        out["steps_per_sec"] = n_steps / secs
        log(f"[{ms}^2] warm {secs:.3f} s -> {n_steps / secs:.0f} steps/s "
            f"({n_steps // every} reassemblies included)")
    un = u[0]
    if not bool(torch.isfinite(un).all()):
        raise FloatingPointError(f"[{ms}^2] the solve is not finite")
    out["final_max"] = float(un.abs().max())
    out["rel_l2"] = rel_l2(un, md, p)
    out.update(chunk_breakdown(md, p, every, iters))
    u2 = solve_time_varying(p, md, **chunk_kwargs(every // 2, iters))[0]
    out["halved_chunk_rel_maxdiff"] = float((u2 - un).abs().max()
                                            / un.abs().max())
    log(f"[{ms}^2] halving reassemble_every: rel maxdiff "
        f"{out['halved_chunk_rel_maxdiff']:.2e}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh_sizes", type=int, nargs="+", default=[513, 1025])
    ap.add_argument("--nt", type=int, nargs="+", default=[1001, 2001])
    ap.add_argument("--reassemble_every", type=int, nargs="+",
                    default=[50, 100])
    ap.add_argument("--chebyshev_iters", type=int, default=8)
    ap.add_argument("--no_warm", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    rows = []
    for ms, nt, every in zip(args.mesh_sizes, args.nt, args.reassemble_every,
                             strict=True):
        rows.append(run(ms, nt, every, args.chebyshev_iters,
                        warm=not args.no_warm, device=args.device))
        log(json.dumps(rows[-1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
