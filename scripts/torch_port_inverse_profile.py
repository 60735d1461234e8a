#!/usr/bin/env python3
"""Where one Adam step of the port's source inversion spends its time on
the GPU: I1's configuration (scripts/torch_port_source_inversion.py, 513^2,
nt=128, 96 sensors, 8 snapshots, engine="auto" -> kernel B4's raw mode,
Chebyshev-12, float32).

Prints one JSON line with, on the host clock around work that ends in
torch.cuda.synchronize() (best of ``--reps``):

- interval_s: the power estimate of the Chebyshev interval, which each
  solve runs once (``linalg.power_bounds`` on the uniform matvec);
- forward_nograd_s: one solve_snapshots under torch.no_grad() (no
  checkpoint, no graph);
- forward_s: the same solve with the graph (checkpointed steps) and the
  misfit;
- backward_s: its backward (each step's checkpoint recompute, then the
  adjoint sweep and the operator's vector-Jacobian product);
- adam_step_s: a whole fit_parameters step (forward + backward + update);
- posterior_s: posterior_covariance (3 forward-mode solves + 1 residual);

and from torch.profiler over one Adam step: the device-busy time (the sum
of kernel times), B4's raw-mode kernel time and launches, the number of
device kernels, and the idle share 1 - busy / wall; and over the forward
and the backward apart, their device kernels and busy time. Needs one
CUDA card.

    python3 scripts/torch_port_inverse_profile.py [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402
from scripts import torch_port_source_inversion as si  # noqa: E402


def timed(fn, reps):
    """(best seconds, last result) of ``fn`` over ``reps`` synchronised
    runs."""
    best, out = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def interval(md):
    """A function that estimates the Chebyshev interval of I1's operator,
    as run_time_loop does once per differentiable solve."""
    from airpollution_tpu_torch.models.crbe import assemble
    from airpollution_tpu_torch.ops import linalg, stencil, uniform

    problem = apt.GaussianSourceProblem(**si.TRUE)
    ops = assemble(md, problem, md.domain.T / (md.nt - 1), 1, "correct")
    pattern = stencil.get_pattern(md)
    ops_fam, matvec, _ = uniform.uniform_family_operators(
        uniform.build_uniform_spec(pattern), pattern, ops, 1)
    example = torch.zeros_like(ops_fam.system_diag)
    scale = 1.0 / torch.sqrt(ops_fam.system_diag)
    return lambda: linalg.power_bounds(matvec.detached(), example,
                                       scale=scale)


def profiled(fn):
    """``(device-busy us, B4 kernel us, device kernels, wall s)`` of one
    synchronised call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, raw_us, kernels = 0.0, 0.0, 0
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", 0.0)
        if dev <= 0:
            continue
        busy_us += dev
        kernels += evt.count
        if "canvas_step_kernel" in evt.key:
            raw_us += dev
    return busy_us, raw_us, kernels, wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh_size", type=int, default=513)
    ap.add_argument("--nt", type=int, default=128)
    ap.add_argument("--sensors", type=int, default=96)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    md = apt.MeshData(apt.create_mesh(args.mesh_size, 20.0), apt.Domain(),
                      nt=args.nt)
    idx = si.snapshot_indices(args.nt)
    obs, sens = si.observations(md, args.sensors, 0.01, "auto", 12)
    obs_t = torch.tensor(obs, dtype=md.dtype, device=md.device)
    sens_t = torch.as_tensor(sens, device=md.device)
    theta0 = {"log_q": np.log(0.5), "xy": np.zeros(2)}

    def problem(params):
        return apt.GaussianSourceProblem(
            q=torch.exp(params["log_q"]), xs=params["xy"][0],
            ys=params["xy"][1], sigma_s=si.TRUE["sigma_s"])

    def leaves(grad):
        return {k: torch.tensor(v, dtype=md.dtype, device=md.device,
                                requires_grad=grad)
                for k, v in theta0.items()}

    def predict(params):
        return inverse.solve_snapshots(problem(params), md, indices=idx,
                                       tol=1e-8, maxiter=60)[:, sens_t]

    def forward_nograd():
        with torch.no_grad():
            return predict(leaves(False))

    def forward():
        p = leaves(True)
        return p, torch.mean((predict(p) - obs_t) ** 2)

    out = {"mesh_size": args.mesh_size, "nt": args.nt,
           "card": si.card_line(),
           "device_name": torch.cuda.get_device_name(0)}
    out["interval_s"], _ = timed(interval(md), args.reps)
    out["forward_nograd_s"], _ = timed(forward_nograd, args.reps)
    out["forward_s"], _ = timed(forward, args.reps)
    back = []
    for _ in range(args.reps):
        p, loss = forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        back.append(time.perf_counter() - t0)
    out["backward_s"] = min(back)

    def adam_steps(n):
        return inverse.fit_parameters(
            obs_t, md, problem, theta0, snapshot_indices=idx,
            sensor_indices=sens, steps=n, lr=0.1, tol=1e-8, maxiter=60)

    adam_steps(1)  # warm-up
    out["adam_step_s"], _ = timed(lambda: adam_steps(1), args.reps)
    out["posterior_s"], _ = timed(lambda: inverse.posterior_covariance(
        md, problem, theta0, snapshot_indices=idx,
        sensor_indices=[int(i) for i in sens], observed=obs, tol=1e-8,
        maxiter=60), 1)

    fused_hbm.CANVAS_RAW_KERNEL.launches = 0
    busy_us, raw_us, kernels, wall = profiled(lambda: adam_steps(1))
    raw_launches = fused_hbm.CANVAS_RAW_KERNEL.launches
    f_busy, _, f_kernels, _ = profiled(forward)
    p, loss = forward()
    b_busy, _, b_kernels, _ = profiled(
        lambda: torch.autograd.grad(loss, list(p.values())))
    out.update({
        "forward_device_kernels": f_kernels,
        "forward_device_busy_s": f_busy * 1e-6,
        "backward_device_kernels": b_kernels,
        "backward_device_busy_s": b_busy * 1e-6,
    })
    out.update({
        "profiled_adam_step_wall_s": wall,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": (1.0 - busy_us * 1e-6 / wall
                              if busy_us > 0 else None),
        "b4_raw_kernel_s": raw_us * 1e-6,
        "b4_raw_launches": raw_launches,
        "device_kernels": kernels,
        "profiler_device_time_seen": busy_us > 0,
    })
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
