#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` for sm_90a, and the repository's
``airpollution_tpu_torch`` package; it builds the CUDA kernels from
``airpollution_tpu_torch/csrc/`` and exits non-zero on any failure (and
without a result line when there is no card or no package).

Phases, each printing one JSON line:

1. toolchain: CUDA version, nvcc, kernel build time, card and power limit;
2. kernels B1-B5 against their plain PyTorch versions, f64 and f32: B1
   (uniform whole-loop solve), B2 (uniform step per launch), B3 (stencil
   matvec), B4 (canvas step per launch; at 129^2 every depth its launch
   plan can split a step into), B5 (canvas whole-loop BiCGStab);
3. the uniform main path at 257^2, nt=1001: CRBESolver(matvec_impl="fused",
   Chebyshev-4, extrapolated warm start), BE and CN, held against the scan
   path (matvec_impl="stencil", BiCGStab) and the analytical solution;
4. the uniform path past the whole-loop size: 1025^2,
   matvec_impl="fused_hbm", Chebyshev-8, extrapolated;
5. the canvas operator (per-DOF coefficients): C1, a rotating wind at
   1025^2 on B4 (Chebyshev-14, BE and CN); C2, the same problem at 257^2 on
   B5 (BiCGStab-5); C3, Robin walls and an obstacle at 257^2 on B4 (CN,
   Chebyshev-8) and on the scan path through B3 (with its steps/s beside
   the plain stencil's);
6. kernel B6 (multispecies step with in-kernel chemistry; K = 1, 3 and 8
   at 129^2, every depth) and B4 with an emission load against their
   plain versions, f64 and f32;
7. the multispecies chemistry-transport path (MultiSpeciesSolver, Strang,
   fused_hbm): M1, the largest row of scripts/multispecies_fused_demo.py
   (1025^2, nt=4001, K=3, CN, Chebyshev-8) on B6, with its k-vs-2k and
   fuse_chemistry=False (B4) checks and chain masses against the f64
   oracle; M2 (257^2, nt=1001, Chebyshev-6) against the stencil scan and
   with strided snapshots;
8. slice 4, sourced, Robin-flux and BiCGStab fused solves: kernel B1 with
   a steady load plane and with a per-step load stack, B1's BiCGStab
   variant, B2 with a load and B4 with a source + Robin flux plane against
   their plain versions (f64 and f32); S1, tpu_sourced_fused.py's 257^2 row
   (a Gaussian emitter, B1 with a load); S2, its 513^2 row on fused_hbm
   (B2 with a load); S3, the plume at 257^2 with the default
   solver_method (B1's BiCGStab variant), BE and CN, and one sourced
   BiCGStab solve; P1 and P2, scripts/torch_port_production_scenario.py
   at 1025^2 (nt=2001, a row every 200) and 513^2 with the
   compensation-point flux (nt=1001, a row every 100) on B4 with its load
   plane, with the lumped-mass budget; then the launch variants of the
   uniform tile step and the BiCGStab loop against their plain versions
   (f64, f32): B2 at its plan, a 16 x 40 tile and depths 2-4, with and
   without a load; B8 on 4 blocks at depth 1 and 2; B1 at depth 2; B5
   and B1's BiCGStab variant in every cells-per-thread mode and global
   mode at 129^2, and at their plans at 513^2;
9. slice 5, differentiable fused solves and source inversion: B4's raw
   mode (p(A) mask(b), kernel B4 with raw_b) against its plain version at
   513^2 and 1025^2 (I1's uniform operator, f32) and 257^2 (C1's variable
   operator, f64 and f32; also k = 24, and every depth its launch plan can
   split a step into), k = 12 and 8, over the coefficients and their
   transpose, with the adjoint dot-product test; gradients through the
   fused engine (engine="fused_hbm", Chebyshev-24) at 129^2, f64, nt=129,
   BE and CN, for Problem(D) and the emitter's (log q, xs, ys), against
   the scan engine and central differences; I1, the production source
   inversion of scripts/torch_port_source_inversion.py at 513^2, nt=128
   (96 sensors, 8 snapshots, 1% noise, 120 Adam steps, the posterior),
   whose solves run on B4's raw mode;
10. slice 6, general meshes: kernel B7 (the ELL gather) against its plain
    version on the 257^2 (f64, f32) and 1025^2 (f32) unstructured system
    operators, one x, a batch, a stack, the transposed backward and both
    JAX-named entry points; its times beside cuSPARSE's CSR product and the
    1025^2 mesh set-up (Delaunay, edges numpy and native, ELL pattern; the
    native library must load); U1, CRBESolver on the 257^2 unstructured
    mesh (f32, nt=1001) on B7 in BE, CN (BiCGStab) and Chebyshev, against
    the same solve through B7's plain version; G1, gradients and a
    posterior at 129^2 unstructured (f64), B7 against plain; the mirrored
    257^2 grid written and read as a .msh file, its flip-solve-flip on B3
    against the general-ELL solve of the raw triangulation on B7;
12. slice 7, the block-sharded solvers (parallel/hbm_shard.py) on 4
    blocks of one card: kernels B8, B9 and B10 (the block modes of B2, B4
    and B6), each with and without a load, against their plain versions
    at 257^2 and 513^2 on 2 and 4 blocks (f64, f32, 3 steps with the
    exchange between them; B9 and B10 at every depth at 257^2) and at
    their main paths' shapes (f32), their
    times beside one block step and one whole-canvas launch; B8 on scripts/tpu_hbm_check.py's 2049^2 row
    (patch assembly, BE, and one CN and one sourced solve) against the
    whole-canvas B2 solve; B9 on C1 against C1's B4 solve, and C3 on 2
    blocks with strided rows (dead DOFs exactly 0); B10 on M1's chain
    against M1's B6 solve;
13. the kernels line (launches on each path, errors, times, bounds; for
    B3 and B7 also the host's time to enqueue one launch and the device
    time alone, from a CUDA graph of 200 launches replayed).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory and non-tensor-core float32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# name, source, TPU kernel it replaces.
KERNELS = {
    "B1": ("uniform_solver", "airpollution_tpu_torch/csrc/uniform_solver.cu",
           "airpollution_tpu/ops/pallas_solver.py:230"),
    "B2": ("uniform_step", "airpollution_tpu_torch/csrc/uniform_step.cu",
           "airpollution_tpu/ops/pallas_hbm.py:201"),
    "B3": ("stencil_matvec", "airpollution_tpu_torch/csrc/stencil_matvec.cu",
           "airpollution_tpu/ops/pallas_stencil.py:39"),
    "B4": ("canvas_step", "airpollution_tpu_torch/csrc/canvas_step.cu",
           "airpollution_tpu/ops/pallas_hbm.py:518"),
    "B5": ("canvas_solver", "airpollution_tpu_torch/csrc/canvas_solver.cu",
           "airpollution_tpu/ops/pallas_solver.py:94"),
    "B6": ("multispecies_step",
           "airpollution_tpu_torch/csrc/multispecies_step.cu",
           "airpollution_tpu/ops/pallas_hbm.py:844"),
    "B1-load": ("uniform_solver (source load)",
                "airpollution_tpu_torch/csrc/uniform_solver.cu",
                "airpollution_tpu/ops/pallas_solver.py:230"),
    "B1-BiCGStab": ("uniform_bicgstab",
                    "airpollution_tpu_torch/csrc/uniform_bicgstab.cu",
                    "airpollution_tpu/ops/pallas_solver.py:230"),
    "B2-load": ("uniform_step (source load)",
                "airpollution_tpu_torch/csrc/uniform_step.cu",
                "airpollution_tpu/ops/pallas_hbm.py:201"),
    "B4-load": ("canvas_step (source + Robin flux load)",
                "airpollution_tpu_torch/csrc/canvas_step.cu",
                "airpollution_tpu/ops/pallas_hbm.py:518"),
    "B4-raw": ("canvas_step (raw_b: p(A) b, forward and adjoint)",
               "airpollution_tpu_torch/csrc/canvas_step.cu",
               "airpollution_tpu/ops/pallas_hbm.py:691"),
    "B7a": ("ell_gather (forward and transposed)",
            "airpollution_tpu_torch/csrc/ell_gather.cu",
            "airpollution_tpu/ops/pallas_gather.py:63"),
    "B7b": ("ell_gather (entry ell_matvec_vmem_roll)",
            "airpollution_tpu_torch/csrc/ell_gather.cu",
            "airpollution_tpu/ops/pallas_gather.py:86"),
    "B8": ("uniform_block_step (B2's block mode)",
           "airpollution_tpu_torch/csrc/uniform_step.cu",
           "airpollution_tpu/parallel/hbm_shard.py:221"),
    "B8-load": ("uniform_block_step (source load)",
                "airpollution_tpu_torch/csrc/uniform_step.cu",
                "airpollution_tpu/parallel/hbm_shard.py:221"),
    "B9": ("canvas_block_step (B4's block mode)",
           "airpollution_tpu_torch/csrc/canvas_step.cu",
           "airpollution_tpu/parallel/hbm_shard.py:570"),
    "B10": ("multispecies_block_step (B6's block mode)",
            "airpollution_tpu_torch/csrc/multispecies_step.cu",
            "airpollution_tpu/parallel/hbm_shard.py:945"),
}

# C1's Chebyshev iterations. The configuration of
# scripts/tpu_varcoef_scaling.py (k=6, extrapolated) diverges at 1025^2,
# nt=1001 in both packages although the applicability check passes it (its
# diffusion number D dt / h^2 is ~2); k=14 is the smallest count that
# converges in BE (8 suffices) and CN alike (PERF.md, section 6).
C1_ITERS = 14

# The multispecies cells: the decay chain of
# scripts/multispecies_fused_demo.py (make_problem), and the chain masses
# of its f64 oracle (results_snapshot/multispecies_fused.json,
# mass_oracle_*: the JAX package's stencil scan with tight BiCGStab in f64
# on the CPU, not a TPU figure).
DEMO_ITERS = {1025: 8, 257: 6}
ORACLE_MASSES = {
    1025: (4.908422111253186, 7.476449759345221, 7.615124509185543),
    257: (4.908417411286732, 7.476452686725357, 7.615125384751755),
}
MASS_TOL = 5e-3

# Kernel-vs-plain bounds on max|kernel - plain|, relative to max|plain|.
# The kernels contract multiply-adds into FMAs and B5 sums its dot
# products in another order than torch.sum; both stay far inside these.
TOL = {"float64": 1e-12, "float32": 1e-5}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


T_START = time.perf_counter()


def emit(obj):
    """Print one JSON line, with the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=time.perf_counter() - T_START)),
          flush=True)


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps=200, batches=3):
    """Host ms to enqueue one call of ``fn``, the card not awaited (the
    median of ``batches`` runs of ``reps`` calls): where it is as long as
    the call's time on the card, the launch path and not the card sets the
    pace."""
    import torch

    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, reps=200):
    """(device ms per call of ``fn``, how): ``reps`` calls captured in one
    CUDA graph and replayed, timed with CUDA events, so that no host work
    sits between the launches ("graph"); where capture is refused, the
    mean kernel time per call from torch.profiler ("profiler")."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in prof.key_averages())
        return total / 1e3 / reps, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms, "graph"


def step_flops_per_dof(k, use_ka, extrapolate):
    """Floating-point operations per DOF of one step: a stencil row is 5
    multiplies and 4 adds; the RHS, warm start, first residual and the k
    iterations (x += d, r -= A d, d = a d + b r) add their axpys. The last
    iteration's r and d are never read, so it counts as x += d alone."""
    row = 9
    rhs = 1 + (row + 2 if use_ka else 0)
    warm = 2 if extrapolate else 0
    first = row + 1 + 1
    return rhs + warm + first + (k - 1) * (1 + row + 1 + 3) + 1


def canvas_step_flops_per_dof(k, use_ka, extrapolate):
    """Floating-point operations per DOF of one canvas step (B4): the RHS
    (BE M u; CN 2 M u + (1 - mask) u - S u), the warm start, the first
    residual and d = (id r) / theta, then k iterations (x += d, r -= S d,
    d = a d + b (id r)), the last of which is only x += d."""
    row = 9
    rhs = (row + 6) if use_ka else 1
    warm = 3 if extrapolate else 1
    first = row + 1 + 2
    return rhs + warm + first + (k - 1) * (1 + row + 1 + 4) + 1


def bicgstab_flops_per_dof(k, use_ka, extrapolate):
    """Floating-point operations per DOF of one B5 step: the RHS, the warm
    start and the first residual, then k BiCGStab iterations of two
    matvecs, four dot products and six vector updates (40 per DOF)."""
    row = 9
    rhs = (row + 6) if use_ka else 1
    warm = 3 if extrapolate else 1
    first = row + 1
    iteration = 2 * row + 4 * 2 + 4 + 1 + 2 + 2 + 1 + 2 + 2
    return rhs + warm + first + k * iteration


def bound(n_bytes, flops):
    """Least time (ms) at the card's peak rates, and which rate bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def uniform_inputs(md, problem, order, k, dtype):
    """The kernels' inputs from the port's own assembly: scalar block,
    initial canvas, and the Chebyshev interval."""
    import torch
    from functools import partial

    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.ops import fused_solver, linalg
    from airpollution_tpu_torch.ops import stencil, uniform

    dt = md.domain.T / (md.nt - 1)
    ops = crbe.assemble(md, problem, dt, order, "reference")
    pattern = stencil.get_pattern(md)
    spec = uniform.build_uniform_spec(pattern)
    perm = torch.as_tensor(pattern.perm.astype("int64"), device=md.device)
    consts = uniform.extract_constants(spec, ops.system.vals)
    lo, hi = linalg.power_bounds(
        partial(uniform.uniform_matvec, spec, consts),
        torch.zeros_like(ops.system_diag),
        scale=1.0 / torch.sqrt(ops.system_diag[perm]),
    )
    scal = fused_solver.step_scalars(
        consts, uniform.family_constants(spec, ops.mass_diag),
        1.0 / uniform.family_constants(spec, ops.system_diag),
        (float(lo), float(hi)), k, dtype,
    )
    u0 = problem.initial_condition_fn(md.midpoints)[perm]
    return scal, fused_solver.to_canvases(spec, u0).to(dtype)


def rel_err(got, ref):
    import torch

    diff = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return float(diff.max()), float(diff.max() / ref.abs().max()), diff


def phase_toolchain():
    import torch

    from airpollution_tpu_torch import _build

    nvcc = _build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    per_source = _build.build(list(dict.fromkeys(
        source.rsplit("/", 1)[1] for _, source, _ in KERNELS.values())))
    emit({"phase": "toolchain", "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc,
          "nvcc_version": version.splitlines()[-1],
          "build_s": time.perf_counter() - t0,
          "build_s_per_source": per_source,
          "card": card_line(),
          "device_name": torch.cuda.get_device_name(0)})


def kernel_objects():
    """Kernel id -> the _build.Kernel that counts its launches."""
    from airpollution_tpu_torch.ops import fused_hbm, fused_solver
    from airpollution_tpu_torch.ops import fused_stencil, gather

    return {"B1": fused_solver.KERNEL, "B2": fused_hbm.KERNEL,
            "B3": fused_stencil.KERNEL, "B4": fused_hbm.CANVAS_KERNEL,
            "B5": fused_solver.CANVAS_KERNEL,
            "B6": fused_hbm.MULTISPECIES_KERNEL,
            "B1-load": fused_solver.LOAD_KERNEL,
            "B1-BiCGStab": fused_solver.BICGSTAB_KERNEL,
            "B2-load": fused_hbm.LOAD_KERNEL,
            "B4-load": fused_hbm.CANVAS_KERNEL,
            "B4-raw": fused_hbm.CANVAS_RAW_KERNEL,
            "B7a": gather.KERNEL, "B7b": gather.KERNEL,
            "B8": fused_hbm.BLOCK_KERNEL,
            "B8-load": fused_hbm.BLOCK_LOAD_KERNEL,
            "B9": fused_hbm.CANVAS_BLOCK_KERNEL,
            "B10": fused_hbm.MULTISPECIES_BLOCK_KERNEL}


def reset_counts():
    """Set every kernel's launch count to 0."""
    for k in kernel_objects().values():
        k.launches = 0


def launches_of(kid):
    return kernel_objects()[kid].launches


def phase_b1(meshes, problem):
    """Kernel B1 against plain_solve: 65^2 with nt=33 in every variant,
    and 257^2 (11 x 11 tiles) with BE/CN extrapolated."""
    import torch

    from airpollution_tpu_torch.ops import fused_solver

    worst = {}
    rows = []
    cases = [(65, 32, o, e) for o in (1, 2) for e in (False, True)]
    cases += [(257, 16, o, True) for o in (1, 2)]
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms, n_steps, order, ext in cases:
            scal, u3 = uniform_inputs(meshes[(ms, name)], problem, order, 4,
                                      dtype)
            kw = dict(n_steps=n_steps, n_iters=4, use_ka=order == 2,
                      extrapolate=ext)
            got, _ = fused_solver.kernel_solve(scal, u3, **kw)
            ref, _ = fused_solver.plain_solve(scal, u3, **kw)
            torch.cuda.synchronize()
            abs_e, rel, _ = rel_err(got, ref)
            rows.append({"ms": ms, "dtype": name, "order": order,
                         "extrapolate": ext, "rel_err": rel})
            check(rel <= TOL[name],
                  f"B1 {ms}^2 {name} order={order} ext={ext}: rel err "
                  f"{rel:.3e} > {TOL[name]:.0e}")
            if ms == 257 and name == "float32":
                worst["B1"] = max(worst.get("B1", 0.0), abs_e)
    emit({"phase": "b1_vs_plain", "cases": rows})
    return worst


def phase_b2(meshes, problem):
    """Kernel B2 against plain_step at 129^2 and 1025^2, k = 4 and 8, BE and
    CN, one step from a state that differs from u_prev."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 1025):
            for k in (4, 8):
                for order in (1, 2):
                    use_ka = order == 2
                    scal, u0 = uniform_inputs(meshes[(ms, name)], problem,
                                              order, k, dtype)
                    masks = fused_solver.rect_masks(u0.shape[-1], dtype,
                                                     u0.device)
                    u, up = fused_solver.plain_step(scal, k, u0, u0, use_ka,
                                                    masks)
                    ref_u, ref_up = fused_solver.plain_step(
                        scal, k, u, up, use_ka, masks)
                    plan = fused_solver.uniform_plan(k, use_ka, dtype,
                                                     u.shape[-1])
                    got_u = torch.empty_like(u)
                    got_up = torch.empty_like(u)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up,
                                          use_ka, halt, plan)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got_u, ref_u)
                    check(bool(torch.equal(got_up, ref_up)),
                          f"B2 {ms}^2 k={k}: u_prev output differs")
                    f, r, c = (int(i) for i in torch.unravel_index(
                        diff.argmax(), diff.shape))
                    rows.append({"ms": ms, "dtype": name, "k": k,
                                 "order": order, "plan": plan,
                                 "rel_err": rel,
                                 "worst_at": {"family": "HVD"[f], "row": r,
                                              "col": c,
                                              "tile": [r // plan.th,
                                                       c // plan.tw],
                                              "in_tile": [r % plan.th,
                                                          c % plan.tw]}})
                    check(rel <= TOL[name],
                          f"B2 {ms}^2 {name} k={k} order={order}: rel err "
                          f"{rel:.3e} > {TOL[name]:.0e} at {rows[-1]}")
                    if ms == 1025 and k == 8 and name == "float32":
                        worst["B2"] = max(worst.get("B2", 0.0), abs_e)
    emit({"phase": "b2_vs_plain", "cases": rows})
    return worst


def timed_solves(solver, reps, warm_up=True):
    if warm_up:
        solver.solve(store_solutions=False)
    times = []
    for _ in range(reps):
        solver.solve(store_solutions=False)
        times.append(solver.solve_time)
    return times


def phase_main_257(md, problem, domain):
    """The main path: fused Chebyshev-4 extrapolated, BE and CN, against
    the scan path and the closed form."""
    import torch

    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.ops import fused_solver

    expect = {1: 0.3153, 2: 0.3152}
    out = {"phase": "main_257", "ms": 257, "nt": md.nt,
           "dofs": md.number_of_segments}
    reset_counts()
    solvers = {}
    for order in (1, 2):
        s = CRBESolver(domain, problem, md, time_scheme_order=order,
                       stiffness_convention="reference", matvec_impl="fused",
                       solver_method="chebyshev", chebyshev_iters=4,
                       extrapolate_warm_start=True)
        times = timed_solves(s, 5)
        rel, _, _ = s.compute_errors(problem.analytical_solution)
        solvers[order] = s
        tag = "be" if order == 1 else "cn"
        out[f"{tag}_steps_per_s_best"] = (md.nt - 1) / min(times)
        out[f"{tag}_steps_per_s_median"] = (md.nt - 1) / statistics.median(
            times)
        out[f"{tag}_rel_l2"] = rel
    launches = fused_solver.KERNEL.launches
    out["b1_launches"] = launches
    check(launches > 0, "the main path did not launch kernel B1")
    for order in (1, 2):
        tag = "be" if order == 1 else "cn"
        scan = CRBESolver(domain, problem, md, time_scheme_order=order,
                          solver_tol=1e-6, solver_maxiter=100,
                          stiffness_convention="reference",
                          matvec_impl="stencil")
        scan.solve(store_solutions=False)
        diff = float((solvers[order].solutions[-1]
                      - scan.solutions[-1]).abs().max())
        out[f"{tag}_max_fused_minus_scan"] = diff
        out[f"{tag}_scan_rel_l2"] = scan.compute_errors(
            problem.analytical_solution)[0]
        check(abs(out[f"{tag}_rel_l2"] - expect[order]) <= 5e-4,
              f"257^2 {tag} rel_l2 {out[f'{tag}_rel_l2']} not within 5e-4 "
              f"of {expect[order]}")
        check(diff <= 1e-4, f"257^2 {tag} max|fused - scan| {diff:.3e} > 1e-4")
    check(all(bool(torch.isfinite(s.solutions).all())
              for s in solvers.values()), "non-finite main-path output")
    emit(out)
    return launches


def phase_main_1025(md, problem, domain):
    """Past the whole-loop size: fused_hbm, Chebyshev-8 extrapolated."""
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.ops import fused_hbm

    reset_counts()
    s = CRBESolver(domain, problem, md, stiffness_convention="reference",
                   matvec_impl="fused_hbm", solver_method="chebyshev",
                   chebyshev_iters=8, extrapolate_warm_start=True)
    times = timed_solves(s, 3)
    launches = fused_hbm.KERNEL.launches
    rel, _, _ = s.compute_errors(problem.analytical_solution)
    emit({"phase": "main_1025", "ms": 1025, "nt": md.nt,
          "dofs": md.number_of_segments,
          "steps_per_s_best": (md.nt - 1) / min(times), "rel_l2": rel,
          "b2_launches": launches})
    check(launches > 0, "the main path did not launch kernel B2")
    check(abs(rel - 0.3097) <= 5e-4,
          f"1025^2 rel_l2 {rel} not within 5e-4 of 0.3097")
    return launches


def kernel_times(meshes, problem):
    """Per-launch times of B1 and B2 and of their plain versions at the
    main path's shapes (float32, BE, extrapolated), their bounds, and the
    largest |kernel - plain| there (f32 bound as in TOL)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    out = {}
    # B1: one launch = the whole 257^2, nt=1001, k=4 solve.
    md = meshes[(257, "float32")]
    n_steps, k = md.nt - 1, 4
    scal, u3 = uniform_inputs(md, problem, 1, k, torch.float32)
    kw = dict(n_steps=n_steps, n_iters=k, use_ka=False, extrapolate=True)
    # The plain solve runs once, timed, and is the check's reference.
    (ref, _), plain = cuda_ms_once(
        lambda: fused_solver.plain_solve(scal, u3, **kw))
    abs_e, rel, _ = rel_err(fused_solver.kernel_solve(scal, u3, **kw)[0],
                            ref)
    check(rel <= TOL["float32"], f"B1 257^2 x 1000 steps: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_solve(scal, u3, **kw), 5)
    dofs = md.number_of_segments
    b_ms, by = bound(2 * u3.numel() * 4,
                     n_steps * dofs * step_flops_per_dof(k, False, True))
    out["B1"] = (ms, plain, b_ms, by, abs_e, None, {
        "plan": fused_solver.uniform_plan(k, False, torch.float32,
                                          u3.shape[-1])})
    # B2: one launch = one 1025^2 step, k=8.
    k = 8
    scal, u = uniform_inputs(meshes[(1025, "float32")], problem, 1, k,
                             torch.float32)
    up = u.clone()
    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    plan = fused_solver.uniform_plan(k, False, torch.float32, u.shape[-1])
    masks = fused_solver.rect_masks(u.shape[-1], torch.float32, u.device)
    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up, False, halt, plan)
    abs_e, rel, _ = rel_err(got_u, fused_solver.plain_step(
        scal, k, u, up, False, masks)[0])
    check(rel <= TOL["float32"], f"B2 1025^2 step: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_hbm.kernel_step(
        scal, k, u, up, got_u, got_up, False, halt, plan), 50)
    plain = cuda_ms(lambda: fused_solver.plain_step(
        scal, k, u, up, False, masks), 5)
    dofs = meshes[(1025, "float32")].number_of_segments
    b_ms, by = bound(4 * u.numel() * 4,
                     dofs * step_flops_per_dof(k, False, True))
    out["B2"] = (ms, plain, b_ms, by, abs_e, None, {"plan": plan})
    return out


def robin_obstacle_problem():
    """C3's problem: the plume (sigma 3, so that mass lies outside the
    block) with a deposition wall at the bottom, a no-flux wall at the top
    and a solid block [-4, 4]^2."""
    import airpollution_tpu_torch as apt

    class RobinObstacle(apt.Problem):
        robin_sides = {"bottom": 0.05, "top": 0.0}
        obstacles = ((-4.0, 4.0, -4.0, 4.0),)

    return RobinObstacle(sigma=3.0)


def canvas_inputs(md, problem, order, dtype, cache):
    """The canvas kernels' inputs from the port's own assembly, as
    CRBESolver builds them: the family-layout operator pieces, the interior
    mask, the Robin rectangle, the Chebyshev interval and the initial
    family vector, kept in ``cache`` (a dict the caller owns); float64
    inputs at 1025^2 are the float32 assembly's, cast: the comparison
    needs identical inputs, not exact ones."""
    import torch
    from functools import partial

    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.ops import fused_hbm, linalg, sparse, stencil

    key = (id(md), id(problem), order)
    if key not in cache:
        dt = md.domain.T / (md.nt - 1)
        ops = crbe.assemble(md, problem, dt, order)
        pattern = stencil.get_pattern(md)
        perm = torch.as_tensor(pattern.perm.astype("int64"), device=md.device)
        dmask = crbe.robin_terms(md, problem)[0]
        _, dead = crbe.obstacle_masks(md, problem)
        if dead is not None:
            dmask = dmask | dead
        bm = dmask[perm]
        lo, hi = linalg.power_bounds(
            partial(sparse.ell_matvec, ops.system),
            torch.zeros_like(ops.system_diag),
            scale=1.0 / torch.sqrt(ops.system_diag))
        u0 = problem.initial_condition_fn(md.midpoints)
        if dead is not None:
            u0 = torch.where(dead, torch.zeros_like(u0), u0)
        robin = getattr(problem, "robin_sides", None)
        cache[key] = dict(
            pattern=pattern, ops=ops, perm=perm,
            coeffs=stencil.extract_coefficients(pattern, ops.system.vals),
            mass=torch.where(bm, torch.zeros_like(ops.mass_diag[perm]),
                             ops.mass_diag[perm]),
            inv_diag=1.0 / ops.system_diag[perm],
            interior=1.0 - bm.to(ops.mass_diag.dtype),
            bounds=(float(lo), float(hi)), u0=u0[perm],
            rect=(fused_hbm.robin_rect_bounds(pattern.c, robin) if robin
                  else (1, pattern.c, 1, pattern.c)),
            dead=None if dead is None else dead[perm],
        )
    got = dict(cache[key])
    for name in ("mass", "inv_diag", "interior", "u0"):
        got[name] = got[name].to(dtype)
    got["coeffs"] = tuple(g.to(dtype) for g in got["coeffs"])
    return got


def worst_at(diff):
    """Family, row and column of the largest entry of a (3, n, n) diff."""
    import torch

    f, r, c = (int(i) for i in torch.unravel_index(diff.argmax(), diff.shape))
    return {"family": "HVD"[f], "row": r, "col": c}


def phase_b3(meshes, problems, cache):
    """Kernel B3 against stencil.stencil_matvec: one matvec at 257^2 on
    C1's and C3's coefficients, from a random x (seed 0)."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import fused_stencil, stencil

    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        md = meshes[(257, name)]
        x = torch.tensor(np.random.default_rng(0).standard_normal(
            md.number_of_segments), dtype=dtype, device=md.device)
        for pname in ("C1", "C3"):
            inp = canvas_inputs(md, problems[pname], 1, dtype, cache)
            got = fused_stencil.StencilOperator(inp["pattern"],
                                                inp["coeffs"])(x)
            ref = stencil.stencil_matvec(inp["pattern"], inp["coeffs"], x)
            torch.cuda.synchronize()
            abs_e, rel, diff = rel_err(got, ref)
            rows.append({"problem": pname, "dtype": name, "rel_err": rel,
                         "worst_dof": int(diff.argmax())})
            check(rel <= TOL[name], f"B3 257^2 {pname} {name}: rel err "
                  f"{rel:.3e} > {TOL[name]:.0e}")
            if name == "float32":
                worst["B3"] = max(worst.get("B3", 0.0), abs_e)
    emit({"phase": "b3_vs_plain", "cases": rows})
    return worst


def canvas_step_inputs(inp, k, dtype):
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    C = fused_hbm.canvas_operator(inp["pattern"], inp["coeffs"], inp["mass"],
                                  inp["inv_diag"], dtype)
    cheb = fused_solver.cheb_scalars(inp["bounds"], k, dtype, C.device)
    u0 = fused_solver.to_canvases(inp["pattern"], inp["u0"])
    masks = fused_solver.rect_masks(u0.shape[-1], dtype, u0.device,
                                    inp["rect"])
    return C, cheb, u0, masks


def depth_plans(k, use_ka, dtype, raw=False, n_species=None):
    """The planner's launch plan of a canvas step (ops/fused_hbm.
    canvas_plan) first, then for every other depth that splits the step
    the largest tile that fits: each instantiation of the canvas kernels
    at split and unsplit depth."""
    from airpollution_tpu_torch.ops import fused_hbm

    kind = dict(raw=raw, n_species=n_species)
    if raw:
        first = fused_hbm.raw_plan(k, dtype)
    elif n_species:
        first = fused_hbm.multispecies_plan(n_species, k, use_ka, dtype)
    else:
        first = fused_hbm.canvas_plan(k, use_ka, dtype)
    plans = [first]
    for depth in range(1, fused_hbm.MAX_DEPTH + 1):
        fits = [t for t in fused_hbm.PLAN_TILES
                if fused_hbm.plan_fits(fused_hbm.CanvasPlan(t, depth), k,
                                       use_ka, dtype, **kind)]
        if depth != first.depth and fits:
            plans.append(fused_hbm.CanvasPlan(fits[0], depth))
    return plans


def dead_max(inp, got, dtype):
    """max |got| on the obstacle's dead DOFs (None without obstacles);
    ``got`` (..., 3, n, n)."""
    from airpollution_tpu_torch.ops import fused_solver

    if inp["dead"] is None:
        return None
    dead3 = fused_solver.to_canvases(inp["pattern"],
                                     inp["dead"].to(dtype)).bool()
    return float(got[..., dead3].abs().max())


def phase_b4(meshes, problems, cache):
    """Kernel B4 against plain_canvas_step at 129^2 (k = 6, 8 and C1's 14,
    every depth that splits the step) and 1025^2 (k = 6 and 14, the
    planner's plan), BE and CN, on C1 (rotating wind) and C3 (Robin
    rectangle and dead DOFs, exactly 0), one step from a state that
    differs from u_prev."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm

    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms, ks in ((129, (6, 8, C1_ITERS)), (1025, (6, C1_ITERS))):
            for pname in ("C1", "C3"):
                for k in ks:
                    for order in (1, 2):
                        use_ka = order == 2
                        inp = canvas_inputs(meshes[(ms, name)],
                                            problems[pname], order, dtype,
                                            cache)
                        C, cheb, u0, masks = canvas_step_inputs(inp, k, dtype)
                        u, up = fused_hbm.plain_canvas_step(
                            C, cheb, k, u0, u0, use_ka, masks)
                        ref_u, ref_up = fused_hbm.plain_canvas_step(
                            C, cheb, k, u, up, use_ka, masks)
                        plans = depth_plans(k, use_ka, dtype)
                        for plan in plans if ms < 1025 else plans[:1]:
                            got_u = torch.empty_like(u)
                            got_up = torch.empty_like(u)
                            halt = torch.tensor(-1, dtype=torch.int32,
                                                device=u.device)
                            fused_hbm.canvas_kernel_step(
                                C, cheb, k, u, up, got_u, got_up, use_ka,
                                inp["rect"], halt, plan)
                            torch.cuda.synchronize()
                            abs_e, rel, diff = rel_err(got_u, ref_u)
                            check(bool(torch.equal(got_up, ref_up)),
                                  f"B4 {ms}^2 k={k}: u_prev output differs")
                            at = worst_at(diff)
                            at["tile"] = [at["row"] // plan.tile,
                                          at["col"] // plan.tile]
                            dead = dead_max(inp, got_u, dtype)
                            rows.append({"ms": ms, "problem": pname,
                                         "dtype": name, "k": k,
                                         "order": order, "plan": plan,
                                         "rel_err": rel, "worst_at": at,
                                         "dead_max_abs": dead})
                            check(rel <= TOL[name],
                                  f"B4 {ms}^2 {pname} {name} k={k} "
                                  f"order={order} {plan}: rel err "
                                  f"{rel:.3e} > {TOL[name]:.0e} at {at}")
                            check(dead in (None, 0.0), f"B4 {ms}^2 {pname}: "
                                  f"dead DOFs reach {dead}")
                            if ms == 1025 and name == "float32":
                                worst["B4"] = max(worst.get("B4", 0.0),
                                                  abs_e)
    emit({"phase": "b4_vs_plain", "cases": rows})
    return worst


def bicgstab_inputs(inp, dtype):
    from airpollution_tpu_torch.ops import fused_solver

    pattern = inp["pattern"]
    C = fused_solver.bicgstab_operator(pattern, inp["coeffs"], inp["mass"],
                                       inp["inv_diag"], inp["interior"],
                                       dtype)
    return C, fused_solver.to_canvases(pattern, inp["u0"])


def phase_b5(meshes, problems, cache):
    """Kernel B5 against plain_bicgstab_solve: 65^2 x 32 steps and 257^2 x
    16 steps, BE and CN, extrapolated or not, on C1's problem.

    Fixed-k BiCGStab keeps iterating after the residual reaches rounding
    level, and in float32 some configurations then amplify rounding: at
    65^2 with nt=33 in BE without extrapolation the plain float32 solve
    itself moves by more than TOL when its input moves by 1e-7. No other
    summation order can agree with it closer than that, so each float32
    case is held to the larger of TOL and 10x that measured sensitivity,
    which the phase prints."""
    import torch

    from airpollution_tpu_torch.ops import fused_solver

    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms, n_steps in ((65, 32), (257, 16)):
            for order in (1, 2):
                inp = canvas_inputs(meshes[(ms, name)], problems["C1"],
                                    order, dtype, cache)
                C, u3 = bicgstab_inputs(inp, dtype)
                for ext in (False, True):
                    kw = dict(n_steps=n_steps, n_iters=5, use_ka=order == 2,
                              extrapolate=ext)
                    got = fused_solver.kernel_bicgstab_solve(C, u3, **kw)
                    ref = fused_solver.plain_bicgstab_solve(C, u3, **kw)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got, ref)
                    tol, sens = TOL[name], None
                    if name == "float32":
                        moved = fused_solver.plain_bicgstab_solve(
                            C, u3 * (1.0 + 1e-7), **kw)
                        sens = rel_err(moved, ref)[1]
                        tol = max(tol, 10.0 * sens)
                    rows.append({"ms": ms, "dtype": name, "order": order,
                                 "extrapolate": ext, "rel_err": rel,
                                 "plain_sensitivity": sens, "tol": tol,
                                 "worst_at": worst_at(diff)})
                    if ms == 257 and name == "float32":
                        worst["B5"] = max(worst.get("B5", 0.0), abs_e)
    emit({"phase": "b5_vs_plain", "cases": rows})
    for r in rows:
        check(r["rel_err"] <= r["tol"], f"B5 case {r}: rel err above tol")
    return worst


def max_diff(a, b):
    return float((a.solutions[-1] - b.solutions[-1]).abs().max())


def phase_canvas_1025(md, problem, domain):
    """C1: the rotating wind at 1025^2 on B4, Chebyshev-14 extrapolated, BE
    and CN; held against the closed form and against the scan path with
    the same iterations and interval."""
    from airpollution_tpu_torch.models.crbe import CRBESolver

    out = {"phase": "main_canvas_1025", "ms": 1025, "nt": md.nt,
           "dofs": md.number_of_segments}
    total = 0
    be = None
    for order in (1, 2):
        tag = "be" if order == 1 else "cn"
        kw = dict(time_scheme_order=order, solver_method="chebyshev",
                  chebyshev_iters=C1_ITERS, extrapolate_warm_start=True)
        s = CRBESolver(domain, problem, md, matvec_impl="fused_hbm", **kw)
        reset_counts()
        s.solve(store_solutions=False)
        per_solve = launches_of("B4")
        check(s.fused_kernel == "B4" and per_solve == md.nt - 1,
              f"C1 {tag}: {per_solve} B4 launches in one solve, not "
              f"{md.nt - 1}")
        times = timed_solves(s, 2, warm_up=False)
        total += launches_of("B4")
        rel, _, _ = s.compute_errors(problem.analytical_solution)
        scan = CRBESolver(domain, problem, md, matvec_impl="stencil",
                          cheb_bounds=s._cheb_bounds, **kw)
        scan.solve(store_solutions=False)
        diff = max_diff(s, scan)
        out.update({
            f"{tag}_steps_per_s_best": (md.nt - 1) / min(times),
            f"{tag}_steps_per_s_median": (md.nt - 1) / statistics.median(
                times),
            f"{tag}_rel_l2": rel,
            f"{tag}_scan_rel_l2": scan.compute_errors(
                problem.analytical_solution)[0],
            f"{tag}_max_fused_minus_scan": diff,
            f"{tag}_cheb_factor": s._cheb_factor,
            f"{tag}_b4_launches_per_solve": per_solve,
        })
        check(diff <= 1e-4, f"C1 {tag}: max|fused - scan| {diff:.3e} > 1e-4")
        check(rel < 0.05, f"C1 {tag}: rel_l2 {rel} against the closed form")
        if order == 1:
            be = (s, {k: out[f"be_{k}"] for k in (
                "steps_per_s_best", "steps_per_s_median", "rel_l2")})
    out["b4_launches"] = total
    emit(out)
    return total, be


def phase_canvas_257_bicgstab(md, problem, domain):
    """C2: the rotating wind at 257^2 on B5 (BiCGStab-5, extrapolated), BE
    and CN; held against the closed form and the converged scan BiCGStab."""
    from airpollution_tpu_torch.models.crbe import CRBESolver

    out = {"phase": "main_canvas_257_bicgstab", "ms": 257, "nt": md.nt,
           "dofs": md.number_of_segments}
    total = 0
    for order in (1, 2):
        tag = "be" if order == 1 else "cn"
        s = CRBESolver(domain, problem, md, time_scheme_order=order,
                       matvec_impl="fused", solver_method="bicgstab",
                       fused_iters=5, extrapolate_warm_start=True)
        reset_counts()
        s.solve(store_solutions=False)
        per_solve = launches_of("B5")
        check(s.fused_kernel == "B5" and per_solve == 1,
              f"C2 {tag}: {per_solve} B5 launches in one solve, not 1")
        times = timed_solves(s, 5)
        total += launches_of("B5")
        rel, _, _ = s.compute_errors(problem.analytical_solution)
        scan = CRBESolver(domain, problem, md, time_scheme_order=order,
                          solver_tol=1e-6, solver_maxiter=100,
                          matvec_impl="stencil")
        scan.solve(store_solutions=False)
        diff = max_diff(s, scan)
        out.update({
            f"{tag}_steps_per_s_best": (md.nt - 1) / min(times),
            f"{tag}_steps_per_s_median": (md.nt - 1) / statistics.median(
                times),
            f"{tag}_rel_l2": rel,
            f"{tag}_scan_rel_l2": scan.compute_errors(
                problem.analytical_solution)[0],
            f"{tag}_max_fused_minus_scan": diff,
        })
        check(diff <= 1e-4, f"C2 {tag}: max|fused - scan| {diff:.3e} > 1e-4")
        check(rel < 0.05, f"C2 {tag}: rel_l2 {rel} against the closed form")
    out["b5_launches"] = total
    emit(out)
    return total


def phase_robin_obstacle(md, md65, problem, domain):
    """C3: Robin walls and an obstacle at 257^2. (a) B4, CN, Chebyshev-8
    extrapolated, nt=1001, against the converged stencil scan; the state on
    dead DOFs must stay exactly 0. (b) The scan path through B3
    (matvec_impl="pallas", BiCGStab, nt=65) against matvec_impl="stencil"."""
    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.models.crbe import CRBESolver

    out = {"phase": "robin_obstacle_257", "ms": 257, "nt_b4": md.nt,
           "nt_b3": md65.nt, "dofs": md.number_of_segments}
    reset_counts()
    s = CRBESolver(domain, problem, md, time_scheme_order=2,
                   matvec_impl="fused_hbm", solver_method="chebyshev",
                   chebyshev_iters=8, extrapolate_warm_start=True)
    s.solve(store_solutions=False)
    b4 = launches_of("B4")
    scan = CRBESolver(domain, problem, md, time_scheme_order=2,
                      solver_tol=1e-6, solver_maxiter=100,
                      matvec_impl="stencil")
    scan.solve(store_solutions=False)
    _, dead = crbe.obstacle_masks(md, problem)
    dead_max = float(s.solutions[-1][dead].abs().max())
    out.update({"b4_launches": b4,
                "b4_max_fused_minus_scan": max_diff(s, scan),
                "dead_dofs": int(dead.sum()), "dead_max_abs": dead_max,
                "max_abs": float(s.solutions[-1].abs().max())})
    check(s.fused_kernel == "B4" and b4 == md.nt - 1,
          f"C3a: {b4} B4 launches, not {md.nt - 1}")
    check(out["b4_max_fused_minus_scan"] <= 1e-4,
          f"C3a: max|fused - scan| {out['b4_max_fused_minus_scan']:.3e}")
    check(dead_max == 0.0, f"C3a: |u| on dead DOFs reaches {dead_max}")

    reset_counts()
    pal = CRBESolver(domain, problem, md65, solver_tol=1e-6,
                     solver_maxiter=100, matvec_impl="pallas")
    pal.solve(store_solutions=False)
    b3 = launches_of("B3")
    ref = CRBESolver(domain, problem, md65, solver_tol=1e-6,
                     solver_maxiter=100, matvec_impl="stencil")
    ref.solve(store_solutions=False)
    out.update({"b3_launches": b3, "b3_max_pallas_minus_stencil":
                max_diff(pal, ref)})
    # C3b's speed: warm solves of each (the first ones above built the
    # operators and warmed every kernel).
    for tag, solver in (("pallas", pal), ("stencil", ref)):
        rates(out, f"b3_{tag}_", md65.nt - 1,
              timed_solves(solver, 2, warm_up=False))
    check(b3 > 0, "C3b: the scan path did not launch kernel B3")
    check(out["b3_max_pallas_minus_stencil"] <= 1e-4,
          f"C3b: max|pallas - stencil| "
          f"{out['b3_max_pallas_minus_stencil']:.3e}")
    emit(out)
    return b3, b4


def canvas_kernel_times(meshes, problems, cache):
    """Per-launch times of B3, B4 and B5 and their plain versions at the
    main paths' shapes (float32), their bounds, B3's library yardstick (a
    CSR SpMV of the masked system), and the largest |kernel - plain|."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver
    from airpollution_tpu_torch.ops import fused_stencil, stencil

    out = {}
    f32 = torch.float32
    # B3: one matvec at 257^2 on C3's operator (the C3b scan path).
    md = meshes[(257, "float32")]
    inp = canvas_inputs(md, problems["C3"], 1, f32, cache)
    pattern, coeffs = inp["pattern"], inp["coeffs"]
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        md.number_of_segments), dtype=f32, device=md.device)
    op = fused_stencil.StencilOperator(pattern, coeffs)  # as a solve binds
    abs_e, rel, _ = rel_err(op(x), stencil.stencil_matvec(pattern, coeffs, x))
    check(rel <= TOL["float32"], f"B3 257^2: rel err {rel:.3e}")
    ms = cuda_ms(lambda: op(x), 200)
    device, how = graph_ms(lambda: op(x))
    extra = {"enqueue_ms": enqueue_ms(lambda: op(x)), "device_ms": device,
             "device_timed_by": how}
    plain = cuda_ms(lambda: stencil.stencil_matvec(pattern, coeffs, x), 50)
    # The same function as one library call: the masked system in CSR, in
    # global DOF order (a permutation of the family layout).
    system = inp["ops"].system
    n_rows, width = system.vals.shape
    csr = torch.sparse_csr_tensor(
        torch.arange(0, n_rows * width + 1, width, device=md.device),
        system.cols.reshape(-1), system.vals.reshape(-1).to(f32),
        size=(n_rows, n_rows))
    xg = x[torch.as_tensor(pattern.inv_perm.astype("int64"),
                           device=md.device)]
    library = cuda_ms(lambda: csr @ xg, 200)
    n_bytes = (sum(g.numel() for g in coeffs) + 2 * x.numel()) * 4
    b_ms, by = bound(n_bytes, 9 * x.numel())
    out["B3"] = (ms, plain, b_ms, by, abs_e, library, extra)
    emit({"phase": "b3_kernel_times", "card": card_line(), "ms": ms,
          **extra, "plain_ms": plain, "csr_ms": library, "bound_ms": b_ms})
    # B4: one step at 1025^2 on C1's operator, BE, extrapolated.
    k = C1_ITERS
    inp = canvas_inputs(meshes[(1025, "float32")], problems["C1"], 1, f32,
                        cache)
    C, cheb, u, masks = canvas_step_inputs(inp, k, f32)
    up = u.clone()
    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    plan = fused_hbm.canvas_plan(k, False, f32)
    work = fused_hbm.work_buffer(plan, u)
    rect = inp["rect"]
    fused_hbm.canvas_kernel_step(C, cheb, k, u, up, got_u, got_up, False,
                                 rect, halt, plan, work=work)
    abs_e, rel, _ = rel_err(got_u, fused_hbm.plain_canvas_step(
        C, cheb, k, u, up, False, masks)[0])
    check(rel <= TOL["float32"], f"B4 1025^2 step: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        C, cheb, k, u, up, got_u, got_up, False, rect, halt, plan,
        work=work), 50)
    plain = cuda_ms(lambda: fused_hbm.plain_canvas_step(
        C, cheb, k, u, up, False, masks), 5)
    dofs = meshes[(1025, "float32")].number_of_segments
    b_ms, by = bound((C.numel() + 4 * u.numel()) * 4,
                     dofs * canvas_step_flops_per_dof(k, False, True))
    out["B4"] = (ms, plain, b_ms, by, abs_e, None, {"plan": plan})
    # B5: one launch = the whole C2 solve (257^2, nt=1001, k=5, BE, ext).
    md = meshes[(257, "float32")]
    inp = canvas_inputs(md, problems["C1"], 1, f32, cache)
    C, u3 = bicgstab_inputs(inp, f32)
    kw = dict(n_steps=md.nt - 1, n_iters=5, use_ka=False, extrapolate=True)
    ref, plain = cuda_ms_once(
        lambda: fused_solver.plain_bicgstab_solve(C, u3, **kw))
    abs_e, rel, _ = rel_err(fused_solver.kernel_bicgstab_solve(C, u3, **kw),
                            ref)
    check(rel <= TOL["float32"], f"B5 257^2 x 1000 steps: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_bicgstab_solve(C, u3, **kw), 3)
    b_ms, by = bound((C.numel() + 2 * u3.numel()) * 4,
                     (md.nt - 1) * md.number_of_segments
                     * bicgstab_flops_per_dof(5, False, True))
    out["B5"] = (ms, plain, b_ms, by, abs_e, None, {
        "cells": fused_solver.bicgstab_cells(u3.shape[-1], "canvas", f32)})
    return out


# --- multispecies: kernel B6, B4 with a load, M1 and M2 --------------------


def chain_R(K):
    """The decay chain A1 -> ... -> AK of scripts/multispecies_fused_demo.py
    (make_problem): rates 0.4, 0.2, then 0.2 * 0.85^i."""
    import numpy as np

    rates = [0.4, 0.2][:K - 1] + [0.2 * 0.85 ** i
                                  for i in range(1, K - 2 + 1)][:max(0, K - 3)]
    R = np.zeros((K, K))
    for i, r in enumerate(rates):
        R[i, i] += r
        R[i + 1, i] -= r
    return R


def demo_species(K):
    """The demo's species: a Gaussian emitter of A, then K - 1 species with
    zero initial and boundary values; all with v = (1, 0.2), D = 0.3."""
    import torch

    import airpollution_tpu_torch as apt

    class Clean(apt.Problem):
        def initial_condition_fn(self, xy):
            return torch.zeros(xy.shape[:-1], dtype=xy.dtype,
                               device=xy.device)

        def boundary_fn(self, xyt):
            return torch.zeros_like(xyt[..., 0])

    src = apt.GaussianSourceProblem(q=2.0, xs=-6.0, ys=0.0, sigma_s=1.5,
                                    v=(1.0, 0.2), D=0.3)
    return [src] + [Clean(v=(1.0, 0.2), D=0.3, sigma=1.0)
                    for _ in range(K - 1)]


def demo_problem(K=3):
    import airpollution_tpu_torch as apt

    return apt.MultiSpeciesProblem(demo_species(K), chain_R(K))


def walled_source():
    """A Gaussian emitter with C3's walls and block: its load is masked by
    the Robin-widened rectangle and must vanish on the dead DOFs."""
    import airpollution_tpu_torch as apt

    class WalledSource(apt.GaussianSourceProblem):
        robin_sides = {"bottom": 0.05, "top": 0.0}
        obstacles = ((-4.0, 4.0, -4.0, 4.0),)

    return WalledSource(q=2.0, xs=-6.0, ys=0.0, sigma_s=1.5)


def species_states(inp, K, seed):
    """K distinct (3, n, n) states on the operator's support: the problem's
    initial state scaled per species plus seeded noise, zero on dead
    DOFs."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import fused_solver

    rng = np.random.default_rng(seed)
    u0 = inp["u0"]
    out = []
    for j in range(K):
        noise = torch.tensor(rng.standard_normal(u0.shape[0]) * 1e-2,
                             dtype=u0.dtype, device=u0.device)
        u = u0 * (1.0 + 0.3 * j) + noise
        if inp["dead"] is not None:
            u = torch.where(inp["dead"], torch.zeros_like(u), u)
        out.append(fused_solver.to_canvases(inp["pattern"], u))
    return torch.stack(out)


def step_loads(inp, md, source, K, use_ka, C, masks, lumped, dtype):
    """The emission load of ``source`` on species 0 (B6's ``loads`` and
    ``load_index``), as the fused solve builds it."""
    from airpollution_tpu_torch.mesh.data import structured_grid
    from airpollution_tpu_torch.ops import fused_solver
    from airpollution_tpu_torch.ops.loads import EmissionLoads

    live = None
    if inp["dead"] is not None:
        live = 1.0 - fused_solver.to_canvases(inp["pattern"],
                                              inp["dead"].to(dtype))
    loads = EmissionLoads(
        (source.source_xy,) + (None,) * (K - 1), (True,) + (False,) * (K - 1),
        grid=structured_grid(md), dt=md.domain.T / (md.nt - 1), t0=0.0,
        use_ka=use_ka, lumped=lumped, mass3=C[15:18], masks=masks, live=live)
    return loads.advance(), loads.index


def b6_case(inp, md, K, k, order, dtype, source, lumped, seed=0):
    """Inputs of one B6 step: (C, cheb, E, scal, U, masks, loads, index,
    plan)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm
    from airpollution_tpu_torch.problems import expm64

    use_ka = order == 2
    C, cheb, _, masks = canvas_step_inputs(inp, k, dtype)
    dt = md.domain.T / (md.nt - 1)
    E64 = expm64(-(0.5 * dt) * torch.as_tensor(chain_R(K)))
    U = species_states(inp, K, seed)
    loads, index = (None, [-1] * K)
    if source is not None:
        loads, index = step_loads(inp, md, source, K, use_ka, C, masks,
                                  lumped, dtype)
    scal = fused_hbm.multispecies_scalars(inp["bounds"], k, E64, dtype,
                                          U.device)
    plan = fused_hbm.multispecies_plan(K, k, use_ka, dtype)
    return dict(C=C, cheb=cheb, E=E64.to(dtype=dtype, device=U.device),
                scal=scal, U=U, masks=masks, loads=loads, index=index,
                plan=plan, use_ka=use_ka)


def run_b6(case, k, rect):
    """(kernel, plain) outputs of one B6 step."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm

    got = torch.empty_like(case["U"])
    halt = torch.tensor(-1, dtype=torch.int32, device=got.device)
    fused_hbm.multispecies_kernel_step(
        case["C"], case["scal"], k, case["U"], got, case["use_ka"], rect,
        halt, case["plan"], case["loads"], case["index"])
    ref = fused_hbm.plain_multispecies_step(
        case["C"], case["cheb"], case["E"], k, case["U"], case["use_ka"],
        case["masks"], case["loads"], case["index"])
    torch.cuda.synchronize()
    return got, ref


def worst_cell(diff, tile):
    """Species, family, row, column and tile of the largest entry of a
    (K, 3, n, n) diff."""
    import torch

    s, f, r, c = (int(i) for i in torch.unravel_index(diff.argmax(),
                                                      diff.shape))
    return {"species": s, "family": "HVD"[f], "row": r, "col": c,
            "tile": [r // tile, c // tile]}


def phase_b6(meshes, problems, cache):
    """Kernel B6 against plain_multispecies_step: one step on the demo's
    transport (k=8), BE and CN, with and without the demo's Gaussian load,
    K = 1, 3 and 8 at 129^2 (every depth that splits the step) and K = 3
    at 1025^2 (the planner's plan); and a 2-species step on C3's Robin
    rectangle and block with the walled emitter's load (reference
    quadrature), whose dead DOFs must stay exactly 0."""
    import torch

    worst = {}
    rows = []
    src = demo_species(1)[0]
    walled = walled_source()
    k = DEMO_ITERS[1025]
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms, species in ((129, (1, 3, 8)), (1025, (3,))):
            md = meshes[(ms, name)]
            cases = [("demo", K, order, source, True)
                     for K in species for order in (1, 2)
                     for source in (None, src)]
            cases += [("C3", 2, order, walled, False) for order in (1, 2)]
            for pname, K, order, source, lumped in cases:
                inp = canvas_inputs(md, problems[pname], order, dtype, cache)
                case = b6_case(inp, md, K, k, order, dtype, source, lumped)
                plans = depth_plans(k, order == 2, dtype, n_species=K)
                for plan in plans if ms < 1025 else plans[:1]:
                    case["plan"] = plan
                    got, ref = run_b6(case, k, inp["rect"])
                    abs_e, rel, diff = rel_err(got, ref)
                    row = {"ms": ms, "problem": pname, "dtype": name,
                           "K": K, "order": order,
                           "load": source is not None, "plan": plan,
                           "rel_err": rel,
                           "worst_at": worst_cell(diff, plan.tile),
                           "dead_max_abs": dead_max(inp, got, dtype)}
                    check(row["dead_max_abs"] in (None, 0.0),
                          f"B6 {ms}^2 {pname}: dead DOFs reach "
                          f"{row['dead_max_abs']}")
                    rows.append(row)
                    check(rel <= TOL[name],
                          f"B6 {ms}^2 {pname} {name} K={K} order={order} "
                          f"{plan}: rel err {rel:.3e} > {TOL[name]:.0e} at "
                          f"{row['worst_at']}")
                    if ms == 1025 and name == "float32":
                        worst["B6"] = max(worst.get("B6", 0.0), abs_e)
    emit({"phase": "b6_vs_plain", "card": card_line(), "cases": rows})
    return worst


def phase_b4_load(meshes, problems, cache):
    """Kernel B4 with an emission load against plain_canvas_step: one step
    at 129^2 (every depth that splits it) and 1025^2 (the planner's plan),
    BE and CN, the demo's emitter on its transport (lumped) and the walled
    emitter on C3's (reference quadrature)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    k = DEMO_ITERS[1025]
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 1025):
            md = meshes[(ms, name)]
            for pname, source, lumped in (("demo", demo_species(1)[0], True),
                                          ("C3", walled_source(), False)):
                for order in (1, 2):
                    use_ka = order == 2
                    inp = canvas_inputs(md, problems[pname], order, dtype,
                                        cache)
                    C, cheb, u, masks = canvas_step_inputs(inp, k, dtype)
                    (load,), _ = step_loads(inp, md, source, 1, use_ka, C,
                                            masks, lumped, dtype)
                    ref, _ = fused_hbm.plain_canvas_step(
                        C, cheb, k, u, None, use_ka, masks, load)
                    plans = depth_plans(k, use_ka, dtype)
                    for plan in plans if ms < 1025 else plans[:1]:
                        got = torch.empty_like(u)
                        halt = torch.tensor(-1, dtype=torch.int32,
                                            device=u.device)
                        fused_hbm.canvas_kernel_step(
                            C, cheb, k, u, None, got, None, use_ka,
                            inp["rect"], halt, plan, load=load)
                        torch.cuda.synchronize()
                        abs_e, rel, diff = rel_err(got, ref)
                        rows.append({"ms": ms, "problem": pname,
                                     "dtype": name, "order": order,
                                     "plan": plan, "rel_err": rel,
                                     "worst_at": worst_at(diff)})
                        check(rel <= TOL[name],
                              f"B4+load {ms}^2 {pname} {name} "
                              f"order={order} {plan}: rel err {rel:.3e} > "
                              f"{TOL[name]:.0e}")
                        if ms == 1025 and name == "float32":
                            worst["B4"] = max(worst.get("B4", 0.0), abs_e)
    emit({"phase": "b4_load_vs_plain", "card": card_line(), "cases": rows})
    return worst


def chain_masses(solver):
    """(K,) masses of the final state: U @ mass_diag, summed in double."""
    U = solver.solutions[-1].double()
    return [float(m) for m in (U * solver._ops.mass_diag.double()).sum(-1)]


def rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def multispecies_solver(md, domain, problem, k, impl="fused_hbm", **kw):
    from airpollution_tpu_torch.models.multispecies import MultiSpeciesSolver

    return MultiSpeciesSolver(domain, problem, md, time_scheme_order=2,
                              matvec_impl=impl, splitting="strang",
                              solver_method="chebyshev", chebyshev_iters=k,
                              **kw)


def phase_m1(md, domain):
    """M1, the demo's largest row: 1025^2, nt=4001, K=3, CN, Chebyshev-8,
    Strang on B6. Warm steps/s, 4,000 B6 launches per solve, chain masses
    against the f64 oracle, k-vs-2k, and the fuse_chemistry=False path (K
    B4 launches per step) against it. Returns the B6 launches of the path's
    run (counts zeroed just before it), the solver and its warm steps/s
    (B10's block solve is held against this solve)."""
    import torch

    problem = demo_problem(3)
    k = DEMO_ITERS[1025]
    n_steps = md.nt - 1
    out = {"phase": "m1_multispecies_1025", "card": card_line(), "ms": 1025,
           "nt": md.nt, "dofs": md.number_of_segments, "K": 3, "k": k}
    s = multispecies_solver(md, domain, problem, k)
    t0 = time.perf_counter()
    reset_counts()
    s.solve(store_solutions=False)
    first = launches_of("B6")
    out["first_solve_s"] = time.perf_counter() - t0
    check(first == n_steps and launches_of("B4") == 0,
          f"M1: {first} B6 launches in one solve, not {n_steps}")
    times = timed_solves(s, 1, warm_up=False)
    launches = launches_of("B6")
    out.update({"b6_launches_per_solve": first, "b6_launches": launches,
                "steps_per_s_best": n_steps / min(times),
                "steps_per_s_median": n_steps / statistics.median(times),
                "cheb_bounds": list(s._fused_bounds_cache[1])})
    U = s.solutions[-1].clone()
    check(bool(torch.isfinite(U).all()), "M1: non-finite state")
    masses = chain_masses(s)
    oracle = ORACLE_MASSES[1025]
    rels = [abs(m - o) / abs(o) for m, o in zip(masses, oracle)]
    out.update({"masses": masses, "oracle_masses": list(oracle),
                "mass_rel_vs_oracle": max(rels)})
    check(max(rels) < MASS_TOL,
          f"M1 masses {masses} not within {MASS_TOL} of {oracle}")
    bounds = s._fused_bounds_cache[1]
    s2 = multispecies_solver(md, domain, problem, 2 * k, cheb_bounds=bounds)
    s2.set_operators(s._ops)
    s2.solve(store_solutions=False)
    out["k_vs_2k_rel_maxdiff"] = rel_max(U, s2.solutions[-1])
    check(out["k_vs_2k_rel_maxdiff"] < 5e-3,
          f"M1 k-vs-2k {out['k_vs_2k_rel_maxdiff']:.3e} >= 5e-3")
    unf = multispecies_solver(md, domain, problem, k, cheb_bounds=bounds,
                              fuse_chemistry=False)
    unf.set_operators(s._ops)
    reset_counts()
    unf.solve(store_solutions=False)
    out["b4_launches_per_solve_unfused"] = launches_of("B4")
    check(launches_of("B4") == 3 * n_steps and launches_of("B6") == 0,
          f"M1 unfused: {launches_of('B4')} B4 launches, not {3 * n_steps}")
    # The check solve is the timed one: solve_time excludes building the
    # solve function, as for the warm solves of timed_solves.
    out["unfused_steps_per_s"] = n_steps / unf.solve_time
    out["fuse_rel_maxdiff"] = rel_max(U, unf.solutions[-1])
    check(out["fuse_rel_maxdiff"] < 1e-4,
          f"M1 fuse A/B {out['fuse_rel_maxdiff']:.3e} >= 1e-4")
    emit(out)
    return launches, s, out["steps_per_s_best"]


def phase_m2(md, domain):
    """M2: 257^2, nt=1001, K=3, CN, Chebyshev-6. B6 against the port's
    stencil scan (Strang, the same interval), chain masses against the
    oracle's 257^2 values, and a snapshot_every=100 solve whose last row
    equals the final-state solve bit for bit."""
    import torch

    problem = demo_problem(3)
    k = DEMO_ITERS[257]
    n_steps = md.nt - 1
    out = {"phase": "m2_multispecies_257", "card": card_line(), "ms": 257,
           "nt": md.nt, "dofs": md.number_of_segments, "K": 3, "k": k}
    reset_counts()
    s = multispecies_solver(md, domain, problem, k)
    s.solve(store_solutions=False)
    out["b6_launches_per_solve"] = launches_of("B6")
    check(launches_of("B6") == n_steps, "M2: B6 launches per solve")
    times = timed_solves(s, 3)
    out["steps_per_s_best"] = n_steps / min(times)
    out["steps_per_s_median"] = n_steps / statistics.median(times)
    U = s.solutions[-1].clone()
    bounds = s._fused_bounds_cache[1]
    scan = multispecies_solver(md, domain, problem, k, impl="stencil",
                               cheb_bounds=bounds)
    scan.set_operators(s._ops)
    reset_counts()
    t0 = time.perf_counter()
    scan.solve(store_solutions=False)
    out["scan_solve_s"] = time.perf_counter() - t0
    check(launches_of("B6") == 0 and launches_of("B4") == 0,
          "M2: the scan path launched a fused kernel")
    out["fused_vs_scan_rel_maxdiff"] = rel_max(U, scan.solutions[-1])
    check(out["fused_vs_scan_rel_maxdiff"] <= 1e-4,
          f"M2 fused vs scan {out['fused_vs_scan_rel_maxdiff']:.3e} > 1e-4")
    masses = chain_masses(s)
    oracle = ORACLE_MASSES[257]
    out["masses"] = masses
    out["mass_rel_vs_oracle"] = max(abs(m - o) / abs(o)
                                    for m, o in zip(masses, oracle))
    check(out["mass_rel_vs_oracle"] < MASS_TOL,
          f"M2 masses {masses} not within {MASS_TOL} of {oracle}")
    snap = multispecies_solver(md, domain, problem, k, cheb_bounds=bounds,
                               snapshot_every=100)
    snap.set_operators(s._ops)
    rows = snap.solve(store_solutions=True)
    out["snapshot_rows"] = rows.shape[0]
    out["snapshot_last_equals_final"] = bool(torch.equal(rows[-1], U))
    check(rows.shape[0] == n_steps // 100 + 1
          and out["snapshot_last_equals_final"],
          "M2: the last strided row differs from the final state")
    emit(out)


def multispecies_kernel_times(meshes, problems, cache):
    """B6's time per launch at M1's shape (1025^2, K=3, k=8, CN, one load,
    f32) and its plain version's, its bound, B6's time at M2's shape
    (257^2, k=6), and B4's time with and without a load at M1's shape (the
    fuse_chemistry=False step's launches)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    md = meshes[(1025, "float32")]
    k, K = DEMO_ITERS[1025], 3
    inp = canvas_inputs(md, problems["demo"], 2, torch.float32, cache)
    case = b6_case(inp, md, K, k, 2, torch.float32, demo_species(1)[0], True)
    got, ref = run_b6(case, k, inp["rect"])
    abs_e, rel, _ = rel_err(got, ref)
    check(rel <= TOL["float32"], f"B6 1025^2 step: rel err {rel:.3e}")
    out_buf = torch.empty_like(case["U"])
    halt = torch.tensor(-1, dtype=torch.int32, device=out_buf.device)
    work = fused_hbm.work_buffer(case["plan"], case["U"], K)
    ms = cuda_ms(lambda: fused_hbm.multispecies_kernel_step(
        case["C"], case["scal"], k, case["U"], out_buf, True, inp["rect"],
        halt, case["plan"], case["loads"], case["index"], work), 30)
    plain = cuda_ms(lambda: fused_hbm.plain_multispecies_step(
        case["C"], case["cheb"], case["E"], k, case["U"], True,
        case["masks"], case["loads"], case["index"]), 3)
    n2 = md.structured_n ** 2
    dofs = md.number_of_segments
    n_bytes = (21 + 6 * K + 3) * n2 * 4
    flops = (K * dofs * canvas_step_flops_per_dof(k, True, False)
             + 2 * dofs * K * (2 * K - 1) + dofs)
    b_ms, by = bound(n_bytes, flops)
    # B4 with a load: one species' step of the same shape.
    u = case["U"][0]
    load = case["loads"][0]
    plan = fused_hbm.canvas_plan(k, True, torch.float32)
    b4_work = fused_hbm.work_buffer(plan, u)
    b4_out = torch.empty_like(u)
    b4_ms = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        case["C"], case["cheb"], k, u, None, b4_out, None, True, inp["rect"],
        halt, plan, load=load, work=b4_work), 30)
    b4_nl = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        case["C"], case["cheb"], k, u, None, b4_out, None, True, inp["rect"],
        halt, plan, work=b4_work), 30)
    # B6 at M2's shape (257^2, k=6), for M2's share of a step.
    md2 = meshes[(257, "float32")]
    k2 = DEMO_ITERS[257]
    inp2 = canvas_inputs(md2, problems["demo"], 2, torch.float32, cache)
    case2 = b6_case(inp2, md2, K, k2, 2, torch.float32, demo_species(1)[0],
                    True)
    out2 = torch.empty_like(case2["U"])
    work2 = fused_hbm.work_buffer(case2["plan"], case2["U"], K)
    ms_257 = cuda_ms(lambda: fused_hbm.multispecies_kernel_step(
        case2["C"], case2["scal"], k2, case2["U"], out2, True, inp2["rect"],
        halt, case2["plan"], case2["loads"], case2["index"], work2), 200)
    emit({"phase": "multispecies_kernel_times", "card": card_line(),
          "b6_ms": ms, "b6_plain_ms": plain, "b6_bound_ms": b_ms,
          "b6_plan": case["plan"], "b6_ms_257_k6": ms_257,
          "b4_with_load_ms": b4_ms, "b4_without_load_ms": b4_nl, "b4_k": k,
          "b4_order": 2, "b4_plan": plan})
    return {"B6": (ms, plain, b_ms, by, abs_e, None, {"plan": case["plan"]})}


# --- slice 4: loads on B1, B2 and B4, B1's BiCGStab variant, S1-S3, P1-P2


# tpu_sourced_fused.py's emitter (its 257^2 and 513^2 rows) and the
# production scenario's TPU rows (results_snapshot/production_scenario.json,
# a TPU figure, held loosely: another card's float32 rounding).
S_SOURCE = dict(q=50.0, xs=-8.0, ys=5.0, sigma_s=3.0)
S_ITERS = 4
TPU_SCENARIO = {(1025, 0.0): {"mass_final": 9.935103416442871,
                              "deposited": 0.0574382787453942},
                (513, 0.005): {"mass_final": 10.011184692382812}}
SCENARIO_TOL = 5e-3
# The 257^2 reference rel_l2 of the plume (the JAX package's scan on the
# CPU in float32, bench configuration).
REF_REL_L2_257 = 0.31563


def scenario():
    """scripts/torch_port_production_scenario.py (problem, solver, budget)."""
    from scripts import torch_port_production_scenario as mod

    return mod


@functools.lru_cache(maxsize=None)
def scenario_problem():
    """The scenario's problem with the compensation-point flux (one
    instance, so that canvas_inputs' cache serves every phase: c_comp
    changes the load, not the operator)."""
    return scenario().BoundaryLayerEmitter(c_comp=0.005)


def s_source():
    import airpollution_tpu_torch as apt

    return apt.GaussianSourceProblem(**S_SOURCE)


def ramp_source():
    """A time-dependent emitter (tests/test_pallas_hbm.py's ramp)."""
    import torch

    import airpollution_tpu_torch as apt

    class Ramp(apt.Problem):
        zero_source = False
        steady_source = False

        def source_term(self, xyt):
            return self.source_xy(xyt[..., 0], xyt[..., 1], xyt[..., 2])

        def source_xy(self, x, y, t):
            return (0.2 + 0.1 * t) * torch.exp(-0.03 * (x ** 2 + y ** 2))

    return Ramp(sigma=1.0)


def uniform_load(md, scal, order, source, n_steps, dtype):
    """The load of ``source`` as B1 / B2 take it: one (3, n, n) plane for a
    steady source, an (n_steps, 3, n, n) stack otherwise."""
    from airpollution_tpu_torch.mesh.data import structured_grid
    from airpollution_tpu_torch.ops import fused_solver

    el = fused_solver.uniform_loads(
        source.source_xy, source.steady_source, scal[15:18],
        fused_solver.rect_masks(md.structured_n, dtype, scal.device),
        grid=structured_grid(md), dt=md.domain.T / (md.nt - 1), t0=0.0,
        use_ka=order == 2, lumped=True)
    if source.steady_source:
        return el.planes[0]
    return el.window(n_steps)[:, 0]


def bicgstab_tol(name, rel_moved):
    """B5's rule for a BiCGStab kernel in float32: the larger of TOL and 10x
    the plain solve's own sensitivity to a 1e-7 input change."""
    if name != "float32":
        return TOL[name]
    return max(TOL[name], 10.0 * rel_moved)


def phase_b1_loads(meshes):
    """B1 (Chebyshev-4) with a steady load plane and with a per-step load
    stack, and B1's BiCGStab variant (k=5) with and without a load, against
    their plain versions: 65^2 x 32 steps, BE and CN, and 257^2 x 16 steps,
    extrapolated. The stack runs in two launches that carry u and u_prev."""
    import torch

    from airpollution_tpu_torch.ops import fused_solver

    problem = plume()
    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms, n_steps in ((65, 32), (257, 16)):
            md = meshes[(ms, name)]
            for order in (1, 2):
                scal, u3 = uniform_inputs(md, problem, order, S_ITERS, dtype)
                kw = dict(n_iters=S_ITERS, use_ka=order == 2,
                          extrapolate=True)
                for label, source in (("steady", s_source()),
                                      ("stack", ramp_source())):
                    load = uniform_load(md, scal, order, source, n_steps,
                                        dtype)
                    if label == "steady":
                        got, _ = fused_solver.kernel_solve(
                            scal, u3, n_steps=n_steps, load=load, **kw)
                    else:
                        half = n_steps // 2
                        u, up = fused_solver.kernel_solve(
                            scal, u3, n_steps=half, load=load[:half], **kw)
                        got, _ = fused_solver.kernel_solve(
                            scal, u, n_steps=n_steps - half, up=up,
                            load=load[half:], **kw)
                    ref, _ = fused_solver.plain_solve(
                        scal, u3, n_steps=n_steps, load=load, **kw)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got, ref)
                    rows.append({"kernel": "B1-load", "ms": ms,
                                 "dtype": name, "order": order,
                                 "load": label, "rel_err": rel,
                                 "worst_at": worst_at(diff)})
                    check(rel <= TOL[name], f"B1+load {rows[-1]}: rel err "
                          f"above {TOL[name]:.0e}")
                    if ms == 257 and name == "float32":
                        worst["B1-load"] = max(worst.get("B1-load", 0.0),
                                               abs_e)
                scal21 = scal[:21].contiguous()
                for ext in (False, True):
                    for label in ("none", "steady"):
                        load = (None if label == "none" else uniform_load(
                            md, scal, order, s_source(), n_steps, dtype))
                        bkw = dict(n_steps=n_steps, n_iters=5,
                                   use_ka=order == 2, extrapolate=ext,
                                   load=load)
                        got, _ = fused_solver.kernel_uniform_bicgstab_solve(
                            scal21, u3, **bkw)
                        ref, _ = fused_solver.plain_uniform_bicgstab_solve(
                            scal21, u3, **bkw)
                        torch.cuda.synchronize()
                        abs_e, rel, diff = rel_err(got, ref)
                        sens = None
                        if name == "float32":
                            moved, _ = fused_solver.plain_uniform_bicgstab_solve(
                                scal21, u3 * (1.0 + 1e-7), **bkw)
                            sens = rel_err(moved, ref)[1]
                        tol = bicgstab_tol(name, sens)
                        rows.append({"kernel": "B1-BiCGStab", "ms": ms,
                                     "dtype": name, "order": order,
                                     "extrapolate": ext, "load": label,
                                     "rel_err": rel,
                                     "plain_sensitivity": sens, "tol": tol,
                                     "worst_at": worst_at(diff)})
                        check(rel <= tol, f"B1-BiCGStab {rows[-1]}: rel "
                              f"err above tol")
                        if ms == 257 and name == "float32":
                            worst["B1-BiCGStab"] = max(
                                worst.get("B1-BiCGStab", 0.0), abs_e)
    emit({"phase": "b1_loads_bicgstab_vs_plain", "card": card_line(),
          "cases": rows})
    return worst


def plume():
    import airpollution_tpu_torch as apt

    return apt.Problem(sigma=1.0)


def phase_b2_load(meshes):
    """B2 with a load against plain_step with the same load: one step at
    129^2 and 1025^2, k = 4 and 8, BE and CN, from a state that differs
    from u_prev, with S1's steady load."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    problem = plume()
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 1025):
            md = meshes[(ms, name)]
            for k in (4, 8):
                for order in (1, 2):
                    use_ka = order == 2
                    scal, u0 = uniform_inputs(md, problem, order, k, dtype)
                    load = uniform_load(md, scal, order, s_source(), 1,
                                        dtype)
                    masks = fused_solver.rect_masks(u0.shape[-1], dtype,
                                                     u0.device)
                    u, up = fused_solver.plain_step(scal, k, u0, u0, use_ka,
                                                    masks, load)
                    ref_u, ref_up = fused_solver.plain_step(
                        scal, k, u, up, use_ka, masks, load)
                    plan = fused_solver.uniform_plan(k, use_ka, dtype,
                                                     u.shape[-1])
                    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up,
                                          use_ka, halt, plan, load=load)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got_u, ref_u)
                    check(bool(torch.equal(got_up, ref_up)),
                          f"B2+load {ms}^2 k={k}: u_prev output differs")
                    rows.append({"ms": ms, "dtype": name, "k": k,
                                 "order": order, "plan": plan,
                                 "rel_err": rel, "worst_at": worst_at(diff)})
                    check(rel <= TOL[name], f"B2+load {rows[-1]}: rel err "
                          f"above {TOL[name]:.0e}")
                    if ms == 1025 and name == "float32":
                        worst["B2-load"] = max(worst.get("B2-load", 0.0),
                                               abs_e)
    emit({"phase": "b2_load_vs_plain", "card": card_line(), "cases": rows})
    return worst


def phase_plan_variants(meshes, problems, cache):
    """The uniform step's and the BiCGStab loop's launch variants against
    their plain versions, f64 and f32. B2: one step at 129^2 and 257^2
    (k=8, BE and CN, extrapolated, with and without S1's load) at its plan,
    at a rectangular 16 x 40 tile and at every depth 2-4 that splits the
    step (those that fit); B8: 4 blocks at 257^2 for 3 steps at its plan
    and at depth 2,
    with and without the load; B1: 65^2 x 16 steps at depth 2, BE and CN,
    with and without a steady load; B5 (C1's operator) and B1's BiCGStab
    variant (the plume) at 129^2 x 16 steps, BE and CN, extrapolated, in
    every cells-per-thread mode their registers allow and in global mode
    (float32 held to bicgstab_tol), and at 513^2 x 8 steps at their plans
    (global mode)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    problem = plume()
    rows = []
    k = 8
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 257):
            md = meshes[(ms, name)]
            n = md.structured_n
            for order in (1, 2):
                use_ka = order == 2
                scal, u0 = uniform_inputs(md, problem, order, k, dtype)
                masks = fused_solver.rect_masks(n, dtype, u0.device)
                base = fused_solver.uniform_plan(k, use_ka, dtype, n)
                plans = [base, fused_solver.UniformPlan(16, 40, 1)]
                plans += [base._replace(depth=d) for d in (2, 3, 4)
                          if fused_solver.depth_fits(k, use_ka, False, d)]
                plans = [pl for pl in plans if fused_solver.uniform_plan_fits(
                    pl, k, use_ka, dtype)]
                for load in (None, uniform_load(md, scal, order, s_source(),
                                                1, dtype)):
                    u, up = fused_solver.plain_step(scal, k, u0, 0.9 * u0,
                                                    use_ka, masks, load)
                    ref_u, ref_up = fused_solver.plain_step(
                        scal, k, u, up, use_ka, masks, load)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    for plan in plans:
                        got_u, got_up = (torch.empty_like(u),
                                         torch.empty_like(u))
                        fused_hbm.kernel_step(scal, k, u, up, got_u, got_up,
                                              use_ka, halt, plan, load=load)
                        torch.cuda.synchronize()
                        _, rel, diff = rel_err(got_u, ref_u)
                        rows.append({"kernel": "B2", "ms": ms, "dtype": name,
                                     "order": order, "load": load is not None,
                                     "plan": plan, "rel_err": rel,
                                     "worst_at": worst_at(diff)})
                        check(bool(torch.equal(got_up, ref_up)),
                              f"B2 {rows[-1]}: u_prev output differs")
                        check(rel <= TOL[name], f"B2 {rows[-1]}: rel err "
                              f"above {TOL[name]:.0e}")
        # B8 on 4 blocks at 257^2, at its plans and at depth 2.
        md = meshes[(257, name)]
        n = md.structured_n
        scal, u3 = uniform_inputs(md, problem, 1, k, dtype)
        plane = uniform_load(md, scal, 1, s_source(), 1, dtype)
        blocks = block_rows(n, 4, k, False)
        bmasks = [fused_hbm.block_masks(b, dtype, u3.device)
                  for b in blocks.blocks]
        for depth in (1, 2):
            plans = [fused_hbm.block_plan(k, False, dtype, b)._replace(
                depth=depth) for b in blocks.blocks]
            for kid, load in (("B8", None), ("B8-load", blocks.split(plane))):
                state = torch.stack([blocks.split(u3),
                                     blocks.split(0.8 * u3)], dim=1)

                def kernel(d, src, dst, load=load, plans=plans):
                    fused_hbm.block_kernel_step(
                        scal, k, src[0], src[1], dst[0], dst[1], False, None,
                        plans[d], blocks.blocks[d],
                        load=None if load is None else load[d])

                def plain(d, src, load=load):
                    x, up = fused_hbm.plain_block_step(
                        scal, k, src[0], src[1], False, *bmasks[d],
                        None if load is None else load[d])
                    return torch.stack([x, up])

                _, rel = block_case_run(kid, blocks, dtype, 3, kernel, plain,
                                        state)
                rows.append({"kernel": kid, "ms": 257, "blocks": 4,
                             "dtype": name, "plans": plans, "rel_err": rel})
        # B1 at depth 2.
        md = meshes[(65, name)]
        for order in (1, 2):
            scal, u3 = uniform_inputs(md, problem, order, k, dtype)
            plan = fused_solver.UniformPlan(16, 16, 2)
            for load in (None, uniform_load(md, scal, order, s_source(), 16,
                                            dtype)):
                kw = dict(n_steps=16, n_iters=k, use_ka=order == 2,
                          extrapolate=True, load=load)
                got, got_up = fused_solver.kernel_solve(scal, u3, plan=plan,
                                                        **kw)
                ref, ref_up = fused_solver.plain_solve(scal, u3, **kw)
                torch.cuda.synchronize()
                _, rel, diff = rel_err(got, ref)
                rows.append({"kernel": "B1", "ms": 65, "dtype": name,
                             "order": order, "load": load is not None,
                             "plan": plan, "rel_err": rel,
                             "worst_at": worst_at(diff)})
                rows[-1]["u_prev_rel_err"] = rel_err(got_up, ref_up)[1]
                check(max(rel, rows[-1]["u_prev_rel_err"]) <= TOL[name],
                      f"B1 {rows[-1]}: rel err above {TOL[name]:.0e}")
        # The BiCGStab loops in every mode.
        for ms, n_steps, forced in ((129, 16, True), (513, 8, False)):
            if ms == 513 and name == "float64":
                continue
            md = meshes[(ms, name)]
            for order in (1, 2):
                kw = dict(n_steps=n_steps, n_iters=5, use_ka=order == 2,
                          extrapolate=True)
                inp = canvas_inputs(md, problems["C1"], order, dtype, cache)
                C, c3 = bicgstab_inputs(inp, dtype)
                scal, u3 = uniform_inputs(md, problem, order, 5, dtype)
                scal21 = scal[:21].contiguous()
                cases = (
                    ("B5", "canvas",
                     lambda cells: fused_solver.kernel_bicgstab_solve(
                         C, c3, cells=cells, **kw),
                     lambda x: fused_solver.plain_bicgstab_solve(C, x, **kw),
                     c3),
                    ("B1-BiCGStab", "uniform",
                     lambda cells: fused_solver.kernel_uniform_bicgstab_solve(
                         scal21, u3, cells=cells, **kw)[0],
                     lambda x: fused_solver.plain_uniform_bicgstab_solve(
                         scal21, x, **kw)[0], u3))
                for kid, op, run, plain, x0 in cases:
                    ref = plain(x0)
                    sens = None
                    if name == "float32":
                        sens = rel_err(plain(x0 * (1.0 + 1e-7)), ref)[1]
                    tol = bicgstab_tol(name, sens)
                    if forced:
                        most = fused_solver.BICGSTAB_CELLS[(op, dtype)]
                        modes = list(range(1, most + 1)) + [0]
                    else:
                        modes = [fused_solver.bicgstab_cells(
                            md.structured_n, op, dtype)]
                    for cells in modes:
                        got = run(cells)
                        torch.cuda.synchronize()
                        _, rel, diff = rel_err(got, ref)
                        rows.append({"kernel": kid, "ms": ms, "dtype": name,
                                     "order": order, "cells": cells,
                                     "rel_err": rel,
                                     "plain_sensitivity": sens, "tol": tol,
                                     "worst_at": worst_at(diff)})
                        check(rel <= tol, f"{kid} {rows[-1]}: rel err above "
                              "tol")
    emit({"phase": "plan_variants_vs_plain", "card": card_line(),
          "cases": rows})


def flux_plane(inp, md, problem, use_ka, C, masks, dtype):
    """B4's load plane of a problem with a source and a Robin flux hook:
    the source load plus dt g |e| on the wall lines, for the first step,
    as fused_solve_canvas_hbm builds it."""
    from airpollution_tpu_torch.mesh.data import structured_grid
    from airpollution_tpu_torch.ops import fused_solver, loads

    live = None
    if inp["dead"] is not None:
        live = 1.0 - fused_solver.to_canvases(inp["pattern"],
                                              inp["dead"].to(dtype))
    grid = structured_grid(md)
    dt = md.domain.T / (md.nt - 1)
    src = loads.EmissionLoads(
        (problem.source_xy,), (True,), grid=grid, dt=dt, t0=0.0,
        use_ka=use_ka, lumped=True, mass3=C[15:18], masks=masks, live=live)
    walls = loads.RobinFluxLoads(
        problem.robin_g_xy, tuple(sorted(problem.robin_sides)), grid=grid,
        dt=dt, use_ka=use_ka, masks=masks, live=live)
    plane = src.planes[0].clone()
    walls.add(plane, src.planes[0], dt)
    return plane


def phase_b4_flux(meshes, cache):
    """B4 with the production scenario's load plane (steady source + the
    compensation-point flux g |e| on the ground line) against
    plain_canvas_step: one step at 129^2 and 1025^2, k=8, BE and CN, on
    the scenario's operator (log-profile wind, Robin floor and lid)."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    problem = scenario_problem()
    worst = {}
    rows = []
    k = 8
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 1025):
            md = meshes[(ms, name)]
            for order in (1, 2):
                use_ka = order == 2
                inp = canvas_inputs(md, problem, order, dtype, cache)
                C, cheb, u, masks = canvas_step_inputs(inp, k, dtype)
                u = u + 0.01 * masks  # a nonzero state under the plume
                plane = flux_plane(inp, md, problem, use_ka, C, masks, dtype)
                plan = fused_hbm.canvas_plan(k, use_ka, dtype)
                got = torch.empty_like(u)
                halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
                fused_hbm.canvas_kernel_step(
                    C, cheb, k, u, u, got, torch.empty_like(u), use_ka,
                    inp["rect"], halt, plan, load=plane)
                ref, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, u,
                                                     use_ka, masks, plane)
                torch.cuda.synchronize()
                abs_e, rel, diff = rel_err(got, ref)
                rows.append({"ms": ms, "dtype": name, "order": order,
                             "plan": plan, "rel_err": rel,
                             "flux_line_max": float(plane[0, 0].abs().max()),
                             "worst_at": worst_at(diff)})
                check(rel <= TOL[name], f"B4+flux {rows[-1]}: rel err above "
                      f"{TOL[name]:.0e}")
                if ms == 1025 and name == "float32":
                    worst["B4-load"] = max(worst.get("B4-load", 0.0), abs_e)
    emit({"phase": "b4_source_flux_vs_plain", "card": card_line(),
          "cases": rows})
    return worst


def cuda_ms_once(fn):
    """(result, device ms) of one call of ``fn`` (CUDA events, no warm-up:
    for plain versions that every earlier phase has already run)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def timed_phase(solver, reps, store=False):
    """(first solve s, warm solve times): a first solve (assembly, spectral
    estimates), then ``reps`` warm ones."""
    t0 = time.perf_counter()
    solver.solve(store_solutions=store)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        solver.solve(store_solutions=store)
        times.append(solver.solve_time)
    return first, times


def rates(out, tag, n_steps, times):
    out[f"{tag}steps_per_s_best"] = n_steps / min(times)
    out[f"{tag}steps_per_s_median"] = n_steps / statistics.median(times)


def sourced_check(out, ms, domain, impl):
    """tpu_sourced_fused.py's check at nt=33: the fused path (Chebyshev-6)
    against the stencil scan, relative to max|scan|. Gated: the scan with
    the same Chebyshev-6 on the same interval (the load and kernel path
    against an independent RHS). Reported: the scan with BiCGStab to 1e-7,
    as the script compares; at this dt (dt |v| / h ~ 2.2 at 257^2) k=6
    leaves an iteration error of tens of percent in both packages."""
    import warnings

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver

    md = apt.MeshData(apt.create_mesh(ms, 20.0), domain, nt=33)
    scan = CRBESolver(domain, s_source(), md, matvec_impl="stencil",
                      solver_tol=1e-7, solver_maxiter=60)
    ref = scan.solve(store_solutions=False)
    fused = CRBESolver(domain, s_source(), md, matvec_impl=impl,
                       solver_method="chebyshev", chebyshev_iters=6)
    fused.set_operators(scan._ops)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the marginal-k warning, expected
        got = fused.solve(store_solutions=False)
    same = CRBESolver(domain, s_source(), md, matvec_impl="stencil",
                      solver_method="chebyshev", chebyshev_iters=6,
                      cheb_bounds=fused._cheb_bounds)
    same.set_operators(scan._ops)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cheb = same.solve(store_solutions=False)
    scale = float(ref.abs().max())
    out.update({
        "check_route": f"{fused.fused_kernel} ({fused.solver_method})",
        "check_cheb_factor": fused._cheb_factor,
        "check_rel_vs_cheb6_scan": float((got - cheb).abs().max()) / scale,
        "check_rel_vs_bicgstab_scan": float((got - ref).abs().max()) / scale,
    })
    check(out["check_rel_vs_cheb6_scan"] <= 1e-4,
          f"{out['phase']}: fused vs the Chebyshev-6 scan "
          f"{out['check_rel_vs_cheb6_scan']:.3e} > 1e-4")


def phase_s1(md, domain):
    """S1: tpu_sourced_fused.py's 257^2 row: the Gaussian emitter, nt=1001,
    BE, Chebyshev-4, extrapolated, 'fused' -> B1 with a load plane, one
    launch per solve; the zero-source solve timed beside it."""
    import torch

    from airpollution_tpu_torch.models.crbe import CRBESolver

    out = {"phase": "s1_sourced_257", "card": card_line(), "ms": 257,
           "nt": md.nt, "dofs": md.number_of_segments}
    n_steps = md.nt - 1
    kw = dict(matvec_impl="fused", solver_method="chebyshev",
              chebyshev_iters=S_ITERS, extrapolate_warm_start=True)
    s = CRBESolver(domain, s_source(), md, **kw)
    reset_counts()
    first, times = timed_phase(s, 5)
    launches = launches_of("B1-load")
    out.update({"route": s.fused_kernel, "first_solve_s": first,
                "b1_load_launches": launches,
                "b1_load_launches_per_solve": launches / 6})
    rates(out, "", n_steps, times)
    check(s.fused_kernel == "B1" and launches == 6
          and launches_of("B1") == 0,
          f"S1: {launches} B1 load launches in 6 solves, not 6")
    check(bool(torch.isfinite(s.solutions).all()), "S1: non-finite state")
    zero = CRBESolver(domain, plume(), md, **kw)
    _, ztimes = timed_phase(zero, 5)
    rates(out, "zero_source_", n_steps, ztimes)
    sourced_check(out, 257, domain, "fused")
    emit(out)
    return launches, s


def phase_s2(md, domain):
    """S2: the same emitter at 513^2, 'fused_hbm' -> B2 with a load plane,
    1,000 launches per solve; the zero-source solve timed beside it."""
    import torch

    from airpollution_tpu_torch.models.crbe import CRBESolver

    out = {"phase": "s2_sourced_513", "card": card_line(), "ms": 513,
           "nt": md.nt, "dofs": md.number_of_segments}
    n_steps = md.nt - 1
    kw = dict(matvec_impl="fused_hbm", solver_method="chebyshev",
              chebyshev_iters=S_ITERS, extrapolate_warm_start=True)
    s = CRBESolver(domain, s_source(), md, **kw)
    reset_counts()
    s.solve(store_solutions=False)
    per_solve = launches_of("B2-load")
    check(s.fused_kernel == "B2" and per_solve == n_steps
          and launches_of("B2") == 0,
          f"S2: {per_solve} B2 load launches in one solve, not {n_steps}")
    _, times = timed_phase(s, 3)
    launches = launches_of("B2-load")
    out.update({"route": s.fused_kernel,
                "b2_load_launches_per_solve": per_solve,
                "b2_load_launches": launches})
    rates(out, "", n_steps, times)
    check(bool(torch.isfinite(s.solutions).all()), "S2: non-finite state")
    zero = CRBESolver(domain, plume(), md, **kw)
    _, ztimes = timed_phase(zero, 3)
    rates(out, "zero_source_", n_steps, ztimes)
    sourced_check(out, 513, domain, "fused_hbm")
    emit(out)
    return launches


def phase_s3(md, domain, s1_solver):
    """S3: the plume at 257^2 on 'fused' with the default solver_method
    (BiCGStab-5), extrapolated, BE and CN -> B1's BiCGStab variant; rel_l2
    within 5e-4 of the reference's 0.31563 and max|fused - converged scan|
    <= 1e-4; and one sourced BiCGStab solve (S1's emitter) against the
    converged scan, as S1's Chebyshev solve."""
    import torch

    from airpollution_tpu_torch.models.crbe import CRBESolver

    problem = plume()
    out = {"phase": "s3_bicgstab_257", "card": card_line(), "ms": 257,
           "nt": md.nt, "dofs": md.number_of_segments}
    n_steps = md.nt - 1
    total = 0
    for order in (1, 2):
        tag = "be" if order == 1 else "cn"
        kw = dict(time_scheme_order=order, stiffness_convention="reference")
        s = CRBESolver(domain, problem, md, matvec_impl="fused",
                       extrapolate_warm_start=True, **kw)
        reset_counts()
        s.solve(store_solutions=False)
        per_solve = launches_of("B1-BiCGStab")
        check(s.fused_kernel == "B1-BiCGStab" and per_solve == 1,
              f"S3 {tag}: {per_solve} B1-BiCGStab launches in one solve")
        _, times = timed_phase(s, 3)
        total += launches_of("B1-BiCGStab")
        rates(out, f"{tag}_", n_steps, times)
        rel, _, _ = s.compute_errors(problem.analytical_solution)
        scan = CRBESolver(domain, problem, md, matvec_impl="stencil",
                          solver_tol=1e-6, solver_maxiter=100, **kw)
        scan.solve(store_solutions=False)
        diff = max_diff(s, scan)
        out.update({f"{tag}_rel_l2": rel,
                    f"{tag}_max_fused_minus_scan": diff})
        check(abs(rel - REF_REL_L2_257) <= 5e-4,
              f"S3 {tag}: rel_l2 {rel} not within 5e-4 of {REF_REL_L2_257}")
        check(diff <= 1e-4, f"S3 {tag}: max|fused - scan| {diff:.3e}")
    src = CRBESolver(domain, s_source(), md, matvec_impl="fused",
                     extrapolate_warm_start=True)
    reset_counts()
    src.solve(store_solutions=False)
    total += launches_of("B1-BiCGStab")
    check(src.fused_kernel == "B1-BiCGStab"
          and launches_of("B1-BiCGStab") == 1,
          "S3: the sourced BiCGStab solve did not launch B1's variant once")
    scan = CRBESolver(domain, s_source(), md, matvec_impl="stencil",
                      solver_tol=1e-6, solver_maxiter=100)
    scan.solve(store_solutions=False)
    scale = float(scan.solutions[-1].abs().max())
    out["sourced_rel_vs_scan"] = max_diff(src, scan) / scale
    out["s1_chebyshev_rel_vs_scan"] = max_diff(s1_solver, scan) / scale
    check(bool(torch.isfinite(src.solutions).all()),
          "S3: non-finite sourced state")
    check(out["sourced_rel_vs_scan"] <= 1e-4,
          f"S3: sourced BiCGStab vs scan {out['sourced_rel_vs_scan']:.3e}")
    check(out["s1_chebyshev_rel_vs_scan"] <= 1e-4,
          f"S1 at nt=1001 vs scan {out['s1_chebyshev_rel_vs_scan']:.3e}")
    out["b1_bicgstab_launches"] = total
    emit(out)
    return total


def phase_scenario(ms, nt, every, c_comp, tag):
    """P1 / P2: the production scenario (scripts/torch_port_production_
    scenario.py) on B4 with its load plane: the steady source, plus the
    compensation-point flux on the ground line when c_comp != 0. Warm
    steps/s, launches per solve, the budget against the TPU's row (a TPU
    figure, <= 5e-3), and over a short horizon (the first 40 steps, a row
    every 10) against the port's stencil scan with the same iterations and
    interval: the extrapolated final state (<= 1e-4), and, without the
    extrapolated warm start (whose u_prev restarts at every snapshot
    chunk, as in the JAX solver), every strided row (<= 1e-4) and the
    last strided row against the final state, bit for bit."""
    import torch

    from airpollution_tpu_torch.models.crbe import CRBESolver

    sc = scenario()
    out = {"phase": f"{tag}_production_{ms}", "card": card_line(), "ms": ms,
           "nt": nt, "snapshot_every": every, "c_comp": c_comp, "k": 8}
    s = sc.make_solver(ms, nt, every, 8, c_comp=c_comp)
    n_steps = nt - 1
    out["dofs"] = s.mesh_data.number_of_segments
    reset_counts()
    t0 = time.perf_counter()
    rows = s.solve(store_solutions=True)
    out["first_solve_s"] = time.perf_counter() - t0
    per_solve = launches_of("B4-load")
    check(s.fused_kernel == "B4" and per_solve == n_steps,
          f"{tag}: {per_solve} B4 launches in one solve, not {n_steps}")
    check(s._robin_g_fused == bool(c_comp), f"{tag}: Robin flux routing")
    times = []
    for _ in range(2):
        rows = s.solve(store_solutions=True)
        times.append(s.solve_time)
    rates(out, "", n_steps, times)
    out["b4_launches_per_solve"] = per_solve
    out["b4_launches"] = launches_of("B4-load")
    check(rows.shape == (n_steps // every + 1, out["dofs"])
          and bool(torch.isfinite(rows).all()),
          f"{tag}: snapshot rows {tuple(rows.shape)} or non-finite")
    out["budget"] = sc.budget(s, rows, every)
    final = s.solve(store_solutions=False)
    out["last_row_rel_vs_final_extrapolated"] = rel_max(rows[-1], final[0])
    for name, want in TPU_SCENARIO.get((ms, c_comp), {}).items():
        got = out["budget"][name]
        out[f"{name}_tpu"] = want
        out[f"{name}_rel_vs_tpu"] = abs(got - want) / abs(want)
        check(out[f"{name}_rel_vs_tpu"] <= SCENARIO_TOL,
              f"{tag}: {name} {got} not within {SCENARIO_TOL} of the TPU's "
              f"{want}")
    # Short horizon: the scenario's first 40 steps (its own dt), fused
    # against the stencil scan, on one operator and one interval. The
    # strided fused path restarts the extrapolated warm start at every
    # chunk (as the JAX solver does) and the scan does not, which early in
    # a source-driven run, where u grows fast relative to itself, moves
    # the rows by Chebyshev-8's iteration error: that gap is reported; the
    # gates compare like with like.
    short = sc.make_solver(ms, 41, 10, 8, c_comp=c_comp, T=40 * s.dt)
    f_rows = short.solve(store_solutions=True)

    def twin(impl, ext, every):
        t = CRBESolver(short.domain, short.problem, short.mesh_data,
                       matvec_impl=impl, solver_method="chebyshev",
                       chebyshev_iters=8, time_scheme_order=2,
                       extrapolate_warm_start=ext, snapshot_every=every,
                       cheb_bounds=short._cheb_bounds)
        t.set_operators(short._ops)
        return t

    def rows_rel(a, b):
        return max(rel_max(a[j], b[j]) for j in range(1, a.shape[0]))

    scan_ext = twin("stencil", True, 10).solve(store_solutions=True)
    out["short_strided_rows_rel_vs_scan_extrapolated"] = rows_rel(f_rows,
                                                                  scan_ext)
    out["short_final_rel_vs_scan_extrapolated"] = rel_max(
        short.solve(store_solutions=False)[0], scan_ext[-1])
    check(out["short_final_rel_vs_scan_extrapolated"] <= 1e-4,
          f"{tag}: fused vs scan (extrapolated) "
          f"{out['short_final_rel_vs_scan_extrapolated']:.3e}")
    plain = twin("fused_hbm", False, 10)
    strided = plain.solve(store_solutions=True)
    out["short_strided_rows_rel_vs_scan"] = rows_rel(
        strided, twin("stencil", False, 10).solve(store_solutions=True))
    check(out["short_strided_rows_rel_vs_scan"] <= 1e-4,
          f"{tag}: strided fused vs scan rows "
          f"{out['short_strided_rows_rel_vs_scan']:.3e}")
    final = plain.solve(store_solutions=False)
    out["short_last_row_equals_final"] = bool(torch.equal(strided[-1],
                                                          final[0]))
    check(out["short_last_row_equals_final"],
          f"{tag}: the last strided row differs from the final state")
    emit(out)
    return out["b4_launches"]


def slice4_kernel_times(meshes, cache, s1_md, s2_md):
    """Per-launch times of the slice's kernel variants at their main paths'
    shapes (float32), their plain versions, bounds and largest |kernel -
    plain|: B1 with a load (S1's solve, 1000 steps), B1's BiCGStab variant
    (S3's BE solve), B2 with a load (S2's step, 513^2, k=4) and B4 with the
    source + flux plane (P2's step, 513^2, k=8, CN). Also, in this call,
    B2 without and with a load at 1025^2, k=8, and B4's load at P1's
    shape."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    f32 = torch.float32
    out = {}
    extra = {"phase": "slice4_kernel_times", "card": card_line()}
    problem = plume()
    # B1 with S1's load plane: one launch = the whole S1 solve.
    n_steps = s1_md.nt - 1
    scal, u3 = uniform_inputs(s1_md, problem, 1, S_ITERS, f32)
    load = uniform_load(s1_md, scal, 1, s_source(), n_steps, f32)
    kw = dict(n_steps=n_steps, n_iters=S_ITERS, use_ka=False,
              extrapolate=True, load=load)
    (ref, _), plain = cuda_ms_once(
        lambda: fused_solver.plain_solve(scal, u3, **kw))
    abs_e, rel, _ = rel_err(fused_solver.kernel_solve(scal, u3, **kw)[0],
                            ref)
    check(rel <= TOL["float32"], f"B1+load 257^2 x 1000: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_solve(scal, u3, **kw), 5)
    dofs = s1_md.number_of_segments
    b_ms, by = bound(3 * u3.numel() * 4, n_steps * dofs * (
        step_flops_per_dof(S_ITERS, False, True) + 1))
    out["B1-load"] = (ms, plain, b_ms, by, abs_e, None)
    extra["b1_without_load_ms"] = cuda_ms(lambda: fused_solver.kernel_solve(
        scal, u3, **dict(kw, load=None)), 5)
    # B1's BiCGStab variant: one launch = S3's BE solve (k=5, ext).
    md = meshes[(257, "float32")]
    scal, u3 = uniform_inputs(md, problem, 1, S_ITERS, f32)
    scal21 = scal[:21].contiguous()
    kw = dict(n_steps=md.nt - 1, n_iters=5, use_ka=False, extrapolate=True)
    got, _ = fused_solver.kernel_uniform_bicgstab_solve(scal21, u3, **kw)
    (ref, _), plain = cuda_ms_once(
        lambda: fused_solver.plain_uniform_bicgstab_solve(scal21, u3, **kw))
    abs_e, rel, _ = rel_err(got, ref)
    check(rel <= TOL["float32"], f"B1-BiCGStab 257^2 x 1000: rel err "
          f"{rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_uniform_bicgstab_solve(
        scal21, u3, **kw), 3)
    b_ms, by = bound(2 * u3.numel() * 4, (md.nt - 1) * md.number_of_segments
                     * bicgstab_flops_per_dof(5, False, True))
    out["B1-BiCGStab"] = (ms, plain, b_ms, by, abs_e, None, {
        "cells": fused_solver.bicgstab_cells(u3.shape[-1], "uniform",
                                             f32)})
    # B2 with a load: one S2 step (513^2, k=4, BE, ext), and at 1025^2,
    # k=8 without and with a load.
    for label, bmd, k in (("s2", s2_md, S_ITERS),
                          ("1025", meshes[(1025, "float32")], 8)):
        scal, u = uniform_inputs(bmd, problem, 1, k, f32)
        load = uniform_load(bmd, scal, 1, s_source(), 1, f32)
        up = u.clone()
        got_u, got_up = torch.empty_like(u), torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
        plan = fused_solver.uniform_plan(k, False, f32, u.shape[-1])
        masks = fused_solver.rect_masks(u.shape[-1], f32, u.device)

        def launch(ld, plan=plan):
            fused_hbm.kernel_step(scal, k, u, up, got_u, got_up, False, halt,
                                  plan, load=ld)

        launch(load)
        abs_e, rel, _ = rel_err(got_u, fused_solver.plain_step(
            scal, k, u, up, False, masks, load)[0])
        check(rel <= TOL["float32"], f"B2+load {label}: rel err {rel:.3e}")
        with_load = cuda_ms(lambda: launch(load), 50)
        without = cuda_ms(lambda: launch(None), 50)
        with_load_2 = cuda_ms(lambda: launch(load), 50)
        without_2 = cuda_ms(lambda: launch(None), 50)
        extra[f"b2_{label}_ms_without_with_with_without"] = [
            without, with_load, with_load_2, without_2]
        if label == "s2":
            plain = cuda_ms(lambda: fused_solver.plain_step(
                scal, k, u, up, False, masks, load), 5)
            b_ms, by = bound(5 * u.numel() * 4, bmd.number_of_segments * (
                step_flops_per_dof(k, False, True) + 1))
            out["B2-load"] = (min(with_load, with_load_2), plain, b_ms, by,
                              abs_e, None)
    # B4 with the scenario's source + flux plane at P2's shape, and its
    # source-only plane at P1's shape.
    problem_s = scenario_problem()
    for label, c_comp, bmd in (("p2", 0.005, meshes[(513, "float32")]),
                               ("p1", 0.0, meshes[(1025, "float32")])):
        inp = canvas_inputs(bmd, problem_s, 2, f32, cache)
        C, cheb, u, masks = canvas_step_inputs(inp, 8, f32)
        u = u + 0.01 * masks
        if c_comp:
            plane = flux_plane(inp, bmd, problem_s, True, C, masks, f32)
        else:
            (plane,), _ = step_loads(inp, bmd, problem_s, 1, True, C, masks,
                                     True, f32)
        plan = fused_hbm.canvas_plan(8, True, f32)
        work = fused_hbm.work_buffer(plan, u)
        got = torch.empty_like(u)
        got_up = torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)

        def launch(ld):
            fused_hbm.canvas_kernel_step(C, cheb, 8, u, u, got, got_up, True,
                                         inp["rect"], halt, plan, load=ld,
                                         work=work)

        launch(plane)
        abs_e, rel, _ = rel_err(got, fused_hbm.plain_canvas_step(
            C, cheb, 8, u, u, True, masks, plane)[0])
        check(rel <= TOL["float32"], f"B4+load {label}: rel err {rel:.3e}")
        with_load = cuda_ms(lambda: launch(plane), 30)
        without = cuda_ms(lambda: launch(None), 30)
        extra[f"b4_{label}_ms_with_without"] = [with_load, without]
        if label == "p2":
            plain = cuda_ms(lambda: fused_hbm.plain_canvas_step(
                C, cheb, 8, u, u, True, masks, plane), 5)
            b_ms, by = bound((C.numel() + 5 * u.numel()) * 4,
                             bmd.number_of_segments * (
                                 canvas_step_flops_per_dof(8, True, True)
                                 + 1))
            out["B4-load"] = (with_load, plain, b_ms, by, abs_e, None,
                              {"plan": plan})
    emit(extra)
    return out


# I1: scripts/torch_port_source_inversion.py at the size of the JAX
# package's results row (results_snapshot/source_inversion_513.csv, a TPU
# figure printed beside the card's for reference, held loosely: another
# card's float32 rounding), and its gates.
I1 = dict(mesh_size=513, nt=128, sensors=96, steps=120, lr=0.1, noise=0.01,
          engine="auto", chebyshev_iters=12)
I1_TPU = {"q_rel_err": 0.00106, "location_offset": 0.0076,
          "s_per_step": 0.5563}
I1_SOURCE = dict(q=2.0, xs=-4.0, ys=2.5, sigma_s=1.5)
RAW_TOL_ADJOINT = {"float64": 1e-12, "float32": 1e-5}


def raw_flops_per_dof(k):
    """Floating-point operations per DOF of B4's raw mode: r = mask b and
    d = (id r) / theta, then k iterations (x += d, r -= S d, d = a d +
    b (id r)), the last of which is only x += d (the kernel skips its
    matvec)."""
    row = 9
    return 3 + (k - 1) * (1 + row + 1 + 4) + 1


def raw_inputs(md, problem, dtype, cache, transposed):
    """B4-raw's (21, n, n) stack (zero mass planes) over the coefficients
    or their transpose, and the interval, from canvas_inputs."""
    from airpollution_tpu_torch.ops import fused_hbm, stencil

    inp = canvas_inputs(md, problem, 1, dtype, cache)
    coeffs = inp["coeffs"]
    if transposed:
        coeffs = stencil.transpose_coefficients(coeffs)
    C = fused_hbm.raw_operator(inp["pattern"], coeffs, inp["inv_diag"],
                               dtype)
    return inp, C


def run_raw(C, cheb, k, b, rect, plan=None):
    import torch

    from airpollution_tpu_torch.ops import fused_hbm

    x = torch.empty_like(b)
    fused_hbm.canvas_raw_kernel(C, cheb, k, b, x, rect,
                                plan or fused_hbm.raw_plan(k, b.dtype))
    return x


def phase_b4_raw(cases, cache):
    """B4's raw mode against plain_canvas_raw on ``cases`` ((label, md,
    problem, dtypes)), k = 12 and 8 (the "c1" cases also k = 24, at every
    depth that splits the step), over the coefficients and their
    transpose, from a random b (seed 0); and the adjoint dot-product test
    <K_A(b), m y> = <m b, K_A^T(y)> with K_A(b) = p(A) m b, the
    transposed-coefficient launch as K_A^T, random b and y."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    gaps = {}
    for label, md, problem, dtypes in cases:
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            rng = np.random.default_rng(0)
            n = md.structured_n
            b, y = (torch.tensor(rng.standard_normal((3, n, n)), dtype=dtype,
                                 device=md.device) for _ in range(2))
            for k in (12, 8, 24) if label.startswith("c1") else (12, 8):
                outs = {}
                plans = depth_plans(k, False, dtype, raw=True)
                for transposed in (False, True):
                    inp, C = raw_inputs(md, problem, dtype, cache,
                                        transposed)
                    cheb = fused_solver.cheb_scalars(inp["bounds"], k, dtype,
                                                     C.device)
                    masks = fused_solver.rect_masks(n, dtype, C.device,
                                                    inp["rect"])
                    vec = y if transposed else b
                    ref = fused_hbm.plain_canvas_raw(C, cheb, k, vec, masks)
                    for plan in plans if label.startswith("c1") \
                            else plans[:1]:
                        got = run_raw(C, cheb, k, vec, inp["rect"], plan)
                        torch.cuda.synchronize()
                        abs_e, rel, diff = rel_err(got, ref)
                        rows.append({"case": label, "dtype": name, "k": k,
                                     "transposed": transposed, "plan": plan,
                                     "rel_err": rel,
                                     "worst_at": worst_at(diff)})
                        check(rel <= TOL[name],
                              f"B4-raw {label} {name} k={k} T={transposed} "
                              f"{plan}: rel err {rel:.3e} > {TOL[name]:.0e}")
                        if label == "i1_513" and name == "float32":
                            worst["B4-raw"] = max(worst.get("B4-raw", 0.0),
                                                  abs_e)
                    outs[transposed] = got
                lhs = torch.sum(outs[False].double() * (masks * y).double())
                rhs = torch.sum((masks * b).double() * outs[True].double())
                gap = float((lhs - rhs).abs() / torch.maximum(lhs.abs(),
                                                              rhs.abs()))
                gaps[name] = max(gaps.get(name, 0.0), gap)
                check(gap <= RAW_TOL_ADJOINT[name],
                      f"B4-raw {label} {name} k={k}: adjoint gap {gap:.3e}"
                      f" > {RAW_TOL_ADJOINT[name]:.0e}")
    emit({"phase": "b4_raw_vs_plain", "cases": rows,
          "adjoint_gap_float64": gaps.get("float64"),
          "adjoint_gap_float32": gaps.get("float32"),
          "adjoint_tol": RAW_TOL_ADJOINT})
    return worst


def grad_rel(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_grad_129(md):
    """Gradients through the fused engine on the card: 129^2, f64,
    nt=129 (dt |v| / h ~ 0.28, where Chebyshev-24 converges tightly, as
    the JAX test at 17^2, nt=17), BE and CN, of sum(u_T^2) in D for
    Problem(D=0.1) and in (log q, xs, ys) for the emitter. The fused
    engine (B4's raw mode, forward and adjoint) within 2e-5 of the scan
    engine (BiCGStab to 1e-10), and its component along itself within
    5e-3 of a central difference of its own loss (step 1e-3)."""
    import math

    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse

    f64 = torch.float64

    def plume(th):
        return apt.Problem(D=th[0])

    def emitter(th):
        return apt.GaussianSourceProblem(
            q=torch.exp(th[0]), xs=th[1], ys=th[2],
            sigma_s=I1_SOURCE["sigma_s"])

    cases = {"plume_D": (plume, [0.1]),
             "emitter_logq_xs_ys": (emitter, [math.log(I1_SOURCE["q"]),
                                              I1_SOURCE["xs"],
                                              I1_SOURCE["ys"]])}
    out = {"phase": "grad_129_fused_vs_scan", "card": card_line(),
           "ms": 129, "nt": md.nt, "k": 24}
    launches = 0
    for cname, (make, theta) in cases.items():
        for order in (1, 2):
            tag = f"{cname}_{'be' if order == 1 else 'cn'}"

            def loss(th, engine, **kw):
                u = inverse.solve_final_state(make(th), md, engine=engine,
                                              time_scheme_order=order, **kw)
                return torch.sum(u ** 2)

            def grad(engine, **kw):
                th = torch.tensor(theta, dtype=f64, device=md.device,
                                  requires_grad=True)
                (g,) = torch.autograd.grad(loss(th, engine, **kw), th)
                return g

            reset_counts()
            t0 = time.perf_counter()
            g_fused = grad("fused_hbm", chebyshev_iters=24)
            torch.cuda.synchronize()
            fused_s = time.perf_counter() - t0
            launches += launches_of("B4-raw")
            check(launches_of("B4-raw") > 0,
                  f"{tag}: the fused gradient launched no B4-raw")
            t0 = time.perf_counter()
            g_scan = grad("scan", tol=1e-10, maxiter=500)
            scan_s = time.perf_counter() - t0
            # The central difference along the gradient's direction e (step
            # 1e-3): it checks g . e, the component a descent step uses;
            # the scan comparison checks every component.
            e = g_fused / torch.linalg.norm(g_fused)
            with torch.no_grad():
                th = torch.tensor(theta, dtype=f64, device=md.device)
                fd = (loss(th + 1e-3 * e, "fused_hbm", chebyshev_iters=24)
                      - loss(th - 1e-3 * e, "fused_hbm",
                             chebyshev_iters=24)) / 2e-3
            out[f"{tag}_grad_fused"] = g_fused.tolist()
            out[f"{tag}_rel_vs_scan"] = grad_rel(g_fused, g_scan)
            out[f"{tag}_rel_vs_central_difference"] = float(
                abs(torch.dot(g_fused, e) - fd) / abs(fd))
            out[f"{tag}_fused_s"] = fused_s
            out[f"{tag}_scan_s"] = scan_s
            check(out[f"{tag}_rel_vs_scan"] <= 2e-5,
                  f"{tag}: fused vs scan gradient "
                  f"{out[f'{tag}_rel_vs_scan']:.3e} > 2e-5")
            check(out[f"{tag}_rel_vs_central_difference"] <= 5e-3,
                  f"{tag}: fused gradient vs central difference "
                  f"{out[f'{tag}_rel_vs_central_difference']:.3e} > 5e-3")
    out["b4_raw_launches"] = launches
    emit(out)
    return launches


def phase_i1():
    """I1: the production source inversion (scripts/
    torch_port_source_inversion.py) at 513^2, nt=128, f32 on the
    differentiable fused engine (engine="auto" -> B4's raw mode forward
    and adjoint), with the observations from the same engine, 120 Adam
    steps and the posterior. Gates: q within 1%, location within 0.05,
    |z| <= 4 for each coordinate, and the loss down 50x."""
    import torch

    from scripts import torch_port_source_inversion as si

    reset_counts()
    t0 = time.perf_counter()
    row = si.run(**I1, device="cuda", dtype=torch.float32)
    total_s = time.perf_counter() - t0
    launches = launches_of("B4-raw")
    out = {"phase": "i1_source_inversion_513", "card": card_line(),
           **row, "total_s": total_s, "b4_raw_launches": launches,
           "tpu_reference": I1_TPU}
    emit(out)
    check(launches > 0 and row["b4_raw_launches_fit"] > 0,
          "I1: the inversion launched no B4-raw")
    check(row["q_rel_err"] <= 1e-2, f"I1: q_rel_err {row['q_rel_err']:.3e}")
    check(row["location_offset"] <= 0.05,
          f"I1: location offset {row['location_offset']:.3e}")
    for z in ("z_q", "z_xs", "z_ys"):
        check(abs(row[z]) <= 4.0, f"I1: {z} = {row[z]:.2f}")
    check(row["loss_last"] < row["loss_first"] / 50,
          f"I1: loss {row['loss_first']:.3e} -> {row['loss_last']:.3e}")
    return launches


def slice5_kernel_times(md_513, cache):
    """B4-raw's time per launch at I1's shape (513^2, k=12, f32, the
    emitter's uniform operator), its plain version's, and the bound: read
    15 coefficient, 3 inverse-diagonal and 3 b planes, write 3 x planes."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    f32 = torch.float32
    problem = i1_problem()
    inp, C = raw_inputs(md_513, problem, f32, cache, False)
    k = I1["chebyshev_iters"]
    n = md_513.structured_n
    cheb = fused_solver.cheb_scalars(inp["bounds"], k, f32, C.device)
    masks = fused_solver.rect_masks(n, f32, C.device, inp["rect"])
    b = torch.tensor(np.random.default_rng(1).standard_normal((3, n, n)),
                     dtype=f32, device=C.device)
    x = torch.empty_like(b)
    plan = fused_hbm.raw_plan(k, f32)
    work = fused_hbm.work_buffer(plan, b)
    ms = cuda_ms(lambda: fused_hbm.canvas_raw_kernel(
        C, cheb, k, b, x, inp["rect"], plan, work), 50)
    plain = cuda_ms(lambda: fused_hbm.plain_canvas_raw(C, cheb, k, b, masks),
                    5)
    abs_e, _, _ = rel_err(x, fused_hbm.plain_canvas_raw(C, cheb, k, b, masks))
    b_ms, by = bound((15 + 3 + 3 + 3) * n * n * 4,
                     md_513.number_of_segments * raw_flops_per_dof(k))
    emit({"phase": "slice5_kernel_times", "card": card_line(),
          "b4_raw_513_k12_ms": ms, "plain_ms": plain, "bound_ms": b_ms,
          "bound_by": by, "plan": plan})
    return {"B4-raw": (ms, plain, b_ms, by, abs_e, None, {"plan": plan})}


@functools.lru_cache(maxsize=1)
def i1_problem():
    import airpollution_tpu_torch as apt

    return apt.GaussianSourceProblem(**I1_SOURCE)


# --- slice 6: general meshes, kernel B7 ------------------------------------

# U1 and G1: the JAX A/B's unstructured mesh (scripts/tpu_vmem_gather_ab.py)
# and its seed.
UNSTRUCTURED_SEED = 1
# B7 against its plain version, max|kernel - plain| / max|plain|: each
# output is a sum of 5 products, summed in slot order by the kernel and by
# torch.sum in its own order.
B7_TOL = {"float64": 1e-14, "float32": 2e-6}


def unstructured_md(ms, nt, dtype):
    import torch

    import airpollution_tpu_torch as apt

    mesh = apt.create_unstructured_mesh(ms, 20.0, seed=UNSTRUCTURED_SEED)
    return apt.MeshData(mesh, apt.Domain(), nt=nt,
                        dtype=getattr(torch, dtype))


@contextlib.contextmanager
def plain_gather():
    """Every ELL product through B7's plain version, on the card: the
    reference side of the U1, G1 and msh comparisons (the port itself never
    takes it for a CUDA tensor)."""
    from airpollution_tpu_torch.ops import gather

    kernel = gather.matvec
    gather.matvec = lambda vals, cols, index, x: gather.plain_matvec(
        vals, cols, x)
    try:
        yield
    finally:
        gather.matvec = kernel


def ell_system(md, order=1):
    """U1's masked system operator (Problem(sigma=1.0), the mesh's dt)."""
    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models import crbe

    dt = md.domain.T / (md.nt - 1)
    return crbe.assemble(md, apt.Problem(sigma=1.0), dt, order).system


def plain_transpose(A, y):
    """A^T y by scatter-adding each slot's value into its column: an
    independent plain version of B7's transposed product."""
    import torch

    contrib = (A.vals * y[..., None]).reshape(y.shape[:-1] + (-1,))
    flat_cols = A.cols.reshape(A.cols.shape[:-2] + (-1,))
    return torch.zeros_like(y).scatter_add_(-1, flat_cols.expand_as(contrib),
                                            contrib)


def b7_bytes(n, width, itemsize):
    """Bytes one product must move: values and int32 columns, x and y,
    each once."""
    return n * width * (itemsize + 4) + 2 * n * itemsize


def phase_b7(cases):
    """Kernel B7 against its plain version on U1's operator: one x, a
    shared batch of 3, a stack of 3 operators; forward and the transposed
    backward (grad x through B7 over the transposed values, grad vals); the
    two entry points named after the JAX kernels."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import gather, sparse

    rows = []
    worst = {}
    for tag, md in cases:
        A = ell_system(md)
        name = str(A.vals.dtype).split(".")[-1]
        n, w = A.vals.shape
        rng = np.random.default_rng(2)

        def t(shape):
            return torch.tensor(rng.standard_normal(shape), dtype=A.vals.dtype,
                                device=md.device)

        x, X, g, G = t(n), t((3, n)), t(n), t((3, n))
        stack = sparse.stack_ell([A._replace(vals=A.vals * (1 + 0.1 * k))
                                  for k in range(3)])
        checks = {
            "single": (sparse.ell_matvec(A, x),
                       gather.plain_matvec(A.vals, A.cols, x)),
            "batch3": (sparse.ell_matvec(A, X),
                       gather.plain_matvec(A.vals, A.cols, X)),
            "stacked3": (sparse.ell_matvec_stacked(stack, X),
                         gather.plain_matvec(stack.vals, stack.cols, X)),
            "ell_matvec_vmem": (gather.ell_matvec_vmem(A, x),
                                gather.plain_matvec(A.vals, A.cols, x)),
            "ell_matvec_vmem_roll": (gather.ell_matvec_vmem_roll(A, x),
                                     gather.plain_matvec(A.vals, A.cols, x)),
        }
        for label, (op, vec, ybar) in {"single": (A, x, g),
                                       "stacked3": (stack, X, G)}.items():
            v = op.vals.clone().requires_grad_(True)
            xr = vec.clone().requires_grad_(True)
            y = sparse.EllMatvec.apply(v, xr, op.cols, op.b7, op.tslot)
            gv, gx = torch.autograd.grad(y, (v, xr), ybar)
            checks[f"{label}_grad_x"] = (gx, plain_transpose(op, ybar))
            checks[f"{label}_grad_vals"] = (
                gv, ybar[..., None] * gather.gather_cols(vec, op.cols))
        torch.cuda.synchronize()
        row = {"case": tag, "dtype": name, "dofs": n, "width": w}
        for label, (got, ref) in checks.items():
            check(got.shape == ref.shape, f"B7 {tag} {label}: shape")
            abs_e, rel, _ = rel_err(got, ref)
            row[label] = rel
            check(rel <= B7_TOL[name], f"B7 {tag} {label}: rel err "
                  f"{rel:.3e} > {B7_TOL[name]:.0e}")
            if name == "float32" and md.number_of_segments < 1_000_000:
                worst["B7a"] = max(worst.get("B7a", 0.0), abs_e)
                if label == "ell_matvec_vmem_roll":
                    worst["B7b"] = abs_e
        rows.append(row)
    emit({"phase": "b7_vs_plain", "card": card_line(), "cases": rows})
    return worst


def mesh_setup_1025():
    """The 1025^2 unstructured mesh's set-up on the host, split: jitter and
    Delaunay, edge enumeration (numpy and native), MeshData (native
    enumeration and geometry), and the ELL pattern with its transposition
    map (built on first use)."""
    import numpy as np

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.mesh import native, topology

    check(native.available(), "the native topology library did not load: "
          f"{native.load_error()}")
    out = {}
    t0 = time.perf_counter()
    mesh = apt.create_unstructured_mesh(1025, 20.0, seed=UNSTRUCTURED_SEED)
    out["delaunay_s"] = time.perf_counter() - t0
    tris = np.asarray(mesh.triangles, np.int64)
    t0 = time.perf_counter()
    segs, t2s, _ = topology._enumerate_numpy(tris, len(mesh.points))
    out["edges_numpy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = native.enumerate_edges_native(tris, len(mesh.points))
    out["edges_native_s"] = time.perf_counter() - t0
    check(np.array_equal(nat[0], segs) and np.array_equal(nat[1], t2s),
          "native edge enumeration differs from numpy's")
    t0 = time.perf_counter()
    md = apt.MeshData(mesh, apt.Domain(), nt=1001)
    out["meshdata_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    md.ell_index()  # the pattern, its transposition map, on the card
    out["ell_pattern_s"] = time.perf_counter() - t0
    out["native_library"] = str(native.library_path().relative_to(
        native.BUILD_ROOT.parent.parent))
    return md, out


def b7_kernel_times(md_257, md_1025, setup):
    """B7's time per product through each entry point at 257^2 and 1025^2
    unstructured (f32, U1's operator), the plain version's, cuSPARSE's CSR
    product of the same matrix (the library yardstick), and the bound by
    bytes. The B7b entry point's launches are counted on its own run."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.ops import gather

    out = {"phase": "b7_kernel_times", "card": card_line(),
           "mesh_setup_1025": setup}
    times = {}
    for ms, md in ((257, md_257), (1025, md_1025)):
        A = ell_system(md)
        n, w = A.vals.shape
        x = torch.tensor(np.random.default_rng(1).standard_normal(n),
                         dtype=A.vals.dtype, device=md.device)
        csr = torch.sparse_csr_tensor(
            torch.arange(0, n * w + 1, w, device=md.device),
            A.cols.reshape(-1), A.vals.reshape(-1), size=(n, n))
        library = cuda_ms(lambda: csr @ x, 200)
        plain = cuda_ms(lambda: gather.plain_matvec(A.vals, A.cols, x), 50)
        b_ms, by = bound(b7_bytes(n, w, 4), 2 * n * w)
        abs_csr = float((csr @ x - gather.plain_matvec(A.vals, A.cols, x))
                        .abs().max())
        for kid, entry in (("B7a", gather.ell_matvec_vmem),
                           ("B7b", gather.ell_matvec_vmem_roll)):
            ms_k = cuda_ms(lambda: entry(A, x), 200)
            out[f"{kid}_{ms}_ms"] = ms_k
            extra = {"enqueue_ms": enqueue_ms(lambda: entry(A, x))}
            extra["device_ms"], extra["device_timed_by"] = graph_ms(
                lambda: entry(A, x))
            out.update({f"{kid}_{ms}_{key}": v for key, v in extra.items()})
            if ms == 257:
                times[kid] = [ms_k, plain, b_ms, by, 0.0, library, extra]
        out[f"dofs_{ms}"] = n
        out[f"plain_{ms}_ms"] = plain
        out[f"csr_{ms}_ms"] = library
        out[f"csr_{ms}_max_abs_vs_plain"] = abs_csr
        out[f"bound_{ms}_ms"] = b_ms
        out[f"bound_{ms}_by"] = by
    reset_counts()
    A = ell_system(md_257)
    x = torch.ones(A.n_rows, dtype=A.vals.dtype, device=md_257.device)
    for _ in range(10):
        gather.ell_matvec_vmem_roll(A, x)
    out["b7b_entry_launches"] = launches_of("B7b")
    emit(out)
    return {kid: tuple(v) for kid, v in times.items()}, \
        out["b7b_entry_launches"]


def phase_u1(md, domain):
    """U1, the general-mesh solve: CRBESolver on the 257^2 unstructured
    mesh (197,120 DOFs), Problem(sigma=1.0), f32, nt=1001,
    matvec_impl="auto" (-> "ell", kernel B7): BiCGStab (tol 1e-7) in BE and
    CN, and Chebyshev extrapolated in BE at the smallest k the
    applicability check accepts from 8 up. Each final state within 1e-4 of
    max|u| of the same solve with B7's plain version on the card."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.ops import linalg

    problem = apt.Problem(sigma=1.0)
    out = {"phase": "u1_general_mesh_257", "card": card_line(),
           "ms": round(md.number_of_points ** 0.5), "nt": md.nt,
           "dofs": md.number_of_segments,
           "ell_width": md.ell_width}
    # Chebyshev at k=8, or at the smallest k that buys at least a 2x
    # residual reduction per step (the applicability check's rule; its
    # worst-case factor does not depend on k).
    s = CRBESolver(domain, problem, md, solver_method="chebyshev",
                   chebyshev_iters=8, extrapolate_warm_start=True)
    s._check_chebyshev_applicable(s._require_ops(), warn=False)
    factor = s._cheb_factor
    check(factor < linalg.CHEBYSHEV_FACTOR_GATE,
          f"U1: Chebyshev factor {factor:.3f} is refused")
    k = 8
    while factor ** k > 0.5:
        k += 1
    if k != 8:
        s = CRBESolver(domain, problem, md, solver_method="chebyshev",
                       chebyshev_iters=k, extrapolate_warm_start=True)
    out["chebyshev_k"] = k
    out["chebyshev_factor"] = factor
    rows = {"be": dict(time_scheme_order=1),
            "cn": dict(time_scheme_order=2),
            "chebyshev_be": dict(time_scheme_order=1,
                                 solver_method="chebyshev",
                                 chebyshev_iters=k,
                                 extrapolate_warm_start=True)}
    total_launches = 0
    cheb = s
    for tag, kw in rows.items():
        # solve_time leaves out assembly and the applicability check, and
        # every kernel and torch op of the solve ran in earlier phases, so
        # no solve is spent on warming up.
        s = cheb if tag == "chebyshev_be" else CRBESolver(
            domain, problem, md, matvec_impl="auto", **kw)
        reset_counts()
        times = timed_solves(s, 2, warm_up=False)
        check(s.solver_method == kw.get("solver_method", "bicgstab"),
              f"U1 {tag}: rerouted to {s.solver_method}")
        launches = launches_of("B7a")
        total_launches += launches
        check(launches > 0, f"U1 {tag}: the solve launched no B7")
        u = s.solutions[-1].clone()
        rel, _, _ = s.compute_errors(problem.analytical_solution)
        with plain_gather():
            ref = CRBESolver(domain, problem, md, matvec_impl="auto",
                             cheb_bounds=s._cheb_bounds, **kw)
            ref.set_operators(s._ops)
            ref.solve(store_solutions=False)
        diff = float((u - ref.solutions[-1]).abs().max() / u.abs().max())
        out[f"{tag}_steps_per_s_best"] = (md.nt - 1) / min(times)
        out[f"{tag}_steps_per_s_median"] = (md.nt - 1) / statistics.median(
            times)
        out[f"{tag}_b7_launches_per_solve"] = launches / len(times)
        out[f"{tag}_rel_l2"] = rel
        out[f"{tag}_max_kernel_minus_plain_rel"] = diff
        check(bool(torch.isfinite(u).all()), f"U1 {tag}: non-finite state")
        check(diff <= 1e-4, f"U1 {tag}: kernel vs plain {diff:.3e} > 1e-4")
    out["b7_launches"] = total_launches
    emit(out)
    return total_launches


def phase_g1(md):
    """G1, gradients on a general mesh: 129^2 unstructured, f64, nt=33,
    the gradient of a weighted sum of solve_final_state in D (the plume)
    and in the emitter's (log q, xs, ys), BiCGStab to 1e-13, B7 against its
    plain version within 1e-10; one posterior_covariance (forward-mode
    tangents through B7's double backward) within 1e-8."""
    import math

    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse

    f64 = torch.float64
    kw = dict(tol=1e-13, maxiter=500)
    w = torch.tensor(np.random.default_rng(5).standard_normal(
        md.number_of_segments), dtype=f64, device=md.device)

    def emitter(th):
        return apt.GaussianSourceProblem(q=torch.exp(th[0]), xs=th[1],
                                         ys=th[2], sigma_s=3.0)

    cases = {"plume_D": (lambda th: apt.Problem(D=th[0]), [0.1]),
             "emitter_logq_xs_ys": (emitter, [math.log(2.0), -4.0, 2.5])}
    out = {"phase": "g1_general_mesh_gradients_129", "card": card_line(),
           "ms": round(md.number_of_points ** 0.5), "nt": md.nt,
           "dofs": md.number_of_segments}

    def grad(make, theta):
        th = torch.tensor(theta, dtype=f64, device=md.device,
                          requires_grad=True)
        u = inverse.solve_final_state(make(th), md, **kw)
        (g,) = torch.autograd.grad(torch.sum(w * u), th)
        return g

    for tag, (make, theta) in cases.items():
        reset_counts()
        t0 = time.perf_counter()
        g = grad(make, theta)
        torch.cuda.synchronize()
        out[f"{tag}_s"] = time.perf_counter() - t0
        out[f"{tag}_b7_launches"] = launches_of("B7a")
        check(launches_of("B7a") > 0, f"G1 {tag}: no B7 launch")
        with plain_gather():
            g_ref = grad(make, theta)
        out[f"{tag}_grad"] = g.tolist()
        out[f"{tag}_rel_vs_plain"] = grad_rel(g, g_ref)
        check(out[f"{tag}_rel_vs_plain"] <= 1e-10,
              f"G1 {tag}: {out[f'{tag}_rel_vs_plain']:.3e} > 1e-10")
    idx = [16, 32]
    sens = list(range(0, md.number_of_segments, 499))
    truth = emitter(torch.tensor([math.log(2.0), -4.0, 2.5], dtype=f64,
                                 device=md.device))
    obs = inverse.solve_snapshots(truth, md, indices=idx, **kw)[:, sens]
    obs = obs + 0.01 * obs.abs().max() * torch.tensor(
        np.random.default_rng(0).standard_normal(tuple(obs.shape)),
        dtype=f64, device=md.device)
    params = {"log_q": torch.tensor(0.6, dtype=f64),
              "xy": torch.tensor([-3.5, 2.0], dtype=f64)}

    def make_problem(p):
        return emitter(torch.stack([p["log_q"], p["xy"][0], p["xy"][1]]))

    post_kw = dict(snapshot_indices=idx, sensor_indices=sens, observed=obs,
                   **kw)
    reset_counts()
    t0 = time.perf_counter()
    uq = inverse.posterior_covariance(md, make_problem, params, **post_kw)
    out["posterior_s"] = time.perf_counter() - t0
    out["posterior_b7_launches"] = launches_of("B7a")
    with plain_gather():
        uq_ref = inverse.posterior_covariance(md, make_problem, params,
                                              **post_kw)
    cov, cov_ref = uq["cov"], uq_ref["cov"]
    out["posterior_std"] = uq["std"]
    out["posterior_cov_rel_vs_plain"] = float(
        (cov - cov_ref).abs().max() / cov_ref.abs().max())
    emit(out)
    check(out["posterior_b7_launches"] > 0, "G1: the posterior launched "
          "no B7")
    check(out["posterior_cov_rel_vs_plain"] <= 1e-8,
          f"G1 posterior: {out['posterior_cov_rel_vs_plain']:.3e} > 1e-8")


def antidiagonal_grid(n):
    """The regular n x n grid of create_mesh with every cell cut along its
    other diagonal (tests/test_msh.py's mirrored grid)."""
    import numpy as np

    import airpollution_tpu_torch as apt

    m = apt.create_mesh(n, 20.0)
    j, i = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (j * n + i).ravel()
    v10, v01, v11 = v00 + 1, v00 + n, v00 + n + 1
    tris = np.empty((2 * v00.size, 3), np.int32)
    tris[0::2] = np.stack([v00, v10, v01], axis=1)
    tris[1::2] = np.stack([v10, v11, v01], axis=1)
    return apt.Mesh(points=m.points, triangles=tris)


def phase_msh(domain, n=257):
    """The mirrored n^2 grid: written with write_msh (into build/msh/ of the
    checkout), read back (the
    canonical mesh tagged mirror=(sx, sy)); the flip-solve-flip on the
    canonical mesh with matvec_impl="pallas" (B3) against the general-ELL
    solve of the file's own triangulation (B7), both f64, solver_tol 1e-12,
    nt=33, within 1e-9 after sorting by midpoint; the canonical mesh on the
    fused route (B1's BiCGStab variant at 80 iterations per step: its
    default 5 leave this dt unconverged) printed beside them."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.mesh.mirror import (mirror_field,
                                                     mirror_problem)
    from airpollution_tpu_torch.models.crbe import CRBESolver

    f64 = torch.float64
    problem = apt.Problem(sigma=1.0)
    out = {"phase": f"msh_mirrored_{n}", "card": card_line(), "ms": n,
           "nt": 33}
    workdir = Path(__file__).resolve().parent / "build" / "msh"
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = apt.write_msh(antidiagonal_grid(n), str(workdir / f"grid_{n}.msh"))
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    canon = apt.read_msh(path)
    out["read_detect_s"] = time.perf_counter() - t0
    raw = apt.read_msh(path, structured=False)
    out["mirror"] = canon.mirror
    check(canon.n_points_per_axis == n and canon.mirror is not None,
          f"msh: the mirrored grid was not detected ({canon.mirror})")
    md_gen = apt.MeshData(raw, domain, nt=33, dtype=f64)
    md_can = apt.MeshData(canon, domain, nt=33, dtype=f64, mirror_ok=True)
    pulled = mirror_problem(problem, canon.mirror)

    def solve(tag, kernel, md, p, **kw):
        reset_counts()
        s = CRBESolver(domain, p, md, **kw)
        t0 = time.perf_counter()
        u = s.solve(store_solutions=False)[-1]
        torch.cuda.synchronize()
        out[f"{tag}_s"] = time.perf_counter() - t0
        kid = getattr(s, "fused_kernel", None) or kernel
        out[f"{tag}_kernel"] = kid
        out[f"{tag}_launches"] = launches_of(kid)
        check(launches_of(kid) > 0, f"msh: the {tag} solve launched no {kid}")
        return u

    tight = dict(solver_tol=1e-12, solver_maxiter=500)
    u_gen = solve("ell", "B7a", md_gen, problem, matvec_impl="ell", **tight)
    u_b3 = solve("pallas", "B3", md_can, pulled, matvec_impl="pallas",
                 **tight)
    u_b1 = solve("fused", None, md_can, pulled, matvec_impl="fused",
                 fused_iters=80)

    def order(md):
        mid = md.midpoints.cpu().numpy()
        q = np.rint((mid - mid.min(0)) / (20.0 / (n - 1))).astype(np.int64)
        return torch.as_tensor(np.lexsort((q[:, 0], q[:, 1])),
                               device=md.device)

    og, oc = order(md_gen), order(md_can)
    check(float((md_gen.midpoints[og] - md_can.midpoints[oc]).abs().max())
          <= 1e-12, "msh: the two meshes' midpoint sets differ")
    ref = u_gen[og]
    for tag, u in (("pallas", u_b3), ("fused", u_b1)):
        back = mirror_field(u, md_can, canon.mirror)[oc]
        out[f"{tag}_max_abs_vs_ell"] = float((back - ref).abs().max())
    out["max_abs_u"] = float(ref.abs().max())
    emit(out)
    check(out["pallas_max_abs_vs_ell"] <= 1e-9,
          f"msh: flip-solve-flip vs general ELL "
          f"{out['pallas_max_abs_vs_ell']:.3e} > 1e-9")


# --- slice 7: the block-sharded solvers, kernels B8-B10 ---------------------


# Tolerance of a block solve against the whole-canvas solve of the same
# kernel family (max|block - whole| / max|whole|, f32): the same per-cell
# arithmetic in another tiling.
BLOCK_TOL = 1e-6
B8_ITERS = 10  # scripts/tpu_hbm_check.py's 2049^2 row (Chebyshev-10)
# Its CN solve takes C1's k=14: with k=10 it diverges near step 550 on the
# H100 in float32, whole canvas and blocks alike (PERF.md, section 6).
B8_CN_ITERS = C1_ITERS
BLOCK_MESH = {"mp": 4}


def block_rows(n, n_blocks, k, use_ka):
    from airpollution_tpu_torch.parallel import hbm_shard

    return hbm_shard.RowBlocks(n, n_blocks, hbm_shard.halo_rows(k, use_ka))


def block_case_run(kid, blocks, dtype, steps, kernel, plain, state):
    """Hold a block kernel against its plain version for ``steps`` steps on
    ``state`` (n_blocks, ...): each step an exchange, then for every block
    the kernel ``kernel(d, src, dst)`` and ``plain(d, src) -> dst rows``
    from the same input, their interiors compared; the kernel's output
    goes on. Returns (max abs, max rel) over steps and blocks."""
    import torch

    from airpollution_tpu_torch.parallel import hbm_shard

    other = torch.empty_like(state)
    worst_abs = worst_rel = 0.0
    sl = slice(blocks.halo, blocks.halo + blocks.local)
    for _ in range(steps):
        hbm_shard.exchange(state, blocks.local, blocks.halo)
        for d in range(blocks.n_blocks):
            kernel(d, state[d], other[d])
            ref = plain(d, state[d])
            torch.cuda.synchronize()
            abs_e, rel, _ = rel_err(other[d][..., sl, :], ref[..., sl, :])
            worst_abs, worst_rel = max(worst_abs, abs_e), max(worst_rel, rel)
        state, other = other, state
    check(worst_rel <= TOL[str(dtype).split(".")[-1]],
          f"{kid}: block kernel vs plain rel err {worst_rel:.3e}")
    return worst_abs, worst_rel


def phase_block_vs_plain(meshes, problem, problems, cache):
    """Kernels B8, B9 and B10, each with and without a load, against their
    plain versions at 257^2 and 513^2 on 2 and 4 blocks, f64 and f32, for
    3 steps with the exchange between them: B8 on the plume (BE,
    extrapolated, k=8; load: S1's emitter), B9 on C3's Robin walls and
    block (CN, extrapolated, k=8; load: the walled emitter), B10 on the
    K=3 demo chain (CN, k=8; load: its emitter on species 0); B9 and B10
    at every depth that splits their step at 257^2, at the planner's plan
    at 513^2."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    k = 8
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (257, 513):
            md = meshes[(ms, name)]
            n = md.structured_n
            scal, u3 = uniform_inputs(md, problem, 1, k, dtype)
            plane = uniform_load(md, scal, 1, s_source(), 1, dtype)
            for nb in (2, 4):
                # B8: uniform, BE, extrapolated (two carried states).
                blocks = block_rows(n, nb, k, False)
                masks = [fused_hbm.block_masks(b, dtype, u3.device)
                         for b in blocks.blocks]
                plans = [fused_hbm.block_plan(k, False, dtype, b)
                         for b in blocks.blocks]
                for kid, load in (("B8", None),
                                  ("B8-load", blocks.split(plane))):
                    state = torch.stack([blocks.split(u3),
                                         blocks.split(0.8 * u3)], dim=1)

                    def kernel(d, src, dst, load=load):
                        fused_hbm.block_kernel_step(
                            scal, k, src[0], src[1], dst[0], dst[1], False,
                            None, plans[d], blocks.blocks[d],
                            load=None if load is None else load[d])

                    def plain(d, src, load=load):
                        x, up = fused_hbm.plain_block_step(
                            scal, k, src[0], src[1], False, *masks[d],
                            None if load is None else load[d])
                        return torch.stack([x, up])

                    abs_e, rel = block_case_run(kid, blocks, dtype, 3, kernel,
                                                plain, state)
                    rows.append({"kernel": kid, "ms": ms, "blocks": nb,
                                 "dtype": name, "rel_err": rel})
                    if name == "float32":
                        worst[kid] = max(worst.get(kid, 0.0), abs_e)
                # B9: C3's operator, CN, extrapolated.
                inp = canvas_inputs(md, problems["C3"], 2, dtype, cache)
                C, cheb, u0, cmasks = canvas_step_inputs(inp, k, dtype)
                blocks = block_rows(n, nb, k, True)
                rect = inp["rect"]
                bm = [fused_hbm.block_masks(b, dtype, u0.device, rect)
                      for b in blocks.blocks]
                Cb = blocks.split(C)
                (flux,), _ = step_loads(inp, md, walled_source(), 1, True, C,
                                        cmasks, False, dtype)
                plans = depth_plans(k, True, dtype)
                for plan, load in [(p, ld) for p in (plans if ms == 257
                                                     else plans[:1])
                                   for ld in (None, blocks.split(flux))]:
                    state = torch.stack([blocks.split(u0),
                                         blocks.split(0.8 * u0)], dim=1)

                    def kernel(d, src, dst, load=load, plan=plan):
                        fused_hbm.canvas_block_kernel_step(
                            Cb[d], cheb, k, src[0], src[1], dst[0], dst[1],
                            True, rect, None, plan, blocks.blocks[d],
                            load=None if load is None else load[d])

                    def plain(d, src, load=load):
                        x, up = fused_hbm.plain_canvas_block_step(
                            Cb[d], cheb, k, src[0], src[1], True, *bm[d],
                            None if load is None else load[d])
                        return torch.stack([x, up])

                    abs_e, rel = block_case_run("B9", blocks, dtype, 3,
                                                kernel, plain, state)
                    rows.append({"kernel": "B9", "ms": ms, "blocks": nb,
                                 "dtype": name, "load": load is not None,
                                 "plan": plan, "rel_err": rel})
                    if name == "float32":
                        worst["B9"] = max(worst.get("B9", 0.0), abs_e)
                # B10: the demo chain, K=3, CN.
                inp = canvas_inputs(md, problems["demo"], 2, dtype, cache)
                plans = depth_plans(k, True, dtype, n_species=3)
                for plan, source in [(p, src) for p in (plans if ms == 257
                                                        else plans[:1])
                                     for src in (None, demo_species(1)[0])]:
                    case = b6_case(inp, md, 3, k, 2, dtype, source, True)
                    Cb = blocks.split(case["C"])
                    bm = [fused_hbm.block_masks(b, dtype, Cb.device,
                                                inp["rect"])
                          for b in blocks.blocks]
                    loads = (None if case["loads"] is None
                             else blocks.split(case["loads"]))
                    state = blocks.split(case["U"].reshape(9, n, n))

                    def species(x):
                        return x.view(3, 3, blocks.rows, n)

                    def kernel(d, src, dst, loads=loads, case=case,
                               plan=plan):
                        fused_hbm.multispecies_block_kernel_step(
                            Cb[d], case["scal"], k, species(src),
                            species(dst), True, inp["rect"], None, plan,
                            blocks.blocks[d],
                            None if loads is None else loads[d],
                            case["index"])

                    def plain(d, src, loads=loads, case=case):
                        return fused_hbm.plain_multispecies_block_step(
                            Cb[d], case["cheb"], case["E"], k, species(src),
                            True, *bm[d],
                            None if loads is None else loads[d],
                            case["index"]).reshape(9, blocks.rows, n)

                    abs_e, rel = block_case_run("B10", blocks, dtype, 3,
                                                kernel, plain, state)
                    rows.append({"kernel": "B10", "ms": ms, "blocks": nb,
                                 "dtype": name, "load": source is not None,
                                 "plan": plan, "rel_err": rel})
                    if name == "float32":
                        worst["B10"] = max(worst.get("B10", 0.0), abs_e)
    emit({"phase": "block_vs_plain", "card": card_line(), "cases": rows})
    return worst


def block_solve_times(solve, reps):
    """Host seconds of ``reps`` calls of ``solve()``, each ending in a
    device synchronisation; returns (last result, times)."""
    import torch

    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def max_rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def phase_b8_2049(domain):
    """B8 on scripts/tpu_hbm_check.py's 2049^2 row: Problem(sigma=1),
    nt=1001, Chebyshev-10, extrapolated, BE, assembly="patch", f32, on 4
    blocks, against CRBESolver(matvec_impl="fused_hbm", assembly="patch")
    on B2; one CN solve (Chebyshev-14, B8_CN_ITERS) and one sourced solve
    (S1's emitter, B8's load entry) against theirs. Returns (launches,
    md)."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.parallel import (build_hbm_halo_solver,
                                                 make_mesh)

    t0 = time.perf_counter()
    md = apt.MeshData(apt.create_mesh(2049, 20.0), domain, nt=1001)
    out = {"phase": "b8_block_2049", "card": card_line(), "ms": 2049,
           "nt": md.nt, "dofs": md.number_of_segments, "k": B8_ITERS,
           "blocks": BLOCK_MESH["mp"], "mesh_setup_s":
           time.perf_counter() - t0}
    n_steps = md.nt - 1
    mesh = make_mesh(BLOCK_MESH)
    launches = {"B8": 0, "B8-load": 0}
    # The BE case times one warm solve each way (the script's time budget).
    cases = (("be", apt.Problem(sigma=1.0), 1, B8_ITERS, 1),
             ("cn", apt.Problem(sigma=1.0), 2, B8_CN_ITERS, 0),
             ("sourced", apt.GaussianSourceProblem(**S_SOURCE), 1, B8_ITERS,
              0))
    for tag, problem, order, k, reps in cases:
        whole = CRBESolver(domain, problem, md, time_scheme_order=order,
                           matvec_impl="fused_hbm", assembly="patch",
                           solver_method="chebyshev", chebyshev_iters=k,
                           extrapolate_warm_start=True)
        first, wtimes = timed_phase(whole, reps)
        check(whole.fused_kernel == "B2", f"B8 {tag}: whole route")
        u0 = whole.set_initial_condition()
        solver = build_hbm_halo_solver(mesh, md, problem, whole.dt,
                                       order=order, iters=k,
                                       extrapolate=True, assembly="patch")
        reset_counts()
        got = solver(None, u0)
        torch.cuda.synchronize()
        kid = "B8-load" if tag == "sourced" else "B8"
        per_solve = launches_of(kid)
        check(per_solve == BLOCK_MESH["mp"] * n_steps
              and launches_of("B2") == 0,
              f"B8 {tag}: {per_solve} {kid} launches in one block solve")
        launches[kid] += per_solve
        _, btimes = block_solve_times(lambda: solver(None, u0), reps)
        ref = whole.solutions
        diff = max_rel(got, ref)
        out.update({
            f"{tag}_max_block_minus_whole_rel": diff,
            f"{tag}_bitwise_equal": bool(torch.equal(got, ref)),
            f"{tag}_launches_per_solve": per_solve, f"{tag}_k": k,
            f"{tag}_whole_first_solve_s": first})
        if reps:
            rates(out, f"{tag}_whole_", n_steps, wtimes)
            rates(out, f"{tag}_block_", n_steps, btimes)
        if tag != "sourced":
            out[f"{tag}_rel_l2_block"] = rel_l2_of(whole, got, problem)
            out[f"{tag}_rel_l2_whole"] = whole.compute_errors(
                problem.analytical_solution)[0]
        check(bool(torch.isfinite(got).all()), f"B8 {tag}: non-finite")
        check(diff <= BLOCK_TOL, f"B8 {tag}: max|block - whole| {diff:.3e}")
    emit(out)
    return launches, md


def rel_l2_of(solver, u, problem):
    """rel_l2 of a final state ``u`` against the closed form at T, as
    CRBESolver.compute_errors computes it."""
    import torch

    exact = solver._exact_at_T(problem.analytical_solution)
    return float(torch.sqrt(torch.sum((u[-1] - exact) ** 2))
                 / torch.sqrt(torch.sum(exact ** 2)))


def phase_b9_blocks(c1, md_257, problems, domain):
    """B9 on C1's configuration (1025^2, nt=1001, Chebyshev-14, BE,
    extrapolated) on 4 blocks against C1's whole-canvas B4 solve, which
    the C1 phase ran; then C3's Robin walls and block at 257^2 (CN,
    Chebyshev-8, a snapshot every 100 steps) on 2 blocks against the
    strided B4 solve, dead DOFs exactly 0.0."""
    import torch

    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.parallel import (build_canvas_hbm_halo_solver,
                                                 make_mesh)

    whole, whole_rates = c1
    md = whole.mesh_data
    n_steps = md.nt - 1
    out = {"phase": "b9_block_c1_c3", "card": card_line(), "ms": 1025,
           "nt": md.nt, "k": C1_ITERS, "blocks": BLOCK_MESH["mp"]}
    out.update({f"c1_whole_{k}": v for k, v in whole_rates.items()})
    solver = build_canvas_hbm_halo_solver(
        make_mesh(BLOCK_MESH), md, problems["C1"], whole.dt, order=1,
        iters=C1_ITERS, extrapolate=True)
    u0 = whole.set_initial_condition()
    ops = whole._require_ops()
    reset_counts()
    got = solver(ops, u0)
    torch.cuda.synchronize()
    per_solve = launches_of("B9")
    check(per_solve == BLOCK_MESH["mp"] * n_steps and launches_of("B4") == 0,
          f"C1 block: {per_solve} B9 launches in one solve")
    total = per_solve
    _, btimes = block_solve_times(lambda: solver(ops, u0), 2)
    rates(out, "c1_block_", n_steps, btimes)
    diff = max_rel(got, whole.solutions)
    out.update({"c1_launches_per_solve": per_solve,
                "c1_max_block_minus_whole_rel": diff,
                "c1_bitwise_equal": bool(torch.equal(got, whole.solutions)),
                "c1_rel_l2_block": rel_l2_of(whole, got, problems["C1"])})
    check(diff <= BLOCK_TOL, f"C1 block: max|block - whole| {diff:.3e}")
    # C3 on 2 blocks, strided, against the strided B4 solve.
    p3 = problems["C3"]
    s3 = CRBESolver(domain, p3, md_257, time_scheme_order=2,
                    matvec_impl="fused_hbm", solver_method="chebyshev",
                    chebyshev_iters=8, snapshot_every=100)
    ref = s3.solve(store_solutions=True)
    solver = build_canvas_hbm_halo_solver(
        make_mesh({"mp": 2}), md_257, p3, s3.dt, order=2, iters=8,
        snapshot_every=100)
    reset_counts()
    traj = solver(s3._require_ops(), s3.set_initial_condition())
    total += launches_of("B9")
    _, dead = crbe.obstacle_masks(md_257, p3)
    dead_max = float(traj[:, dead].abs().max())
    diff = max_rel(traj, ref)
    out.update({"c3_rows": traj.shape[0], "c3_b9_launches": launches_of("B9"),
                "c3_max_block_minus_whole_rel": diff,
                "c3_dead_dofs": int(dead.sum()), "c3_dead_max_abs": dead_max})
    check(traj.shape == ref.shape and diff <= BLOCK_TOL,
          f"C3 block: max|block - whole| {diff:.3e}")
    check(dead_max == 0.0, f"C3 block: |u| on dead DOFs reaches {dead_max}")
    out["b9_launches"] = total
    emit(out)
    return total


def phase_b10_m1(m1, domain):
    """B10 on M1's configuration (the K=3 chain at 1025^2, nt=4001, CN,
    Chebyshev-8) on 4 blocks against M1's whole-canvas B6 solve, which the
    M1 phase ran: ``m1`` is (its solver, its warm steps/s). One block
    solve, counted and timed."""
    import torch

    from airpollution_tpu_torch.parallel import (
        build_multispecies_hbm_halo_solver, make_mesh)

    whole, whole_rate = m1
    md = whole.mesh_data
    k = DEMO_ITERS[1025]
    n_steps = md.nt - 1
    out = {"phase": "b10_block_m1", "card": card_line(), "ms": 1025,
           "nt": md.nt, "K": 3, "k": k, "blocks": BLOCK_MESH["mp"],
           "whole_steps_per_s_best": whole_rate}
    solver = build_multispecies_hbm_halo_solver(
        make_mesh(BLOCK_MESH), md, whole.problem, whole.dt, order=2,
        iters=k)
    ops, C0 = whole._require_ops(), whole.set_initial_condition()
    reset_counts()
    got, times = block_solve_times(lambda: solver(ops, C0), 1)
    per_solve = launches_of("B10")
    check(per_solve == BLOCK_MESH["mp"] * n_steps and launches_of("B6") == 0,
          f"M1 block: {per_solve} B10 launches in one solve")
    rates(out, "block_", n_steps, times)
    ref = whole.solutions
    diff = max_rel(got, ref)
    masses = [float(m) for m in (got[-1].double()
                                 * ops.mass_diag.double()).sum(-1)]
    out.update({"launches_per_solve": per_solve,
                "max_block_minus_whole_rel": diff,
                "bitwise_equal": bool(torch.equal(got, ref)),
                "masses_block": masses, "masses_whole": chain_masses(whole)})
    check(diff <= BLOCK_TOL, f"M1 block: max|block - whole| {diff:.3e}")
    emit(out)
    return per_solve


def interior_err(kid, got, ref, block):
    """max|got - ref| over the interior rows of a block kernel's output
    ``got`` (the last launch's, read after a synchronisation) and its plain
    version's ``ref``; fails past TOL["float32"] of max|ref|."""
    import torch

    torch.cuda.synchronize()
    sl = slice(block.halo, block.halo + block.local)
    abs_e, rel, _ = rel_err(got[..., sl, :], ref[..., sl, :])
    check(rel <= TOL["float32"],
          f"{kid} at its main path's shape: kernel vs plain rel err {rel:.3e}")
    return abs_e


def per_step_ms(state, blocks, launch_all):
    """Device ms of one block step: the exchange, then ``launch_all()``."""
    from airpollution_tpu_torch.parallel import hbm_shard

    def run():
        hbm_shard.exchange(state, blocks.local, blocks.halo)
        launch_all()

    return cuda_ms(run, 20)


def b8_kernel_times(md):
    """B8 per launch at its main path's shape (2049^2, k=10, BE,
    extrapolated, the patch scalars, f32; one interior block of 4), with
    and without a load, held against its plain version at that shape
    (the interior rows, TOL["float32"]) and timed with it, its bound by
    bytes (each input block read once, the interior written once), and one
    step of 4 blocks with the exchange against one whole-canvas launch of
    B2."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver
    from airpollution_tpu_torch.parallel import hbm_shard

    f32 = torch.float32
    nb = BLOCK_MESH["mp"]
    extra = {"phase": "b8_kernel_times", "card": card_line(), "blocks": nb}
    times = {}
    k = B8_ITERS
    scal, u = patch_inputs(md, k, f32)
    blocks = block_rows(md.structured_n, nb, k, False)
    state = torch.stack([blocks.split(u)] * 2, dim=1)
    out = torch.empty_like(state)
    plans = [fused_hbm.block_plan(k, False, f32, blk)
             for blk in blocks.blocks]
    extra["plans"] = plans
    b = blocks.blocks[1]
    m, on = fused_hbm.block_masks(b, f32, u.device)
    plane = blocks.split(uniform_load(md, scal, 1, s_source(), 1, f32))
    cells = 3 * b.local * b.n
    for kid, load in (("B8", None), ("B8-load", plane)):
        def launch(d, load=load):
            fused_hbm.block_kernel_step(
                scal, k, state[d][0], state[d][1], out[d][0], out[d][1],
                False, None, plans[d], blocks.blocks[d],
                load=None if load is None else load[d])

        def plain_step(load=load):
            return torch.stack(fused_hbm.plain_block_step(
                scal, k, state[1][0], state[1][1], False, m, on,
                None if load is None else load[1]))

        ms_k = cuda_ms(lambda: launch(1), 50)
        plain = cuda_ms(plain_step, 3)
        abs_e = interior_err(kid, out[1], plain_step(), b)
        planes_in = 6 if load is None else 9  # u, up (and the load)
        b_ms, by = bound((planes_in * b.rows + 6 * b.local) * b.n * 4,
                         cells * (step_flops_per_dof(k, False, True)
                                  + (load is not None)))
        times[kid] = (ms_k, plain, b_ms, by, abs_e, None,
                      {"plan": plans[1]})
        extra[f"{kid}_max_abs_err_vs_plain"] = abs_e
        extra[f"{kid}_ms"] = ms_k
        extra[f"{kid}_step_4_blocks_ms"] = per_step_ms(
            state, blocks, lambda: [launch(d) for d in range(nb)])
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    whole_out = (torch.empty_like(u), torch.empty_like(u))
    whole_plan = fused_solver.uniform_plan(k, False, f32, u.shape[-1])
    extra["B2_2049_ms"] = cuda_ms(lambda: fused_hbm.kernel_step(
        scal, k, u, u, *whole_out, False, halt, whole_plan), 20)
    extra["exchange_ms"] = cuda_ms(
        lambda: hbm_shard.exchange(state, blocks.local, blocks.halo), 50)
    emit(extra)
    return times


def block_kernel_times(meshes, problems, cache):
    """B9 and B10 per launch at their main paths' shapes (f32; one
    interior block of 4): B9 at C1's step (1025^2, k=14, BE, extrapolated),
    B10 at M1's (1025^2, K=3, k=8, CN, one load); each held against its
    plain version at that shape (the interior rows, TOL["float32"]) and
    timed with it; their bounds by bytes (each input block read once, the
    interior written once), and one step of 4 blocks with the exchange
    against one whole-canvas launch of B4 and B6."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver
    from airpollution_tpu_torch.parallel import hbm_shard

    f32 = torch.float32
    nb = BLOCK_MESH["mp"]
    extra = {"phase": "block_kernel_times", "card": card_line(),
             "blocks": nb}
    times = {}
    md = meshes[(1025, "float32")]
    n = md.structured_n
    # B9: C1's operator.
    k = C1_ITERS
    inp = canvas_inputs(md, problems["C1"], 1, f32, cache)
    C, cheb, u, _ = canvas_step_inputs(inp, k, f32)
    rect = inp["rect"]
    blocks = block_rows(n, nb, k, False)
    Cb = blocks.split(C)
    state = torch.stack([blocks.split(u)] * 2, dim=1)
    out = torch.empty_like(state)
    plan = fused_hbm.canvas_plan(k, False, f32)
    work = fused_hbm.work_buffer(plan, state[0][0])
    b = blocks.blocks[1]
    m, on = fused_hbm.block_masks(b, f32, u.device, rect)

    def b9(d):
        fused_hbm.canvas_block_kernel_step(
            Cb[d], cheb, k, state[d][0], state[d][1], out[d][0], out[d][1],
            False, rect, None, plan, blocks.blocks[d], work=work)

    def plain_b9():
        return torch.stack(fused_hbm.plain_canvas_block_step(
            Cb[1], cheb, k, state[1][0], state[1][1], False, m, on))

    ms_k = cuda_ms(lambda: b9(1), 50)
    plain = cuda_ms(plain_b9, 3)
    abs_e = interior_err("B9", out[1], plain_b9(), b)
    cells = 3 * b.local * n
    b_ms, by = bound(((21 + 2 * 3) * b.rows * n + 2 * cells) * 4,
                     cells * canvas_step_flops_per_dof(k, False, True))
    times["B9"] = (ms_k, plain, b_ms, by, abs_e, None, {"plan": plan})
    extra["B9_max_abs_err_vs_plain"] = abs_e
    extra["B9_step_4_blocks_ms"] = per_step_ms(
        state, blocks, lambda: [b9(d) for d in range(nb)])
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    whole_out = (torch.empty_like(u), torch.empty_like(u))
    whole_work = fused_hbm.work_buffer(plan, u)
    extra["B4_1025_ms"] = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        C, cheb, k, u, u, *whole_out, False, rect, halt, plan,
        work=whole_work), 20)
    del whole_work
    del state, out, Cb, whole_out
    # B10: M1's step.
    k, K = DEMO_ITERS[1025], 3
    inp = canvas_inputs(md, problems["demo"], 2, f32, cache)
    case = b6_case(inp, md, K, k, 2, f32, demo_species(1)[0], True)
    rect = inp["rect"]
    blocks = block_rows(n, nb, k, True)
    Cb = blocks.split(case["C"])
    loads = blocks.split(case["loads"])
    state = blocks.split(case["U"].reshape(3 * K, n, n))
    out = torch.empty_like(state)
    b = blocks.blocks[1]
    m, on = fused_hbm.block_masks(b, f32, u.device, rect)
    plan = case["plan"]
    work = fused_hbm.work_buffer(plan, Cb[0], K)

    def b10(d):
        fused_hbm.multispecies_block_kernel_step(
            Cb[d], case["scal"], k, state[d].view(K, 3, b.rows, n),
            out[d].view(K, 3, b.rows, n), True, rect, None, plan,
            blocks.blocks[d], loads[d], case["index"], work)

    def plain_b10():
        return fused_hbm.plain_multispecies_block_step(
            Cb[1], case["cheb"], case["E"], k,
            state[1].view(K, 3, b.rows, n), True, m, on, loads[1],
            case["index"])

    ms_k = cuda_ms(lambda: b10(1), 30)
    plain = cuda_ms(plain_b10, 3)
    abs_e = interior_err("B10", out[1].view(K, 3, b.rows, n), plain_b10(), b)
    cells = 3 * b.local * n
    b_ms, by = bound(((21 + 3 * K + 3) * b.rows * n + K * cells) * 4,
                     K * cells * canvas_step_flops_per_dof(k, True, False)
                     + 2 * cells * K * (2 * K - 1))
    times["B10"] = (ms_k, plain, b_ms, by, abs_e, None, {"plan": plan})
    extra["B10_max_abs_err_vs_plain"] = abs_e
    extra["B10_step_4_blocks_ms"] = per_step_ms(
        state, blocks, lambda: [b10(d) for d in range(nb)])
    wout = torch.empty_like(case["U"])
    whole_work = fused_hbm.work_buffer(plan, case["U"], K)
    extra["B6_1025_ms"] = cuda_ms(lambda: fused_hbm.multispecies_kernel_step(
        case["C"], case["scal"], k, case["U"], wout, True, rect, halt,
        plan, case["loads"], case["index"], whole_work), 20)
    del whole_work
    extra["exchange_ms_b10_state"] = cuda_ms(
        lambda: hbm_shard.exchange(state, blocks.local, blocks.halo), 50)
    extra.update({f"{kid}_ms": times[kid][0] for kid in ("B9", "B10")})
    emit(extra)
    return times


def patch_inputs(md, k, dtype):
    """B8's scalar block from the patch scalars (as the block builder
    takes them) and the initial canvas of Problem(sigma=1)."""
    import torch
    from functools import partial

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.ops import fused_solver, linalg, stencil
    from airpollution_tpu_torch.ops import uniform

    problem = apt.Problem(sigma=1.0)
    n = md.structured_n
    spec = uniform.make_spec_lite(n)
    dt = md.domain.T / (md.nt - 1)
    xs = md.points[:, 0]
    sys_c, _, mass_c, diag_c = uniform.patch_constants(
        n, float(xs.max() - xs.min()) / 2.0, problem, dt, 1,
        dtype=md.midpoints.dtype, device=md.device)
    perm = torch.as_tensor(stencil.get_family_perm(md)[0].astype("int64"),
                           device=md.device)
    diag = uniform.family_diag_vector(spec, diag_c, md.boundary_mask[perm])
    lo, hi = linalg.power_bounds(
        partial(uniform.uniform_matvec, spec, sys_c), torch.zeros_like(diag),
        scale=1.0 / torch.sqrt(diag))
    scal = fused_solver.step_scalars(sys_c, mass_c, 1.0 / diag_c,
                                     (float(lo), float(hi)), k, dtype)
    u0 = problem.initial_condition_fn(md.midpoints)[perm]
    return scal, fused_solver.to_canvases(spec, u0).to(dtype)


# --- slice 11: the PINN (no kernel of its own: library dense products) ------

# The paper's widest PINN, [3, 64 x 4, 1] tanh at the ms=128 collocation
# budget (experiments/common.py schedules: 16,000 epochs, patience 1,000,
# lr 1e-4, lambda (180, 80, 80)), cut to 2,000 epochs for time; and the
# levers row of results_snapshot/df_pinn_training_results_levers.csv
# ("fourier64+causal+wide64x4+lbfgs1000") at the ms=64 budget, cut to
# 1,000 Adam epochs and 50 L-BFGS steps.
PINN_LAYERS = [3, 64, 64, 64, 64, 1]
PINN_LAMBDA = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
PINN_WIDE = dict(mesh_size=128, batch={"pde": 34744, "ic": 6949,
                                       "bc": 6949},
                 lr=1e-4, patience=1000, epochs=2000, scheduled_epochs=16000)
PINN_LEVERS = dict(mesh_size=64, batch={"pde": 8595, "ic": 1719,
                                        "bc": 1719},
                   lr=1e-4, patience=1000, epochs=1000, lbfgs_steps=50,
                   fourier_features=64, causal_eps=1.0,
                   scheduled_lbfgs_steps=1000)
# The widest cell's loss must fall at least this factor over its 2,000
# epochs: it fell 8,138-fold and 8,485-fold in the first two runs on an
# H100 (PERF.md section 6), so a tenth of that leaves room for rounding.
PINN_LOSS_DROP = 800.0
PINN_OBSTACLES = ((-6.0, -1.0, -4.0, 3.0), (4.0, 9.0, 2.0, 5.0))


def pinn_numpy_params(layers, fourier, seed):
    """The JAX package's parameter layout as seeded numpy arrays: a B of
    ``fourier`` columns over the input half-widths, Xavier-normal weights,
    small biases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params, widths = [], list(layers)
    if fourier:
        B = rng.standard_normal((layers[0], fourier))
        params.append({"B": B / np.array([20.0, 20.0, 5.0])[:, None]})
        widths[0] = 2 * fourier
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        params.append({
            "W": np.sqrt(2.0 / (fan_in + fan_out))
            * rng.standard_normal((fan_in, fan_out)),
            "b": 0.05 * rng.standard_normal(fan_out)})
    return params


def pinn_points(seed, n_pde=6000, n_ic=1200, n_bc=1200):
    """Seeded numpy points in the box [-20, 20]^2 x [0, 10]: PDE (n, 3),
    IC (n, 2), BC (4 (n // 4), 3) in side blocks left, right, bottom,
    top."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pde = np.stack([rng.uniform(-20, 20, n_pde), rng.uniform(-20, 20, n_pde),
                    rng.uniform(0, 10, n_pde)], axis=1)
    ic = rng.uniform(-20, 20, (n_ic, 2))
    k = n_bc // 4
    along = rng.uniform(-20, 20, 4 * k)
    x = np.concatenate([np.full(k, -20.0), np.full(k, 20.0), along[2 * k:]])
    y = np.concatenate([along[:2 * k], np.full(k, -20.0), np.full(k, 20.0)])
    bc = np.stack([x, y, rng.uniform(0, 10, 4 * k)], axis=1)
    return pde, ic, bc


def pinn_problem(obstacles):
    import airpollution_tpu_torch as apt

    p = apt.Problem(sigma=1.0)
    if obstacles:
        p.obstacles = PINN_OBSTACLES
    return p


def pinn_loss_step(device, dtype, params, pts, fac, options):
    """The composite loss, its gradient and one Adam step of the trainer
    (models/pinn.adam, lr 1e-4) on ``device``, from the same parameters
    and points: (loss and terms, gradient, parameters after the step)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.interop import pinn_params_from_numpy
    from airpollution_tpu_torch.models import pinn

    problem = pinn_problem(options["obstacles"])
    model = apt.PINN(PINN_LAYERS, problem, apt.Domain(), activation="tanh",
                     dtype=dtype, fourier_features=options["fourier"],
                     device=device)
    model.mlp = pinn_params_from_numpy(params, "tanh", dtype=dtype,
                                       device=device)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    pde, ic, bc, ic_target, bc_target = pts
    xyt_ic = t(np.concatenate([ic, np.zeros((len(ic), 1))], axis=1))
    kw = {}
    if fac is not None:
        kw = dict(xyt_fac=t(fac[0]), fac_normals=t(fac[1]))
    total, aux = pinn.composite_loss(
        model.mlp, problem, t(pde), xyt_ic, t(ic_target), t(bc),
        t(bc_target), PINN_LAMBDA, None, t_final=10.0,
        causal_eps=options["causal_eps"], **kw)
    (grad,) = torch.autograd.grad(total, model.mlp.flat)
    flat = model.mlp.flat
    opt = pinn.adam(flat, model.fresh_carry(1e-4, PINN_LAMBDA))
    with torch.no_grad():
        flat.grad = grad
        opt.step()
    return (torch.stack([total, *aux]).detach().cpu().double(),
            grad.detach().cpu().double(), flat.detach().cpu().double())


def phase_pinn_card_vs_cpu():
    """The PINN's loss, gradient and one Adam step at [3, 64 x 4, 1] on the
    card against the CPU plain path, from the same parameters (seeded
    numpy arrays carried by interop.pinn_params_from_numpy) and points,
    in float64 (1e-12) and float32 (1e-5): the plain loss (6,000 PDE
    points: the chunked mean), and Fourier features with causal weighting
    and two buildings (facade points, dead collocation points)."""
    import torch

    from airpollution_tpu_torch.ops import sampling

    out = {"phase": "pinn_card_vs_cpu", "card": card_line(),
           "layers": PINN_LAYERS}
    cases = {"plain": dict(fourier=0, causal_eps=0.0, obstacles=False),
             "fourier_causal_obstacles": dict(fourier=64, causal_eps=1.0,
                                              obstacles=True)}
    worst = 0.0
    for name, options in cases.items():
        params = pinn_numpy_params(PINN_LAYERS, options["fourier"], 11)
        pde, ic, bc = pinn_points(12)
        ref = pinn_problem(options["obstacles"])
        f64 = torch.float64
        ic_target = ref.initial_condition_fn(
            torch.tensor(ic, dtype=f64)).reshape(-1, 1).numpy()
        bc_target = ref.boundary_fn(
            torch.tensor(bc, dtype=f64)).reshape(-1, 1).numpy()
        fac = None
        if options["obstacles"]:
            g = torch.Generator().manual_seed(13)
            xyt, nrm = sampling.sample_facade_points(
                g, 1200, PINN_OBSTACLES, (0.0, 10.0), f64)
            fac = (xyt.numpy(), nrm.numpy())
        pts = (pde, ic, bc, ic_target, bc_target)
        for dname in ("float64", "float32"):
            dtype = getattr(torch, dname)
            t0 = time.perf_counter()
            card = pinn_loss_step("cuda", dtype, params, pts, fac, options)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = pinn_loss_step("cpu", dtype, params, pts, fac, options)
            cpu_s = time.perf_counter() - t0
            errs = {
                "loss": float(((card[0] - cpu[0]).abs()
                               / cpu[0].abs().clamp_min(1e-300)).max()),
                "grad": float((card[1] - cpu[1]).abs().max()
                              / cpu[1].abs().max()),
                "adam_step": float((card[2] - cpu[2]).abs().max()
                                   / cpu[2].abs().max()),
            }
            tag = f"{name}_{dname}"
            out[tag] = dict(errs, card_s=card_s, cpu_s=cpu_s,
                            loss=cpu[0].tolist())
            if dname == "float64":
                worst = max(worst, *errs.values())
            for what, e in errs.items():
                check(e <= TOL[dname],
                      f"PINN {tag}: card vs CPU {what} {e:.3e} > "
                      f"{TOL[dname]:.0e}")
    out["worst_float64"] = worst
    emit(out)


def pinn_train_cell(cfg, **model_kw):
    """Train one PINN cell on the card (the Gaussian plume, tanh, seed
    1234): (model, problem, history, Adam seconds, Adam epochs)."""
    import torch

    import airpollution_tpu_torch as apt

    problem = apt.Problem(sigma=1.0)
    model = apt.PINN(PINN_LAYERS, problem, apt.Domain(), activation="tanh",
                     seed=1234, **model_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = model.train(cfg["batch"], cfg["epochs"], cfg["lr"],
                          PINN_LAMBDA, early_stopping_patience=cfg["patience"],
                          causal_eps=cfg.get("causal_eps", 0.0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return model, problem, history, seconds, len(history["total_loss"])


def phase_pinn_widest(md):
    """The paper's widest PINN cell on the card (PINN_WIDE), f32: epochs/s,
    the loss at the first and last epochs, compute_errors and
    compute_fem_errors at t = T on the ms=128 mesh. Gates: finite values
    and a loss that falls PINN_LOSS_DROP-fold."""
    import math

    reset_counts()
    model, problem, h, seconds, n = pinn_train_cell(PINN_WIDE)
    loss = h["total_loss"]
    rel_l2, l2, max_err = model.compute_errors(md, problem.analytical_solution)
    fem = model.compute_fem_errors(md, problem.analytical_solution)
    out = {"phase": "pinn_widest_ms128", "card": card_line(),
           "layers": PINN_LAYERS, "batch": PINN_WIDE["batch"],
           "epochs": n, "scheduled_epochs": PINN_WIDE["scheduled_epochs"],
           "seconds": seconds, "epochs_per_s": n / seconds,
           "loss_first": loss[0], "loss_last": loss[-1],
           "loss_drop": loss[0] / loss[-1],
           "rel_l2": rel_l2, "l2": l2, "max_error": max_err,
           "fem_rel_l2": fem[0], "fem_l2": fem[1], "fem_max_error": fem[2],
           "kernel_launches": sum(k.launches
                                  for k in kernel_objects().values())}
    emit(out)
    values = loss + [rel_l2, l2, max_err, *fem]
    check(all(math.isfinite(v) for v in values),
          "PINN widest cell: a loss or an error is not finite")
    check(n == PINN_WIDE["epochs"],
          f"PINN widest cell stopped early at epoch {n}")
    check(loss[-1] * PINN_LOSS_DROP <= loss[0],
          f"PINN widest cell: loss {loss[0]:.3e} -> {loss[-1]:.3e}, not "
          f"down {PINN_LOSS_DROP:g}x")
    return out


def phase_pinn_levers(md):
    """The levers cell on the card (PINN_LEVERS), f32: Fourier 64 and
    causal weighting, 1,000 Adam epochs, then 50 L-BFGS steps. Gates:
    finite values, and the L-BFGS loss does not rise."""
    import math

    import torch

    model, problem, h, seconds, n = pinn_train_cell(
        PINN_LEVERS, fourier_features=PINN_LEVERS["fourier_features"])
    t0 = time.perf_counter()
    h = model.finetune_lbfgs(PINN_LEVERS["batch"], PINN_LEVERS["lbfgs_steps"],
                             PINN_LAMBDA)
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - t0
    lb = h["total_loss"][n:]
    rel_l2, l2, max_err = model.compute_errors(md, problem.analytical_solution)
    out = {"phase": "pinn_levers_ms64", "card": card_line(),
           "layers": PINN_LAYERS, "batch": PINN_LEVERS["batch"],
           "fourier_features": PINN_LEVERS["fourier_features"],
           "causal_eps": PINN_LEVERS["causal_eps"], "adam_epochs": n,
           "adam_seconds": seconds, "epochs_per_s": n / seconds,
           "adam_loss_first": h["total_loss"][0],
           "adam_loss_last": h["total_loss"][n - 1],
           "lbfgs_steps": len(lb), "lbfgs_seconds": lbfgs_s,
           "lbfgs_steps_per_s": len(lb) / lbfgs_s,
           "lbfgs_loss_first": lb[0], "lbfgs_loss_last": lb[-1],
           "rel_l2": rel_l2, "l2": l2, "max_error": max_err}
    emit(out)
    check(all(math.isfinite(v) for v in h["total_loss"] + [rel_l2]),
          "PINN levers cell: a loss or an error is not finite")
    check(len(lb) == PINN_LEVERS["lbfgs_steps"],
          "PINN levers cell: L-BFGS steps missing")
    check(lb[-1] <= lb[0], f"PINN levers cell: the L-BFGS loss rose "
          f"{lb[0]:.3e} -> {lb[-1]:.3e}")
    return out


def phase_pinn(domain):
    """Slice 11: the PINN's card-against-CPU check, its widest cell and its
    levers cell, then the pinn line."""
    import airpollution_tpu_torch as apt

    t0 = time.perf_counter()
    phase_pinn_card_vs_cpu()
    wide = phase_pinn_widest(apt.MeshData(apt.create_mesh(128, 20.0),
                                          domain, nt=128))
    levers = phase_pinn_levers(apt.MeshData(apt.create_mesh(64, 20.0),
                                            domain, nt=128))
    emit({"phase": "pinn", "card": card_line(),
          "widest_epochs_per_s": wide["epochs_per_s"],
          "levers_epochs_per_s": levers["epochs_per_s"],
          "levers_lbfgs_steps_per_s": levers["lbfgs_steps_per_s"],
          "seconds": time.perf_counter() - t0})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import airpollution_tpu_torch as apt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_toolchain()

    domain = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    problems = {"C1": apt.RotatingPlumeProblem(omega=0.05, D=0.3),
                "C3": robin_obstacle_problem(),
                "demo": apt.Problem(v=(1.0, 0.2), D=0.3, sigma=1.0)}
    # float64 meshes where the float64 kernel checks need their own
    # assembly; the 1025^2 float64 checks reuse the float32 assembly's
    # inputs (the comparison needs identical inputs, not exact ones).
    meshes = {}
    for ms, nt, dtypes in ((65, 33, ("float64", "float32")),
                           (129, 1001, ("float64", "float32")),
                           (257, 1001, ("float64", "float32")),
                           (1025, 1001, ("float32",))):
        mesh = apt.create_mesh(ms, 20.0)
        for name in dtypes:
            meshes[(ms, name)] = apt.MeshData(mesh, domain, nt=nt,
                                              dtype=getattr(torch, name))
    mesh_1025 = mesh
    meshes[(1025, "float64")] = meshes[(1025, "float32")]
    mesh_513 = apt.create_mesh(513, 20.0)
    meshes[(513, "float32")] = apt.MeshData(mesh_513, domain, nt=1001)
    md_257_65 = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=65)
    worst = phase_b1(meshes, problem)
    worst.update(phase_b2(meshes, problem))
    cache = {}
    worst.update(phase_b3(meshes, problems, cache))
    worst.update(phase_b4(meshes, problems, cache))
    worst.update(phase_b5(meshes, problems, cache))
    worst.update(phase_b6(meshes, problems, cache))
    worst["B4"] = max(worst["B4"],
                      phase_b4_load(meshes, problems, cache)["B4"])
    worst.update(phase_b1_loads(meshes))
    worst.update(phase_b2_load(meshes))
    worst.update(phase_b4_flux(meshes, cache))
    meshes[(513, "float64")] = meshes[(513, "float32")]
    phase_plan_variants(meshes, problems, cache)
    times = kernel_times(meshes, problem)
    times.update(canvas_kernel_times(meshes, problems, cache))
    times.update(multispecies_kernel_times(meshes, problems, cache))
    times.update(slice4_kernel_times(meshes, cache, meshes[(257, "float32")],
                                     meshes[(513, "float32")]))
    # Slice 7: the block kernels against their plain versions, their times.
    worst.update(phase_block_vs_plain(meshes, problem, problems, cache))
    times.update(block_kernel_times(meshes, problems, cache))

    launches = {
        "B1": phase_main_257(meshes[(257, "float32")], problem, domain),
        "B2": phase_main_1025(meshes[(1025, "float32")], problem, domain),
    }
    launches["B4"], c1_be = phase_canvas_1025(meshes[(1025, "float32")],
                                              problems["C1"], domain)
    launches["B5"] = phase_canvas_257_bicgstab(meshes[(257, "float32")],
                                               problems["C1"], domain)
    launches["B3"], _ = phase_robin_obstacle(
        meshes[(257, "float32")], md_257_65, problems["C3"], domain)
    cache.clear()
    md_m1 = apt.MeshData(apt.create_mesh(1025, 20.0), domain, nt=4001)
    launches["B6"], *m1 = phase_m1(md_m1, domain)
    # Slice 7: B10 on M1's chain, against M1's solve.
    launches["B10"] = phase_b10_m1(m1, domain)
    del m1
    phase_m2(meshes[(257, "float32")], domain)
    del md_m1
    launches["B1-load"], s1 = phase_s1(meshes[(257, "float32")], domain)
    launches["B2-load"] = phase_s2(meshes[(513, "float32")], domain)
    launches["B1-BiCGStab"] = phase_s3(meshes[(257, "float32")], domain, s1)
    launches["B4-load"] = phase_scenario(1025, 2001, 200, 0.0, "p1")
    launches["B4-load"] += phase_scenario(513, 1001, 100, 0.005, "p2")
    # Slice 5: B4's raw mode, the fused gradients, and I1.
    cache.clear()
    nt_i1 = I1["nt"]
    md_513_i1 = apt.MeshData(mesh_513, domain, nt=nt_i1)
    md_1025_i1 = apt.MeshData(mesh_1025, domain, nt=nt_i1)
    worst.update(phase_b4_raw([
        ("i1_513", md_513_i1, i1_problem(), (torch.float32,)),
        ("i1_1025", md_1025_i1, i1_problem(), (torch.float32,)),
        ("c1_257_f64", meshes[(257, "float64")], problems["C1"],
         (torch.float64,)),
        ("c1_257_f32", meshes[(257, "float32")], problems["C1"],
         (torch.float32,)),
    ], cache))
    times.update(slice5_kernel_times(md_513_i1, cache))
    del md_1025_i1
    cache.clear()
    md_129_grad = apt.MeshData(apt.create_mesh(129, 20.0), domain, nt=129,
                               dtype=torch.float64)
    phase_grad_129(md_129_grad)
    del md_129_grad
    launches["B4-raw"] = phase_i1()
    # Slice 6: general meshes, kernel B7.
    md_u257 = {name: unstructured_md(257, 1001, name)
               for name in ("float64", "float32")}
    md_u1025, setup = mesh_setup_1025()
    worst.update(phase_b7([("257_f64", md_u257["float64"]),
                           ("257_f32", md_u257["float32"]),
                           ("1025_f32", md_u1025)]))
    b7_times, launches["B7b"] = b7_kernel_times(md_u257["float32"],
                                                md_u1025, setup)
    times.update(b7_times)
    del md_u1025, md_u257["float64"]
    launches["B7a"] = phase_u1(md_u257["float32"], domain)
    phase_g1(unstructured_md(129, 33, "float64"))
    phase_msh(domain)
    # Slice 7: the block-sharded solvers on B8, B9 and B10.
    b8_launches, md_2049 = phase_b8_2049(domain)
    launches.update(b8_launches)
    times.update(b8_kernel_times(md_2049))
    del md_2049
    launches["B9"] = phase_b9_blocks(c1_be, meshes[(257, "float32")],
                                     problems, domain)
    # Slice 11: the PINN (its path launches no kernel of the port).
    phase_pinn(domain)
    kernels = []
    for kid, (name, source, replaces) in KERNELS.items():
        ms, plain, b_ms, by, abs_e, library, *extra = times[kid]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kid],
            "max_abs_err": max(worst[kid], abs_e), "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library,
            **(extra[0] if extra else {}),
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
