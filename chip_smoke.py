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
   matvec), B4 (canvas step per launch), B5 (canvas whole-loop BiCGStab);
3. the uniform main path at 257^2, nt=1001: CRBESolver(matvec_impl="fused",
   Chebyshev-4, extrapolated warm start), BE and CN, held against the scan
   path (matvec_impl="stencil", BiCGStab) and the analytical solution;
4. the uniform path past the whole-loop size: 1025^2,
   matvec_impl="fused_hbm", Chebyshev-8, extrapolated;
5. the canvas operator (per-DOF coefficients): C1, a rotating wind at
   1025^2 on B4 (Chebyshev-14, BE and CN); C2, the same problem at 257^2 on
   B5 (BiCGStab-5); C3, Robin walls and an obstacle at 257^2 on B4 (CN,
   Chebyshev-8) and on the scan path through B3;
6. kernel B6 (multispecies step with in-kernel chemistry) and B4 with an
   emission load against their plain versions, f64 and f32;
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
   plane, with the lumped-mass budget;
9. the kernels line (launches on each path, errors, times, bounds).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

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
    from airpollution_tpu_torch.ops import fused_stencil

    return {"B1": fused_solver.KERNEL, "B2": fused_hbm.KERNEL,
            "B3": fused_stencil.KERNEL, "B4": fused_hbm.CANVAS_KERNEL,
            "B5": fused_solver.CANVAS_KERNEL,
            "B6": fused_hbm.MULTISPECIES_KERNEL,
            "B1-load": fused_solver.LOAD_KERNEL,
            "B1-BiCGStab": fused_solver.BICGSTAB_KERNEL,
            "B2-load": fused_hbm.LOAD_KERNEL,
            "B4-load": fused_hbm.CANVAS_KERNEL}


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
                    tile = fused_solver.choose_tile(
                        fused_solver.halo_of(k, use_ka), dtype,
                        fused_hbm.TILE)
                    got_u = torch.empty_like(u)
                    got_up = torch.empty_like(u)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up,
                                          use_ka, halt, tile)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got_u, ref_u)
                    check(bool(torch.equal(got_up, ref_up)),
                          f"B2 {ms}^2 k={k}: u_prev output differs")
                    f, r, c = (int(i) for i in torch.unravel_index(
                        diff.argmax(), diff.shape))
                    rows.append({"ms": ms, "dtype": name, "k": k,
                                 "order": order, "tile": tile,
                                 "rel_err": rel,
                                 "worst_at": {"family": "HVD"[f], "row": r,
                                              "col": c,
                                              "tile": [r // tile, c // tile],
                                              "in_tile": [r % tile,
                                                          c % tile]}})
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
    abs_e, rel, _ = rel_err(fused_solver.kernel_solve(scal, u3, **kw)[0],
                            fused_solver.plain_solve(scal, u3, **kw)[0])
    check(rel <= TOL["float32"], f"B1 257^2 x 1000 steps: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_solve(scal, u3, **kw), 5)
    plain = cuda_ms(lambda: fused_solver.plain_solve(scal, u3, **kw), 1)
    dofs = md.number_of_segments
    b_ms, by = bound(2 * u3.numel() * 4,
                     n_steps * dofs * step_flops_per_dof(k, False, True))
    out["B1"] = (ms, plain, b_ms, by, abs_e, None)
    # B2: one launch = one 1025^2 step, k=8.
    k = 8
    scal, u = uniform_inputs(meshes[(1025, "float32")], problem, 1, k,
                             torch.float32)
    up = u.clone()
    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    tile = fused_solver.choose_tile(fused_solver.halo_of(k, False),
                                    torch.float32, fused_hbm.TILE)
    masks = fused_solver.rect_masks(u.shape[-1], torch.float32, u.device)
    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up, False, halt, tile)
    abs_e, rel, _ = rel_err(got_u, fused_solver.plain_step(
        scal, k, u, up, False, masks)[0])
    check(rel <= TOL["float32"], f"B2 1025^2 step: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_hbm.kernel_step(
        scal, k, u, up, got_u, got_up, False, halt, tile), 50)
    plain = cuda_ms(lambda: fused_solver.plain_step(
        scal, k, u, up, False, masks), 5)
    dofs = meshes[(1025, "float32")].number_of_segments
    b_ms, by = bound(4 * u.numel() * 4,
                     dofs * step_flops_per_dof(k, False, True))
    out["B2"] = (ms, plain, b_ms, by, abs_e, None)
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
            got = fused_stencil.kernel_matvec(inp["pattern"], inp["coeffs"], x)
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


def phase_b4(meshes, problems, cache):
    """Kernel B4 against plain_canvas_step at 129^2 and 1025^2, k = 6, 8
    and C1's 14, BE and CN, on C1 (rotating wind) and C3 (Robin rectangle
    and dead DOFs), one step from a state that differs from u_prev."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver

    worst = {}
    rows = []
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        for ms in (129, 1025):
            for pname in ("C1", "C3"):
                for k in (6, 8, C1_ITERS):
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
                        tile = fused_solver.choose_tile(
                            fused_solver.halo_of(k, use_ka), dtype,
                            fused_hbm.CANVAS_TILE)
                        got_u = torch.empty_like(u)
                        got_up = torch.empty_like(u)
                        halt = torch.tensor(-1, dtype=torch.int32,
                                            device=u.device)
                        fused_hbm.canvas_kernel_step(
                            C, cheb, k, u, up, got_u, got_up, use_ka,
                            inp["rect"], halt, tile)
                        torch.cuda.synchronize()
                        abs_e, rel, diff = rel_err(got_u, ref_u)
                        check(bool(torch.equal(got_up, ref_up)),
                              f"B4 {ms}^2 k={k}: u_prev output differs")
                        at = worst_at(diff)
                        at["tile"] = [at["row"] // tile, at["col"] // tile]
                        rows.append({"ms": ms, "problem": pname,
                                     "dtype": name, "k": k, "order": order,
                                     "tile": tile, "rel_err": rel,
                                     "worst_at": at})
                        check(rel <= TOL[name],
                              f"B4 {ms}^2 {pname} {name} k={k} "
                              f"order={order}: rel err {rel:.3e} > "
                              f"{TOL[name]:.0e} at {at}")
                        if ms == 1025 and name == "float32":
                            worst["B4"] = max(worst.get("B4", 0.0), abs_e)
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
        times = timed_solves(s, 3)
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
    out["b4_launches"] = total
    emit(out)
    return total


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
    abs_e, rel, _ = rel_err(fused_stencil.kernel_matvec(pattern, coeffs, x),
                            stencil.stencil_matvec(pattern, coeffs, x))
    check(rel <= TOL["float32"], f"B3 257^2: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_stencil.kernel_matvec(pattern, coeffs, x), 200)
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
    out["B3"] = (ms, plain, b_ms, by, abs_e, library)
    # B4: one step at 1025^2 on C1's operator, BE, extrapolated.
    k = C1_ITERS
    inp = canvas_inputs(meshes[(1025, "float32")], problems["C1"], 1, f32,
                        cache)
    C, cheb, u, masks = canvas_step_inputs(inp, k, f32)
    up = u.clone()
    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    tile = fused_solver.choose_tile(fused_solver.halo_of(k, False), f32,
                                    fused_hbm.CANVAS_TILE)
    rect = inp["rect"]
    fused_hbm.canvas_kernel_step(C, cheb, k, u, up, got_u, got_up, False,
                                 rect, halt, tile)
    abs_e, rel, _ = rel_err(got_u, fused_hbm.plain_canvas_step(
        C, cheb, k, u, up, False, masks)[0])
    check(rel <= TOL["float32"], f"B4 1025^2 step: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        C, cheb, k, u, up, got_u, got_up, False, rect, halt, tile), 50)
    plain = cuda_ms(lambda: fused_hbm.plain_canvas_step(
        C, cheb, k, u, up, False, masks), 5)
    dofs = meshes[(1025, "float32")].number_of_segments
    b_ms, by = bound((C.numel() + 4 * u.numel()) * 4,
                     dofs * canvas_step_flops_per_dof(k, False, True))
    out["B4"] = (ms, plain, b_ms, by, abs_e, None)
    # B5: one launch = the whole C2 solve (257^2, nt=1001, k=5, BE, ext).
    md = meshes[(257, "float32")]
    inp = canvas_inputs(md, problems["C1"], 1, f32, cache)
    C, u3 = bicgstab_inputs(inp, f32)
    kw = dict(n_steps=md.nt - 1, n_iters=5, use_ka=False, extrapolate=True)
    abs_e, rel, _ = rel_err(fused_solver.kernel_bicgstab_solve(C, u3, **kw),
                            fused_solver.plain_bicgstab_solve(C, u3, **kw))
    check(rel <= TOL["float32"], f"B5 257^2 x 1000 steps: rel err {rel:.3e}")
    ms = cuda_ms(lambda: fused_solver.kernel_bicgstab_solve(C, u3, **kw), 3)
    plain = cuda_ms(lambda: fused_solver.plain_bicgstab_solve(C, u3, **kw), 1)
    b_ms, by = bound((C.numel() + 2 * u3.numel()) * 4,
                     (md.nt - 1) * md.number_of_segments
                     * bicgstab_flops_per_dof(5, False, True))
    out["B5"] = (ms, plain, b_ms, by, abs_e, None)
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
    tile)."""
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
    tile = fused_hbm.multispecies_tile(K, k, use_ka, dtype)
    return dict(C=C, cheb=cheb, E=E64.to(dtype=dtype, device=U.device),
                scal=scal, U=U, masks=masks, loads=loads, index=index,
                tile=tile, use_ka=use_ka)


def run_b6(case, k, rect):
    """(kernel, plain) outputs of one B6 step."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm

    got = torch.empty_like(case["U"])
    halt = torch.tensor(-1, dtype=torch.int32, device=got.device)
    fused_hbm.multispecies_kernel_step(
        case["C"], case["scal"], k, case["U"], got, case["use_ka"], rect,
        halt, case["tile"], case["loads"], case["index"])
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
    """Kernel B6 against plain_multispecies_step: one step at 129^2 and
    1025^2, K = 3 and 5, BE and CN, with and without the demo's Gaussian
    load, on the demo's transport (k=8); and a 2-species step on C3's Robin
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
        for ms in (129, 1025):
            md = meshes[(ms, name)]
            cases = [("demo", K, order, source, True)
                     for K in (3, 5) for order in (1, 2)
                     for source in (None, src)]
            cases += [("C3", 2, order, walled, False) for order in (1, 2)]
            for pname, K, order, source, lumped in cases:
                inp = canvas_inputs(md, problems[pname], order, dtype, cache)
                case = b6_case(inp, md, K, k, order, dtype, source, lumped)
                got, ref = run_b6(case, k, inp["rect"])
                abs_e, rel, diff = rel_err(got, ref)
                row = {"ms": ms, "problem": pname, "dtype": name, "K": K,
                       "order": order, "load": source is not None,
                       "tile": case["tile"], "rel_err": rel,
                       "worst_at": worst_cell(diff, case["tile"])}
                if inp["dead"] is not None:
                    from airpollution_tpu_torch.ops import fused_solver

                    dead3 = fused_solver.to_canvases(
                        inp["pattern"], inp["dead"].to(dtype)).bool()
                    row["dead_max_abs"] = float(got[:, dead3].abs().max())
                    check(row["dead_max_abs"] == 0.0,
                          f"B6 {ms}^2 {pname}: dead DOFs reach "
                          f"{row['dead_max_abs']}")
                rows.append(row)
                check(rel <= TOL[name],
                      f"B6 {ms}^2 {pname} {name} K={K} order={order}: rel "
                      f"err {rel:.3e} > {TOL[name]:.0e} at {row['worst_at']}")
                if ms == 1025 and name == "float32":
                    worst["B6"] = max(worst.get("B6", 0.0), abs_e)
    emit({"phase": "b6_vs_plain", "card": card_line(), "cases": rows})
    return worst


def phase_b4_load(meshes, problems, cache):
    """Kernel B4 with an emission load against plain_canvas_step: one step
    at 129^2 and 1025^2, BE and CN, the demo's emitter on its transport
    (lumped) and the walled emitter on C3's (reference quadrature)."""
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
                    tile = fused_solver.choose_tile(
                        fused_solver.halo_of(k, use_ka), dtype,
                        fused_hbm.CANVAS_TILE)
                    got = torch.empty_like(u)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    fused_hbm.canvas_kernel_step(
                        C, cheb, k, u, None, got, None, use_ka, inp["rect"],
                        halt, tile, load=load)
                    ref, _ = fused_hbm.plain_canvas_step(
                        C, cheb, k, u, None, use_ka, masks, load)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got, ref)
                    rows.append({"ms": ms, "problem": pname, "dtype": name,
                                 "order": order, "tile": tile,
                                 "rel_err": rel, "worst_at": worst_at(diff)})
                    check(rel <= TOL[name],
                          f"B4+load {ms}^2 {pname} {name} order={order}: "
                          f"rel err {rel:.3e} > {TOL[name]:.0e}")
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
    run (counts zeroed just before it)."""
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
    times = timed_solves(s, 2, warm_up=False)
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
    times_u = timed_solves(unf, 2, warm_up=False)
    out["unfused_steps_per_s_best"] = n_steps / min(times_u)
    out["unfused_steps_per_s_median"] = n_steps / statistics.median(times_u)
    out["fuse_rel_maxdiff"] = rel_max(U, unf.solutions[-1])
    check(out["fuse_rel_maxdiff"] < 1e-4,
          f"M1 fuse A/B {out['fuse_rel_maxdiff']:.3e} >= 1e-4")
    emit(out)
    return launches


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
    ms = cuda_ms(lambda: fused_hbm.multispecies_kernel_step(
        case["C"], case["scal"], k, case["U"], out_buf, True, inp["rect"],
        halt, case["tile"], case["loads"], case["index"]), 30)
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
    tile = fused_solver.choose_tile(fused_solver.halo_of(k, True),
                                    torch.float32, fused_hbm.CANVAS_TILE)
    b4_out = torch.empty_like(u)
    b4_ms = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        case["C"], case["cheb"], k, u, None, b4_out, None, True, inp["rect"],
        halt, tile, load=load), 30)
    b4_nl = cuda_ms(lambda: fused_hbm.canvas_kernel_step(
        case["C"], case["cheb"], k, u, None, b4_out, None, True, inp["rect"],
        halt, tile), 30)
    # B6 at M2's shape (257^2, k=6), for M2's share of a step.
    md2 = meshes[(257, "float32")]
    k2 = DEMO_ITERS[257]
    inp2 = canvas_inputs(md2, problems["demo"], 2, torch.float32, cache)
    case2 = b6_case(inp2, md2, K, k2, 2, torch.float32, demo_species(1)[0],
                    True)
    out2 = torch.empty_like(case2["U"])
    ms_257 = cuda_ms(lambda: fused_hbm.multispecies_kernel_step(
        case2["C"], case2["scal"], k2, case2["U"], out2, True, inp2["rect"],
        halt, case2["tile"], case2["loads"], case2["index"]), 200)
    emit({"phase": "multispecies_kernel_times", "card": card_line(),
          "b6_ms": ms, "b6_plain_ms": plain, "b6_bound_ms": b_ms,
          "b6_tile": case["tile"], "b6_ms_257_k6": ms_257,
          "b4_with_load_ms": b4_ms, "b4_without_load_ms": b4_nl, "b4_k": k,
          "b4_order": 2})
    return {"B6": (ms, plain, b_ms, by, abs_e, None)}


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
                    tile = fused_solver.choose_tile(
                        fused_solver.halo_of(k, use_ka), dtype,
                        fused_hbm.TILE)
                    got_u, got_up = torch.empty_like(u), torch.empty_like(u)
                    halt = torch.tensor(-1, dtype=torch.int32,
                                        device=u.device)
                    fused_hbm.kernel_step(scal, k, u, up, got_u, got_up,
                                          use_ka, halt, tile, load=load)
                    torch.cuda.synchronize()
                    abs_e, rel, diff = rel_err(got_u, ref_u)
                    check(bool(torch.equal(got_up, ref_up)),
                          f"B2+load {ms}^2 k={k}: u_prev output differs")
                    rows.append({"ms": ms, "dtype": name, "k": k,
                                 "order": order, "tile": tile,
                                 "rel_err": rel, "worst_at": worst_at(diff)})
                    check(rel <= TOL[name], f"B2+load {rows[-1]}: rel err "
                          f"above {TOL[name]:.0e}")
                    if ms == 1025 and name == "float32":
                        worst["B2-load"] = max(worst.get("B2-load", 0.0),
                                               abs_e)
    emit({"phase": "b2_load_vs_plain", "card": card_line(), "cases": rows})
    return worst


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
                tile = fused_solver.choose_tile(
                    fused_solver.halo_of(k, use_ka), dtype,
                    fused_hbm.CANVAS_TILE)
                got = torch.empty_like(u)
                halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
                fused_hbm.canvas_kernel_step(
                    C, cheb, k, u, u, got, torch.empty_like(u), use_ka,
                    inp["rect"], halt, tile, load=plane)
                ref, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, u,
                                                     use_ka, masks, plane)
                torch.cuda.synchronize()
                abs_e, rel, diff = rel_err(got, ref)
                rows.append({"ms": ms, "dtype": name, "order": order,
                             "tile": tile, "rel_err": rel,
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
    out["B1-BiCGStab"] = (ms, plain, b_ms, by, abs_e, None)
    # B2 with a load: one S2 step (513^2, k=4, BE, ext), and at 1025^2,
    # k=8 without and with a load.
    for label, bmd, k in (("s2", s2_md, S_ITERS),
                          ("1025", meshes[(1025, "float32")], 8)):
        scal, u = uniform_inputs(bmd, problem, 1, k, f32)
        load = uniform_load(bmd, scal, 1, s_source(), 1, f32)
        up = u.clone()
        got_u, got_up = torch.empty_like(u), torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
        tile = fused_solver.choose_tile(fused_solver.halo_of(k, False), f32,
                                        fused_hbm.TILE)
        masks = fused_solver.rect_masks(u.shape[-1], f32, u.device)

        def launch(ld):
            fused_hbm.kernel_step(scal, k, u, up, got_u, got_up, False, halt,
                                  tile, load=ld)

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
        tile = fused_solver.choose_tile(fused_solver.halo_of(8, True), f32,
                                        fused_hbm.CANVAS_TILE)
        got = torch.empty_like(u)
        got_up = torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)

        def launch(ld):
            fused_hbm.canvas_kernel_step(C, cheb, 8, u, u, got, got_up, True,
                                         inp["rect"], halt, tile, load=ld)

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
            out["B4-load"] = (with_load, plain, b_ms, by, abs_e, None)
    emit(extra)
    return out


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
    meshes[(1025, "float64")] = meshes[(1025, "float32")]
    meshes[(513, "float32")] = apt.MeshData(apt.create_mesh(513, 20.0),
                                            domain, nt=1001)
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
    times = kernel_times(meshes, problem)
    times.update(canvas_kernel_times(meshes, problems, cache))
    times.update(multispecies_kernel_times(meshes, problems, cache))
    times.update(slice4_kernel_times(meshes, cache, meshes[(257, "float32")],
                                     meshes[(513, "float32")]))

    launches = {
        "B1": phase_main_257(meshes[(257, "float32")], problem, domain),
        "B2": phase_main_1025(meshes[(1025, "float32")], problem, domain),
        "B4": phase_canvas_1025(meshes[(1025, "float32")], problems["C1"],
                                domain),
        "B5": phase_canvas_257_bicgstab(meshes[(257, "float32")],
                                        problems["C1"], domain),
    }
    launches["B3"], _ = phase_robin_obstacle(
        meshes[(257, "float32")], md_257_65, problems["C3"], domain)
    cache.clear()
    md_m1 = apt.MeshData(apt.create_mesh(1025, 20.0), domain, nt=4001)
    launches["B6"] = phase_m1(md_m1, domain)
    phase_m2(meshes[(257, "float32")], domain)
    del md_m1
    launches["B1-load"], s1 = phase_s1(meshes[(257, "float32")], domain)
    launches["B2-load"] = phase_s2(meshes[(513, "float32")], domain)
    launches["B1-BiCGStab"] = phase_s3(meshes[(257, "float32")], domain, s1)
    launches["B4-load"] = phase_scenario(1025, 2001, 200, 0.0, "p1")
    launches["B4-load"] += phase_scenario(513, 1001, 100, 0.005, "p2")
    kernels = []
    for kid, (name, source, replaces) in KERNELS.items():
        ms, plain, b_ms, by, abs_e, library = times[kid]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kid],
            "max_abs_err": max(worst[kid], abs_e), "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library,
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
