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
6. the kernels line (launches on each path, errors, times, bounds).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
}

# C1's Chebyshev iterations. The configuration of
# scripts/tpu_varcoef_scaling.py (k=6, extrapolated) diverges at 1025^2,
# nt=1001 in both packages although the applicability check passes it (its
# diffusion number D dt / h^2 is ~2); k=14 is the smallest count that
# converges in BE (8 suffices) and CN alike (PERF.md, section 6).
C1_ITERS = 14

# Kernel-vs-plain bounds on max|kernel - plain|, relative to max|plain|.
# The kernels contract multiply-adds into FMAs and B5 sums its dot
# products in another order than torch.sum; both stay far inside these.
TOL = {"float64": 1e-12, "float32": 1e-5}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    per_source = _build.build(
        [source.rsplit("/", 1)[1] for _, source, _ in KERNELS.values()])
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
            "B5": fused_solver.CANVAS_KERNEL}


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
            got = fused_solver.kernel_solve(scal, u3, **kw)
            ref = fused_solver.plain_solve(scal, u3, **kw)
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


def timed_solves(solver, reps):
    solver.solve(store_solutions=False)  # warm-up
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
    abs_e, rel, _ = rel_err(fused_solver.kernel_solve(scal, u3, **kw),
                            fused_solver.plain_solve(scal, u3, **kw))
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
                "C3": robin_obstacle_problem()}
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
    md_257_65 = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=65)
    worst = phase_b1(meshes, problem)
    worst.update(phase_b2(meshes, problem))
    cache = {}
    worst.update(phase_b3(meshes, problems, cache))
    worst.update(phase_b4(meshes, problems, cache))
    worst.update(phase_b5(meshes, problems, cache))
    times = kernel_times(meshes, problem)
    times.update(canvas_kernel_times(meshes, problems, cache))

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
