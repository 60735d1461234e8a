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
   fused_hbm), through scripts/torch_port_multispecies_fused_demo.py's
   run(): M1, its largest row (1025^2, nt=4001, K=3, CN, Chebyshev-8) on
   B6, with its k-vs-2k and fuse_chemistry=False (B4) checks and chain
   masses against the f64 oracle; M2, its 257^2 row (nt=1001,
   Chebyshev-6), against the stencil scan and with strided snapshots;
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
   BE, for Problem(D) and the emitter's (log q, xs, ys), and (slice 14,
   F2) the deposition log alphas, the exchange log alphas and
   compensation points (CN), a rotating wind's omega and a full initial
   field, against the scan engine and central differences; I1, the
   production source
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
13. slice 12, time-varying winds (models/unsteady.solve_time_varying,
    scripts/torch_port_unsteady_scale.py's rows, the turning wind): W1,
    1025^2 (nt=2001, a chunk every 100 steps, CN, Chebyshev-8) on B4 with
    a fresh stack per chunk and the chunks' intervals on B3: warm steps/s,
    one chunk's assembly and interval against its B4 sweep, the halved
    chunk (<= 5e-3), a chunk's B4 step against its plain version, and at
    513^2 the fused chunks against the scan-Chebyshev chunks (f64 on the
    same intervals <= 1e-4; f32 each with its own estimate, reported);
    W2, the 513^2 row on 4 row blocks (B9, <= 1e-6 of the whole canvas);
    W3, a misfit's gradient in the turning rate through the
    differentiable fused chunks (B4-raw) at 257^2 against the plain
    polynomial (<= 2e-5) and a central difference (<= 5e-3);
14. slice 13, the command line (``airpollution_tpu_torch.cli``, run
    through ``cli.main``; X3 in a background process, its line printed
    after the wait): X1, ``solve --mesh_size 2049 --nt
    101`` with the parser's defaults ('auto' -> the uniform scan route
    with patch assembly -> the large-mesh policy), its route, steps/s,
    rel_l2 and seconds to the first step, no kernel launched; the fused
    route at the same size and k on B2 (|delta rel_l2| <= 5e-4), and at
    513^2 in f64 on one shared interval (<= 1e-10 of max|u|); X2,
    BiCGStab with the spectral preconditioner against Jacobi at 1025^2
    (iterations per step, steps/s; <= 1e-5 of max|u|); X3, ``solve`` BE
    and CN with saved fields, ``invert`` and ``fit-source`` on them,
    ``multispecies`` on the uniform route against B6, ``solve
    --matvec_impl fused`` on B1, and ``pinn`` with checkpoints;
15. slice 14, the rest of the inverse layer (diagnostics/inverse.py; F2,
    its f64 gradients, are phase 9's cases): F1, fit_surface_exchange,
    fit_wind and fit_initial_condition at I1's 513^2, nt=128 (f32, B4's
    raw mode over the per-DOF canvases; the 4D-Var roughness on B7a),
    each fit's gradient through B4-raw against its plain polynomial
    (<= 2e-5) and 5 Adam steps that lower the loss; F3, the
    differentiable multispecies solve's d/dR, fit_chemistry and
    receptor_footprint (B7a) at 17^2, f64, card against CPU (<= 1e-10);
    F4, ``fit-ic``, ``fit-deposition`` and ``fit-exchange`` through the
    command line (the JAX CLI's keys, a falling misfit);
16. slice 15, ensembles and the FNO surrogate: E1, ``ensemble
    --place_sensors 16`` at the CLI's defaults (32 members at 64^2,
    nt=128, CN; every ELL product one launch of B7a over the member
    stack, on one shared column index) against serial solves, the f64
    member loop's BiCGStab counts against serial ones, B7a's stacked
    mode against its plain version, enkf_update and place_sensors card
    against CPU; E2, scripts/torch_port_ensemble_demo.py at the row of
    results_snapshot/ensemble_tpu.csv (64 members, f64) against that
    CSV's accuracy figures, batched against 4 serial members; N1, ``fno
    --mesh_size 64 --nt 128 --epochs 500`` at the CLI's widths, with the
    JAX tests' gates and a forward pass and three AdamW steps card
    against CPU in f64;
17. slice 16, the paper's experiment harness (in a background process,
    its line printed after the wait; R1,
    ``airpollution_tpu_torch.experiments`` and ``.reporting``, each
    driver through its ``main`` in a temporary directory, f32): the CRBE
    sweep over the paper's mesh sizes 4-128 at nt=128 (rel_l2 at ms=16
    and 32 within 5e-4 of the reference-parity targets), the unstructured
    sweep at 8, 16 and 32 (B7a's launches counted from 0), the PINN sweep
    at ms 4 and 8 (100 epochs), the D-sensitivity sweep (50 epochs), a
    fixed-runtime cell (ms=4, 2 s), a 2-trial search on 2 threads, then
    the eight LaTeX tables and the figures (skipped without matplotlib),
    each row beside results_snapshot/'s;
18. slice 17, multi-device on torch.distributed (D1,
    ``airpollution_tpu_torch.parallel``): (a) one NCCL rank in this
    process (a FileStore group of world size 1) runs every distributed
    entry point at full width, each against its one-process counterpart:
    the block solver on X1's 2049^2 mesh data (B8, bitwise), the
    row-sharded FEM solve at 257^2 (B7a row blocks) against the ELL
    solve, the D-sweep at 64^2 over the sensitivity driver's five D
    values against five serial solves, PINN.train_parallel at PINN-W's
    widths against PINN.train on the same seed and points, train_fno_dp
    at N1's widths against train_fno, ensemble_forecast(mesh=) at E1's
    shape against the one batch (bitwise); (b) two gloo ranks sharing
    the card (parallel.launch.spawn) run B8 at 2049^2, B9 at C1's 1025^2,
    B10 on M1's chain and the halo-exchange stencil solver at 257^2
    (Chebyshev), one block per rank, the halo slabs staged through host
    memory, each bitwise against the same solve on 2 blocks in this
    process, with the host-staged exchange's ms; the ranks start right
    after the kernel build and run beside the kernel checks;
19. slice 18, the last scripts (y1_scripts, each through its run() or
    main(), in three processes of their own: the scan and PINN scripts,
    which launch no kernel of the port, start with the script beside the
    kernel build, the others right after it, and all run beside the
    untimed kernel checks): B4 with its load plane on the street canyon's own canvas
    against its plain version (f64, f32, dead DOFs 0.0); the canyon's
    fused row (257^2, nt=1001, CN, Chebyshev-8, the 2k check, budget
    terms against the JAX package's row); the multispecies script's K
    sweep at 257^2 (M1 and M2 are its other rows); the extrapolation A/B
    at 513^2, nt=128 (B4-raw); the assimilation, cycling and network
    design scripts at their defaults (B7a); the wind inversion, the
    rotating convergence table and the multispecies demo, and the PINN
    scripts and problem 3's last two, each cut in depth only;
20. the PINN (slice 11; its levers cell a row of
    scripts/torch_port_pinn_accuracy_levers.py), then the kernels line
    (launches on each path,
    errors, times, bounds; for B3 and B7 also the host's time to enqueue
    one launch and the device time alone, from a CUDA graph of 200
    launches replayed; for B4, B4-raw and B9 the launches of slice 12's
    paths apart as ``time_varying_launches``, for B1, B2 and B6 those of
    slice 13's as ``cli_launches``, for B3, B4-raw and B7a those of slice
    14's as ``inverse_fits_launches``, for B7a those of slice 15's as
    ``ensemble_fno_launches``, of slice 16's as
    ``paper_harness_launches``, for B7a-B10 those of slice 17's as
    ``distributed_launches`` and for B4 (with or without a load: one
    counter), B4-raw, B6 and B7a those of slice 18's scripts as
    ``scripts_launches``).

Set-up is shared where it can be: meshes that differ only in nt are one
MeshData retimed (``retimed``), B8 runs after X1 on the 2049^2 mesh data
of X1's command, the 1025^2 unstructured mesh's Delaunay runs on a host
thread beside the kernel build, and the work that shares no state with
the main path runs in background processes (BACKGROUND_GROUPS: slice
18's scripts, D1's two gloo ranks, X3 and R1) beside the build and the
untimed kernel checks; their times are upper bounds, and the lines they
print carry ``ran_beside``.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
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


def retimed(md, nt):
    """``md`` with ``nt`` time points: the same mesh, topology and device
    tensors (shared, not rebuilt: a 1025^2 MeshData takes ~2 s, a 2049^2
    one ~8 s); only ``nt`` and the time grid are its own."""
    import copy

    import torch

    out = copy.copy(md)
    out.nt = int(nt)
    out.time_discr = torch.linspace(0.0, float(md.domain.T), out.nt,
                                    dtype=md.dtype, device=md.device)
    return out


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
    # C3b's speed: a warm solve of each (the first ones above built the
    # operators and warmed every kernel).
    for tag, solver in (("pallas", pal), ("stencil", ref)):
        rates(out, f"b3_{tag}_", md65.nt - 1,
              timed_solves(solver, 1, warm_up=False))
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
    """The decay chain A1 -> ... -> AK of
    scripts/torch_port_multispecies_fused_demo.py: rates 0.4, 0.2, then
    0.2 * 0.85^i."""
    from scripts import torch_port_multispecies_fused_demo as demo

    return demo.chain_R(K)


def demo_problem(K=3):
    """The demo's chain (make_problem): a Gaussian emitter of A, then K - 1
    species with zero initial and boundary values; all with v = (1, 0.2),
    D = 0.3."""
    from scripts import torch_port_multispecies_fused_demo as demo

    return demo.make_problem(K)


def demo_species(K):
    """The demo chain's first K species (K = 1: its emitter alone)."""
    return list(demo_problem(max(K, 2)).species)[:K]


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


def multispecies_row(md, ms, k, **kw):
    """One row of scripts/torch_port_multispecies_fused_demo.py through its
    run() on ``md`` (the ms^2 mesh, Domain(), f32), counts zeroed just
    before: (row, its solvers, the B6 and B4 launches, seconds)."""
    from scripts import torch_port_multispecies_fused_demo as demo

    reset_counts()
    t0 = time.perf_counter()
    row = demo.run(ms, md.nt, k, mesh_data=md, **kw)
    seconds = time.perf_counter() - t0
    return (row, row.pop("solvers"), launches_of("B6"), launches_of("B4"),
            seconds)


def phase_m1(md, domain):
    """M1, scripts/torch_port_multispecies_fused_demo.py's 1025^2 row
    through its run(): nt=4001, K=3, CN, Chebyshev-8, Strang on B6; a first
    and a warm solve, the 2k solve, and the fuse_chemistry=False path (K
    B4 launches per step, one timed solve), the last two on the fused
    solve's operator and interval. Gates: 3 x 4,000 B6 and 3 x 4,000 B4
    launches; chain masses against the f64 oracle; k-vs-2k < 5e-3 (the
    script's own); the fuse A/B within 1e-4. Returns the B6 launches of
    the path's run (counts zeroed just before it), the fused solver and
    its warm steps/s (B10's block solve is held against this solve)."""
    k = DEMO_ITERS[1025]
    n_steps = md.nt - 1
    import torch

    row, solvers, b6, b4, seconds = multispecies_row(md, 1025, k,
                                                     scan_check=False)
    s = solvers["fused"]
    out = {"phase": "m1_multispecies_1025", "card": card_line(), **row,
           "seconds": seconds, "b6_launches": b6,
           "b4_launches_unfused": b4,
           "cheb_bounds": list(s._fused_bounds_cache[1])}
    check(b6 == 3 * n_steps and b4 == 3 * n_steps,
          f"M1: {b6} B6 and {b4} B4 launches, not {3 * n_steps} and "
          f"{3 * n_steps} (first, warm and 2k fused solves; one unfused)")
    check(bool(torch.isfinite(s.solutions[-1]).all()),
          "M1: non-finite state")
    masses = chain_masses(s)
    oracle = ORACLE_MASSES[1025]
    rels = [abs(m - o) / abs(o) for m, o in zip(masses, oracle)]
    out.update({"masses": masses, "oracle_masses": list(oracle),
                "mass_rel_vs_oracle": max(rels)})
    emit(out)
    check(max(rels) < MASS_TOL,
          f"M1 masses {masses} not within {MASS_TOL} of {oracle}")
    check(row["k_vs_2k_rel_maxdiff"] < 5e-3,
          f"M1 k-vs-2k {row['k_vs_2k_rel_maxdiff']:.3e} >= 5e-3")
    check(row["fused_vs_unfused_rel_maxdiff"] < 1e-4,
          f"M1 fuse A/B {row['fused_vs_unfused_rel_maxdiff']:.3e} >= 1e-4")
    return {"B6": b6, "B4": b4}, s, row["fused_steps_per_sec"]


def phase_m2(md, domain):
    """M2, the script's 257^2 row through its run(): nt=1001, K=3, CN,
    Chebyshev-6; the fused solves, 2k, the unfused A/B and the stencil
    scan, here on the fused solve's interval. Gates: 3 x 1,000 B6 and 3 x
    1,000 B4 launches (the scan none), fused against the scan within
    1e-4, chain masses against the oracle's 257^2 values, and a
    snapshot_every=100 solve whose last row equals the final state bit for
    bit. Returns the row's B6 and B4 launches."""
    import torch

    k = DEMO_ITERS[257]
    n_steps = md.nt - 1
    row, solvers, b6, b4, seconds = multispecies_row(
        md, 257, k, scan_check=True, scan_on_fused_interval=True)
    s = solvers["fused"]
    out = {"phase": "m2_multispecies_257", "card": card_line(), **row,
           "seconds": seconds, "b6_launches": b6,
           "b4_launches_unfused": b4}
    check(b6 == 3 * n_steps and b4 == 3 * n_steps,
          f"M2: {b6} B6 and {b4} B4 launches")
    check(row["fused_vs_scan_rel_maxdiff"] <= 1e-4,
          f"M2 fused vs scan {row['fused_vs_scan_rel_maxdiff']:.3e} > 1e-4")
    check(row["k_vs_2k_rel_maxdiff"] < 5e-3,
          f"M2 k-vs-2k {row['k_vs_2k_rel_maxdiff']:.3e} >= 5e-3")
    masses = chain_masses(s)
    oracle = ORACLE_MASSES[257]
    out["masses"] = masses
    out["mass_rel_vs_oracle"] = max(abs(m - o) / abs(o)
                                    for m, o in zip(masses, oracle))
    check(out["mass_rel_vs_oracle"] < MASS_TOL,
          f"M2 masses {masses} not within {MASS_TOL} of {oracle}")
    from scripts import torch_port_multispecies_fused_demo as demo

    U = s.solutions[-1].clone()
    snap = demo.sharing(s, domain=domain, msp=s.problem, md=md, iters=k,
                         cheb_bounds=s._fused_bounds_cache[1],
                         snapshot_every=100)
    rows = snap.solve(store_solutions=True)
    out["snapshot_rows"] = rows.shape[0]
    out["snapshot_last_equals_final"] = bool(torch.equal(rows[-1], U))
    emit(out)
    check(rows.shape[0] == n_steps // 100 + 1
          and out["snapshot_last_equals_final"],
          "M2: the last strided row differs from the final state")
    return {"B6": b6, "B4": b4}


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


# Slice 14's cases of phase_grad_129 (F2): the Robin walls of the
# deposition and exchange cases, their traced parameters' values, and the
# rotating wind (C1's problem: dt |v| / h <= 0.35 at 129^2, nt=129, where
# Chebyshev-24 converges).
F2_SIDES = ("right", "top")
F2_LOG_ALPHA = (math.log(0.4), math.log(0.2))
F2_C_COMP = (0.05, 0.2)
F2_WIND = dict(omega=0.05, D=0.3)


def f2_walled():
    """The deposition and exchange cases' problem: a square pulse carried
    toward Robin walls on the right and top."""
    import airpollution_tpu_torch as apt

    p = apt.SquarePulseProblem(v=(0.5, 0.3), D=0.3, lo=4.0, hi=16.0)
    p.robin_sides = dict(zip(F2_SIDES, (0.4, 0.2)))
    return p


def grad_129_cases(md):
    """phase_grad_129's cases: name -> (th -> (problem, solve keywords),
    starting parameters, time scheme orders). The plume's D and the
    emitter's (log q, xs, ys) in BE (slice 5); slice 14's deposition log
    alphas, exchange log alphas and compensation points (in CN, the
    phase's CN gradient gate), the rotating wind's omega, and the full
    initial field of the 4D-Var control."""
    import torch

    import airpollution_tpu_torch as apt

    def plume(th):
        return apt.Problem(D=th[0]), {}

    def emitter(th):
        return apt.GaussianSourceProblem(
            q=torch.exp(th[0]), xs=th[1], ys=th[2],
            sigma_s=I1_SOURCE["sigma_s"]), {}

    walled = f2_walled()

    def deposition(th):
        return walled, {"robin_alpha": {
            s: torch.exp(th[i]) for i, s in enumerate(F2_SIDES)}}

    def exchange(th):
        alphas = {s: torch.exp(th[i]) for i, s in enumerate(F2_SIDES)}
        return walled, {"robin_alpha": alphas, "robin_g_const": {
            s: alphas[s] * th[2 + i] for i, s in enumerate(F2_SIDES)}}

    def wind(th):
        return apt.RotatingPlumeProblem(omega=th[0],
                                        D=F2_WIND["D"]), {}

    plain = apt.Problem()

    def ic(th):
        return plain, {"u0": th}

    return {
        "plume_D": (plume, [0.1], (1,)),
        "emitter_logq_xs_ys": (emitter, [math.log(I1_SOURCE["q"]),
                                         I1_SOURCE["xs"], I1_SOURCE["ys"]],
                               (1,)),
        "deposition_log_alpha": (deposition, list(F2_LOG_ALPHA), (1,)),
        "exchange_log_alpha_c_comp": (exchange, list(F2_LOG_ALPHA)
                                      + list(F2_C_COMP), (2,)),
        "wind_omega": (wind, [F2_WIND["omega"]], (1,)),
        "ic_u0": (ic, plain.initial_condition_fn(md.midpoints), (1,)),
    }


def phase_grad_129(md):
    """Gradients through the fused engine on the card: 129^2, f64,
    nt=129 (dt |v| / h ~ 0.28, where Chebyshev-24 converges tightly, as
    the JAX test at 17^2, nt=17), of sum(u_T^2) in each case's parameters
    (grad_129_cases: BE, the exchange case CN). The fused engine (B4's raw
    mode, forward and adjoint; the Robin and wind cases on the per-DOF
    canvases) within 2e-5 of the scan engine (BiCGStab to 1e-10), and its
    component along itself within 5e-3 of a central difference of its own
    loss (step 1e-3). Returns B4-raw's launches: (all, slice 14's)."""
    import torch

    from airpollution_tpu_torch.diagnostics import inverse

    f64 = torch.float64
    out = {"phase": "grad_129_fused_vs_scan", "card": card_line(),
           "ms": 129, "nt": md.nt, "k": 24}
    launches = slice14 = 0
    t_start = time.perf_counter()
    for cname, (make, theta, orders) in grad_129_cases(md).items():
        for order in orders:
            tag = f"{cname}_{'be' if order == 1 else 'cn'}"

            def loss(th, engine, **kw):
                problem, extra = make(th)
                u = inverse.solve_final_state(problem, md, engine=engine,
                                              time_scheme_order=order,
                                              **extra, **kw)
                return torch.sum(u ** 2)

            def start():
                return torch.as_tensor(theta, dtype=f64,
                                       device=md.device).clone()

            def grad(engine, **kw):
                th = start().requires_grad_(True)
                (g,) = torch.autograd.grad(loss(th, engine, **kw), th)
                return g

            reset_counts()
            t0 = time.perf_counter()
            g_fused = grad("fused_hbm", chebyshev_iters=24)
            torch.cuda.synchronize()
            fused_s = time.perf_counter() - t0
            launches += launches_of("B4-raw")
            if cname not in ("plume_D", "emitter_logq_xs_ys"):
                slice14 += launches_of("B4-raw")
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
                fd = (loss(start() + 1e-3 * e, "fused_hbm",
                           chebyshev_iters=24)
                      - loss(start() - 1e-3 * e, "fused_hbm",
                             chebyshev_iters=24)) / 2e-3
            if g_fused.numel() <= 4:
                out[f"{tag}_grad_fused"] = g_fused.tolist()
            else:
                out[f"{tag}_grad_fused_norm"] = float(
                    torch.linalg.norm(g_fused))
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
    out["b4_raw_launches_slice14"] = slice14
    out["seconds"] = time.perf_counter() - t_start
    emit(out)
    return launches, slice14


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


def unstructured_mesh_timed(ms):
    """(the ms^2 unstructured mesh, the seconds its jitter and Delaunay
    took)."""
    import airpollution_tpu_torch as apt

    t0 = time.perf_counter()
    mesh = apt.create_unstructured_mesh(ms, 20.0, seed=UNSTRUCTURED_SEED)
    return mesh, time.perf_counter() - t0


def mesh_setup_1025():
    """The 1025^2 unstructured mesh's set-up on the host, split: jitter and
    Delaunay, edge enumeration (numpy and native), MeshData (native
    enumeration and geometry), and the ELL pattern with its transposition
    map (built on first use). It runs in :func:`host_setup`, beside the
    kernel build, so its seconds are those of one host thread while eight
    nvcc run."""
    import numpy as np

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.mesh import native, topology

    check(native.available(), "the native topology library did not load: "
          f"{native.load_error()}")
    out = {"beside_build": True}
    mesh, out["delaunay_s"] = unstructured_mesh_timed(1025)
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
        times = timed_solves(s, 1, warm_up=False)
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
B8_NT = 1001  # scripts/tpu_hbm_check.py's 2049^2 row
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


def phase_b8_2049(domain, md):
    """B8 on scripts/tpu_hbm_check.py's 2049^2 row: Problem(sigma=1),
    nt=1001, Chebyshev-10, extrapolated, BE, assembly="patch", f32, on 4
    blocks, against CRBESolver(matvec_impl="fused_hbm", assembly="patch")
    on B2; one CN solve (Chebyshev-14, B8_CN_ITERS) and one sourced solve
    (S1's emitter, B8's load entry) against theirs. ``md`` is X1's 2049^2
    mesh data (the same mesh, nt and dtype; its set-up is X1's
    ``seconds_to_first_step``). Returns B8's launches."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.parallel import (build_hbm_halo_solver,
                                                 make_mesh)

    check(md.structured_n == 2049 and md.nt == B8_NT
          and md.dtype == torch.float32 and md.domain.T == domain.T,
          "B8: X1's mesh data is not the 2049^2 row's")
    out = {"phase": "b8_block_2049", "card": card_line(), "ms": 2049,
           "nt": md.nt, "dofs": md.number_of_segments, "k": B8_ITERS,
           "blocks": BLOCK_MESH["mp"], "mesh_from": "x1_default_route_2049"}
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
    return launches


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
# lr 1e-4, lambda (180, 80, 80)), cut to 1,000 epochs for time; and the
# levers row of results_snapshot/df_pinn_training_results_levers.csv
# ("fourier64+causal+wide64x4+lbfgs1000") at the ms=64 budget, cut to
# 1,000 Adam epochs and 50 L-BFGS steps.
PINN_LAYERS = [3, 64, 64, 64, 64, 1]
PINN_LAMBDA = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
PINN_WIDE = dict(mesh_size=128, batch={"pde": 34744, "ic": 6949,
                                       "bc": 6949},
                 lr=1e-4, patience=1000, epochs=1000, scheduled_epochs=16000)
# The levers cell: a row of scripts/torch_port_pinn_accuracy_levers.py
# (n_col 8,595 at ms=64), its 16,000 epochs and 1,000 L-BFGS steps cut.
PINN_LEVERS = dict(variant="fourier+causal+wide+lbfgs", mesh_size=64,
                   epochs=1000, lbfgs_steps=50, scheduled_epochs=16000,
                   scheduled_lbfgs_steps=1000)
# The widest cell's loss must fall at least this factor: a tenth of the
# 8,138-fold and 8,485-fold falls of its first two 2,000-epoch runs on an
# H100 (PERF.md section 6); over 1,000 epochs it fell 2,544-fold.
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


def phase_pinn_levers():
    """The levers cell on the card (PINN_LEVERS), f32:
    scripts/torch_port_pinn_accuracy_levers.py's variant
    "fourier+causal+wide+lbfgs" at ms=64 through its run() (Fourier 64,
    causal weighting, 64 x 4, lr 1e-3), its schedule cut to 1,000 Adam
    epochs and 50 L-BFGS steps. Gates: finite values, and the L-BFGS loss
    does not rise."""
    import math

    from scripts import torch_port_pinn_accuracy_levers as levers

    (row,) = levers.run(PINN_LEVERS["epochs"], PINN_LEVERS["mesh_size"],
                        [PINN_LEVERS["variant"]], device="cuda",
                        epoch_cap=PINN_LEVERS["epochs"],
                        lbfgs_cap=PINN_LEVERS["lbfgs_steps"])
    h, n = row["history"]["total_loss"], row["adam_epochs"]
    lb = h[n:]
    lbfgs_s = row["warm_train_time_s"] - row["adam_s"]
    out = {"phase": "pinn_levers_ms64", "card": card_line(),
           "variant": PINN_LEVERS["variant"],
           "mesh_size": PINN_LEVERS["mesh_size"], "adam_epochs": n,
           "scheduled_epochs": PINN_LEVERS["scheduled_epochs"],
           "adam_seconds": row["adam_s"],
           "epochs_per_s": n / row["adam_s"], "adam_loss_first": h[0],
           "adam_loss_last": h[n - 1], "lbfgs_steps": len(lb),
           "scheduled_lbfgs_steps": PINN_LEVERS["scheduled_lbfgs_steps"],
           "lbfgs_seconds": lbfgs_s,
           "lbfgs_steps_per_s": len(lb) / lbfgs_s,
           "lbfgs_loss_first": lb[0], "lbfgs_loss_last": lb[-1],
           "rel_l2": row["rel_l2"], "l2": row["l2"],
           "max_error": row["max_error"]}
    emit(out)
    check(all(math.isfinite(v) for v in h + [row["rel_l2"]]),
          "PINN levers cell: a loss or an error is not finite")
    check(len(lb) == PINN_LEVERS["lbfgs_steps"],
          "PINN levers cell: L-BFGS steps missing")
    check(lb[-1] <= lb[0], f"PINN levers cell: the L-BFGS loss rose "
          f"{lb[0]:.3e} -> {lb[-1]:.3e}")
    return out


# Slice 12, time-varying winds (models/unsteady): the rows of
# scripts/torch_port_unsteady_scale.py, (mesh size, nt, reassemble_every),
# and the gradient cell.
W_ROWS = {513: (1001, 50), 1025: (2001, 100)}
W_ITERS = 8
W_HALVED_TOL = 5e-3
W_FUSED_VS_SCAN_TOL = 1e-4
# W3 at 257^2: nt=257, not 65, where Chebyshev-8 diverges (dt |v| / h = 1,
# D dt / h^2 = 1.9; max|u| 6e4 at T in the port and its plain version).
W3 = dict(ms=257, nt=257, every=16, omega_t=0.5, omega_obs=0.4, step=3e-3)


def unsteady_scale():
    """scripts/torch_port_unsteady_scale.py (problem, solve arguments,
    timing, the chunk breakdown)."""
    from scripts import torch_port_unsteady_scale as mod

    return mod


def phase_w1(meshes):
    """W1: the turning wind at 1025^2 (nt=2001, a chunk every 100 steps;
    CN, Chebyshev-8, extrapolated, fused_hbm, f32), a fresh B4 stack per
    chunk. The run with a chunk every 50 steps first (the warm-up, and the
    halving check, <= 5e-3), then the timed run: warm steps/s with the
    reassembly, B4's launches (2,000), final_max, rel_l2, one middle
    chunk's seconds in assembly and interval against its B4 sweep, and
    that chunk's B4 step against plain_canvas_step on its stack
    (TOL["float32"]). Then 513^2 (nt=1001, every 50): the fused chunks
    against the scan-Chebyshev chunks at the same k, in f32 each with its
    own interval estimate (reported), and in f64 on the fused chunks'
    intervals (IntervalTape; <= 1e-4 of max|u|), with the f32 run against
    the f64 one (reported). The chunks' interval estimates run on B3 (a
    matvec and its transpose per power iteration). The f32 meshes are
    main's, retimed. Returns (B4 launches, B3 launches, the largest B4
    error, the 513^2 fused state, its mesh data)."""
    import torch

    from airpollution_tpu_torch.models.crbe import assemble_canvas
    from airpollution_tpu_torch.models.unsteady import solve_time_varying
    from airpollution_tpu_torch.ops import fused_hbm, fused_solver, stencil

    sc = unsteady_scale()
    p = sc.problem()
    out = {"phase": "w1_time_varying", "card": card_line(), "k": W_ITERS}
    nt, every = W_ROWS[1025]
    n_steps = nt - 1
    md = retimed(meshes[(1025, "float32")], nt)
    out.update({"ms": 1025, "nt": nt, "reassemble_every": every,
                "dofs": md.number_of_segments})
    halved, out["halved_first_solve_s"] = sc.timed(
        lambda: solve_time_varying(p, md, **sc.chunk_kwargs(
            every // 2, W_ITERS)), md.device)
    reset_counts()
    u, secs = sc.timed(lambda: solve_time_varying(
        p, md, **sc.chunk_kwargs(every, W_ITERS)), md.device)
    launches = launches_of("B4")
    b3 = launches_of("B3")
    out.update({"warm_solve_s": secs, "steps_per_s": n_steps / secs,
                "b4_launches": launches, "b3_launches": b3,
                "chunks": n_steps // every})
    check(b3 > 0, "W1: the interval estimate launched no B3")
    check(launches == n_steps, f"W1: {launches} B4 launches, not {n_steps}")
    check(bool(torch.isfinite(u).all()), "W1: the solve is not finite")
    out["final_max"] = float(u.abs().max())
    out["rel_l2"] = sc.rel_l2(u[0], md, p)
    out["halved_chunk_rel_maxdiff"] = rel_max(halved, u)
    check(out["halved_chunk_rel_maxdiff"] <= W_HALVED_TOL,
          f"W1: halving reassemble_every moves the answer by "
          f"{out['halved_chunk_rel_maxdiff']:.3e} > {W_HALVED_TOL}")
    out["chunk"] = sc.chunk_breakdown(md, p, every, W_ITERS)
    # One chunk's B4 launch against plain_canvas_step on its stack.
    dt = float(md.domain.T) / n_steps
    pattern = stencil.family_pattern(md)
    t0 = (n_steps // every // 2) * every * dt
    with torch.no_grad():
        coeffs, mass, diag = assemble_canvas(md, p, dt, 2,
                                             coeff_time=t0 + 0.5 * every * dt)
        perm = torch.as_tensor(pattern.perm.astype("int64"),
                               device=md.device)
        mass = torch.where(md.boundary_mask[perm], torch.zeros_like(mass),
                           mass)
        C = fused_hbm.canvas_operator(pattern, coeffs, mass, 1.0 / diag,
                                      torch.float32)
        cheb = fused_solver.cheb_scalars(
            fused_hbm.canvas_interval(pattern, coeffs, diag), W_ITERS,
            torch.float32, md.device)
        u3 = fused_solver.to_canvases(pattern, u[0][perm])
        up3 = fused_solver.to_canvases(pattern, halved[0][perm])
        masks = fused_solver.rect_masks(u3.shape[-1], torch.float32,
                                        md.device)
        ref, _ = fused_hbm.plain_canvas_step(C, cheb, W_ITERS, u3, up3, True,
                                             masks)
        got, got_up = torch.empty_like(u3), torch.empty_like(u3)
        halt = torch.tensor(-1, dtype=torch.int32, device=md.device)
        fused_hbm.canvas_kernel_step(
            C, cheb, W_ITERS, u3, up3, got, got_up, True,
            (1, pattern.c, 1, pattern.c), halt,
            fused_hbm.canvas_plan(W_ITERS, True, torch.float32))
        torch.cuda.synchronize()
        abs_e, rel, _ = rel_err(got, ref)
    out["b4_chunk_step_rel_vs_plain"] = rel
    check(rel <= TOL["float32"], f"W1: a chunk's B4 step vs plain rel err "
          f"{rel:.3e}")
    del md, halved, u, C, u3, up3, ref, got, got_up
    # 513^2: fused chunks against the scan-Chebyshev chunks, in f32 with
    # each route's own interval estimate (reported), and in f64 on the
    # same intervals (gated): in f32, rounding alone moves this row's
    # answer by ~6e-4 (fused f32 against fused f64, the same intervals).
    nt5, every5 = W_ROWS[513]
    md5 = retimed(meshes[(513, "float32")], nt5)
    kw5 = sc.chunk_kwargs(every5, W_ITERS)
    scan_kw = dict(kw5, matvec_impl="scan", solver="chebyshev")
    fused, s_fused = sc.timed(lambda: solve_time_varying(p, md5, **kw5),
                              md5.device)
    scan, s_scan = sc.timed(lambda: solve_time_varying(p, md5, **scan_kw),
                            md5.device)
    md64 = sc.mesh_data(513, nt5, dtype=torch.float64)
    tape = IntervalTape()
    with tape.record():
        fused64 = solve_time_varying(p, md64, **kw5)
    with tape.replay():
        scan64, s_scan64 = sc.timed(
            lambda: solve_time_varying(p, md64, **scan_kw), md64.device)
    out.update({"ms_513_fused_solve_s": s_fused,
                "ms_513_scan_solve_s": s_scan,
                "ms_513_scan_f64_solve_s": s_scan64,
                "ms_513_final_max": float(fused.abs().max()),
                "ms_513_rel_l2": sc.rel_l2(fused[0], md5, p),
                "ms_513_fused_vs_scan_own_intervals_rel": rel_max(fused, scan),
                "ms_513_fused_f32_vs_f64_rel": rel_max(fused.double(),
                                                       fused64),
                "ms_513_fused_vs_scan_f64_same_intervals_rel": rel_max(
                    fused64, scan64)})
    check(out["ms_513_fused_vs_scan_f64_same_intervals_rel"]
          <= W_FUSED_VS_SCAN_TOL,
          f"W1 513^2: fused vs scan-Chebyshev chunks (f64, same intervals) "
          f"{out['ms_513_fused_vs_scan_f64_same_intervals_rel']:.3e} > "
          f"{W_FUSED_VS_SCAN_TOL}")
    del md64, fused64, scan64
    emit(out)
    return launches, b3, abs_e, fused, md5


class IntervalTape:
    """The per-chunk Chebyshev intervals of a fused time-varying solve
    (fused_hbm.canvas_interval), recorded in order, then handed to the
    scan chunks' loops (run_time_loop's ``bounds``) in the same order: the
    two routes then run one algorithm on the same intervals, as PERF.md
    section 2's fused-vs-scan gate compares them (the steady cells share
    the solver's interval)."""

    def __init__(self):
        self.bounds = []

    @contextlib.contextmanager
    def record(self):
        from airpollution_tpu_torch.ops import fused_hbm

        real = fused_hbm.canvas_interval

        def recorded(*a):
            self.bounds.append(real(*a))
            return self.bounds[-1]

        fused_hbm.canvas_interval = recorded
        try:
            yield
        finally:
            fused_hbm.canvas_interval = real

    @contextlib.contextmanager
    def replay(self):
        from airpollution_tpu_torch.models import unsteady

        real = unsteady.run_time_loop
        taped = iter(self.bounds)

        def replayed(ops, u0, **kw):
            return real(ops, u0, **dict(kw, bounds=next(taped)))

        unsteady.run_time_loop = replayed
        try:
            yield
        finally:
            unsteady.run_time_loop = real


def phase_w2(fused, md):
    """W2: W1's 513^2 row on 4 row blocks of one card,
    solve_time_varying(mesh=...), which is B9 with a stack rebuilt from
    assemble_canvas at each chunk (coeff_time), against W1's whole-canvas
    fused chunks (<= 1e-6 of max|u|; bitwise reported)."""
    import torch

    from airpollution_tpu_torch.models.unsteady import solve_time_varying
    from airpollution_tpu_torch.parallel import make_mesh

    sc = unsteady_scale()
    nt, every = W_ROWS[513]
    n_steps = nt - 1
    out = {"phase": "w2_time_varying_blocks", "card": card_line(),
           "ms": 513, "nt": nt, "reassemble_every": every, "k": W_ITERS,
           "blocks": BLOCK_MESH["mp"]}
    reset_counts()
    got, secs = sc.timed(lambda: solve_time_varying(
        sc.problem(), md, mesh=make_mesh(BLOCK_MESH),
        **sc.chunk_kwargs(every, W_ITERS)), md.device)
    launches = launches_of("B9")
    check(launches == BLOCK_MESH["mp"] * n_steps and launches_of("B4") == 0,
          f"W2: {launches} B9 launches, not {BLOCK_MESH['mp'] * n_steps}")
    diff = max_rel(got, fused)
    out.update({"solve_s": secs, "steps_per_s": n_steps / secs,
                "b9_launches": launches,
                "max_block_minus_whole_rel": diff,
                "bitwise_equal": bool(torch.equal(got, fused))})
    check(diff <= BLOCK_TOL, f"W2: max|block - whole| {diff:.3e}")
    emit(out)
    return launches


@contextlib.contextmanager
def plain_raw_sweeps():
    """The differentiable fused chunks with their B4-raw sweeps replaced by
    linalg's plain Chebyshev polynomial on the stencil matvec (forward
    and transposed): the same chunks, intervals and loop on the plain
    path."""
    from airpollution_tpu_torch.ops import fused_hbm

    real = fused_hbm.raw_solve_pair
    fused_hbm.raw_solve_pair = lambda *a, **k: (None, None)
    try:
        yield
    finally:
        fused_hbm.raw_solve_pair = real


def phase_w3():
    """W3: the gradient of a misfit through the differentiable fused
    chunks (B4-raw forward and adjoint) at 257^2, nt=257, a chunk every 16
    steps (CN, Chebyshev-8, extrapolated, f32): d/d omega_t of
    sum((u_T - c_obs)^2), c_obs the closed form at T of a turning rate of
    0.4, at omega_t = 0.5. Held against the same chunks on the plain
    polynomial (<= 2e-5 relative) and against a central difference of the
    forward fused chunks (step 3e-3, <= 5e-3); the scan route's gradient
    (matvec_impl="scan", Chebyshev-8 with its own interval estimate on the
    ELL operator) is reported beside them. sum(u_T^2) is not the loss:
    the puff's L2 norm does not change as the wind turns, so its
    derivative is below float32's resolution and, in float64, dominated
    by the intervals' dependence on omega_t, which the adjoint holds
    fixed."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.unsteady import solve_time_varying

    sc = unsteady_scale()
    md = sc.mesh_data(W3["ms"], W3["nt"])
    t_col = torch.full((md.number_of_segments, 1), float(md.domain.T),
                       device=md.device)
    obs = apt.TurningWindProblem(
        speed=1.0, omega_t=W3["omega_obs"], D=0.3).analytical_solution(
            torch.cat([md.midpoints, t_col], dim=1))
    kw = sc.chunk_kwargs(W3["every"], W_ITERS)

    def loss(u):
        return torch.sum((u[-1] - obs) ** 2)

    def grad(**extra):
        om = torch.tensor(W3["omega_t"], device=md.device,
                          requires_grad=True)
        p = apt.TurningWindProblem(speed=1.0, omega_t=om, D=0.3)
        u = solve_time_varying(p, md, differentiable=True,
                               **dict(kw, **extra))
        (g,) = torch.autograd.grad(loss(u), om)
        return float(g)

    out = {"phase": "w3_time_varying_gradient", "card": card_line(),
           "ms": W3["ms"], "nt": W3["nt"], "reassemble_every": W3["every"],
           "k": W_ITERS, "omega_t": W3["omega_t"]}
    reset_counts()
    g, secs = sc.timed(grad, md.device)
    launches = launches_of("B4-raw")
    check(launches > 0, "W3: the fused gradient launched no B4-raw")
    with plain_raw_sweeps():
        g_plain = grad()
    check(launches_of("B4-raw") == launches,
          "W3: the plain twin launched B4-raw")
    g_scan = grad(matvec_impl="scan", solver="chebyshev")
    h = W3["step"]

    def forward(w):
        with torch.no_grad():
            return float(loss(solve_time_varying(apt.TurningWindProblem(
                speed=1.0, omega_t=w, D=0.3), md, **kw)).double())

    fd = (forward(W3["omega_t"] + h) - forward(W3["omega_t"] - h)) / (2 * h)
    out.update({"grad_fused": g, "grad_plain": g_plain, "grad_scan": g_scan,
                "central_difference": fd, "fused_gradient_s": secs,
                "b4_raw_launches": launches,
                "rel_vs_plain": abs(g - g_plain) / abs(g_plain),
                "rel_vs_scan_route": abs(g - g_scan) / abs(g_scan),
                "rel_vs_central_difference": abs(g - fd) / abs(fd)})
    check(out["rel_vs_plain"] <= 2e-5,
          f"W3: fused vs plain gradient {out['rel_vs_plain']:.3e} > 2e-5")
    check(out["rel_vs_central_difference"] <= 5e-3,
          f"W3: fused gradient vs central difference "
          f"{out['rel_vs_central_difference']:.3e} > 5e-3")
    emit(out)
    return launches


def phase_time_varying(meshes):
    """Slice 12: W1, W2 and W3, then their launches on the kernels' paths
    and the phases' seconds."""
    t0 = time.perf_counter()
    b4, b3, b4_err, fused, md = phase_w1(meshes)
    b9 = phase_w2(fused, md)
    del fused, md
    raw = phase_w3()
    emit({"phase": "time_varying", "card": card_line(),
          "seconds": time.perf_counter() - t0})
    return {"B4": b4, "B3": b3, "B9": b9, "B4-raw": raw}, b4_err


# Slice 13: the command line and the routes it exposes.
# X1's depth: 101 steps (1001 until slice 17; its route, k and the
# scan-vs-B2 gate do not need 1,000 steps, and the cut pays for D1).
X1 = dict(mesh_size=2049, nt=101)
X1_F64_MS = 513
X1_F64_NT = 101  # the f64 comparison's horizon (201 until slice 17)
X1_F64_TOL = 1e-10  # fused against scan, f64, one shared interval
X1_REL_L2_TOL = 5e-4  # |delta rel_l2| at 2049^2, f32, each its own interval
X2_TOL = 1e-5  # spectral against Jacobi, of max|u|
X2_SOLVER_TOL = 1e-9
X2_MAXITER = 50
X2_NT = 201
X3_MS_TOL = 1e-4  # multispecies uniform against fused_hbm: final masses
# The inverse subcommands cost ~0.4 s per Adam step and 8 time steps on
# the card (host-bound eager autograd), so X3 fits with fewer steps than
# the JAX package's tests/test_cli.py, under its gates: invert from its
# D0 in 10 steps at lr 0.15 (60 at 0.3 there; at 0.3, 10 steps overshoot
# to D ~0.63); fit-source on a 9-step trajectory (17 there) from a start
# nearer the emitter (q0 1, (0, 0) there) in 50 steps (500 there; 30 end
# at q ~1.74, outside its gate).
X3_INVERT = ["--steps", 10, "--lr", 0.15]
X3_FIT_SOURCE = ["--sensors", 40, "--steps", 50, "--lr", 0.15, "--q0", 1.5,
                 "--xy0", -3.0, 2.0]


def run_cli(argv):
    """``cli.main(argv)`` in this process: (its return value, its JSON line,
    wall seconds). The line is also printed, as the command prints it."""
    import io

    from airpollution_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    return result, json.loads(text.strip().splitlines()[-1]), wall


def phase_x1_default_route(domain):
    """X1: ``python -m airpollution_tpu_torch solve --mesh_size 2049 --nt
    1001`` with the parser's defaults, through ``cli.main``: 'auto' ->
    the uniform scan route with patch assembly -> BiCGStab -> the
    large-mesh policy (float32). Its route, steps/s, rel_l2 and the
    seconds outside the timed solve (mesh set-up, patch scalars, the
    interval; and the error norms after it); no kernel launches on that
    route. Then the fused route at the same size and k (fused_hbm,
    Chebyshev, kernel B2) on its own interval and on the scan's, and at
    513^2 in float64 (nt=X1_F64_NT) the fused route against the uniform
    scan on one shared interval. Returns (B2's launches, the 2049^2 mesh
    data of the command's solve)."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver

    t0 = time.perf_counter()
    reset_counts()
    scan, line, wall = run_cli(["solve", "--mesh_size", X1["mesh_size"],
                                "--nt", X1["nt"]])
    scan_launches = {kid: launches_of(kid) for kid in KERNELS}
    check(not any(scan_launches.values()),
          f"X1: the uniform scan route launched kernels {scan_launches}")
    md = scan.mesh_data
    n_steps = md.nt - 1
    cheb = scan.solver_method == "chebyshev"
    out = {"phase": "x1_default_route_2049", "card": card_line(),
           "argv": f"solve --mesh_size {X1['mesh_size']} --nt {X1['nt']}",
           "dofs": md.number_of_segments, "nt": md.nt,
           "matvec_impl": scan.matvec_impl,
           "assembly": "patch" if scan._use_patch() else "full",
           "solver_method": scan.solver_method,
           "chebyshev_iters": scan.chebyshev_iters if cheb else None,
           "solver_tol": scan.solver_tol,
           "cheb_factor": getattr(scan, "_cheb_factor", None),
           "cheb_bounds": list(scan._cheb_bounds) if cheb else None,
           "policy_applied": scan._large_mesh_policy_applied,
           "steps_per_s": n_steps / scan.solve_time,
           "solve_s": scan.solve_time, "rel_l2": line["rel_l2"],
           "seconds_to_first_step": wall - scan.solve_time}
    check(scan.matvec_impl == "uniform" and scan._use_patch()
          and scan._large_mesh_policy_applied,
          f"X1: 'auto' took {scan.matvec_impl}, patch {scan._use_patch()}, "
          f"policy {scan._large_mesh_policy_applied}")
    u_scan = scan.solutions[-1]
    check(bool(torch.isfinite(u_scan).all()), "X1: non-finite scan state")
    k = scan.chebyshev_iters if cheb else B8_ITERS
    problem = scan.problem
    b2 = 0
    for tag, bounds in (("own", None), ("shared", scan._cheb_bounds)):
        if tag == "shared" and (bounds is None or tuple(bounds) == tuple(
                out["fused_own_cheb_bounds"])):
            # The fused route estimated the scan's interval bit for bit:
            # its own run is the shared-interval run.
            out["shared_is_own"] = bounds is not None
            for key in ("max_abs_diff", "max_rel_diff"):
                out[f"fused_shared_{key}"] = out[f"fused_own_{key}"]
            continue
        fused = CRBESolver(domain, problem, md, matvec_impl="fused_hbm",
                           solver_method="chebyshev", chebyshev_iters=k,
                           cheb_bounds=bounds)
        reset_counts()
        fused.solve(store_solutions=False)
        b2 += launches_of("B2")
        check(fused.fused_kernel == "B2" and launches_of("B2") == n_steps,
              f"X1 fused {tag}: {launches_of('B2')} B2 launches")
        u = fused.solutions[-1]
        rel = fused.compute_errors(problem.analytical_solution)[0]
        out.update({
            f"fused_{tag}_rel_l2": rel,
            f"fused_{tag}_steps_per_s": n_steps / fused.solve_time,
            f"fused_{tag}_max_abs_diff": float((u - u_scan).abs().max()),
            f"fused_{tag}_max_rel_diff": max_rel(u, u_scan)})
        if tag == "own":
            out["fused_own_cheb_bounds"] = list(fused._cheb_bounds)
            out["delta_rel_l2"] = abs(rel - line["rel_l2"])
        del fused, u
    del scan, u_scan
    # 513^2, float64: fused (B2) against the uniform scan, one interval.
    md64 = apt.MeshData(apt.create_mesh(X1_F64_MS, 20.0), domain,
                        nt=X1_F64_NT, dtype=torch.float64)
    ref = CRBESolver(domain, problem, md64, matvec_impl="uniform",
                     solver_method="chebyshev", chebyshev_iters=k)
    ref.solve(store_solutions=False)
    fused = CRBESolver(domain, problem, md64, matvec_impl="fused_hbm",
                       solver_method="chebyshev", chebyshev_iters=k,
                       cheb_bounds=ref._cheb_bounds)
    fused.set_operators(ref._ops)
    reset_counts()
    fused.solve(store_solutions=False)
    b2 += launches_of("B2")
    out["f64_513_max_rel_diff"] = max_rel(fused.solutions[-1],
                                          ref.solutions[-1])
    out["f64_513_k"] = k
    out["f64_513_nt"] = X1_F64_NT
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    check(out["delta_rel_l2"] <= X1_REL_L2_TOL,
          f"X1: |rel_l2 fused - scan| {out['delta_rel_l2']:.3e} at 2049^2")
    check(out["f64_513_max_rel_diff"] <= X1_F64_TOL,
          f"X1: f64 513^2 fused vs scan {out['f64_513_max_rel_diff']:.3e}")
    return b2, md


def phase_x2_spectral(domain):
    """X2: BiCGStab with the spectral preconditioner against Jacobi at
    1025^2 (full assembly, the stencil scan path, nt=X2_NT, maxiter
    X2_MAXITER) in float64 at solver_tol X2_SOLVER_TOL, so that the
    solver's tolerance, summed over the steps, stays under the gate: the
    two answers within X2_TOL of max|u|; iterations per step and steps/s
    of each."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver

    t0 = time.perf_counter()
    md = apt.MeshData(apt.create_mesh(1025, 20.0), domain, nt=X2_NT,
                      dtype=torch.float64)
    problem = apt.Problem(sigma=1.0)
    out = {"phase": "x2_spectral_1025", "card": card_line(), "ms": 1025,
           "nt": md.nt, "dofs": md.number_of_segments, "dtype": "float64",
           "solver_tol": X2_SOLVER_TOL}
    ops, states = None, {}
    for pc in ("jacobi", "spectral"):
        s = CRBESolver(domain, problem, md, matvec_impl="stencil",
                       preconditioner=pc, solver_tol=X2_SOLVER_TOL,
                       solver_maxiter=X2_MAXITER)
        if ops is None:
            ops = s.build_global_matrices()
        else:
            s.set_operators(ops)
        reset_counts()
        s.solve(store_solutions=False, collect_iters=True)
        check(not any(launches_of(kid) for kid in KERNELS),
              f"X2 {pc}: the stencil scan launched a kernel")
        its = s.solver_iterations
        states[pc] = s.solutions[-1]
        out.update({f"{pc}_mean_iters": statistics.fmean(its),
                    f"{pc}_max_iters": max(its),
                    f"{pc}_steps_per_s": (md.nt - 1) / s.solve_time})
        check(bool(torch.isfinite(states[pc]).all()), f"X2 {pc}: non-finite")
    out["max_rel_diff"] = max_rel(states["spectral"], states["jacobi"])
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    check(out["max_rel_diff"] <= X2_TOL,
          f"X2: spectral vs Jacobi {out['max_rel_diff']:.3e} of max|u|")


def phase_x3_cli():
    """X3: the command line end to end, small: ``solve`` BE with --save
    and CN with --save_all, a sourced strided trajectory, ``invert`` and
    ``fit-source`` on the saved fields (recovery gates of the JAX
    package's tests/test_cli.py), ``multispecies --matvec_impl uniform``
    against ``--matvec_impl fused_hbm`` (Strang, Chebyshev, kernel B6),
    and ``pinn --epochs 200 --checkpoint_dir``; ``solve --matvec_impl
    fused`` at 65^2 (kernel B1). The line is printed before its gates are
    read. Returns {kernel id: launches} (B1, B6)."""
    import math
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    out = {"phase": "x3_cli", "card": card_line()}
    gates = []
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tmp = Path(tmp)
        _, be, _ = run_cli(["solve", "--mesh_size", 8, "--nt", 8, "--D",
                            0.3, "--save", tmp / "obs.npz"])
        _, cn, _ = run_cli(["solve", "--mesh_size", 6, "--nt", 5, "--order",
                            2, "--extrapolate", "--save", tmp / "f.npz",
                            "--save_all"])
        rows = np.load(tmp / "f.npz")
        out.update({"solve_be_rel_l2": be["rel_l2"],
                    "solve_cn_rel_l2": cn["rel_l2"],
                    "solve_cn_rows": rows["solutions"].shape[0]})
        gates.append((math.isfinite(be["rel_l2"])
                      and math.isfinite(cn["rel_l2"])
                      and rows["solutions"].shape[0] == 5 and "times" in rows,
                      "X3: solve BE/CN lines or the saved trajectory"))
        reset_counts()
        fused, fline, _ = run_cli(["solve", "--mesh_size", 65, "--nt", 65,
                                   "--matvec_impl", "fused",
                                   "--solver_method", "chebyshev",
                                   "--extrapolate"])
        b1 = launches_of("B1")
        out.update({"solve_fused_kernel": fused.fused_kernel,
                    "solve_fused_b1_launches": b1,
                    "solve_fused_rel_l2": fline["rel_l2"]})
        gates.append((fused.fused_kernel == "B1" and b1 == 1
                      and math.isfinite(fline["rel_l2"]),
                      f"X3: solve --matvec_impl fused took "
                      f"{fused.fused_kernel} with {b1} B1 launches"))
        _, inv, wall = run_cli(["invert", "--mesh_size", 8, "--nt", 8,
                                "--observed", tmp / "obs.npz", "--D0", 0.08]
                               + X3_INVERT)
        out.update({"invert_D_est": inv["D_est"], "invert_s": wall})
        gates.append((abs(inv["D_est"] - 0.3) / 0.3 < 0.15
                      and inv["misfit_last"] < inv["misfit_first"],
                      f"X3: invert recovered D {inv['D_est']}, not 0.3"))
        _, src, _ = run_cli(["solve", "--problem", "gaussian_source", "--q",
                             2.0, "--xs", -4.0, "--ys", 2.5, "--sigma_s",
                             2.0, "--mesh_size", 16, "--nt", 9,
                             "--snapshot_every", 2, "--save",
                             tmp / "src.npz", "--save_all"])
        gates.append((src["rel_l2"] is None
                      and np.load(tmp / "src.npz")["solutions"].shape[0] == 5,
                      "X3: the sourced strided trajectory"))
        _, fit, wall = run_cli(["fit-source", "--observed", tmp / "src.npz",
                                "--mesh_size", 16, "--nt", 9, "--sigma_s",
                                2.0] + X3_FIT_SOURCE)
        out.update({"fit_source_q": fit["q"], "fit_source_xs": fit["xs"],
                    "fit_source_ys": fit["ys"], "fit_source_s": wall})
        gates.append((fit["n_snapshots"] == 4 and fit["n_sensors"] == 40
                      and abs(fit["q"] - 2.0) / 2.0 < 0.1
                      and abs(fit["xs"] + 4.0) < 0.3
                      and abs(fit["ys"] - 2.5) < 0.3
                      and fit["misfit_last"] < fit["misfit_first"] * 1e-2,
                      f"X3: fit-source recovered {fit}"))
        chem = ["multispecies", "--mesh_size", 65, "--nt", 65,
                "--splitting", "strang", "--solver_method", "chebyshev",
                "--source_q", 2.0]
        reset_counts()
        uni, uline, _ = run_cli(chem + ["--matvec_impl", "uniform"])
        gates.append((not any(launches_of(kid) for kid in KERNELS),
                      "X3: multispecies uniform launched a kernel"))
        reset_counts()
        fus, fline, _ = run_cli(chem + ["--matvec_impl", "fused_hbm"])
        b6 = launches_of("B6")
        gates.append((b6 == 64, f"X3: {b6} B6 launches for 64 steps"))
        mass_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(uline["final_masses"], fline["final_masses"]))
        out.update({"multispecies_mass_rel_diff": mass_rel,
                    "multispecies_max_rel_diff": max_rel(
                        uni.solutions[-1], fus.solutions[-1]),
                    "multispecies_b6_launches": b6,
                    "multispecies_uniform_steps_per_s":
                        uline["steps_per_sec"],
                    "multispecies_fused_steps_per_s": fline["steps_per_sec"]})
        gates.append((mass_rel <= X3_MS_TOL,
                      f"X3: multispecies masses uniform vs fused "
                      f"{mass_rel:.3e}"))
        _, pinn, _ = run_cli(["pinn", "--mesh_size", 16, "--nt", 16,
                              "--epochs", 200, "--checkpoint_dir",
                              tmp / "ck"])
        out.update({"pinn_final_loss": pinn["final_loss"],
                    "pinn_epochs_run": pinn["epochs_run"],
                    "pinn_train_time_s": pinn["train_time_s"]})
        gates.append((pinn["epochs_run"] == 200
                      and math.isfinite(pinn["final_loss"])
                      and (tmp / "ck" / "pinn_latest.npz").exists(),
                      "X3: pinn epochs, loss or checkpoint"))
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for cond, msg in gates:
        check(cond, msg)
    return {"B1": b1, "B6": b6}


def phase_cli(domain, x3_launches):
    """Slice 13: X1 and X2, then the cli line; X3 ran in a scripts'
    process (child_x3), ``x3_launches`` its launches. Returns ({kernel id:
    launches} of the new phases' fused routes (B2 in X1, B1 and B6 in X3),
    X1's 2049^2 mesh data)."""
    t0 = time.perf_counter()
    b2, md_2049 = phase_x1_default_route(domain)
    launches = {"B2": b2}
    phase_x2_spectral(domain)
    launches.update(x3_launches)
    emit({"phase": "cli", "card": card_line(),
          "seconds": time.perf_counter() - t0})
    return launches, md_2049


def phase_pinn(domain):
    """Slice 11: the PINN's card-against-CPU check, its widest cell and its
    levers cell, then the pinn line."""
    import airpollution_tpu_torch as apt

    t0 = time.perf_counter()
    phase_pinn_card_vs_cpu()
    wide = phase_pinn_widest(apt.MeshData(apt.create_mesh(128, 20.0),
                                          domain, nt=128))
    levers = phase_pinn_levers()
    emit({"phase": "pinn", "card": card_line(),
          "widest_epochs_per_s": wide["epochs_per_s"],
          "levers_epochs_per_s": levers["epochs_per_s"],
          "levers_lbfgs_steps_per_s": levers["lbfgs_steps_per_s"],
          "seconds": time.perf_counter() - t0})


# Slice 14: the rest of the inverse layer (diagnostics/inverse.py), F1-F4.
# F1 runs I1's mesh and horizon (513^2, nt=128, f32, engine "auto" -> B4's
# raw mode) with its 8 snapshot rows, 5 Adam steps per fit.
F1 = dict(mesh_size=513, nt=128, steps=5)
F1_SIDES = ("right", "top")
# tests/test_robin.py's exchange twin, scaled up: truth alphas and
# compensation points, 1% multiplicative noise, the start; D 0.1 (I1's:
# D dt / h^2 = 1.3), not the twin's 1.0, whose D dt / h^2 = 12.9 at this
# mesh and horizon diverges on Chebyshev-12 with the extrapolated warm
# start (the loss reached 1.6e28 on an H100).
F1_EXCHANGE = dict(D=0.1, alphas=(0.6, 0.15), c_comp=(0.05, 0.2),
                   alpha0=0.25, c_comp0=0.0, lr=0.05, noise=0.01)
# The wind fit: omega 0.1 (not the JAX test's 0.15: at 513^2, nt=128 the
# rotation's corner Courant number dt |v| / h is 2.85 at 0.1 and 3.4 at
# 0.12, where the Chebyshev solve diverges already,
# scripts/torch_port_wind_fit_stability.py), D 0.08, the start 0.05 and a
# 3-point grid below the truth.
F1_WIND = dict(omega=0.1, D=0.08, sigma=1.5, x0=5.0, y0=0.0, omega0=0.05,
               grid=(0.02, 0.05, 0.08), lr=0.01)
# 4D-Var of the JAX test's plume (tests/test_inverse.py:293), from a zero
# field; lr below the field's amplitude (max u0 = 1/(4 pi)).
F1_IC = dict(v=(1.0, 0.5), D=0.1, sigma=2.0, lr=0.002, smoothness=1e-4)
F_GRAD_TOL = 2e-5  # B4-raw against its plain polynomial, as W3
F3_TOL = 1e-10  # card against CPU, f64
F3_R = ((0.25, 0.0), (-0.25, 0.1))
F3_R_START = ((0.2, 0.01), (-0.2, 0.15))
# F4: the JAX CLI's keys of each line (airpollution_tpu/cli.py).
F4_KEYS = {
    "fit_ic": {"method", "n_dofs", "n_sensors", "n_snapshots", "smoothness",
               "misfit_first", "misfit_last", "steps",
               "rel_l2_vs_problem_ic"},
    "fit_deposition": {"method", "alphas", "n_snapshots", "misfit_first",
                       "misfit_last", "steps"},
    "fit_surface_exchange": {"method", "exchange", "n_snapshots",
                             "misfit_first", "misfit_last", "steps"},
}


def f1_exchange(md, idx):
    """The exchange fit: (observations, gradient at the start, the fit)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse

    c = F1_EXCHANGE
    p = apt.SquarePulseProblem(v=(0.0, 0.0), D=c["D"], lo=10.0, hi=20.0)
    p.robin_sides = dict(zip(F1_SIDES, c["alphas"]))
    g_true = {s: a * cc for s, a, cc in zip(F1_SIDES, c["alphas"],
                                            c["c_comp"])}
    with torch.no_grad():
        obs = inverse.solve_snapshots(p, md, indices=idx,
                                      robin_g_const=g_true)
    rng = np.random.default_rng(0)
    obs = obs * (1.0 + c["noise"] * torch.as_tensor(
        rng.standard_normal(tuple(obs.shape)), dtype=obs.dtype,
        device=obs.device))

    def grad():
        la = torch.full((2,), math.log(c["alpha0"]), device=md.device,
                        requires_grad=True)
        cc = torch.full((2,), c["c_comp0"], device=md.device,
                        requires_grad=True)
        alphas = {s: torch.exp(la[i]) for i, s in enumerate(F1_SIDES)}
        g = {s: alphas[s] * cc[i] for i, s in enumerate(F1_SIDES)}
        pred = inverse.solve_snapshots(p, md, indices=idx,
                                       robin_alpha=alphas, robin_g_const=g)
        return torch.cat(torch.autograd.grad(
            torch.mean((pred - obs) ** 2), (la, cc)))

    def fit(on_step):
        out, losses = inverse.fit_surface_exchange(
            obs, md, p, alpha0=c["alpha0"], c_comp0=c["c_comp0"],
            snapshot_indices=idx, steps=F1["steps"], lr=c["lr"],
            on_step=on_step)
        return {s: {"v_d": v, "c_comp": cc} for s, (v, cc) in out.items()}, \
            losses

    return grad, fit


def f1_wind(md, idx):
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse

    c = F1_WIND
    release = dict(sigma=c["sigma"], x0=c["x0"], y0=c["y0"])
    with torch.no_grad():
        obs = inverse.solve_snapshots(apt.RotatingPlumeProblem(
            omega=c["omega"], D=c["D"], **release), md, indices=idx)

    def grad():
        om = torch.tensor(c["omega0"], device=md.device, requires_grad=True)
        pred = inverse.solve_snapshots(apt.RotatingPlumeProblem(
            omega=om, D=c["D"], **release), md, indices=idx)
        (g,) = torch.autograd.grad(torch.mean((pred - obs) ** 2), om)
        return g.reshape(1)

    def fit(on_step):
        return inverse.fit_wind(
            obs, md, snapshot_indices=idx, omega0=c["omega0"], D=c["D"],
            steps=F1["steps"], lr=c["lr"], omega_grid=c["grid"],
            on_step=on_step, **release)

    return grad, fit


def f1_ic(md, idx):
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.models.crbe import assemble
    from airpollution_tpu_torch.ops import sparse

    c = F1_IC
    p = apt.Problem(v=c["v"], D=c["D"], sigma=c["sigma"])
    with torch.no_grad():
        obs = inverse.solve_snapshots(p, md, indices=idx)
    n = md.number_of_segments
    K1 = assemble(md, apt.Problem(v=(0.0, 0.0), D=1.0), 1.0, 1).stiffness

    def grad():
        # The 4D-Var objective at half the true field: B7a forward and
        # transposed in the roughness term.
        u0 = (0.5 * p.initial_condition_fn(md.midpoints)).requires_grad_()
        pred = inverse.solve_snapshots(p, md, indices=idx, u0=u0)
        loss = (torch.mean((pred - obs) ** 2)
                + c["smoothness"] * (u0 @ sparse.ell_matvec(K1, u0)) / n)
        (g,) = torch.autograd.grad(loss, u0)
        return g

    def fit(on_step):
        u0, losses = inverse.fit_initial_condition(
            obs, md, p, snapshot_indices=idx, steps=F1["steps"],
            lr=c["lr"], smoothness=c["smoothness"], on_step=on_step)
        true = p.initial_condition_fn(md.midpoints)
        return {"rel_l2_vs_true_ic": float(torch.linalg.norm(u0 - true)
                                           / torch.linalg.norm(true))}, \
            losses

    return grad, fit


def phase_f1():
    """F1: fit_surface_exchange, fit_wind (with its omega grid) and
    fit_initial_condition at I1's mesh and horizon (513^2, nt=128, f32,
    engine "auto": B4's raw mode forward and adjoint over the per-DOF
    canvases, with the traced Robin alphas and the wind in them; the
    4D-Var roughness on B7a forward and transposed). For each fit: the
    misfit's gradient at the start through B4-raw against the same
    through its plain polynomial (<= F_GRAD_TOL), B4-raw launched (and
    B7a for the 4D-Var fit), then F1["steps"] Adam steps that must lower
    the loss; seconds and launches per Adam step. Returns {kernel id:
    launches}."""
    import statistics as st

    import torch

    import airpollution_tpu_torch as apt
    from scripts import torch_port_source_inversion as si

    t_start = time.perf_counter()
    md = apt.MeshData(apt.create_mesh(F1["mesh_size"], 20.0), apt.Domain(),
                      nt=F1["nt"])
    idx = si.snapshot_indices(md.nt)
    out = {"phase": "f1_inverse_fits_513", "card": card_line(),
           "ms": F1["mesh_size"], "nt": F1["nt"], "k": 12,
           "snapshots": idx, "adam_steps": F1["steps"]}
    launches = {"B4-raw": 0, "B7a": 0, "B3": 0}
    gates = []
    for name, setup in (("exchange", f1_exchange), ("wind", f1_wind),
                        ("ic", f1_ic)):
        t0 = time.perf_counter()
        reset_counts()
        grad, fit = setup(md, idx)
        g = grad()
        raw, b7 = launches_of("B4-raw"), launches_of("B7a")
        with plain_raw_sweeps():
            g_plain = grad()
        rel = grad_rel(g, g_plain)
        stamps, counts = [], []

        def on_step(i, loss):
            stamps.append(time.perf_counter())
            counts.append((launches_of("B4-raw"), launches_of("B7a")))

        torch.cuda.synchronize()
        fit_t0 = time.perf_counter()
        result, losses = fit(on_step)
        per_step = [b - a for a, b in zip([fit_t0] + stamps, stamps)]
        step_launches = [(b[0] - a[0], b[1] - a[1])
                         for a, b in zip(counts, counts[1:])]
        for kid in launches:
            launches[kid] += launches_of(kid)
        out[name] = {
            "grad_norm": float(torch.linalg.norm(g)),
            "grad_rel_vs_plain": rel, "grad_b4_raw_launches": raw,
            "grad_b7a_launches": b7, **result,
            "loss_first": losses[0], "loss_last": losses[-1],
            "s_per_adam_step_median": st.median(per_step),
            "s_per_adam_step": per_step,
            "b4_raw_launches_per_adam_step": step_launches[-1][0],
            "b7a_launches_per_adam_step": step_launches[-1][1],
            "b3_launches": launches_of("B3"),
            "seconds": time.perf_counter() - t0}
        gates += [
            (rel <= F_GRAD_TOL, f"F1 {name}: gradient through B4-raw vs "
                                f"plain {rel:.3e} > {F_GRAD_TOL}"),
            (raw > 0 and step_launches[-1][0] > 0,
             f"F1 {name}: B4-raw not launched"),
            (all(map(math.isfinite, losses)) and losses[-1] < losses[0],
             f"F1 {name}: loss {losses[0]:.4e} -> {losses[-1]:.4e}")]
        if name == "ic":
            gates.append((b7 > 0 and step_launches[-1][1] > 0,
                          "F1 ic: the roughness launched no B7a"))
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_start
    emit(out)
    for cond, msg in gates:
        check(cond, msg)
    return launches


def f3_run(device):
    """F3's computations on one device at 17^2, nt=17, f64: the
    multispecies snapshots and d sum(u^2)/dR, three Adam steps of
    fit_chemistry (the chain's log-rates), and two receptors' footprints
    (the ELL loop: B7a on the card)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse

    f64 = torch.float64
    domain = apt.Domain(T=4.0)
    md = apt.MeshData(apt.create_mesh(17, 20.0), domain, nt=17, dtype=f64,
                      device=device)
    species = (apt.Problem(sigma=1.0), apt.Problem(sigma=2.0))
    msp = apt.MultiSpeciesProblem(species, np.asarray(F3_R))
    idx = [4, 8, 12, 16]
    kw = dict(tol=1e-12, maxiter=500)
    R = torch.tensor(F3_R_START, dtype=f64, device=device,
                     requires_grad=True)
    u = inverse.solve_multispecies_snapshots(msp, md, R=R, indices=idx, **kw)
    (gR,) = torch.autograd.grad(torch.sum(u ** 2), R)
    with torch.no_grad():
        obs = inverse.solve_multispecies_snapshots(msp, md, indices=idx,
                                                   **kw)

    def make_R(params):
        r1, r2 = torch.exp(params["log_r1"]), torch.exp(params["log_r2"])
        return torch.stack([torch.stack([r1, 0.0 * r1]),
                            torch.stack([-r1, r2])])

    R_fit, _, losses = inverse.fit_chemistry(
        obs, md, species, make_R=make_R,
        init_params={"log_r1": math.log(0.1), "log_r2": math.log(0.3)},
        snapshot_indices=idx, steps=3, lr=0.05, **kw)
    launches = launches_of("B7a")
    F = inverse.receptor_footprint(
        md, domain, apt.Problem(v=(1.0, 0.5), D=0.2),
        [md.number_of_segments // 2, 7], **kw)
    return ({"u": u.detach(), "dR": gR, "R_fit": R_fit,
             "losses": torch.tensor(losses), "footprint": F},
            launches_of("B7a") - launches)


def phase_f3():
    """F3 (no kernel of its own): the differentiable multispecies solve's
    gradient in R, fit_chemistry and receptor_footprint at 17^2, nt=17,
    f64, on the card against the same on the CPU (<= F3_TOL relative);
    B7a launched by the footprint's ELL loop. Returns its B7a launches."""
    t0 = time.perf_counter()
    reset_counts()
    card, b7 = f3_run("cuda")
    cpu, _ = f3_run("cpu")
    rel = {k: float((card[k].cpu() - cpu[k]).abs().max()
                    / cpu[k].abs().max()) for k in card}
    out = {"phase": "f3_multispecies_adjoint_footprint_17",
           "card": card_line(), "card_vs_cpu": rel,
           "dR": card["dR"].tolist(), "R_fit": card["R_fit"].tolist(),
           "losses": card["losses"].tolist(), "footprint_b7a_launches": b7,
           "seconds": time.perf_counter() - t0}
    emit(out)
    for k, v in rel.items():
        check(v <= F3_TOL, f"F3 {k}: card vs CPU {v:.3e} > {F3_TOL}")
    check(b7 > 0, "F3: the footprint launched no B7a")
    check(card["losses"][-1] < card["losses"][0],
          "F3: fit_chemistry's loss did not fall")
    return b7


def phase_f4():
    """F4: ``fit-ic``, ``fit-deposition`` and ``fit-exchange`` through the
    command line (cli.main) at X3's sizes, 5 Adam steps each (f32, the
    scan engine): each line has the JAX CLI's keys (F4_KEYS) and a falling
    misfit. The exchange trajectory (a compensation-point wall) is made
    with inverse.solve_snapshots, as the JAX CLI test makes it."""
    import tempfile

    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.io.checkpoint import save_field

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    pulse = ["--problem", "square_pulse", "--v", 0, 0, "--D", 1.0]
    out = {"phase": "f4_cli_fits", "card": card_line()}
    lines = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tmp = Path(tmp)
        run_cli(["solve", "--mesh_size", 10, "--nt", 9, "--sigma", 2.0,
                 "--save", tmp / "traj.npz", "--save_all"])
        _, lines["fit_ic"], out["fit_ic_s"] = run_cli([
            "fit-ic", "--mesh_size", 10, "--nt", 9, "--sigma", 2.0,
            "--observed", tmp / "traj.npz", "--steps", 5, "--lr", 0.002,
            "--smoothness", 1e-4])
        run_cli(["solve", "--mesh_size", 8, "--nt", 9, *pulse, "--robin",
                 "right=0.5,top=0.5", "--save", tmp / "dep.npz",
                 "--save_all"])
        _, lines["fit_deposition"], out["fit_deposition_s"] = run_cli([
            "fit-deposition", "--mesh_size", 8, "--nt", 9, *pulse,
            "--robin", "right=0.5,top=0.5", "--observed", tmp / "dep.npz",
            "--alpha0", 0.2, "--steps", 5, "--lr", 0.1])
        md = apt.MeshData(apt.create_mesh(8, 20.0), apt.Domain(), nt=9)
        p = apt.SquarePulseProblem(v=(0.0, 0.0), D=1.0)
        p.robin_sides = {"right": 0.5}
        with torch.no_grad():
            obs = inverse.solve_snapshots(p, md,
                                          robin_g_const={"right": 0.05})
        save_field(str(tmp / "exch.npz"), obs, times=md.time_discr)
        _, lines["fit_surface_exchange"], out["fit_exchange_s"] = run_cli([
            "fit-exchange", "--mesh_size", 8, "--nt", 9, *pulse, "--robin",
            "right=0.5", "--observed", tmp / "exch.npz", "--alpha0", 0.2,
            "--c_comp0", 0.05, "--steps", 5, "--lr", 0.05])
    out.update({f"{k}_misfit": [v["misfit_first"], v["misfit_last"]]
                for k, v in lines.items()})
    out["fit_ic_rel_l2_vs_problem_ic"] = lines["fit_ic"][
        "rel_l2_vs_problem_ic"]
    out["fit_deposition_alphas"] = lines["fit_deposition"]["alphas"]
    out["fit_exchange"] = lines["fit_surface_exchange"]["exchange"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for method, keys in F4_KEYS.items():
        line = lines[method]
        check(line["method"] == method and set(line) == keys,
              f"F4: {method} line keys {sorted(line)}")
        check(line["misfit_last"] < line["misfit_first"],
              f"F4: {method} misfit {line['misfit_first']:.4e} -> "
              f"{line['misfit_last']:.4e}")


def phase_inverse_fits():
    """Slice 14: F1, F3 and F4 (F2 is in phase_grad_129), then their line.
    Returns {kernel id: launches} of these phases."""
    t0 = time.perf_counter()
    launches = phase_f1()
    launches["B7a"] += phase_f3()
    phase_f4()
    emit({"phase": "inverse_fits", "card": card_line(),
          "seconds": time.perf_counter() - t0})
    return launches


# Slice 15: ensembles (E1, E2) and the FNO surrogate (N1).
# E1, the CLI's ensemble at its defaults with 16 stations: 32 members at
# 64^2 (12,033 DOFs), nt=128, CN, float32; members against serial solves
# to E_MEMBER_TOL of max|u| (float32 BiCGStab to tol 1e-7, dots summed in
# another order batched than serially).
E1_ARGV = ["ensemble", "--place_sensors", 16]
E_MEMBER_TOL = 1e-5
E_F64_TOL = 1e-10  # batched against serial members and card against CPU
E_F64_DS = (0.01, 0.1, 0.4, 2.0)  # tests/test_torch_port_ensemble.py's
# E2: the row of results_snapshot/ensemble_tpu.csv (scripts/ensemble_demo.py
# at 64 members, 64^2, nt=129, T=5, f64): its accuracy figures, held to
# E2_TOL. They are numbers of the FEM ensemble against its closed form,
# not times.
E2_CSV = {"ensemble_mean_rel_l2": 0.080643,
          "fem_exceedance_mean": (0.013969, 0.007316, 0.003137),
          "analytic_exceedance_mean": (0.013849, 0.007235, 0.003067)}
E2_TOL = 1e-3
E2_SEQUENTIAL = 4  # serial members timed (all 64 would take minutes)
# N1, the CLI's fno at full width (2,365,921 parameters, as
# results_snapshot/fno_surrogate.json): 64^2 mesh (a 63^2 grid), nt=128,
# 128 + 32 problems, batch 16, lr 1.5e-3; the CLI's 2,000 epochs cut to
# 500. The gates of the JAX package's tests/test_fno.py:179-190 (the
# loss falls 10x, relative_l2 on the training rows below 1), and the
# holdout's relative_l2 below 1 too. The holdout gate is a weak one: a
# zero prediction scores 1.0, and an H100 run read 0.983 at 500 epochs
# and 1.115 at 1,000 (PERF.md, section 6; why more epochs read worse was
# not measured). What holds the surrogate's arithmetic is the f64 card
# against CPU comparison to N1_TOL.
N1_ARGV = ["fno", "--mesh_size", 64, "--nt", 128, "--epochs", 500]
N1_TRAIN = 128
N1_PARAMS = 2_365_921
N1_TOL = 1e-10  # card against CPU, f64, relative to the largest value


def e1_f64_members():
    """E1's f64 check at tests/test_torch_port_ensemble.py's size (8^2,
    nt=9, T=2): the member loop's outputs and per-member BiCGStab counts
    on the card against serial CRBESolver(matvec_impl="ell") solves on
    the card. Returns (max difference, counts equal)."""
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import ensemble
    from airpollution_tpu_torch.models import crbe

    dom = apt.Domain(T=2.0)
    md = apt.MeshData(apt.create_mesh(8, 20.0), dom, nt=9,
                      dtype=torch.float64)
    probs = [apt.Problem(v=(1.0, 0.5), D=d) for d in E_F64_DS]
    dt = dom.T / (md.nt - 1)
    worst, same = 0.0, True
    for order in (1, 2):
        batched = ensemble.stack_problems(probs, dtype=torch.float64,
                                          device=md.device)
        sols, its = crbe.run_time_loop(
            ensemble.member_operators(md, probs, dt, order),
            ensemble.member_initial_state(md, batched, len(probs)),
            mesh_data=md, problem=batched, dt=dt, order=order, tol=1e-7,
            maxiter=200, store_solutions=False, collect_iters=True)
        counts = torch.stack(its).T.tolist()
        for k, p in enumerate(probs):
            s = crbe.CRBESolver(dom, p, md, matvec_impl="ell",
                                time_scheme_order=order)
            ref = s.solve(store_solutions=False, collect_iters=True)[0]
            worst = max(worst, float((sols[0, k] - ref).abs().max()))
            same = same and s.solver_iterations == counts[k]
    return worst, same


def b7a_stacked_vs_single(A, X):
    """Whether B7a's stacked product (one launch over the K operators on
    their one shared column index) equals, bit for bit, K launches of one
    operator each (``unstack_ell``): the same products, summed in the
    same order."""
    import torch

    from airpollution_tpu_torch.ops import sparse

    single = torch.stack([sparse.ell_matvec(sparse.unstack_ell(A, k), X[k])
                          for k in range(A.vals.shape[0])])
    return bool(torch.equal(sparse.ell_matvec_stacked(A, X), single))


def e1_kernel_vs_plain(md, problems):
    """B7a's stacked mode on E1's 32 system and K + A operators (one
    shared column index) against its plain version, f32 on E1's mesh and
    f64 on the same problems' f64 assembly. Returns ({dtype: max error
    relative to max|y|}, {the f32 stacked product's ms, its plain
    version's, its bound, and a CSR product's of the block-diagonal
    stack})."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics import ensemble
    from airpollution_tpu_torch.ops import gather, sparse

    out = {}
    md64 = apt.MeshData(md.mesh, md.domain, nt=md.nt, dtype=torch.float64)
    for name, m in (("float32", md), ("float64", md64)):
        ops = ensemble.member_operators(m, problems,
                                        m.domain.T / (m.nt - 1), 2)
        check(ops.system.cols32.dim() == 2 and ops.system.b7.stack
              == len(problems), "E1: the stack does not share its columns")
        X = torch.tensor(np.random.default_rng(5).standard_normal(
            (len(problems), m.number_of_segments)), dtype=m.dtype,
            device=m.device)
        worst = 0.0
        for A in (ops.system, ops.ka):
            y = sparse.ell_matvec_stacked(A, X)
            ref = gather.plain_matvec(A.vals, A.cols, X)
            worst = max(worst, float((y - ref).abs().max()
                                     / ref.abs().max()))
        out[name] = worst
        if name == "float32":
            A = ops.system
            K, n, w = A.vals.shape
            out["float32_bitwise_vs_single_operators"] = \
                b7a_stacked_vs_single(A, X)
            # Bytes: the K value blocks, the one shared column index, x
            # and y, each once.
            b_ms, by = bound(K * n * w * 4 + n * w * 4 + 2 * K * n * 4,
                             2 * K * n * w)
            # The library yardstick: one CSR product of the block-diagonal
            # stack (the K operators' columns offset by k n) with the K
            # states end to end.
            cols = A.cols.expand(K, n, w) + n * torch.arange(
                K, device=X.device).view(K, 1, 1)
            csr = torch.sparse_csr_tensor(
                torch.arange(0, K * n * w + 1, w, device=X.device),
                cols.reshape(-1), A.vals.reshape(-1), size=(K * n, K * n))
            x = X.reshape(-1)
            ref = gather.plain_matvec(A.vals, A.cols, X)
            times = {"ms": cuda_ms(lambda: sparse.ell_matvec_stacked(A, X),
                                   200),
                     "plain_ms": cuda_ms(lambda: gather.plain_matvec(
                         A.vals, A.cols, X), 50),
                     "bound_ms": b_ms, "bound_by": by,
                     "library_ms": cuda_ms(lambda: csr @ x, 200),
                     "library_max_rel_vs_plain": float(
                         ((csr @ x).view(K, n) - ref).abs().max()
                         / ref.abs().max()),
                     "shape": [K, n, w]}
    return out, times


def e1_assimilation(members, stations):
    """enkf_update's analysis on identical noise and place_sensors, card
    against CPU in f64, on E1's members (f64 copies). Returns (relative
    differences, picks equal)."""
    import numpy as np
    import torch

    from airpollution_tpu_torch.diagnostics import ensemble

    X = members.double()
    rng = np.random.default_rng(3)
    sensors = list(stations)
    y = X.mean(0)[sensors] + 0.01 * torch.tensor(
        rng.standard_normal(len(sensors)), dtype=X.dtype, device=X.device)
    eps = torch.tensor(0.01 * rng.standard_normal((X.shape[0],
                                                   len(sensors))),
                       dtype=X.dtype, device=X.device)
    idx = torch.tensor(sensors, device=X.device)
    card = ensemble._enkf_update(X, y, idx, 0.01, eps, 1.1)
    cpu = ensemble._enkf_update(X.cpu(), y.cpu(), idx.cpu(), 0.01,
                                eps.cpu(), 1.1)
    rel = {"enkf": float((card.cpu() - cpu).abs().max() / cpu.abs().max())}
    picks_c, reds_c = ensemble.place_sensors(X, 16, obs_std=0.01)
    picks_h, reds_h = ensemble.place_sensors(X.cpu(), 16, obs_std=0.01)
    rel["place_sensors"] = max(abs(a - b) / abs(b)
                               for a, b in zip(reds_c, reds_h))
    return rel, picks_c == picks_h


def phase_e1():
    """E1: ``ensemble --place_sensors 16`` at the CLI's defaults through
    cli.main (32 members of 12,033 DOFs, nt=128, CN, f32: every ELL
    product one launch of kernel B7a over the member stack); 4 members
    against serial solves; the f64 member loop against serial solves with
    equal BiCGStab counts; B7a's stacked mode against its plain version;
    enkf_update and place_sensors, card against CPU. Returns its B7a
    launches."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models import crbe

    t0 = time.perf_counter()
    reset_counts()
    prods, line, wall = run_cli(E1_ARGV)
    b7 = launches_of("B7a")
    members = prods["members"]
    K, n = members.shape
    out = {"phase": "e1_ensemble_cli", "card": card_line(), "members": K,
           "dofs": n, "nt": line["nt"], "wall_s": line["wall_s"],
           "cli_s": wall, "member_steps_per_s":
               K * (line["nt"] - 1) / line["wall_s"],
           "b7a_launches": b7, "stations": line["stations"],
           "mean_field_max": line["mean_field_max"],
           "exceedance_mean": line["exceedance_mean"]}
    # The CLI's members: numpy draws from its seed, as cmd_ensemble makes
    # them (the defaults: D 0.1, lognormal 0.3; v (1, 0.5) +- 0.15).
    rng = np.random.default_rng(1234)
    Ds = np.exp(rng.normal(np.log(0.1), 0.3, K))
    Vs = rng.normal([1.0, 0.5], 0.15, (K, 2))
    problems = [apt.Problem(v=tuple(v), D=float(d), sigma=1.0)
                for v, d in zip(Vs, Ds)]
    domain = apt.Domain()
    md = apt.MeshData(apt.create_mesh(64, 20.0), domain, nt=line["nt"])
    scale = float(members.abs().max())
    serial = 0.0
    for k in (0, 1, K // 2, K - 1):
        ref = crbe.CRBESolver(domain, problems[k], md, time_scheme_order=2,
                              matvec_impl="ell").solve(
            store_solutions=False)[0]
        serial = max(serial, float((members[k] - ref).abs().max()) / scale)
    out["members_vs_serial"] = serial
    out["f64_members_vs_serial"], counts_equal = e1_f64_members()
    out["f64_iteration_counts_equal"] = counts_equal
    out["b7a_stacked_vs_plain"], out["b7a_stacked_times"] = \
        e1_kernel_vs_plain(md, problems)
    out["assimilation_card_vs_cpu"], picks_equal = e1_assimilation(
        members, line["stations"])
    out["place_sensors_picks_equal"] = picks_equal
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    check(bool(torch.isfinite(members).all()), "E1: non-finite members")
    check(b7 > 0, "E1: the ensemble launched no B7a")
    check(serial <= E_MEMBER_TOL, f"E1: members vs serial {serial:.3e}")
    check(out["f64_members_vs_serial"] <= E_F64_TOL and counts_equal,
          f"E1: f64 members {out['f64_members_vs_serial']:.3e}, counts "
          f"equal {counts_equal}")
    for name, err in out["b7a_stacked_vs_plain"].items():
        if name.endswith("single_operators"):
            check(err, "E1: B7a's stacked product differs from its single "
                  "operators'")
        else:
            check(err <= TOL[name], f"E1: B7a stacked {name} {err:.3e}")
    for name, err in out["assimilation_card_vs_cpu"].items():
        check(err <= E_F64_TOL, f"E1: {name} card vs CPU {err:.3e}")
    check(picks_equal, "E1: place_sensors picks differ card vs CPU")
    check(len(line["stations"]) == 16, "E1: not 16 stations")
    return b7


def phase_e2():
    """E2: scripts/torch_port_ensemble_demo.py at the row of
    results_snapshot/ensemble_tpu.csv (64 members, 64^2, nt=129, T=5,
    f64): the FEM ensemble's mean and exceedance against the closed form,
    within E2_TOL of that CSV's figures; seconds per member batched and
    over E2_SEQUENTIAL serial solves, timed after the batched forecasts'
    B7a launches were read. Returns those launches."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from scripts import torch_port_ensemble_demo as demo

    t0 = time.perf_counter()
    reset_counts()
    res = demo.run(members=64, mesh_size=64, nt=129, seed=1234,
                   sequential=0)
    b7 = launches_of("B7a")
    domain, md, problems = demo.setup(members=64, mesh_size=64, nt=129,
                                      seed=1234)
    t_seq = demo.time_sequential(domain, md, problems[:E2_SEQUENTIAL])
    rows = res["rows"]
    out = {"phase": "e2_ensemble_demo", "card": card_line(),
           "members": res["members"], "dofs": res["n_dofs"],
           "ensemble_mean_rel_l2": res["ensemble_mean_rel_l2"],
           "fem_exceedance_mean": [r["fem_exceedance_mean"] for r in rows],
           "analytic_exceedance_mean": [r["analytic_exceedance_mean"]
                                        for r in rows],
           "max_prob_disagreement": [r["max_prob_disagreement"]
                                     for r in rows],
           "t_batched_first_s": res["t_batched_s"],
           "t_batched_warm_s": res["t_batched_warm_s"],
           "s_per_member_batched": res["s_per_member_batched"],
           "n_sequential": E2_SEQUENTIAL,
           "s_per_member_sequential": t_seq / E2_SEQUENTIAL,
           "b7a_launches": b7, "seconds": time.perf_counter() - t0}
    emit(out)
    check(b7 > 0, "E2: the batched forecasts launched no B7a")
    err = abs(res["ensemble_mean_rel_l2"] - E2_CSV["ensemble_mean_rel_l2"])
    check(err <= E2_TOL, f"E2: ensemble mean rel_l2 "
          f"{res['ensemble_mean_rel_l2']:.6f} vs the CSV's 0.080643")
    for key in ("fem_exceedance_mean", "analytic_exceedance_mean"):
        for got, want in zip(out[key], E2_CSV[key]):
            check(abs(got - want) <= E2_TOL,
                  f"E2: {key} {got:.6f} vs the CSV's {want}")
    return b7


def n1_card_vs_cpu(params, X, devices=("cuda", "cpu")):
    """One forward pass and three AdamW steps on N1's trained parameters
    and identical batches (f64), on the two ``devices`` (the card against
    the CPU). Returns {what: max difference relative to the largest
    value}."""
    import torch

    from airpollution_tpu_torch.models import fno

    f64 = torch.float64
    rows = torch.arange(8).reshape(2, 4) % X.shape[0]
    idx = torch.stack([rows[0], rows[1], rows[0]])
    xb = X[:8].to(f64)
    yb = X[:8, ..., :1].to(f64) ** 2  # a target of the inputs' scale
    out = {}
    runs = []
    draw = fno.batch_indices
    try:
        fno.batch_indices = lambda gen, n, b, e, device: idx.to(device)
        for dev in devices:
            p = fno.FNOParams(*[t.to(device=dev, dtype=f64) for t in params])
            with torch.no_grad():
                y = fno.fno_apply(p, xb.to(dev))
            p3, _, losses = fno.train_fno(p, xb.to(dev), yb.to(dev),
                                          epochs=3, batch=4, lr=1.5e-3)
            runs.append((y.cpu(), [t.cpu() for t in p3], losses))
    finally:
        fno.batch_indices = draw
    (yc, pc, lc), (yh, ph, lh) = runs
    out["forward"] = float((yc - yh).abs().max() / yh.abs().max())
    out["adamw_params"] = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(pc, ph))
    out["adamw_losses"] = float((lc - lh).abs().max() / lh.abs().max())
    return out


def phase_n1():
    """N1: ``fno --mesh_size 64 --nt 128 --epochs 500`` through cli.main
    at the CLI's widths (2,365,921 parameters; 128 + 32 problems through
    the member-batched ensemble, B7a stacked), f32: the last loss below
    a tenth of the first, relative_l2 below 1 on the training rows and on
    the holdout, all finite; the dataset seconds, training steps/s,
    inference fields/s; then n1_card_vs_cpu. Returns the dataset's B7a
    launches."""
    import torch

    t0 = time.perf_counter()
    reset_counts()
    (params, losses), line, wall = run_cli(N1_ARGV)
    b7 = launches_of("B7a")
    n_params = sum(p.numel() for p in params)
    out = {"phase": "n1_fno_cli", "card": card_line(), "cli_s": wall,
           "epochs": line["epochs"], "epochs_cut_from": 2000,
           "n_params": n_params, "dataset_gen_s": line["dataset_gen_s"],
           "train_s": line["train_s"],
           "train_steps_per_s": line["epochs"] / line["train_s"],
           "inference_fields_per_s": line["inference_fields_per_sec"],
           "loss_first": line["loss_first"], "loss_last": line["loss_last"],
           "rel_l2_holdout_vs_fem": line["rel_l2_holdout_vs_fem"],
           "dataset_b7a_launches": b7}
    # The CLI's dataset again (the same generator seed): its training
    # rows for JAX's gate and the f64 check.
    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models import fno

    md = apt.MeshData(apt.create_mesh(64, 20.0), apt.Domain(), nt=128)
    n_all = N1_TRAIN + 32
    X, Y, _ = fno.make_plume_dataset(md, apt.Domain(),
                                     torch.Generator().manual_seed(0), n_all)
    out["rel_l2_train_vs_fem"] = fno.relative_l2(params, X[:N1_TRAIN],
                                                 Y[:N1_TRAIN])
    out["rel_l2_holdout_again"] = fno.relative_l2(params, X[N1_TRAIN:],
                                                  Y[N1_TRAIN:])
    out["card_vs_cpu_f64"] = n1_card_vs_cpu(params, X)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    check(n_params == N1_PARAMS, f"N1: {n_params} parameters")
    check(bool(torch.isfinite(losses).all())
          and math.isfinite(line["rel_l2_holdout_vs_fem"]),
          "N1: non-finite losses or holdout error")
    check(line["loss_last"] < 0.1 * line["loss_first"],
          f"N1: loss {line['loss_first']:.4g} -> {line['loss_last']:.4g}")
    check(out["rel_l2_train_vs_fem"] < 1.0,
          f"N1: training rel_l2 {out['rel_l2_train_vs_fem']:.4f}")
    check(line["rel_l2_holdout_vs_fem"] < 1.0
          and abs(out["rel_l2_holdout_again"]
                  - line["rel_l2_holdout_vs_fem"]) <= 1e-6,
          f"N1: holdout rel_l2 {line['rel_l2_holdout_vs_fem']:.4f} (again "
          f"{out['rel_l2_holdout_again']:.4f})")
    check(b7 > 0, "N1: the dataset launched no B7a")
    for name, err in out["card_vs_cpu_f64"].items():
        check(err <= N1_TOL, f"N1: {name} card vs CPU {err:.3e}")
    return b7


def phase_ensemble_fno():
    """Slice 15: E1, E2 and N1, then their line. Returns {kernel id:
    launches} of these phases (B7a)."""
    t0 = time.perf_counter()
    b7 = phase_e1() + phase_e2() + phase_n1()
    emit({"phase": "ensemble_fno", "card": card_line(),
          "seconds": time.perf_counter() - t0})
    return {"B7a": b7}


# Slice 16: the paper's experiment harness (airpollution_tpu_torch.
# experiments and .reporting) through the drivers' main on the card, f32.
R1_CRBE_SIZES = [4, 8, 16, 32, 64, 128]  # the paper's sweep, nt=128
R1_UNSTRUCTURED_SIZES = [8, 16, 32]
# Reference parity of the structured sweep (ROADMAP.md, the main path).
R1_PARITY = {16: 1.741805, 32: 0.787025}
R1_PARITY_TOL = 5e-4
# The PINN parts' depth (200 and 100 epochs until slice 17; their gates are
# finite errors and epochs run, and the cut pays for D1).
R1_PINN = ["--mesh_sizes", 4, 8, "--epochs", 100]
R1_SENSITIVITY = ["--epochs", 50]
R1_FIXED = dict(mesh_idx=0, time_budget=2.0)  # ms=4, a 2-s budget
R1_SEARCH = ["--n_trials", 2, "--epochs", 20, "--n_jobs", 2]
R1_TABLES = ("convergence_comparison", "convergence_rates",
             "computational_resources", "efficiency_comparison",
             "summary_statistics", "method_characteristics",
             "parameter_sensitivity", "fixed_runtime")


def snapshot_rows(name):
    """results_snapshot/<name> (the JAX package's committed sweep) as
    mesh_size -> rel_l2_error."""
    from airpollution_tpu_torch.reporting import frames

    table = frames.read_csv(str(Path(__file__).resolve().parent
                                / "results_snapshot" / name))
    return dict(zip(table["mesh_size"].tolist(),
                    table["rel_l2_error"].tolist()))


def phase_r1_paper_harness():
    """R1, slice 16: the paper's drivers on the card in a temporary
    directory, each through its ``main`` (f32): the CRBE sweep over the
    paper's mesh sizes at nt=128 (route 'auto': the plain stencil scan,
    no kernel), rel_l2 at ms=16 and 32 against the reference-parity
    targets; the unstructured sweep (route 'ell': every product on B7a,
    counted from 0); the PINN sweep at ms 4 and 8 (100 epochs), the
    D-sensitivity sweep (50 epochs), one fixed-runtime cell (ms=4, 2 s)
    through the module's functions, and the hyperparameter search (2
    trials of 20 epochs on 2 threads); then the LaTeX tables and the
    figures (skipped, one line each, without matplotlib) from the CSVs
    written. Every row beside results_snapshot/'s. Returns B7a's
    launches under the unstructured sweep."""
    import os
    import tempfile

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.experiments import (
        common, crbe_experiments, fixed_runtime_experiments,
        optimal_hyperparams_search, pinn_experiments, sensitivity_analysis)
    from airpollution_tpu_torch.reporting import (data_visualization,
                                                  table_generator)

    dev = "cuda"
    t0 = time.perf_counter()
    out = {"phase": "r1_paper_harness", "card": card_line()}
    snap = snapshot_rows("df_crbe_training_results.csv")
    snap_u = snapshot_rows("df_crbe_training_results_unstructured.csv")

    def finite(*values):
        return all(math.isfinite(v) for v in values)

    def argv(items):
        return [str(a) for a in items]

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            s0 = time.perf_counter()
            reset_counts()
            # The paper's sweep in a directory of its own: the tables pair
            # the CRBE and PINN rows mesh by mesh, and the PINN sweep here
            # is cut to ms 4 and 8 (R1_PINN), so the tables read a CRBE
            # sweep of those meshes, run below.
            os.mkdir("sweep")
            os.chdir("sweep")
            rows = crbe_experiments.main(
                argv(["--mesh_sizes", *R1_CRBE_SIZES]), device=dev)
            os.chdir(tmp)
            out["crbe_launches"] = {kid: launches_of(kid) for kid in KERNELS
                                    if launches_of(kid)}
            out["crbe"] = [{k: r[k] for k in (
                "mesh_size", "n_dofs", "rel_l2_error", "max_error",
                "train_time", "solve_time", "steps_per_sec")}
                | {"snapshot_rel_l2": snap.get(r["mesh_size"])}
                for r in rows]
            out["crbe_s"] = time.perf_counter() - s0
            rel = {r["mesh_size"]: r["rel_l2_error"] for r in rows}
            s0 = time.perf_counter()
            reset_counts()
            urows = crbe_experiments.main(
                argv(["--mesh_sizes", *R1_UNSTRUCTURED_SIZES, "--mesh_kind",
                      "unstructured"]), device=dev)
            b7a = launches_of("B7a")
            out["unstructured"] = [
                {k: r[k] for k in ("mesh_size", "n_dofs", "rel_l2_error",
                                   "max_error", "solve_time")}
                | {"snapshot_rel_l2": snap_u.get(r["mesh_size"])}
                for r in urows]
            out["unstructured_b7a_launches"] = b7a
            out["unstructured_s"] = time.perf_counter() - s0

            s0 = time.perf_counter()
            prows = pinn_experiments.main(argv(R1_PINN), device=dev)
            trows = crbe_experiments.main(
                argv(["--mesh_sizes", *[r["mesh_size"] for r in prows]]),
                device=dev)
            out["pinn"] = [{k: r[k] for k in (
                "mesh_size", "rel_l2_error", "max_error", "final_loss",
                "epochs_run", "epochs_per_sec")} for r in prows]
            out["pinn_s"] = time.perf_counter() - s0
            s0 = time.perf_counter()
            srows = sensitivity_analysis.main(argv(R1_SENSITIVITY),
                                              device=dev)
            out["sensitivity"] = srows
            out["sensitivity_s"] = time.perf_counter() - s0
            s0 = time.perf_counter()
            ms = fixed_runtime_experiments.FR_MESH_SIZES[R1_FIXED["mesh_idx"]]
            md = apt.MeshData(apt.create_mesh(ms, common.DOMAIN_SIZE),
                              apt.Domain(), nt=common.N_STEPS, device=dev)
            frows = fixed_runtime_experiments.run_cell(
                apt.Domain(), apt.Problem(sigma=1.0), md, **R1_FIXED)
            save_dir = "experimental_results/fixed_runtime"
            os.makedirs(save_dir, exist_ok=True)
            fixed_runtime_experiments.save_results(frows, save_dir)
            out["fixed_runtime"] = [{k: r[k] for k in (
                "method", "actual_runtime", "epochs_completed",
                "rel_l2_error", "max_error")} for r in frows]
            out["fixed_runtime_s"] = time.perf_counter() - s0
            s0 = time.perf_counter()
            trials = optimal_hyperparams_search.main(argv(R1_SEARCH),
                                                     device=dev)
            out["search"] = [{k: t[k] for k in (
                "number", "value", "state", "params_lr")} for t in trials]
            out["search_s"] = time.perf_counter() - s0
            s0 = time.perf_counter()
            tables = table_generator.main([])
            tex = Path("experimental_results/tables/convergence_tables.tex")
            out["tables"] = list(tables)
            out["tex_bytes"] = tex.stat().st_size if tex.exists() else 0
            data_visualization.main([])
            out["reporting_s"] = time.perf_counter() - s0
        finally:
            os.chdir(cwd)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    for ms, want in R1_PARITY.items():
        check(abs(rel.get(ms, math.inf) - want) <= R1_PARITY_TOL,
              f"R1: CRBE rel_l2 at ms={ms} {rel.get(ms)} not within "
              f"{R1_PARITY_TOL} of {want}")
    check(all(finite(r["rel_l2_error"], r["l2_error"], r["max_error"])
              for r in rows + urows + trows),
          "R1: a CRBE error is not finite")
    check(b7a > 0, "R1: the unstructured sweep launched no B7a")
    check(all(finite(r["rel_l2_error"], r["max_error"])
              and r["epochs_run"] > 0 for r in prows),
          "R1: a PINN row is not finite or ran no epoch")
    check(all(finite(r["pinn_l2_error"], r["max_error"], r["cr_l2_error"],
                     r["cr_max_error"]) for r in srows),
          "R1: a sensitivity error is not finite")
    check(all(finite(r["rel_l2_error"], r["max_error"]) for r in frows)
          and frows[0]["epochs_completed"] > 0,
          "R1: the fixed-runtime cell is not finite or ran no epoch")
    check(len(trials) == 2 and all(finite(t["value"]) for t in trials),
          f"R1: search values {[t['value'] for t in trials]}")
    check(tuple(tables) == R1_TABLES and out["tex_bytes"] > 0,
          f"R1: tables {list(tables)}, .tex {out['tex_bytes']} bytes")
    return b7a


# Slice 17: multi-device on torch.distributed (airpollution_tpu_torch/
# parallel/), D1. (a) One NCCL rank in this process (a FileStore group of
# world size 1): every distributed entry point at full width through the
# NCCL code path. (b) Two gloo ranks sharing the card (parallel.launch.spawn)
# run B8, B9 and B10 one block per rank, the halo slabs staged through host
# memory, and the halo-exchange stencil solver; each held bitwise against
# the same solve on 2 blocks in this process.
D1_B8_NT = 101  # (a) the 2049^2 block solve's depth
D1_FEM = dict(mesh_size=257, nt=51)
D1_SWEEP = dict(mesh_size=64, nt=64, D=(0.001, 0.01, 0.1, 1.0, 10.0))
D1_PINN = dict(batch={"pde": 34744, "ic": 6949, "bc": 6948}, epochs=100,
               lr=1e-4)  # PINN-W's widths; bc a multiple of 4 (one draw)
D1_FNO = dict(samples=128, cells=63, epochs=20, batch=16)  # N1's widths
D1_PINN_TOL = 1e-3  # train_parallel's losses against PINN.train's, f32
D1_TOL = 1e-5  # one NCCL rank against its one-process counterpart, f32
# (b): the 2-rank solves, short depth: (mesh size, nt, k). The stencil
# solver runs Chebyshev: its BiCGStab, whose dots are host-staged gloo
# all-reduces here, ran 2.1 steps/s at 257^2 on 2 ranks (PERF.md).
D1_RANKS = {"b8": (2049, 21, B8_ITERS), "b9": (1025, 21, C1_ITERS),
            "b10": (1025, 21, DEMO_ITERS[1025]), "halo": (257, 21, 8)}
D1_SPAWN_TIMEOUT = 300


def d1_block_solves(domain, mesh, mds):
    """The (b) cases on ``mesh`` (2 ranks or 2 blocks): case -> (a
    callable giving the solve's output, its steps, its kernel or None).
    ``mds``: mesh size -> float32 mesh data."""
    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.parallel import (
        build_canvas_hbm_halo_solver, build_halo_solver,
        build_hbm_halo_solver, build_multispecies_hbm_halo_solver)

    def retime(ms, nt):
        md = mds[ms]
        return md if md.nt == nt else retimed(md, nt)

    cases = {}
    ms, nt, k = D1_RANKS["b8"]
    md = retime(ms, nt)
    p = apt.Problem(sigma=1.0)
    dt = domain.T / (nt - 1)
    solve = build_hbm_halo_solver(mesh, md, p, dt, iters=k,
                                  extrapolate=True, assembly="patch")
    u0 = p.initial_condition_fn(md.midpoints)
    cases["b8"] = (lambda s=solve, u=u0: s(None, u), nt - 1, "B8")
    ms, nt, k = D1_RANKS["b9"]
    md = retime(ms, nt)
    p = apt.RotatingPlumeProblem(omega=0.05, D=0.3)
    dt = domain.T / (nt - 1)
    ops = crbe.assemble(md, p, dt, 1, "correct")
    solve = build_canvas_hbm_halo_solver(mesh, md, p, dt, order=1, iters=k,
                                         extrapolate=True)
    u0 = p.initial_condition_fn(md.midpoints)
    cases["b9"] = (lambda s=solve, o=ops, u=u0: s(o, u), nt - 1, "B9")
    ms, nt, k = D1_RANKS["b10"]
    md = retime(ms, nt)
    p = demo_problem(3)
    dt = domain.T / (nt - 1)
    ops = crbe.assemble(md, p.species[0], dt, 2, "correct")
    solve = build_multispecies_hbm_halo_solver(mesh, md, p, dt, order=2,
                                               iters=k)
    C0 = p.initial_conditions(md.midpoints)
    cases["b10"] = (lambda s=solve, o=ops, c=C0: s(o, c), nt - 1, "B10")
    ms, nt, k = D1_RANKS["halo"]
    md = retime(ms, nt)
    p = apt.Problem(sigma=1.0)
    dt = domain.T / (nt - 1)
    ops = crbe.assemble(md, p, dt, 1, "correct")
    solve = build_halo_solver(mesh, md, p, dt, iters=k, extrapolate=True)
    u0 = p.initial_condition_fn(md.midpoints)
    cases["halo"] = (lambda s=solve, o=ops, u=u0: s(o, u), nt - 1, None)
    return cases


def d1_rank(out_dir, device):
    """One of (b)'s 2 gloo ranks on ``device``: D1_RANKS's solves with one
    block per rank, their outputs saved for the parent
    (rank<r>_<case>.pt), the host-staged halo exchange of B8's 2049^2
    block timed, this rank's launches by kernel. Writes rank<r>.json."""
    import os

    import torch
    import torch.distributed as dist

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.parallel import hbm_shard, make_mesh
    from airpollution_tpu_torch.parallel.collectives import RowChain

    rank = dist.get_rank()
    domain = apt.Domain()
    t0 = time.perf_counter()
    mds = {ms: apt.MeshData(apt.create_mesh(ms, 20.0), domain, nt=nt,
                            device=device)
           for ms, nt, _ in D1_RANKS.values()}
    info = {"setup_s": time.perf_counter() - t0}
    mesh = make_mesh({"mp": 2}, device=device)
    reset_counts()
    for case, (run, n_steps, _) in d1_block_solves(domain, mesh,
                                                    mds).items():
        t1 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        info[f"{case}_s"] = time.perf_counter() - t1
        torch.save(out.cpu(), os.path.join(out_dir, f"rank{rank}_{case}.pt"))
    info["launches"] = {kid: launches_of(kid) for kid in ("B8", "B9", "B10")}
    ms, _, k = D1_RANKS["b8"]
    halo = hbm_shard.halo_rows(k, False)
    blocks = hbm_shard.RowBlocks(ms, 2, halo, RowChain(mesh, "mp"))
    state = torch.zeros((1, 2, 3, blocks.rows, ms), device=mesh.device)
    reps = 20
    hbm_shard.exchange_ranks(state, blocks.local, blocks.halo, blocks.chain)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        hbm_shard.exchange_ranks(state, blocks.local, blocks.halo,
                                 blocks.chain)
    torch.cuda.synchronize()
    info["exchange_ms"] = 1e3 * (time.perf_counter() - t1) / reps
    info["exchange_bytes"] = 2 * state[0, ..., :halo, :].numel() * 4
    info["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    return info


def d1_pair(runs, kid=None):
    """Each of ``runs`` (tag -> ``run(warm)``) once to warm it
    (``run(True)``, untimed, a short version where noted), then each once
    timed (``run(False)``), so that neither side's time holds the
    process's first use of a path. Returns tag -> (the timed run's output,
    its host seconds up to a synchronisation, ``kid``'s launches in it or
    None); the launch counts start from 0 at each timed run."""
    import torch

    for run in runs.values():
        run(True)
    out = {}
    for tag, run in runs.items():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = run(False)
        torch.cuda.synchronize()
        out[tag] = (got, time.perf_counter() - t0,
                    launches_of(kid) if kid else None)
    return out


def d1_nccl_rank(domain, md_2049, md_257):
    """(a): every distributed entry point on one NCCL rank (this process),
    each against its one-process counterpart, both sides warmed before
    either is timed (d1_pair); each one's launches counted from 0 around
    its own timed run. Returns (the line's fields, launches by kernel)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.diagnostics.ensemble import ensemble_forecast
    from airpollution_tpu_torch.models import fno
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.parallel import (
        build_hbm_halo_solver, build_sharded_solver, crbe_diffusion_sweep,
        launch, make_mesh, train_fno_dp)
    from airpollution_tpu_torch.parallel.device_mesh import BlockMesh

    out, launches = {}, {"B7a": 0, "B8": 0}
    cuda = md_257.device
    with launch.process_group("nccl", device="cuda:0"):
        # B8 at 2049^2, nt=D1_B8_NT: the rank's one block against the
        # one-process one-block solve.
        md = retimed(md_2049, D1_B8_NT)
        p = apt.Problem(sigma=1.0)
        dt = domain.T / (md.nt - 1)
        u0 = p.initial_condition_fn(md.midpoints)
        solvers = {tag: build_hbm_halo_solver(
            mesh, md, p, dt, iters=B8_ITERS, extrapolate=True,
            assembly="patch") for tag, mesh in (
                ("rank", make_mesh({"mp": 1})),
                ("one_process", BlockMesh({"mp": 1}, cuda)))}
        runs = d1_pair({tag: lambda warm, s=s: s(None, u0)
                        for tag, s in solvers.items()}, "B8")
        del solvers
        for tag, (_, sec, _) in runs.items():
            out[f"b8_{tag}_steps_per_s"] = (md.nt - 1) / sec
        out["b8_launches"] = runs["rank"][2]
        launches["B8"] += out["b8_launches"]
        out["b8_bitwise_equal"] = bool(torch.equal(runs["rank"][0],
                                                   runs["one_process"][0]))
        check(out["b8_launches"] == md.nt - 1,
              f"D1 B8 rank: {out['b8_launches']} launches")
        check(out["b8_bitwise_equal"], "D1 B8: the NCCL rank's block solve "
              "differs from the one-process block solve")
        # The row-sharded FEM solve (B7a row blocks) at 257^2.
        md = retimed(md_257, D1_FEM["nt"])
        whole = CRBESolver(domain, p, md, matvec_impl="ell", device=cuda)
        sharded = build_sharded_solver(make_mesh({"mp": 1}), md, p, whole.dt,
                                       tol=whole.solver_tol)
        args = (whole._require_ops(), whole.set_initial_condition())
        runs = d1_pair({
            "rank": lambda warm: sharded(*args),
            "one_process": lambda warm: whole.solve(store_solutions=False),
        }, "B7a")
        (got, sec, out["fem_b7a_launches"]), (ref, ref_sec, _) = \
            runs["rank"], runs["one_process"]
        launches["B7a"] += out["fem_b7a_launches"]
        out["fem_rank_steps_per_s"] = (md.nt - 1) / sec
        out["fem_one_process_steps_per_s"] = (md.nt - 1) / ref_sec
        out["fem_max_rel_diff"] = max_rel(got, ref)
        out["fem_bitwise_equal"] = bool(torch.equal(got, ref))
        check(out["fem_b7a_launches"] > 0, "D1 FEM: no B7a launch")
        check(out["fem_max_rel_diff"] <= D1_TOL,
              f"D1 FEM: rank vs ELL solve {out['fem_max_rel_diff']:.3e}")
        # The D-sweep at 64^2 over the sensitivity driver's five D values
        # (each side warmed on the first D alone).
        md64 = apt.MeshData(apt.create_mesh(D1_SWEEP["mesh_size"], 20.0),
                            domain, nt=D1_SWEEP["nt"], device=cuda)

        def sweep_rank(warm):
            return crbe_diffusion_sweep(
                md64, domain, D1_SWEEP["D"][:1] if warm else D1_SWEEP["D"],
                mesh=make_mesh({"trial": 1}))

        def sweep_serial(warm):
            errors = []
            for D in D1_SWEEP["D"][:1] if warm else D1_SWEEP["D"]:
                q = apt.Problem(v=(1.0, 0.5), D=D, sigma=1.0)
                s = CRBESolver(domain, q, md64, matvec_impl="ell",
                               stiffness_convention="reference", device=cuda)
                s.solve(store_solutions=False)
                errors.append(s.compute_errors(q.analytical_solution))
            return errors

        runs = d1_pair({"rank": sweep_rank, "serial": sweep_serial}, "B7a")
        (sweep, out["sweep_s"], out["sweep_b7a_launches"]), \
            (serial, out["sweep_serial_s"], _) = runs["rank"], runs["serial"]
        launches["B7a"] += out["sweep_b7a_launches"]
        want = np.asarray(serial)
        got = torch.stack([sweep[k] for k in ("rel_l2_error", "l2_error",
                                              "max_error")], 1).cpu().numpy()
        out["sweep_rel_l2"] = got[:, 0].tolist()
        out["sweep_max_rel_diff"] = float(np.abs(got - want).max()
                                          / np.abs(want).max())
        check(np.isfinite(got).all() and out["sweep_max_rel_diff"] <= 1e-4,
              f"D1 sweep vs serial solves {out['sweep_max_rel_diff']:.3e}")

        # PINN.train_parallel at PINN-W's widths against PINN.train, from
        # one seed (each side warmed on a 5-epoch run of its own model).
        def pinn(tag, warm):
            model = apt.PINN(PINN_LAYERS, apt.Problem(sigma=1.0), domain,
                             activation="tanh", seed=1234, device=cuda)
            epochs = 5 if warm else D1_PINN["epochs"]
            if tag == "rank":
                return model.train_parallel(
                    make_mesh({"dp": 1, "tp": 1}), D1_PINN["batch"], epochs,
                    D1_PINN["lr"], PINN_LAMBDA)
            return model.train(D1_PINN["batch"], epochs, D1_PINN["lr"],
                               PINN_LAMBDA,
                               mini_batch_size=D1_PINN["batch"]["pde"])

        runs = d1_pair({tag: functools.partial(pinn, tag)
                        for tag in ("rank", "serial")})
        for tag, (_, sec, _) in runs.items():
            out[f"pinn_{tag}_epochs_per_s"] = D1_PINN["epochs"] / sec
        a, b = (np.asarray(runs[tag][0]["total_loss"])
                for tag in ("rank", "serial"))
        out["pinn_loss_first_last"] = [float(a[0]), float(a[-1])]
        out["pinn_max_rel_loss_diff"] = float(np.max(np.abs(a - b) / b))
        check(a.shape == b.shape == (D1_PINN["epochs"],)
              and np.isfinite(a).all() and a[-1] < a[0],
              "D1 PINN: the parallel losses are not finite and falling")
        check(out["pinn_max_rel_loss_diff"] <= D1_PINN_TOL,
              f"D1 PINN: train_parallel vs train "
              f"{out['pinn_max_rel_loss_diff']:.3e}")
        # train_fno_dp at N1's widths against train_fno, seeded data (each
        # side warmed on 2 steps).
        gen = torch.Generator(device=cuda).manual_seed(5)
        c = D1_FNO["cells"]
        X = torch.randn((D1_FNO["samples"], c, c, 6), generator=gen,
                        device=cuda)
        Y = torch.randn((D1_FNO["samples"], c, c, 1), generator=gen,
                        device=cuda)
        params = fno.init_fno_params(
            torch.Generator(device=cuda).manual_seed(1), in_ch=6,
            device=cuda)

        def fno_run(tag, warm):
            g = torch.Generator(device=cuda).manual_seed(2)
            kw = dict(epochs=2 if warm else D1_FNO["epochs"],
                      batch=D1_FNO["batch"], lr=1.5e-3, generator=g)
            if tag == "rank":
                return train_fno_dp(make_mesh({"data": 1}), params, X, Y,
                                    **kw)
            return fno.train_fno(params, X, Y, **kw)

        runs = d1_pair({tag: functools.partial(fno_run, tag)
                        for tag in ("rank", "serial")})
        for tag, (_, sec, _) in runs.items():
            out[f"fno_{tag}_steps_per_s"] = D1_FNO["epochs"] / sec
        (pa, _, la), (pb, _, lb) = runs["rank"][0], runs["serial"][0]
        out["fno_n_params"] = sum(t.numel() for t in pa)
        out["fno_max_rel_loss_diff"] = max_rel(la, lb)
        out["fno_max_rel_param_diff"] = max(max_rel(x, y)
                                            for x, y in zip(pa, pb))
        check(out["fno_n_params"] == N1_PARAMS, "D1 FNO: not N1's widths")
        check(max(out["fno_max_rel_loss_diff"],
                  out["fno_max_rel_param_diff"]) <= D1_TOL,
              f"D1 FNO: train_fno_dp vs train_fno "
              f"{out['fno_max_rel_loss_diff']:.3e} / "
              f"{out['fno_max_rel_param_diff']:.3e}")
        # ensemble_forecast(mesh=) at E1's shape against the one batch
        # (each side warmed on 2 members).
        rng = np.random.default_rng(1234)
        K = 32
        Ds = np.exp(rng.normal(np.log(0.1), 0.3, K))
        Vs = rng.normal([1.0, 0.5], 0.15, (K, 2))
        members = [apt.Problem(v=tuple(v), D=float(d), sigma=1.0)
                   for v, d in zip(Vs, Ds)]

        def ensemble(tag, warm):
            return ensemble_forecast(
                md64, domain, members[:2] if warm else members, order=2,
                mesh=make_mesh({"trial": 1}) if tag == "rank" else None)

        runs = d1_pair({tag: functools.partial(ensemble, tag)
                        for tag in ("rank", "one_process")}, "B7a")
        for tag, (_, sec, _) in runs.items():
            out[f"ensemble_{tag}_member_steps_per_s"] = (
                K * (md64.nt - 1) / sec)
        out["ensemble_b7a_launches"] = runs["rank"][2]
        launches["B7a"] += out["ensemble_b7a_launches"]
        out["ensemble_bitwise_equal"] = bool(torch.equal(
            runs["rank"][0]["members"], runs["one_process"][0]["members"]))
        check(out["ensemble_bitwise_equal"],
              "D1 ensemble: the rank's members differ from the batch's")
    return out, launches


def phase_d1_distributed(domain, md_2049, meshes, ranks):
    """D1 (slice 17): (a) d1_nccl_rank, then (b)'s references, the same
    solves on a one-process 2-block BlockMesh, each rank's output (from
    child_d1, ``ranks``) held bitwise against them. Returns {kernel id:
    launches}: (a)'s and both ranks'."""
    import os
    import shutil

    import torch

    from airpollution_tpu_torch.parallel.device_mesh import BlockMesh

    tmp = ranks["dir"]
    t0 = time.perf_counter()
    out = {"phase": "d1_distributed", "card": card_line()}
    try:
        nccl, launches = d1_nccl_rank(domain, md_2049,
                                      meshes[(257, "float32")])
        out.update({f"nccl_{k}": v for k, v in nccl.items()})
        out["nccl_s"] = time.perf_counter() - t0
        mds = {2049: md_2049, 1025: meshes[(1025, "float32")],
               257: meshes[(257, "float32")]}
        refs = {}
        for case, (run, _, _) in d1_block_solves(
                domain, BlockMesh({"mp": 2}, md_2049.device), mds).items():
            refs[case] = run().cpu()
        out["gloo_references_s"] = time.perf_counter() - t0 - out["nccl_s"]
        out["gloo_ranks_wall_s"] = ranks["ranks_wall_s"]
        infos = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                infos.append(json.load(f))
        for case, ref in refs.items():
            equal = [bool(torch.equal(torch.load(
                os.path.join(tmp, f"rank{r}_{case}.pt")), ref))
                for r in range(2)]
            out[f"gloo_{case}_bitwise_equal"] = all(equal)
            out[f"gloo_{case}_rank_s"] = [i[f"{case}_s"] for i in infos]
            check(all(equal), f"D1 {case}: 2 gloo ranks differ from 2 "
                  f"blocks in one process ({equal})")
            check(bool(torch.isfinite(ref).all()), f"D1 {case}: non-finite")
        for kid in ("B8", "B9", "B10"):
            n = sum(i["launches"][kid] for i in infos)
            out[f"gloo_{kid}_launches"] = n
            check(n > 0, f"D1: the gloo ranks launched no {kid}")
            launches[kid] = launches.get(kid, 0) + n
        out["gloo_rank_setup_s"] = [i["setup_s"] for i in infos]
        out["gloo_rank_seconds"] = [i["seconds"] for i in infos]
        out["gloo_exchange_ms_host_staged"] = [i["exchange_ms"]
                                               for i in infos]
        out["gloo_exchange_bytes"] = infos[0]["exchange_bytes"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return launches


# Slice 18: the last scripts on the card (y1_scripts). The street canyon's
# budget terms at 257^2, nt=1001 (physics figures, not times): the JAX
# package's scripts/obstacle_canyon_demo.py run() on a CPU (float32, the
# stencil row, BiCGStab to 1e-7), which the port's fused row is held to
# within CANYON_TOL: about 13 times the spread between the port's own
# fused and stencil rows on a CPU in float32 (7.4e-6, accumulated mass).
CANYON_JAX_CPU = {"canyon_accumulated": 3.9046974182128906,
                  "canyon_ground_deposited": 0.13857981003820896,
                  "canyon_facade_plus_outflow": 5.9567227717489}
CANYON_TOL = 1e-4
# The committed fused row (results_snapshot/obstacle_canyon.json, 257^2
# "fused_hbm", a TPU), printed beside: its canyon terms lie 7.1e-4
# (accumulated mass) from what the JAX package's run() gives now, its
# stencil row too, so it is reported and not gated on.
CANYON_SNAPSHOT = {"canyon_accumulated": 3.901850700378418,
                   "canyon_ground_deposited": 0.13854623399674892,
                   "canyon_facade_plus_outflow": 5.959603065624833}
CANYON = dict(ms=257, nt=1001, every=100, k=8)
# The K sweep's rows at 257^2 (results_snapshot/multispecies_K_sweep.json).
K_SWEEP = (6, 8)
# Figures of results_snapshot/ computed in float64 by the JAX package on a
# CPU (the rotating convergence table and the multispecies demo's rows)
# are held at this relative gap; the forecast figures of the assimilation
# scripts, which draw no EnKF noise, at F32_SNAPSHOT_TOL where the JAX
# script ran float32 (da_cycling, network_design) and the CSV's rounding
# (6 places) where it ran float64 (enkf).
F64_SNAPSHOT_TOL = 1e-6
F32_SNAPSHOT_TOL = 1e-3
# The chain's rows (results_snapshot/multispecies.csv) come from solves
# to the solver's default BiCGStab tolerance, 1e-7, on both sides: 1e-5.
CHAIN_SNAPSHOT_TOL = 1e-5
# The canyon PINN script's FEM figures at 49^2, nt=49 (float32, the
# stencil scan): the JAX package's scripts/canyon_pinn_fem.py on a CPU
# (APT_PLATFORM=cpu, --epochs 1 --lbfgs 0 --configs base: its FEM does not
# depend on the PINN's flags), held within CANYON_TOL;
# results_snapshot/canyon_pinn_fem.json's (printed beside) lie 1.0% off
# them (the wake mean), like the street canyon's committed rows.
CANYON_PINN_FEM_JAX_CPU = {"fem_wake_mean": 0.0011815894395112991,
                           "fem_free_mean": 0.002937580458819866,
                           "fem_wake_deficit": 0.001755991019308567}
# Depth cuts of the PINN and inverse scripts (their widths stay): epochs,
# Adam and L-BFGS steps, mesh-size lists.
Y1_DEPTH = dict(wind_steps=8, rotating_sizes=(8, 16, 32, 64),
                ms_sizes=(8, 16, 32), ms_steps=5, pinn_epochs=200,
                lever_epochs=50, lever_lbfgs=5, canyon_epochs=100,
                canyon_lbfgs=10, p3_sizes=(4, 8, 16), p3_epochs=100,
                p3c_epochs=20)
# A background process may run this long (most start after the build).
BACKGROUND_TIMEOUT_S = 900
# One variant per lever of the levers script beside the levers cell (RAD,
# grad-norm weights, hard IC, Fourier scale, sine, depth, batch, tuned
# and flat loss weights).
Y1_LEVERS = ("base", "rad", "adaptive", "hardic", "fcw-scale2-16k",
             "fcw-sine-16k", "fcw-deep6-16k", "fcw-batch2x-16k",
             "hpo-tuned", "base-flat-lambdas")


def snapshot_csv(name):
    """results_snapshot/<name> as a list of row dicts (strings)."""
    import csv

    with open(Path(__file__).resolve().parent / "results_snapshot" / name,
              newline="") as f:
        return list(csv.DictReader(f))


def close_to(got, want, tol):
    return abs(got - want) <= tol * abs(want)


def y1_mesh_data(ms, nt):
    """The ms^2 mesh data of a part of slice 18 (Domain(), f32, the
    card)."""
    import airpollution_tpu_torch as apt

    return apt.MeshData(apt.create_mesh(ms, 20.0), apt.Domain(), nt=nt)


def y1_canyon():
    """scripts/torch_port_obstacle_canyon_demo.py's fused row at 257^2,
    nt=1001, a row every 100 steps, CN, Chebyshev-8 on B4 with its load
    plane (street source), the buildings' dead DOFs and the Robin ground:
    the canyon and the flat terrain, a first and a warm solve each, and the
    script's 2k check. The stencil row runs only in the CPU tests. Gates:
    the script's own (a NaN stops the run, k-vs-2k < 5e-3), B4's launches
    (5 solves of 1,000 steps), the solids exactly 0.0, and each budget
    term within CANYON_TOL of the JAX package's (CANYON_JAX_CPU), printed
    beside the committed fused row's."""
    from scripts import torch_port_obstacle_canyon_demo as canyon

    c = CANYON
    md = y1_mesh_data(c["ms"], c["nt"])
    reset_counts()
    t0 = time.perf_counter()
    row = canyon.run(c["ms"], c["nt"], c["every"], warm=True,
                     matvec_impl="fused_hbm", chebyshev_iters=c["k"],
                     mesh_data=md)
    seconds = time.perf_counter() - t0
    solvers = row.pop("solvers")
    b4 = launches_of("B4")
    gaps = {k: abs(row[k] - v) / abs(v) for k, v in CANYON_JAX_CPU.items()}
    out = {"script": "obstacle_canyon_demo", "seconds": seconds, **row,
           "b4_launches": b4, "kernel": solvers["canyon"].fused_kernel,
           "jax_cpu_stencil_row": CANYON_JAX_CPU, "rel_gap_to_jax": gaps,
           "snapshot_fused_row": CANYON_SNAPSHOT,
           "rel_gap_to_snapshot": {
               k: abs(row[k] - v) / abs(v)
               for k, v in CANYON_SNAPSHOT.items()}}
    check(solvers["canyon"].fused_kernel == "B4"
          and b4 == 5 * (c["nt"] - 1),
          f"canyon: {b4} B4 launches, not {5 * (c['nt'] - 1)}")
    check(row["solid_max_abs"] == 0.0,
          f"canyon: the solids reach {row['solid_max_abs']}")
    check(row["k_vs_2k_rel_maxdiff"] < 5e-3,
          f"canyon: k-vs-2k {row['k_vs_2k_rel_maxdiff']:.3e} >= 5e-3")
    check(max(gaps.values()) <= CANYON_TOL,
          f"canyon: budget terms {gaps} not within {CANYON_TOL} of JAX's")
    return [out], {"B4": b4}


def y1_canyon_kernel(meshes, cache):
    """B4 with its load plane on the canyon's own canvas against
    plain_canvas_step: one CN step at 257^2, k=8, the planner's plan, f64
    and f32, from a nonzero state that is 0 on the buildings: the dead
    DOFs, the street source (lumped) and the Robin ground row. Gates: the
    module's tolerances and the dead DOFs exactly 0.0."""
    import torch

    from airpollution_tpu_torch.ops import fused_hbm, fused_solver
    from scripts import torch_port_obstacle_canyon_demo as canyon

    problem = canyon.CanyonEmitter(buildings=True)
    k, rows, worst = CANYON["k"], [], 0.0
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        md = meshes[(257, name)]
        inp = canvas_inputs(md, problem, 2, dtype, cache)
        C, cheb, u, masks = canvas_step_inputs(inp, k, dtype)
        live = 1.0 - fused_solver.to_canvases(inp["pattern"],
                                              inp["dead"].to(dtype))
        u = (u + 0.01 * masks) * live
        (load,), _ = step_loads(inp, md, problem, 1, True, C, masks, True,
                                dtype)
        plan = fused_hbm.canvas_plan(k, True, dtype)
        got = torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
        fused_hbm.canvas_kernel_step(C, cheb, k, u, u, got,
                                     torch.empty_like(u), True, inp["rect"],
                                     halt, plan, load=load)
        ref, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, u, True, masks,
                                             load)
        torch.cuda.synchronize()
        abs_e, rel, diff = rel_err(got, ref)
        dead = dead_max(inp, got, dtype)
        rows.append({"dtype": name, "plan": plan, "rel_err": rel,
                     "dead_max_abs": dead, "worst_at": worst_at(diff),
                     "load_max": float(load.abs().max())})
        check(rel <= TOL[name], f"B4 canyon {name}: rel err {rel:.3e}")
        check(dead == 0.0, f"B4 canyon {name}: dead DOFs reach {dead}")
        if name == "float32":
            worst = abs_e
    emit({"phase": "y1_canyon_b4_load_vs_plain", "card": card_line(),
          "cases": rows})
    return worst


def y1_k_sweep():
    """The K sweep's rows at 257^2 (K = 6 and 8, nt=1001, Chebyshev-6)
    through the multispecies script's run(): its k-vs-2k and fuse A/B
    gates (< 5e-3), B6 and B4 launches counted."""
    md = y1_mesh_data(257, 1001)
    out, launches = [], {"B6": 0, "B4": 0}
    for K in K_SWEEP:
        row, _, b6, b4, seconds = multispecies_row(
            md, 257, DEMO_ITERS[257], scan_check=False, K=K)
        n = md.nt - 1
        check(b6 == 3 * n and b4 == K * n,
              f"K sweep K={K}: {b6} B6 and {b4} B4 launches")
        out.append({**row, "seconds": seconds})
        launches["B6"] += b6
        launches["B4"] += b4
    return [{"script": "multispecies_fused_demo (K sweep)", "rows": out}], \
        launches


def y1_extrapolate():
    """scripts/torch_port_extrapolate_ab.py at 513^2, nt=128 (I1's shape,
    full width), its timed Adam steps cut to 2. Gates: every row finite;
    at each k the extrapolated start lies nearer the tight solve than the
    cold one; B4-raw launched."""
    import math

    from scripts import torch_port_extrapolate_ab as ab

    md = y1_mesh_data(513, 128)
    reset_counts()
    t0 = time.perf_counter()
    res = ab.run(513, md.nt, 96, 2, mesh_data=md)
    seconds = time.perf_counter() - t0
    raw = launches_of("B4-raw")
    rows = [{k: v for k, v in r.items() if k != "losses"}
            for r in res["rows"]]
    out = {"script": "extrapolate_ab", "seconds": seconds,
           "tight_s": res["tight_s"], "rows": rows, "b4_raw_launches": raw}
    check(raw > 0, "extrapolate_ab launched no B4-raw")
    check(all(math.isfinite(r["primal_rel_maxdiff_vs_tight"])
              and all(math.isfinite(x) for x in r["losses"])
              for r in res["rows"]), "extrapolate_ab: a non-finite row")
    acc = {(r["extrapolate"], r["chebyshev_iters"]):
           r["primal_rel_maxdiff_vs_tight"] for r in res["rows"]}
    for k in (12, 8):
        check(acc[(True, k)] < acc[(False, k)],
              f"extrapolate_ab k={k}: extrapolated {acc[(True, k)]:.3e} "
              f"not nearer the tight solve than cold {acc[(False, k)]:.3e}")
    return [out], {"B4-raw": raw}


def y1_assimilation():
    """The three EnKF scripts at their defaults (each member batch on
    B7a's stacked mode), the two 24^2 ones on one mesh. Gates: the
    analysis error below the forecast's (enkf); the last cycle's analysis
    below the free run (da_cycling); the greedy network at or below the
    random mean at every size (network_design); and the figures drawn
    before any EnKF noise against results_snapshot/."""
    import airpollution_tpu_torch as apt
    from scripts import torch_port_assimilation_demo as enkf
    from scripts import torch_port_da_cycling_demo as cycling
    from scripts import torch_port_network_design_demo as network

    out, b7a = [], 0
    mesh24 = apt.create_mesh(24, 20.0)

    reset_counts()
    t0 = time.perf_counter()
    r = enkf.run(mesh=mesh24)
    row = {k: r[k] for k in enkf.COLUMNS}
    out.append({"script": "assimilation_demo",
                "seconds": time.perf_counter() - t0, **row,
                "b7a_launches": launches_of("B7a")})
    b7a += launches_of("B7a")
    snap = snapshot_csv("enkf.csv")[0]
    check(row["rel_err_analysis_mean"] < row["rel_err_forecast_mean"],
          f"enkf: analysis {row['rel_err_analysis_mean']:.4e} not below "
          f"forecast {row['rel_err_forecast_mean']:.4e}")
    for k in ("rel_err_forecast_mean", "station_spread_forecast",
              "brier_forecast"):
        check(abs(row[k] - float(snap[k])) <= 5e-7,
              f"enkf: {k} {row[k]:.7f} against the snapshot's {snap[k]}")

    reset_counts()
    t0 = time.perf_counter()
    r = cycling.run()
    rows = r["rows"]
    out.append({"script": "da_cycling_demo",
                "seconds": time.perf_counter() - t0,
                "truth_s": r["truth_s"], "cycles_s": r["cycles_s"],
                "rows": rows, "b7a_launches": launches_of("B7a")})
    b7a += launches_of("B7a")
    snap = snapshot_csv("da_cycling.csv")
    last = rows[-1]
    check(last["rmse_analysis"] < last["rmse_free"],
          f"da_cycling: last analysis {last['rmse_analysis']} not below "
          f"the free run {last['rmse_free']}")
    for k in ("rmse_forecast", "rmse_free"):
        check(close_to(rows[0][k], float(snap[0][k]), F32_SNAPSHOT_TOL),
              f"da_cycling: cycle 1 {k} {rows[0][k]:.6f} against the "
              f"snapshot's {snap[0][k]}")

    reset_counts()
    t0 = time.perf_counter()
    r = network.run(mesh=mesh24)
    rows = r["rows"]
    out.append({"script": "network_design_demo",
                "seconds": time.perf_counter() - t0,
                "forecast_s": r["forecast_s"], "rows": rows,
                "b7a_launches": launches_of("B7a")})
    b7a += launches_of("B7a")
    for row in rows:
        check(row["err_greedy"] <= row["err_random_mean"],
              f"network_design m={row['n_sensors']}: greedy "
              f"{row['err_greedy']:.6f} above random "
              f"{row['err_random_mean']:.6f}")
    snap = snapshot_csv("network_design.csv")[0]
    check(close_to(rows[0]["err_prior"], float(snap["err_prior"]),
                   F32_SNAPSHOT_TOL),
          f"network_design: prior error {rows[0]['err_prior']:.6f} against "
          f"the snapshot's {snap['err_prior']}")
    check(b7a > 0, "the assimilation scripts launched no B7a")
    return out, {"B7a": b7a}


def falls(losses):
    """Finite losses whose last lies below the first."""
    import math

    return all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def lowers(losses):
    """Finite losses of a fit that reaches below its start (Adam's first
    steps may overshoot before the misfit falls)."""
    import math

    return all(math.isfinite(x) for x in losses) and min(losses) < losses[0]


def y1_wind():
    """wind_inversion_demo at its 64^2, nt=128 (the scan engine there, as
    the JAX script's 'auto'), the 13-point omega grid, then 8 Adam steps
    (its lr of 0.02 overshoots first; the misfit falls below its start at
    the eighth, 7.6e-7 against 1.1e-6 on a CPU and on the card alike).
    Gate: finite losses that reach below the start."""
    from scripts import torch_port_wind_inversion_demo as wind

    t0 = time.perf_counter()
    row = wind.run(steps=Y1_DEPTH["wind_steps"])
    out = {"script": "wind_inversion_demo",
           "seconds": time.perf_counter() - t0,
           **{k: row[k] for k in wind.COLUMNS}, "omega0": row["omega0"],
           "losses": row["losses"]}
    check(lowers(row["losses"]), f"wind_inversion: losses {row['losses']}")
    return [out], {}


def y1_rotating():
    """rotating_convergence in f64 at ms 8-64 (128 cut), BE and CN, held to
    results_snapshot/rotating_convergence.csv (the JAX package's f64 CPU
    table, BiCGStab to 1e-11) to its 6 places and F64_SNAPSHOT_TOL."""
    from scripts import torch_port_rotating_convergence as rotating

    t0 = time.perf_counter()
    rows = rotating.run(Y1_DEPTH["rotating_sizes"])
    snap = {(int(r["time_scheme_order"]), int(r["mesh_size"])):
            float(r["rel_l2"]) for r in snapshot_csv(
                "rotating_convergence.csv")}
    for r in rows:
        want = snap[(r["time_scheme_order"], r["mesh_size"])]
        check(abs(r["rel_l2"] - want) <= 5e-7 + F64_SNAPSHOT_TOL * want,
              f"rotating_convergence {r['time_scheme_order']}/"
              f"{r['mesh_size']}: rel_l2 {r['rel_l2']:.7f} against {want}")
    return [{"script": "rotating_convergence",
             "seconds": time.perf_counter() - t0, "rows": rows}], {}


def y1_multispecies_demo():
    """multispecies_demo: the chain's convergence rows at ms 8-32 (64 cut),
    held to results_snapshot/multispecies.csv within CHAIN_SNAPSHOT_TOL,
    then Y1_DEPTH["ms_steps"] Adam steps of the rate fit (finite losses
    that fall)."""
    from scripts import torch_port_multispecies_demo as chain

    t0 = time.perf_counter()
    rows = chain.convergence_rows(Y1_DEPTH["ms_sizes"], 129)
    inv = chain.inversion_row(16, 33, 0.01, Y1_DEPTH["ms_steps"], 0.05)
    snap = {int(r["mesh_size"]): r for r in snapshot_csv("multispecies.csv")
            if r["kind"] == "convergence"}
    for r in rows:
        for k in ("rel_l2_total", "rel_l2_A", "rel_l2_B", "rel_l2_C"):
            want = float(snap[r["mesh_size"]][k])
            check(close_to(r[k], want, CHAIN_SNAPSHOT_TOL),
                  f"multispecies_demo ms={r['mesh_size']}: {k} {r[k]} "
                  f"against {want}")
    check(falls(inv["losses"]), f"multispecies_demo fit: {inv['losses']}")
    return [{"script": "multispecies_demo",
             "seconds": time.perf_counter() - t0, "rows": rows,
             "inversion": inv}], {}


def y1_pinn_scripts():
    """pinn_rotating_demo (32^2 budget, 200 epochs), the levers script's
    Y1_LEVERS (50 epochs, 5 L-BFGS steps each; its levers cell runs in the
    PINN phase), canyon_pinn_fem (every config, 100 epochs and 10 L-BFGS
    steps; the FEM at 49^2), problem3_comparative_analysis (ms 4, 8, 16,
    100 epochs) and problem3_comprehensive_analysis2 (20 epochs), widths
    as published, in a temporary directory. Gates: finite losses that
    fall; the canyon FEM's wake figures against the JAX package's
    (CANYON_PINN_FEM_JAX_CPU) within CANYON_TOL; finite discrepancies."""
    import json
    import math
    import os
    import tempfile

    from scripts import torch_port_canyon_pinn_fem as canyon_pinn
    from scripts import torch_port_pinn_accuracy_levers as levers
    from scripts import torch_port_pinn_rotating_demo as rotating
    from scripts import torch_port_problem3_comparative_analysis as p3
    from scripts import torch_port_problem3_comprehensive_analysis2 as p3c

    d = Y1_DEPTH
    out = []
    t0 = time.perf_counter()
    row = rotating.run(epochs=d["pinn_epochs"])
    out.append({"script": "pinn_rotating_demo",
                "seconds": time.perf_counter() - t0,
                **{k: row[k] for k in rotating.COLUMNS}})
    check(falls(row["history"]["total_loss"]) and math.isfinite(
        row["rel_l2"]), "pinn_rotating: losses do not fall")

    t0 = time.perf_counter()
    rows = levers.run(d["lever_epochs"], 64, Y1_LEVERS, device="cuda",
                      epoch_cap=d["lever_epochs"],
                      lbfgs_cap=d["lever_lbfgs"])
    out.append({"script": "pinn_accuracy_levers",
                "seconds": time.perf_counter() - t0,
                "rows": [{k: v for k, v in r.items() if k not in levers.EXTRA}
                         for r in rows]})
    for r in rows:
        check(falls(r["history"]["total_loss"][:r["adam_epochs"]])
              and math.isfinite(r["rel_l2"]),
              f"levers {r['variant']}: losses do not fall")

    t0 = time.perf_counter()
    res = canyon_pinn.run(epochs=d["canyon_epochs"],
                          lbfgs_cap=d["canyon_lbfgs"])
    out.append({"script": "canyon_pinn_fem",
                "seconds": time.perf_counter() - t0, "fem_s": res["fem_s"],
                "rows": res["rows"]})
    with open(Path(__file__).resolve().parent / "results_snapshot"
              / "canyon_pinn_fem.json") as f:
        snap = json.load(f)["configs"][0]
    out[-1]["fem_jax_cpu"] = CANYON_PINN_FEM_JAX_CPU
    out[-1]["fem_snapshot"] = {k: snap[k] for k in CANYON_PINN_FEM_JAX_CPU}
    for r in res["rows"]:
        check(falls(res["histories"][r["config"]]["total_loss"]),
              f"canyon_pinn_fem {r['config']}: losses do not fall")
    for k, want in CANYON_PINN_FEM_JAX_CPU.items():
        got = res["rows"][0][k]
        check(close_to(got, want, CANYON_TOL),
              f"canyon_pinn_fem: {k} {got} against JAX's {want}")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rows = p3.main(["--mesh_sizes", *map(str, d["p3_sizes"]),
                            "--epochs", str(d["p3_epochs"])], device="cuda")
            out.append({"script": "problem3_comparative_analysis",
                        "seconds": time.perf_counter() - t0, "rows": rows})
            check(len(rows) == len(d["p3_sizes"]) and all(
                math.isfinite(r["l2_error_diff"])
                and math.isfinite(r["max_error_diff"]) for r in rows),
                "problem3_comparative: a non-finite discrepancy")
            t0 = time.perf_counter()
            _, stats = p3c.main(["--epochs", str(d["p3c_epochs"])],
                                device="cuda")
            out.append({"script": "problem3_comprehensive_analysis2",
                        "seconds": time.perf_counter() - t0,
                        **{k: float(v) for k, v in stats.items()}})
            check(all(math.isfinite(v) for v in stats.values()),
                  "problem3_comprehensive_analysis2: a non-finite figure")
        finally:
            os.chdir(cwd)
    return out, {}


# Work that shares no state with the main path runs in processes of its
# own (background groups): slice 18's scripts, and earlier slices' phases
# that need processes anyway or are bound by the host (CHILD_PHASES: D1's
# gloo ranks; X3, the command line end to end; R1, the paper's harness).
# The groups that launch no kernel of the port (the scan and PINN scripts)
# start with the script, beside the kernel build; the others after it, so
# that they load the built kernels. All of them run beside the untimed
# kernel checks, so their times are upper bounds (BESIDE). Each part
# returns (its script lines, its launches by kernel); a child phase
# returns what the main path reads of it instead of the launches.
BACKGROUND_GROUPS = {
    "scans": ("y1_wind",),
    "pinn": ("y1_pinn_scripts", "y1_rotating", "y1_multispecies_demo"),
    "d1": ("child_d1",),
    "kernels": ("y1_canyon", "y1_k_sweep", "y1_extrapolate",
                "y1_assimilation"),
    "cli": ("child_x3",),
    "r1": ("child_r1",),
}
Y1_KIDS = ("B4", "B4-raw", "B6", "B7a")
CHILD_PHASES = ("child_d1", "child_r1", "child_x3")
BESIDE = ("the kernel build, the untimed kernel checks and the other "
          "background groups")


def child_d1():
    """D1 (b): two gloo ranks sharing the card (parallel.launch.spawn,
    device cuda:0) run d1_rank, their results in a directory under build/.
    Returns {"dir": that directory, "ranks_wall_s": the ranks' seconds}
    for phase_d1_distributed."""
    import tempfile

    from airpollution_tpu_torch.parallel import launch

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="d1_", dir=build)
    t0 = time.perf_counter()
    launch.spawn(d1_rank, 2, backend="gloo", device="cuda:0",
                 args=(tmp, "cuda:0"), timeout_s=D1_SPAWN_TIMEOUT)
    return [], {"dir": tmp, "ranks_wall_s": time.perf_counter() - t0}


def child_r1():
    """R1 (phase_r1_paper_harness): its B7a launches."""
    return [], {"B7a": phase_r1_paper_harness()}


def child_x3():
    """X3 (phase_x3_cli): its B1 and B6 launches."""
    return [], phase_x3_cli()


def background_child(out_path, group):
    """One group of BACKGROUND_GROUPS on the card, in a process of its own
    (start_background), on meshes of its own; writes {"scripts": [...],
    "launches": {...}, "phases": {child phase: what it returned},
    "seconds": ...} to ``out_path``. A failed gate raises (SmokeFailure)
    and a diverged canyon solve exits (SystemExit), so the process ends
    nonzero."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    launches = {kid: 0 for kid in Y1_KIDS}
    phases = {}
    scripts = []
    for name in BACKGROUND_GROUPS[group]:
        reset_counts()
        got, counted = globals()[name]()
        scripts += got
        if name in CHILD_PHASES:
            phases[name] = counted
            continue
        for kid in Y1_KIDS:
            launches[kid] += counted.get(kid, launches_of(kid))
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"scripts": scripts, "launches": launches,
                   "phases": phases, "seconds": time.perf_counter() - t0},
                  f)


def start_background(groups):
    """Start each of ``groups`` (names in BACKGROUND_GROUPS) in a process
    of its own (background_child; its log under build/). Returns a list
    of (group, the process, its result file, its log)."""
    import atexit
    import tempfile

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    started = []
    for group in groups:
        tmp = Path(tempfile.mkdtemp(prefix=f"bg_{group}_", dir=build))
        out, log = tmp / "result.json", tmp / "log.txt"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke as cs; "
                 f"cs.background_child({str(out)!r}, {group!r})"],
                cwd=Path(__file__).resolve().parent, stdout=f,
                stderr=subprocess.STDOUT)
        # A failure of the parent before its wait must not leave it running.
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        started.append((group, proc, out, log))
    return started


def wait_background(started):
    """Wait for the background processes (start_background) so that no
    timed phase shares the card with them; a failed one raises here with
    the end of its log. Returns their results, merged in
    BACKGROUND_GROUPS' order."""
    t0 = time.perf_counter()
    results = {}
    for group, proc, out, log in started:
        rc = proc.wait(timeout=BACKGROUND_TIMEOUT_S)
        if rc != 0:
            tail = log.read_text()[-6000:]
            raise SmokeFailure(f"the {group} background group failed "
                               f"(rc {rc}):\n{tail}")
        results[group] = json.loads(out.read_text())
        # The lines of the earlier phases that ran there (their t_s on
        # that process's clock), marked as sharing the card.
        for line in log.read_text().splitlines():
            if line.startswith('{"phase"'):
                print(json.dumps({**json.loads(line), "ran_beside": BESIDE}),
                      flush=True)
    emit({"phase": "background_wait", "wait_s": time.perf_counter() - t0,
          "process_seconds": {g: r["seconds"] for g, r in results.items()}})
    merged = {"scripts": [], "launches": {kid: 0 for kid in Y1_KIDS},
              "phases": {}, "seconds": {}}
    for group in BACKGROUND_GROUPS:
        if group in results:
            merged["scripts"] += results[group]["scripts"]
            merged["seconds"][group] = results[group]["seconds"]
            merged["phases"].update(results[group]["phases"])
            for kid, n in results[group]["launches"].items():
                merged["launches"][kid] += n
    return merged


def phase_y1_scripts(result, m_launches):
    """Slice 18's line (y1_scripts): each script's seconds, rows and gates
    from the background processes (``result``, wait_background; their
    times are upper bounds), and each kernel's launches on the scripts'
    paths, M1's and M2's (``m_launches``) counted in. Returns those
    launches."""
    launches = dict(result["launches"])
    for kid, v in m_launches.items():
        launches[kid] += v
    emit({"phase": "y1_scripts", "card": card_line(),
          "process_seconds": result["seconds"],
          "ran_beside": BESIDE,
          "launches": launches, "scripts": result["scripts"]})
    return launches


def structured_meshes(domain):
    """The structured meshes of the kernel checks and the main path, by
    (mesh size, dtype name): float64 ones where the float64 kernel checks
    need their own assembly; the 1025^2 and 513^2 float64 checks reuse the
    float32 assembly's inputs (the comparison needs identical inputs, not
    exact ones)."""
    import torch

    import airpollution_tpu_torch as apt

    meshes = {}
    for ms, nt, dtypes in ((65, 33, ("float64", "float32")),
                           (129, 1001, ("float64", "float32")),
                           (257, 1001, ("float64", "float32")),
                           (513, 1001, ("float32",)),
                           (1025, 1001, ("float32",))):
        mesh = apt.create_mesh(ms, 20.0)
        for name in dtypes:
            meshes[(ms, name)] = apt.MeshData(mesh, domain, nt=nt,
                                              dtype=getattr(torch, name))
    meshes[(1025, "float64")] = meshes[(1025, "float32")]
    return meshes


def host_setup(domain):
    """The set-up that needs no kernel and is bound by one host core, run
    on a thread beside the kernel build (45 s of eight nvcc in call 8):
    :func:`structured_meshes` and :func:`mesh_setup_1025` (its Delaunay
    alone ~15 s). Returns (meshes, (the 1025^2 unstructured mesh data,
    its set-up seconds))."""
    return structured_meshes(domain), mesh_setup_1025()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import airpollution_tpu_torch as apt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    domain = apt.Domain()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    setup = pool.submit(host_setup, domain)
    pool.shutdown(wait=False)
    # Slice 18: the scripts that launch no kernel of the port start now,
    # beside the kernel build, in processes of their own.
    background = start_background(("scans", "pinn"))
    phase_toolchain()
    # D1's gloo ranks, slice 18's scripts that launch kernels, X3 and R1
    # run beside the kernel checks.
    background += start_background(("d1", "kernels", "cli", "r1"))
    t0 = time.perf_counter()
    meshes, (md_u1025, u1025_setup) = setup.result()
    emit({"phase": "host_setup", "wait_s": time.perf_counter() - t0})

    problem = apt.Problem(sigma=1.0)
    problems = {"C1": apt.RotatingPlumeProblem(omega=0.05, D=0.3),
                "C3": robin_obstacle_problem(),
                "demo": apt.Problem(v=(1.0, 0.2), D=0.3, sigma=1.0)}
    md_257_65 = retimed(meshes[(257, "float32")], 65)
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
    worst["B4"] = max(worst["B4"], y1_canyon_kernel(meshes, cache))
    y1_result = wait_background(background)
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
    md_m1 = retimed(meshes[(1025, "float32")], 4001)
    # M1 and M2 are rows of scripts/torch_port_multispecies_fused_demo.py.
    m_launches, *m1 = phase_m1(md_m1, domain)
    launches["B6"] = m_launches["B6"]
    # Slice 7: B10 on M1's chain, against M1's solve.
    launches["B10"] = phase_b10_m1(m1, domain)
    del m1
    for kid, n in phase_m2(meshes[(257, "float32")], domain).items():
        m_launches[kid] += n
    del md_m1
    launches["B1-load"], s1 = phase_s1(meshes[(257, "float32")], domain)
    launches["B2-load"] = phase_s2(meshes[(513, "float32")], domain)
    launches["B1-BiCGStab"] = phase_s3(meshes[(257, "float32")], domain, s1)
    launches["B4-load"] = phase_scenario(1025, 2001, 200, 0.0, "p1")
    launches["B4-load"] += phase_scenario(513, 1001, 100, 0.005, "p2")
    # Slice 5: B4's raw mode, the fused gradients, and I1.
    cache.clear()
    nt_i1 = I1["nt"]
    md_513_i1 = retimed(meshes[(513, "float32")], nt_i1)
    md_1025_i1 = retimed(meshes[(1025, "float32")], nt_i1)
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
    md_129_grad = retimed(meshes[(129, "float64")], 129)
    _, f2_raw = phase_grad_129(md_129_grad)
    del md_129_grad
    launches["B4-raw"] = phase_i1()
    # Slice 6: general meshes, kernel B7.
    mesh_u257, _ = unstructured_mesh_timed(257)
    md_u257 = {name: apt.MeshData(mesh_u257, domain, nt=1001,
                                  dtype=getattr(torch, name))
               for name in ("float64", "float32")}
    worst.update(phase_b7([("257_f64", md_u257["float64"]),
                           ("257_f32", md_u257["float32"]),
                           ("1025_f32", md_u1025)]))
    b7_times, launches["B7b"] = b7_kernel_times(md_u257["float32"],
                                                md_u1025, u1025_setup)
    times.update(b7_times)
    del md_u1025, md_u257["float64"]
    launches["B7a"] = phase_u1(md_u257["float32"], domain)
    phase_g1(unstructured_md(129, 33, "float64"))
    phase_msh(domain)
    # Slice 7: the block-sharded solvers on B9 (B8 after X1, on its mesh).
    launches["B9"] = phase_b9_blocks(c1_be, meshes[(257, "float32")],
                                     problems, domain)
    # Slice 12: time-varying winds, B4, B9 and B4-raw with a fresh stack
    # per chunk.
    w_launches, w_b4_err = phase_time_varying(meshes)
    worst["B4"] = max(worst["B4"], w_b4_err)
    for kid, n in w_launches.items():
        launches[kid] += n
    # Slice 13: the command line, the uniform scan route at 2049^2 and
    # the spectral preconditioner.
    cli_launches, md_2049 = phase_cli(domain,
                                      y1_result["phases"]["child_x3"])
    for kid, n in cli_launches.items():
        launches[kid] += n
    # Slice 7: B8 on the 2049^2 mesh data of X1's command, retimed to
    # its 1001 steps.
    md_2049_b8 = retimed(md_2049, B8_NT)
    launches.update(phase_b8_2049(domain, md_2049_b8))
    times.update(b8_kernel_times(md_2049_b8))
    del md_2049_b8
    # Slice 17: multi-device on torch.distributed, D1: one NCCL rank here,
    # then B8-B10 and the stencil solver on 2 gloo ranks sharing the card.
    d1_launches = phase_d1_distributed(domain, md_2049, meshes,
                                       y1_result["phases"]["child_d1"])
    for kid, n in d1_launches.items():
        launches[kid] += n
    del md_2049
    # Slice 14: the rest of the inverse layer, B4-raw and B7a on new paths
    # (F2's launches are grad_129's slice-14 cases).
    fit_launches = phase_inverse_fits()
    fit_launches["B4-raw"] += f2_raw
    for kid, n in fit_launches.items():
        launches[kid] += n
    # Slice 15: the ensemble and the FNO surrogate, B7a's stacked mode
    # over the members.
    ens_launches = phase_ensemble_fno()
    for kid, n in ens_launches.items():
        launches[kid] += n
    # Slice 16: the paper's experiment harness; B7a under its unstructured
    # sweep.
    r1_b7a = y1_result["phases"]["child_r1"]["B7a"]
    launches["B7a"] += r1_b7a
    # Slice 18: the last scripts (B4, B4-raw, B6 and B7a on their paths;
    # M1 and M2 counted in).
    y1_launches = phase_y1_scripts(y1_result, m_launches)
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
            **({"time_varying_launches": w_launches[kid]}
               if kid in w_launches else {}),
            **({"cli_launches": cli_launches[kid]}
               if kid in cli_launches else {}),
            **({"inverse_fits_launches": fit_launches[kid]}
               if kid in fit_launches else {}),
            **({"ensemble_fno_launches": ens_launches[kid]}
               if kid in ens_launches else {}),
            **({"paper_harness_launches": r1_b7a} if kid == "B7a" else {}),
            **({"distributed_launches": d1_launches[kid]}
               if kid in d1_launches else {}),
            **({"scripts_launches": y1_launches[kid]}
               if kid in y1_launches else {}),
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
