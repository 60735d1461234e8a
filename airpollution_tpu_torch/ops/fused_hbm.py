"""Fused CRBE solves with one kernel launch per time step, PyTorch
counterpart of ``airpollution_tpu/ops/pallas_hbm.py``'s
``fused_solve_uniform_hbm``, ``fused_solve_canvas_hbm``,
``fused_multispecies_canvas_hbm``, ``robin_rect_bounds``, ``guard_stride``
and ``_guarded_scan``.

- Kernel B2 (``fused_solve_uniform_hbm``): the uniform operator, for
  meshes past the whole-loop kernel's routing limit, with an optional
  source load (its own entry point, so the load-free step is unchanged).
  ``csrc/uniform_step.cu``.
- Kernel B4 (``fused_solve_canvas_hbm``): the per-DOF canvas operator (a
  (21, n, n) stack: 15 coefficient canvases of the masked system, 3
  masked-mass and 3 inverse-diagonal canvases), for variable
  coefficients, Robin walls and obstacles at any mesh size, with an
  optional load plane: a source load, an inhomogeneous Robin flux load on
  the wall lines, or their sum. ``csrc/canvas_step.cu``.
- Kernel B6 (``fused_multispecies_canvas_hbm``): one Strang step of K
  species sharing the canvas operator, the (K, K) chemistry half-steps
  applied inside the kernel. ``csrc/multispecies_step.cu``.
- B4's raw mode (``chebyshev_apply_canvas_hbm``): the bare
  Jacobi-preconditioned Chebyshev polynomial ``p(A) mask(b)`` from a zero
  start, one launch; over the transposed coefficients it is ``p(A^T)``.
  The primal and adjoint solve of the differentiable fused engine
  (diagnostics/inverse.py). ``csrc/canvas_step.cu`` (``kRaw``).
- Kernels B8, B9, B10: the block modes of B2, B4 and B6, one step on one
  row block of the canvas (:class:`BlockRows`: ``local`` interior rows and
  ``halo`` rows of each neighbour's) with global-row masks, writing the
  interior only; the steps of parallel/hbm_shard.py's block-sharded
  solvers (:func:`block_kernel_step`, :func:`canvas_block_kernel_step`,
  :func:`multispecies_block_kernel_step`; plain versions
  :func:`plain_block_step`, :func:`plain_canvas_block_step`,
  :func:`plain_multispecies_block_step`).

Loads (ops/loads.py). The TPU kernels evaluate a problem's Python hooks
inside the kernel, on coordinates rebuilt from iotas. A Python hook cannot
be compiled into an ``nvcc`` kernel, so here each load is built in torch
from the problem's own ``source_xy`` / ``robin_g_xy`` on the same
coordinates and handed to the kernel as one extra (3, n, n) plane per
sourced species. A steady source's load is built once per solve, any
other's before every launch; a Robin flux load rewrites only the wall
lines, before every launch.

Each step is one call of a kernel's entry point: one block per 2-D output
tile runs the step (RHS, warm start, k Chebyshev iterations) on a window
with a halo in both directions, reading the state once and writing it
once. B4 and B6 (and their raw and block modes) hold each window's
operator in registers, so a step too deep for them runs as 2-4 launches
of a part of its iterations each (:func:`canvas_plan`), x, r and d passed
on through a work buffer (:func:`work_buffer`). The host
loops over steps in chunks of ``guard_every``; after each chunk a
divergence flag is updated on the device, never read there, and read once
by the caller. Once the flag is set, later launches return at once.

On a CPU tensor each step is the kernel's plain version
(``fused_solver.plain_step``, :func:`plain_canvas_step`,
:func:`plain_multispecies_step`): the same step on the full canvas.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import fused_solver, linalg
from airpollution_tpu_torch.ops.loads import EmissionLoads, RobinFluxLoads
from airpollution_tpu_torch.problems import mix_species

# B2 takes a uniform plan's tile rows and columns and depth, and a work
# buffer (null at depth 1).
KERNEL = _build.Kernel(
    "uniform_step", "uniform_step.cu",
    {torch.float32: "crbe_uniform_step_f32",
     torch.float64: "crbe_uniform_step_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
LOAD_KERNEL = _build.Kernel(
    "uniform_step_load", "uniform_step.cu",
    {torch.float32: "crbe_uniform_step_load_f32",
     torch.float64: "crbe_uniform_step_load_f64"},
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
# The canvas kernels (B4, its raw mode, B6) take a plan's tile and depth
# and a work buffer (null at depth 1) instead of a halo and a block size.
CANVAS_KERNEL = _build.Kernel(
    "canvas_step", "canvas_step.cu",
    {torch.float32: "crbe_canvas_step_f32",
     torch.float64: "crbe_canvas_step_f64"},
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
CANVAS_RAW_KERNEL = _build.Kernel(
    "canvas_step_raw", "canvas_step.cu",
    {torch.float32: "crbe_canvas_step_raw_f32",
     torch.float64: "crbe_canvas_step_raw_f64"},
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
)
MULTISPECIES_KERNEL = _build.Kernel(
    "multispecies_step", "multispecies_step.cu",
    {torch.float32: "crbe_multispecies_step_f32",
     torch.float64: "crbe_multispecies_step_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
# The block modes (B8, B9, B10): one row block per launch, with the block's
# rows, global row offset and interior as four more ints.
BLOCK_KERNEL = _build.Kernel(
    "uniform_block_step", "uniform_step.cu",
    {torch.float32: "crbe_uniform_block_step_f32",
     torch.float64: "crbe_uniform_block_step_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
BLOCK_LOAD_KERNEL = _build.Kernel(
    "uniform_block_step_load", "uniform_step.cu",
    {torch.float32: "crbe_uniform_block_step_load_f32",
     torch.float64: "crbe_uniform_block_step_load_f64"},
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
CANVAS_BLOCK_KERNEL = _build.Kernel(
    "canvas_block_step", "canvas_step.cu",
    {torch.float32: "crbe_canvas_block_step_f32",
     torch.float64: "crbe_canvas_block_step_f64"},
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
)
MULTISPECIES_BLOCK_KERNEL = _build.Kernel(
    "multispecies_block_step", "multispecies_step.cu",
    {torch.float32: "crbe_multispecies_block_step_f32",
     torch.float64: "crbe_multispecies_block_step_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 14 + [ctypes.c_void_p],
)

MAX_SPECIES = 8  # csrc/multispecies_step.cu kMaxSpecies


def guard_stride(n_steps: int, target: int = 64) -> int:
    """Largest divisor of ``n_steps`` that is <= ``target``: the length of
    a divergence-guard chunk."""
    for d in range(min(target, n_steps), 0, -1):
        if n_steps % d == 0:
            return d
    return 1


def robin_rect_bounds(c, robin_sides):
    """Interior-rectangle bounds ``(h_lo, h_hi, v_lo, v_hi)`` for a Robin
    side spec: each named side leaves the Dirichlet set, widening the
    rectangle by its wall line (H rows 0 / c for bottom / top, V columns
    0 / c for left / right; D touches no wall). The canvas coefficients
    already carry the walls' alpha |e| terms, so the bounds are all that
    Robin changes in the kernel."""
    sides = robin_sides or ()
    return (0 if "bottom" in sides else 1,
            c + 1 if "top" in sides else c,
            0 if "left" in sides else 1,
            c + 1 if "right" in sides else c)


# --- the canvas kernels' plan (B4, B4's raw mode, B6 and their block modes)

#: The canvas kernels' (B4's and B6's) compiled launch shape per dtype,
#: threads per block and window cells per thread (csrc/canvas_tile.cuh
#: CANVAS_THREADS_* / CANVAS_CELLS_*): a window holds at most their product
#: of cells, each thread keeping its cells' 18 operator values, x and r in
#: registers. Measured on an H100 (scripts/torch_port_b4_b6_ab.py --sweep).
CANVAS_SHAPE = {torch.float32: (512, 4), torch.float64: (256, 4)}
#: The most launches one step is split into (csrc/tile_step.cuh kMaxDepth,
#: shared with the uniform step), and the output tiles the planner tries.
MAX_DEPTH = fused_solver.MAX_DEPTH
PLAN_TILES = (64, 56, 48, 44, 40, 36, 32, 30, 28, 26, 24, 22, 20, 18, 16,
              14, 12, 10, 8)
#: Plans measured on an H100 (scripts/torch_port_b4_b6_ab.py --sweep) for the
#: main paths' shapes, keyed by (mode, k, use_ka, K, dtype); every other
#: shape takes the cost model of :func:`canvas_plan`.
MEASURED_PLANS = {("raw", 12, False, 1, torch.float32): (28, 2)}


class CanvasPlan(NamedTuple):
    """How a canvas step is launched: the output tile edge and the number
    of launches (spans) the step's phases are split over."""

    tile: int
    depth: int = 1


# The spans of a split step, shared with the uniform step (fused_solver).
step_halo = fused_solver.step_halo
Span = fused_solver.Span
depth_fits = fused_solver.depth_fits
canvas_spans = fused_solver.step_spans


_elem = fused_solver._elem


def plan_fits(plan: CanvasPlan, n_iters: int, use_ka: bool, dtype, *,
              raw: bool = False, n_species: int | None = None,
              shape=None) -> bool:
    """Whether every span's window fits the compiled shape's registers
    (W^2 <= threads x cells; ``shape`` another (threads, cells) than
    :data:`CANVAS_SHAPE`'s) and its planes shared memory: 6 (d and d_next)
    for B4, 3K + 6 for B6."""
    if not depth_fits(n_iters, use_ka, raw, plan.depth):
        return False
    w = plan.tile + 2 * canvas_spans(n_iters, use_ka, raw,
                                     plan.depth)[0].halo
    threads, cells = shape or CANVAS_SHAPE[dtype]
    planes = 6 if n_species is None else 3 * n_species + 6
    return (w * w <= threads * cells
            and planes * w * w * _elem(dtype) <= fused_solver.SMEM_BUDGET)


def plan_cost(plan: CanvasPlan, n_iters: int, use_ka: bool, *,
              raw: bool = False, n_species: int = 1) -> float:
    """The cost model behind :func:`canvas_plan`, per output cell, in units
    of one cell's matvec phase: each span reads its window's values (the 18
    operator values; the first span the mass and the K states, a later one
    r and d of the K species), ~0.4 each, writes 3K values per tile cell
    (9K when another span follows), and runs its phases, each costing its
    square's rows times the window's width (the cells are dealt to warps
    in row-major order)."""
    K = n_species
    cost = 0.0
    for sp in canvas_spans(n_iters, use_ka, raw, plan.depth):
        w = plan.tile + 2 * sp.halo
        reads = 18 + (3 + 3 * K if sp.first else 6 * K)
        cost += 0.4 * (reads * w * w
                       + (3 if sp.last else 9) * K * plan.tile ** 2)
        cost += K * sum((w - 2 * lo) * w for lo in range(sp.halo + 1))
    return cost / plan.tile ** 2


@functools.lru_cache(maxsize=None)
def canvas_plan(n_iters: int, use_ka: bool, dtype, *, raw: bool = False,
                n_species: int | None = None) -> CanvasPlan:
    """The launch plan of a canvas step (B4 and B9; ``raw``: B4's raw
    mode; ``n_species``: B6 and B10): the measured plan of the shape where
    there is one (:data:`MEASURED_PLANS`), else the fitting (tile, depth)
    of least :func:`plan_cost` (cached: the differentiable engine asks once
    per solve). Raises ValueError when nothing fits."""
    mode = "raw" if raw else ("multispecies" if n_species else "step")
    key = (mode, n_iters, bool(use_ka), n_species or 1, dtype)
    if key in MEASURED_PLANS:
        return CanvasPlan(*MEASURED_PLANS[key])
    fits = [CanvasPlan(t, d) for d in range(1, MAX_DEPTH + 1)
            for t in PLAN_TILES
            if plan_fits(CanvasPlan(t, d), n_iters, use_ka, dtype, raw=raw,
                         n_species=n_species)]
    if not fits:
        halo = step_halo(n_iters, use_ka, raw)
        raise ValueError(f"halo {halo} too deep for the shared-memory budget")
    return min(fits, key=lambda p: (plan_cost(p, n_iters, use_ka, raw=raw,
                                              n_species=n_species or 1),
                                    -p.tile))


def work_buffer(plan: CanvasPlan, like: torch.Tensor, n_species: int = 1):
    """The work planes of a split step (x, r and d of every species, 9 K
    planes the shape of one of ``like``'s (rows, n) planes; two sets from
    depth 3 on), or None at depth 1."""
    if plan.depth == 1:
        return None
    sets = 1 if plan.depth == 2 else 2
    return torch.empty((sets * 9 * n_species,) + tuple(like.shape[-2:]),
                       dtype=like.dtype, device=like.device)


def kernel_step(scal, n_iters, u, up, u_out, up_out, use_ka, halt,
                plan: fused_solver.UniformPlan, load=None, work=None):
    """One launch of B2: (u, up) -> (u_out, up_out); CUDA tensors only.
    ``plan``: fused_solver.uniform_plan's; ``work``: its work buffer
    (fused_solver.uniform_work, made here when not given); ``load``: an
    optional (3, n, n) plane added to the right-hand side (B2's load entry
    point, counted in :data:`LOAD_KERNEL`)."""
    n = u.shape[-1]
    if not (u.is_cuda and u_out.is_cuda and scal.is_cuda):
        raise ValueError("kernel_step needs CUDA tensors")
    if load is not None and (load.shape != u.shape or load.dtype != u.dtype):
        raise ValueError("load must be a (3, n, n) plane of u's dtype")
    if work is None:
        work = fused_solver.uniform_work(plan, u)
    P = _build.pointer
    head = (P(scal), P(u), P(up), P(u_out), P(up_out), P(halt))
    tail = (P(work), n, plan.th, plan.tw, plan.depth, n_iters, int(use_ka),
            _build.current_stream())
    if load is None:
        KERNEL.launch(u.dtype, *head, *tail)
    else:
        LOAD_KERNEL.launch(u.dtype, *head, P(load), *tail)


def _iterate(S, idg, cheb, n_iters, x, r, d, it0, it1):
    """Chebyshev iterations [it0, it1) of the canvas kernels on the full
    canvas: x += d; r -= S d; d = a d + b (id r)."""
    for k in range(it0, it1):
        x = x + d
        r = r - fused_solver.stencil_terms(S, d)
        d = cheb[1 + k] * d + cheb[1 + n_iters + k] * (idg * r)
    return x, r, d


def plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks, load=None,
                      depth=1):
    """B4's plain version: one full-canvas step with the (21, n, n) canvas
    operator ``C`` and the Chebyshev scalars ``cheb``
    (fused_solver.cheb_scalars); ``masks`` the (widened) interior
    rectangles; ``load`` an optional (3, n, n) emission load added to the
    right-hand side. Returns ``(u_new, up_new)`` (``up_new`` None without
    ``up``). The coefficients of the masked system vanish outside each
    family's rows, so the matvec needs no mask; the masks enter through
    the warm start and Crank-Nicolson's ``(1 - mask) u`` term. ``depth``
    runs the iterations in the kernel's spans (:func:`canvas_spans`); the
    result is the same."""
    S, m, idg = C[:15], C[15:18], C[18:21]
    if use_ka:
        r = 2.0 * m * u + (1.0 - masks) * u - fused_solver.stencil_terms(S, u)
    else:
        r = m * u
    if load is not None:
        r = r + load
    if up is None:
        x, up_new = masks * u, None
    else:
        x, up_new = masks * (2.0 * u - up), u
    r = r - fused_solver.stencil_terms(S, x)
    d = cheb[0] * (idg * r)
    for sp in canvas_spans(n_iters, use_ka, False, depth):
        x, r, d = _iterate(S, idg, cheb, n_iters, x, r, d, sp.it0, sp.it1)
    return x + d, up_new


def canvas_kernel_step(C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect,
                       halt, plan: CanvasPlan, load=None, work=None):
    """One launch of B4 (``plan.depth`` kernel launches): (u, up) ->
    (u_out, up_out); CUDA tensors only. ``rect``: the interior-rectangle
    bounds (robin_rect_bounds); ``load`` an optional (3, n, n) emission
    load; ``work`` the split step's :func:`work_buffer` (made here when
    None)."""
    n = u.shape[-1]
    if not (u.is_cuda and u_out.is_cuda and C.is_cuda and cheb.is_cuda):
        raise ValueError("canvas_kernel_step needs CUDA tensors")
    if C.shape != (21, n, n) or C.dtype != u.dtype or cheb.dtype != u.dtype:
        raise ValueError("C must be the (21, n, n) canvas operator of u, "
                         "C and cheb of u's dtype")
    if load is not None and (load.shape != u.shape or load.dtype != u.dtype):
        raise ValueError("load must be a (3, n, n) plane of u's dtype")
    if work is None:
        work = work_buffer(plan, u)
    P = _build.pointer
    CANVAS_KERNEL.launch(u.dtype, P(C), P(cheb), P(u), P(up), P(u_out),
                         P(up_out), P(halt), P(load), P(work), n, plan.tile,
                         plan.depth, n_iters, int(use_ka), *rect,
                         _build.current_stream())


def raw_operator(pattern, coeffs, inv_diag_fam, dtype):
    """B4's (21, n, n) stack for the raw mode: the coefficient canvases,
    zero mass planes (unused there) and the inverse diagonal, as the JAX
    package builds it."""
    return canvas_operator(pattern, coeffs, torch.zeros_like(inv_diag_fam),
                           inv_diag_fam, dtype)


def plain_canvas_raw(C, cheb, n_iters, b, masks, depth=1):
    """B4's raw mode, plain version: ``p(A) mask(b)`` on the full canvas
    from a zero start, with the (21, n, n) stack ``C`` and the Chebyshev
    scalars ``cheb`` (fused_solver.cheb_scalars). Only the input is masked
    (see csrc/canvas_step.cu); the last iteration's matvec, whose r and d
    are never read, is skipped as the kernel skips it. ``depth`` as in
    :func:`plain_canvas_step`."""
    S, idg = C[:15], C[18:21]
    r = masks * b
    x = torch.zeros_like(b)
    d = cheb[0] * (idg * r)
    for sp in canvas_spans(n_iters, False, True, depth):
        x, r, d = _iterate(S, idg, cheb, n_iters, x, r, d, sp.it0, sp.it1)
    return x + d


def canvas_raw_kernel(C, cheb, n_iters, b, x_out, rect, plan: CanvasPlan,
                      work=None):
    """One launch of B4's raw mode (``plan.depth`` kernel launches):
    ``x_out = p(A) mask(b)``, (3, n, n) canvases; CUDA tensors only.
    ``rect``: interior-rectangle bounds; ``work`` as in
    :func:`canvas_kernel_step`."""
    n = b.shape[-1]
    if not (b.is_cuda and x_out.is_cuda and C.is_cuda and cheb.is_cuda):
        raise ValueError("canvas_raw_kernel needs CUDA tensors")
    if C.shape != (21, n, n) or C.dtype != b.dtype or cheb.dtype != b.dtype:
        raise ValueError("C must be the (21, n, n) canvas operator of b, "
                         "C and cheb of b's dtype")
    if x_out.shape != b.shape or x_out.dtype != b.dtype:
        raise ValueError("x_out must be like b")
    if work is None:
        work = work_buffer(plan, b)
    P = _build.pointer
    CANVAS_RAW_KERNEL.launch(b.dtype, P(C), P(cheb), P(b), P(x_out), P(work),
                             n, plan.tile, plan.depth, n_iters, *rect,
                             _build.current_stream())


def raw_plan(n_iters: int, dtype) -> CanvasPlan:
    """The raw mode's launch plan (:func:`canvas_plan`)."""
    try:
        return canvas_plan(n_iters, False, dtype, raw=True)
    except ValueError:
        raise ValueError(f"chebyshev_iters={n_iters} too deep for the raw "
                         f"mode's shared-memory budget in {dtype}") from None


def apply_canvas_raw(pattern, C, b_fam, *, n_iters: int, cheb, rect=None):
    """``p(A) mask(b)`` in family layout with a prebuilt raw stack ``C``
    (:func:`raw_operator`) and Chebyshev scalars ``cheb``: one launch of
    B4's raw mode on a CUDA tensor, its plain version on a CPU tensor."""
    n, c = pattern.n, pattern.c
    rect = tuple(rect) if rect is not None else (1, c, 1, c)
    b = fused_solver.to_canvases(pattern, b_fam.to(C.dtype))
    if b.is_cuda:
        x = torch.empty_like(b)
        canvas_raw_kernel(C, cheb, n_iters, b, x, rect,
                          raw_plan(n_iters, b.dtype))
    else:
        masks = fused_solver.rect_masks(n, b.dtype, b.device, rect)
        x = plain_canvas_raw(C, cheb, n_iters, b, masks)
    return fused_solver.from_canvases(pattern, x)


def chebyshev_apply_canvas_hbm(pattern, coeffs, inv_diag_fam, b_fam, *,
                               n_iters: int, bounds, rect=None):
    """Apply the Jacobi-preconditioned Chebyshev polynomial ``p(A) b`` (b
    masked to the interior rectangle, ``rect`` as in
    :func:`fused_solve_canvas_hbm`) from a zero start: B4's raw mode, one
    launch with all ``n_iters`` iterations. Over
    stencil.transpose_coefficients(coeffs) it applies ``p(A^T)``, the exact
    adjoint (``p(A)^T == p(A^T)``). The same polynomial and preconditioner
    as linalg.chebyshev. The solve and transpose solve of
    linalg.differentiable_chebyshev_solve on the fused engine (which builds
    the stack once per solve and calls :func:`apply_canvas_raw`)."""
    dtype = b_fam.dtype
    C = raw_operator(pattern, coeffs, inv_diag_fam, dtype)
    cheb = fused_solver.cheb_scalars(bounds, n_iters, dtype, b_fam.device)
    return apply_canvas_raw(pattern, C, b_fam, n_iters=n_iters, cheb=cheb,
                            rect=rect)


def _step_loop(step, u, up, n_steps, guard_every, keep=None):
    """Run ``step`` n_steps times in guard chunks; returns ``(u, bad)``,
    ``bad`` the device-side divergence flag (see fused_solve_uniform_hbm).
    ``step(u, up, bad) -> (u, up)``; ``keep(u)``, when given, sees the
    state at the end of every chunk."""
    device = u.device
    ref_norm = torch.linalg.norm(u)
    bad = torch.tensor(-1, dtype=torch.int32, device=device)
    chunk = n_steps if guard_every is None else guard_every
    if n_steps % chunk:
        raise ValueError("guard_every must divide n_steps")
    for i in range(n_steps // chunk):
        for _ in range(chunk):
            u, up = step(u, up, bad)
        tripped = (bad < 0) & linalg.diverged_state(u, ref_norm)
        bad.copy_(torch.where(tripped, (i + 1) * chunk, bad))
        if keep is not None:
            keep(u)
    return u, bad


def _pingpong(launch, u, extrapolate):
    """A step function for a one-step kernel ``launch(u, up, u_out, up_out,
    bad)`` that swaps two state buffers (and two u_prev buffers)."""
    bufs = {"u": torch.empty_like(u),
            "up": torch.empty_like(u) if extrapolate else None}

    def step(u, up, bad):
        u_nxt, up_nxt = bufs["u"], bufs["up"]
        launch(u, up, u_nxt, up_nxt, bad)
        bufs["u"], bufs["up"] = u, up
        return u_nxt, up_nxt

    return step


def fused_solve_uniform_hbm(spec, consts, mass_consts, inv_diag_consts,
                            u0_fam, *, n_steps: int, n_iters: int, bounds,
                            use_ka: bool = False, extrapolate: bool = False,
                            guard_every: int | None = None, source_fn=None,
                            source_steady: bool = False,
                            source_lumped: bool = True, grid=None, t0=0.0,
                            dt=None):
    """Whole time loop, one B2 launch per step (Chebyshev only).

    Same contract as fused_solver.fused_solve_uniform, sources included
    (one load plane, built once for a steady source and before every
    launch otherwise). With ``guard_every`` it returns ``(state, bad)``:
    ``bad`` is a 0-d int32 tensor on the state's device holding the
    1-based step that ends the first diverged guard chunk (non-finite or
    exploded state, see linalg.diverged_state), or -1 for a clean run.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if source_fn is not None and (grid is None or dt is None):
        raise ValueError("source_fn requires grid=(xmin, ymin, h) and dt")
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        return (u0_fam, bad) if guard_every is not None else u0_fam
    scal = fused_solver.step_scalars(
        consts, mass_consts, inv_diag_consts, bounds, n_iters, dtype
    )
    u = fused_solver.to_canvases(spec, u0_fam)
    masks = fused_solver.rect_masks(u.shape[-1], dtype, device)
    loads = fused_solver.uniform_loads(
        source_fn, source_steady, mass_consts, masks, grid=grid, dt=dt,
        t0=t0, use_ka=use_ka, lumped=source_lumped,
    ) if source_fn is not None else None

    def load_of_step():
        return None if loads is None else loads.advance()[0]

    if u.is_cuda:
        plan = fused_solver.uniform_plan(n_iters, use_ka, dtype, u.shape[-1])
        work = fused_solver.uniform_work(plan, u)
        step = _pingpong(
            lambda u, up, u_out, up_out, bad: kernel_step(
                scal, n_iters, u, up, u_out, up_out, use_ka, bad, plan,
                load=load_of_step(), work=work),
            u, extrapolate)
    else:
        def step(u, up, bad):
            load = load_of_step()
            if int(bad) >= 0:  # a free read on the CPU
                return u, up
            return fused_solver.plain_step(scal, n_iters, u, up, use_ka,
                                           masks, load)

    u, bad = _step_loop(step, u, u.clone() if extrapolate else None,
                        n_steps, guard_every)
    out = fused_solver.from_canvases(spec, u)
    return (out, bad) if guard_every is not None else out


def canvas_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam, dtype):
    """The (21, n, n) canvas operator stack of kernel B4."""
    return torch.cat([
        fused_solver.coeff_canvases(pattern, coeffs).to(dtype),
        fused_solver.to_canvases(pattern, mass_masked_fam.to(dtype)),
        fused_solver.to_canvases(pattern, inv_diag_fam.to(dtype)),
    ])


def canvas_live(pattern, dead_fam, dtype):
    """(3, n, n) canvases, 0 on dead DOFs and 1 elsewhere, or None."""
    if dead_fam is None:
        return None
    return 1.0 - fused_solver.to_canvases(pattern, dead_fam.to(dtype))


def fused_solve_canvas_hbm(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                           u0_fam, *, n_steps: int, n_iters: int, bounds,
                           use_ka: bool = False, extrapolate: bool = False,
                           rect=None, guard_every: int | None = None,
                           source_fn=None, source_steady: bool = False,
                           source_lumped: bool = True, grid=None, t0=0.0,
                           dt=None, dead_fam=None, robin_g_fn=None,
                           robin_sides=()):
    """Whole time loop with the canvas operator, one B4 launch per step
    (Chebyshev only).

    ``pattern`` a stencil.StencilPattern; ``coeffs`` the 15 coefficient
    grids of the masked system (stencil.extract_coefficients);
    ``mass_masked_fam`` zero on Dirichlet rows; ``inv_diag_fam`` the
    reciprocal system diagonal; all in family layout. ``u0_fam`` arrives
    full (boundary values included). ``rect``: interior-rectangle bounds
    for Robin walls (:func:`robin_rect_bounds`; the masks and coefficients
    must then come from the reduced Dirichlet set). ``source_fn``: an
    elementwise ``(x, y, t) -> s`` emission hook (a problem's
    ``source_xy``), loaded as ops/loads.EmissionLoads describes;
    ``robin_g_fn`` + ``robin_sides``: the problem's ``robin_g_xy`` and
    the Robin sides whose flux load ops/loads.RobinFluxLoads adds on the
    wall lines. Either needs ``grid`` and ``dt`` (the first step ends at
    ``t0 + dt``), and ``dead_fam`` (family layout) zeroes both loads on
    obstacle dead DOFs. Both go to the kernel as one plane. Returns the
    final homogeneous state in family layout, and with ``guard_every`` the
    divergence flag as fused_solve_uniform_hbm does.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    needs_t = source_fn is not None or robin_g_fn is not None
    if needs_t and (grid is None or dt is None):
        raise ValueError(
            "source_fn/robin_g_fn require grid=(xmin, ymin, h) and dt")
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        return (u0_fam, bad) if guard_every is not None else u0_fam
    n, c = pattern.n, pattern.c
    rect = tuple(rect) if rect is not None else (1, c, 1, c)
    C = canvas_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                        dtype)
    cheb = fused_solver.cheb_scalars(bounds, n_iters, dtype, device)
    u = fused_solver.to_canvases(pattern, u0_fam)
    masks = fused_solver.rect_masks(n, dtype, device, rect)
    live = canvas_live(pattern, dead_fam, dtype)
    load_of_step = load_planes(
        EmissionLoads(
            (source_fn,), (source_steady,), grid=grid, dt=dt, t0=t0,
            use_ka=use_ka, lumped=source_lumped, mass3=C[15:18],
            masks=masks, live=live,
        ) if source_fn is not None else None,
        RobinFluxLoads(
            robin_g_fn, tuple(robin_sides), grid=grid, dt=dt, use_ka=use_ka,
            masks=masks, live=live,
        ) if robin_g_fn is not None else None,
        t0, dt, u)

    if u.is_cuda:
        plan = canvas_plan(n_iters, use_ka, dtype)
        work = work_buffer(plan, u)
        step = _pingpong(
            lambda u, up, u_out, up_out, bad: canvas_kernel_step(
                C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect, bad,
                plan, load=load_of_step(), work=work),
            u, extrapolate)
    else:
        def step(u, up, bad):
            load = load_of_step()
            if int(bad) >= 0:  # a free read on the CPU
                return u, up
            return plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks,
                                     load)

    u, bad = _step_loop(step, u, u.clone() if extrapolate else None,
                        n_steps, guard_every)
    out = fused_solver.from_canvases(pattern, u)
    return (out, bad) if guard_every is not None else out


def load_planes(sources, walls, t0, dt, u):
    """``load_of_step()``: B4's load plane for the next step, or None. A
    Robin flux load is written on the wall lines of the source plane when
    that is rebuilt every step, else of a plane of its own over the steady
    source plane (or zero)."""
    if walls is None:
        return (lambda: None) if sources is None else \
            (lambda: sources.advance()[0])
    steady = sources is None or sources.steady
    own = None
    if steady:
        own = (torch.zeros_like(u) if sources is None
               else sources.planes[0].clone())
    step = [0]

    def load_of_step():
        step[0] += 1
        t = float(t0) + float(dt) * step[0]
        if not steady:
            plane = sources.advance()[0]
            walls.add(plane, plane, t)
            return plane
        walls.add(own, None if sources is None else sources.planes[0], t)
        return own

    return load_of_step


def multispecies_plan(n_species: int, n_iters: int, use_ka: bool,
                      dtype) -> CanvasPlan:
    """B6's launch plan (:func:`canvas_plan` with the K species' 3K mixed
    planes beside d and d_next in shared memory). Raises ValueError past
    the kernel's envelope."""
    if not 1 <= n_species <= MAX_SPECIES:
        raise ValueError(
            f"kernel B6 takes 1 to {MAX_SPECIES} species, got K={n_species} "
            f"— use fuse_chemistry=False (one B4 launch per species) or "
            f"the scan engines (matvec_impl='stencil'/'ell')"
        )
    try:
        return canvas_plan(n_iters, use_ka, dtype, n_species=n_species)
    except ValueError:
        raise ValueError(
            f"kernel B6's shared-memory envelope exceeded: K={n_species} "
            f"species x 3 families + 6 planes do not fit even the smallest "
            f"tile with chebyshev_iters={n_iters} — reduce the species "
            f"count K (in-kernel chemistry holds all species resident), "
            f"lower chebyshev_iters (the halo scales with it), or use the "
            f"scan engines (matvec_impl='stencil'/'ell'), which have no "
            f"window envelope"
        ) from None


def plain_multispecies_step(C, cheb, E, n_iters, U, use_ka, masks,
                            loads=None, load_index=None, depth=1):
    """B6's plain version: one Strang step of the (K, 3, n, n) species
    stack ``U``: the half-mix ``E`` (the (K, K) expm(-dt/2 R)), for each
    species B4's step without extrapolation (its load, when
    ``load_index[k] >= 0``, is ``loads[load_index[k]]``), the half-mix
    again. ``depth`` as in :func:`plain_canvas_step`."""
    Uh = mix_species(E, U)
    solved = []
    for k in range(U.shape[0]):
        li = -1 if load_index is None else load_index[k]
        x, _ = plain_canvas_step(C, cheb, n_iters, Uh[k], None, use_ka, masks,
                                 None if li < 0 else loads[li], depth)
        solved.append(x)
    return mix_species(E, torch.stack(solved))


def multispecies_kernel_step(C, scal, n_iters, U, U_out, use_ka, rect, halt,
                             plan: CanvasPlan, loads=None, load_index=None,
                             work=None):
    """One launch of B6 (``plan.depth`` kernel launches): U -> U_out,
    (K, 3, n, n) species stacks; CUDA tensors only. ``scal``: the
    Chebyshev scalars then E_half row-major (:func:`multispecies_scalars`);
    ``loads`` (n_src, 3, n, n) with ``load_index`` as in
    :func:`plain_multispecies_step`; ``work`` the split step's
    :func:`work_buffer` for K species (made here when None)."""
    K, _, n, _ = U.shape
    if not (U.is_cuda and U_out.is_cuda and C.is_cuda and scal.is_cuda):
        raise ValueError("multispecies_kernel_step needs CUDA tensors")
    if C.shape != (21, n, n) or C.dtype != U.dtype or scal.dtype != U.dtype:
        raise ValueError("C must be the (21, n, n) canvas operator of U, "
                         "C and scal of U's dtype")
    if scal.numel() != 1 + 2 * n_iters + K * K:
        raise ValueError("scal must hold the Chebyshev scalars and E_half")
    if not 1 <= K <= MAX_SPECIES:
        raise ValueError(f"kernel B6 takes 1 to {MAX_SPECIES} species")
    index = list(load_index) if load_index is not None else [-1] * K
    if any(i >= 0 for i in index) and (
            loads is None or loads.dtype != U.dtype
            or loads.shape[1:] != U.shape[1:] or max(index) >= len(loads)):
        raise ValueError("loads must be (n_src, 3, n, n) of U's dtype")
    if work is None:
        work = work_buffer(plan, U, K)
    P = _build.pointer
    MULTISPECIES_KERNEL.launch(
        U.dtype, P(C), P(scal), P(U), P(loads), P(U_out), P(halt), P(work),
        (ctypes.c_int * K)(*index), K, n, plan.tile, plan.depth, n_iters,
        int(use_ka), *rect, _build.current_stream())


def _host_f64(a):
    """A float64 CPU copy of a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=torch.float64)
    return torch.tensor(np.asarray(a, dtype=np.float64))


def multispecies_scalars(bounds, n_iters, E_half, dtype, device):
    """B6's scalar block: fused_solver.cheb_scalars, then E_half
    row-major, both computed on the host in double and cast once."""
    E = _host_f64(E_half).reshape(-1)
    return torch.cat([fused_solver.cheb_scalars(bounds, n_iters, dtype,
                                                device),
                      E.to(dtype=dtype, device=device)])


def fused_multispecies_canvas_hbm(pattern, coeffs, mass_masked_fam,
                                  inv_diag_fam, C0_fam, E_half, *,
                                  n_steps: int, n_iters: int, bounds,
                                  use_ka: bool = False, rect=None,
                                  snapshot_every=None, source_fns=None,
                                  source_steady=None, source_lumped=True,
                                  grid=None, t0=0.0, dt=None, dead_fam=None,
                                  guard_every: int | None = None,
                                  fuse_chemistry: bool = True):
    """Strang-split K-species loop on the shared canvas operator.

    ``C0_fam``: the (K, N) initial state in family layout, full (boundary
    values included; obstacle dead DOFs already 0). ``E_half``: the (K, K)
    half-step exponential expm(-dt/2 R), in float64 (cast once here).
    ``bounds``: the shared Chebyshev interval. ``rect``: Robin rectangle
    bounds, as in :func:`fused_solve_canvas_hbm`.

    ``fuse_chemistry=True``: one B6 launch per step, both half-mixes inside
    the kernel. ``False``: K B4 launches per step, the mixes as explicit
    sums of K scaled planes in between (elementwise, no matrix product).

    ``source_fns``: optional K-tuple of elementwise ``(x, y, t) -> s``
    emission hooks (None: that species has no source), with
    ``source_steady`` the matching K-tuple of steady flags;
    ``source_lumped`` picks the quadrature; they need ``grid`` and ``dt``,
    and ``dead_fam`` (family layout) zeroes the loads on dead DOFs
    (:class:`EmissionLoads`).

    Returns the final homogeneous (K, N) family state, or with
    ``snapshot_every=k`` the (n_steps / k, K, N) states after every k
    steps (no initial row); with ``guard_every`` also the divergence flag
    (checked per snapshot chunk when strided, else every ``guard_every``
    steps).
    """
    K = C0_fam.shape[0]
    dtype, device = C0_fam.dtype, C0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    n, c = pattern.n, pattern.c
    rect = tuple(rect) if rect is not None else (1, c, 1, c)
    source_fns = tuple(source_fns) if source_fns else (None,) * K
    if len(source_fns) != K:
        raise ValueError("source_fns must have one entry per species")
    source_steady = tuple(source_steady) if source_steady else (False,) * K
    if len(source_steady) != K:
        raise ValueError("source_steady must have one entry per species")
    needs_t = any(f is not None for f in source_fns)
    if needs_t and (grid is None or dt is None):
        raise ValueError("source_fns require grid=(xmin, ymin, h) and dt")
    if snapshot_every is not None and (
            snapshot_every < 1 or n_steps % snapshot_every):
        raise ValueError("snapshot_every must be a positive divisor "
                         "of n_steps")
    if fuse_chemistry:
        plan = multispecies_plan(K, n_iters, use_ka, dtype)
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        out = (C0_fam if snapshot_every is None
               else C0_fam.new_zeros((0,) + tuple(C0_fam.shape)))
        return (out, bad) if guard_every is not None else out

    C = canvas_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                        dtype)
    cheb = fused_solver.cheb_scalars(bounds, n_iters, dtype, device)
    E = _host_f64(E_half).to(dtype=dtype, device=device)
    U = torch.stack([fused_solver.to_canvases(pattern, C0_fam[k])
                     for k in range(K)])
    masks = fused_solver.rect_masks(n, dtype, device, rect)
    loads = EmissionLoads(
        source_fns, source_steady, grid=grid, dt=dt, t0=t0, use_ka=use_ka,
        lumped=source_lumped, mass3=C[15:18], masks=masks,
        live=canvas_live(pattern, dead_fam, dtype),
    ) if needs_t else None

    def next_loads():
        return None if loads is None else loads.advance()

    index = loads.index if loads is not None else [-1] * K
    if fuse_chemistry and U.is_cuda:
        scal = multispecies_scalars(bounds, n_iters, E_half, dtype, device)
        work = work_buffer(plan, U, K)
        step = _pingpong(
            lambda U, _up, U_out, _up_out, bad: multispecies_kernel_step(
                C, scal, n_iters, U, U_out, use_ka, rect, bad, plan,
                next_loads(), index, work),
            U, False)
    elif U.is_cuda:
        plan = canvas_plan(n_iters, use_ka, dtype)
        work = work_buffer(plan, U)

        def step(U, up, bad):
            planes = next_loads()
            Uh = mix_species(E, U)
            Ut = torch.empty_like(U)
            for k in range(K):
                canvas_kernel_step(
                    C, cheb, n_iters, Uh[k], None, Ut[k], None, use_ka, rect,
                    bad, plan,
                    load=None if index[k] < 0 else planes[index[k]],
                    work=work)
            return mix_species(E, Ut), None
    else:
        def step(U, up, bad):
            planes = next_loads()
            if int(bad) >= 0:  # a free read on the CPU
                return U, up
            return plain_multispecies_step(C, cheb, E, n_iters, U, use_ka,
                                           masks, planes, index), None

    def to_fam(U):
        return torch.stack([fused_solver.from_canvases(pattern, U[k])
                            for k in range(K)])

    snaps = [] if snapshot_every is not None else None
    chunk = snapshot_every if snapshot_every is not None else guard_every
    U, bad = _step_loop(
        step, U, None, n_steps, chunk,
        keep=None if snaps is None else (lambda U: snaps.append(to_fam(U))))
    out = to_fam(U) if snaps is None else torch.stack(snaps)
    return (out, bad) if guard_every is not None else out


# --- the block modes: kernels B8 (B2's), B9 (B4's) and B10 (B6's) ---------


class BlockRows(NamedTuple):
    """One row block of an n x n canvas, as the block kernels take it:
    ``local + 2 halo`` array rows whose row 0 is the global canvas row
    ``row0`` (negative for the first block), interior rows
    ``[halo, halo + local)``; rows past the canvas are padding."""

    n: int
    row0: int
    halo: int
    local: int

    @property
    def rows(self) -> int:
        return self.local + 2 * self.halo

    def kernel_args(self):
        """n, rows, row0, int_lo, int_hi: the kernels' geometry ints."""
        return (self.n, self.rows, self.row0, self.halo,
                self.halo + self.local)

    @property
    def live_rows(self) -> int:
        """The interior rows whose global row lies below n - 1 (the rows
        the uniform block step's tiles cover)."""
        first = self.row0 + self.halo
        return max(0, min(first + self.local, self.n - 1) - first)


def block_plan(n_iters: int, use_ka: bool, dtype, block: BlockRows):
    """B8's launch plan on ``block`` (fused_solver.uniform_plan's on the
    block's live rows, the tile height balanced over them)."""
    return fused_solver.uniform_plan(n_iters, use_ka, dtype, block.n,
                                     live_rows=block.live_rows)


def block_masks(block: BlockRows, dtype, device, rect=None):
    """``(masks, on_canvas)`` of a row block: the (3, rows, n) interior
    rectangles at the block's global rows, and the (rows, 1) indicator of
    its rows that lie on the canvas."""
    g = torch.arange(block.row0, block.row0 + block.rows, device=device)
    on = ((g >= 0) & (g < block.n)).to(dtype)[:, None]
    return (fused_solver.rect_masks(block.n, dtype, device, rect,
                                    row0=block.row0, rows=block.rows), on)


def _on_canvas(on, *planes):
    """Each plane (or None) with its rows past the canvas set to 0, as the
    block kernels read them."""
    return tuple(None if p is None else p * on for p in planes)


def plain_block_step(scal, n_iters, u, up, use_ka, masks, on_canvas,
                     load=None):
    """B8's plain version: :func:`fused_solver.plain_step` on a (3, rows, n)
    block with its :func:`block_masks`; the block's rows past the canvas
    act as 0 and come out 0. Returns ``(u_new, up_new)`` on every row of
    the block: the interior is the kernel's result, the halo rows are not
    (the kernel leaves them as they were)."""
    u, up, load = _on_canvas(on_canvas, u, up, load)
    x, up_new = fused_solver.plain_step(scal, n_iters, u, up, use_ka, masks,
                                        load)
    return x * on_canvas, up_new


def plain_canvas_block_step(C, cheb, n_iters, u, up, use_ka, masks,
                            on_canvas, load=None):
    """B9's plain version: :func:`plain_canvas_step` on a row block, ``C``
    the block's (21, rows, n) stack; result as :func:`plain_block_step`."""
    u, up, load = _on_canvas(on_canvas, u, up, load)
    x, up_new = plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks,
                                  load)
    return x * on_canvas, up_new


def plain_multispecies_block_step(C, cheb, E, n_iters, U, use_ka, masks,
                                  on_canvas, loads=None, load_index=None):
    """B10's plain version: :func:`plain_multispecies_step` on a row block
    of the (K, 3, rows, n) species stack; result as
    :func:`plain_block_step`."""
    U, loads = _on_canvas(on_canvas, U, loads)
    return plain_multispecies_step(C, cheb, E, n_iters, U, use_ka, masks,
                                   loads, load_index) * on_canvas


def _check_block(block: BlockRows, n_iters, use_ka, shape):
    if shape[-2:] != (block.rows, block.n):
        raise ValueError(f"the block arrays must have {block.rows} rows of "
                         f"{block.n}, got {tuple(shape)}")
    if block.halo < fused_solver.halo_of(n_iters, use_ka):
        raise ValueError("the block's halo is shallower than the step's "
                         "window halo")


def block_kernel_step(scal, n_iters, u, up, u_out, up_out, use_ka, halt,
                      plan: fused_solver.UniformPlan, block: BlockRows,
                      load=None, work=None):
    """One launch of B8 on a row block: (u, up) -> the interior rows of
    (u_out, up_out), (3, rows, n) blocks; CUDA tensors only. ``plan``:
    :func:`block_plan`'s; ``work``: its work buffer
    (fused_solver.uniform_work, made here when not given); ``load``: an
    optional (3, rows, n) load block (B8's load entry point, counted in
    :data:`BLOCK_LOAD_KERNEL`)."""
    if not (u.is_cuda and u_out.is_cuda and scal.is_cuda):
        raise ValueError("block_kernel_step needs CUDA tensors")
    _check_block(block, n_iters, use_ka, u.shape)
    if load is not None and (load.shape != u.shape or load.dtype != u.dtype):
        raise ValueError("load must be a (3, rows, n) block of u's dtype")
    if work is None:
        work = fused_solver.uniform_work(plan, u)
    P = _build.pointer
    head = (P(scal), P(u), P(up), P(u_out), P(up_out), P(halt))
    tail = (P(work), *block.kernel_args(), plan.th, plan.tw, plan.depth,
            n_iters, int(use_ka), _build.current_stream())
    if load is None:
        BLOCK_KERNEL.launch(u.dtype, *head, *tail)
    else:
        BLOCK_LOAD_KERNEL.launch(u.dtype, *head, P(load), *tail)


def canvas_block_kernel_step(C, cheb, n_iters, u, up, u_out, up_out, use_ka,
                             rect, halt, plan: CanvasPlan, block: BlockRows,
                             load=None, work=None):
    """One launch of B9 on a row block (``plan.depth`` kernel launches):
    ``C`` the block's (21, rows, n) stack, (u, up) -> the interior rows of
    (u_out, up_out); ``rect`` the global rectangle bounds; ``work`` as in
    :func:`canvas_kernel_step`, of the block's rows; CUDA tensors only."""
    if not (u.is_cuda and u_out.is_cuda and C.is_cuda and cheb.is_cuda):
        raise ValueError("canvas_block_kernel_step needs CUDA tensors")
    _check_block(block, n_iters, use_ka, u.shape)
    if C.shape != (21, block.rows, block.n) or C.dtype != u.dtype \
            or cheb.dtype != u.dtype:
        raise ValueError("C must be the block's (21, rows, n) stack, C and "
                         "cheb of u's dtype")
    if load is not None and (load.shape != u.shape or load.dtype != u.dtype):
        raise ValueError("load must be a (3, rows, n) block of u's dtype")
    if work is None:
        work = work_buffer(plan, u)
    P = _build.pointer
    CANVAS_BLOCK_KERNEL.launch(
        u.dtype, P(C), P(cheb), P(u), P(up), P(u_out), P(up_out), P(halt),
        P(load), P(work), *block.kernel_args(), plan.tile, plan.depth,
        n_iters, int(use_ka), *rect, _build.current_stream())


def multispecies_block_kernel_step(C, scal, n_iters, U, U_out, use_ka, rect,
                                   halt, plan: CanvasPlan, block: BlockRows,
                                   loads=None, load_index=None, work=None):
    """One launch of B10 on a row block (``plan.depth`` kernel launches):
    the (K, 3, rows, n) species block U -> the interior rows of U_out;
    ``C`` the block's (21, rows, n) stack, ``scal`` as
    :func:`multispecies_kernel_step`'s, ``loads`` (n_src, 3, rows, n),
    ``work`` as there, of the block's rows; CUDA tensors only."""
    K = U.shape[0]
    if not (U.is_cuda and U_out.is_cuda and C.is_cuda and scal.is_cuda):
        raise ValueError("multispecies_block_kernel_step needs CUDA tensors")
    _check_block(block, n_iters, use_ka, U.shape)
    if C.shape != (21, block.rows, block.n) or C.dtype != U.dtype \
            or scal.dtype != U.dtype:
        raise ValueError("C must be the block's (21, rows, n) stack, C and "
                         "scal of U's dtype")
    if scal.numel() != 1 + 2 * n_iters + K * K:
        raise ValueError("scal must hold the Chebyshev scalars and E_half")
    if not 1 <= K <= MAX_SPECIES:
        raise ValueError(f"kernel B10 takes 1 to {MAX_SPECIES} species")
    index = list(load_index) if load_index is not None else [-1] * K
    if any(i >= 0 for i in index) and (
            loads is None or loads.dtype != U.dtype
            or loads.shape[1:] != U.shape[1:] or max(index) >= len(loads)):
        raise ValueError("loads must be (n_src, 3, rows, n) of U's dtype")
    if work is None:
        work = work_buffer(plan, U, K)
    P = _build.pointer
    MULTISPECIES_BLOCK_KERNEL.launch(
        U.dtype, P(C), P(scal), P(U), P(loads), P(U_out), P(halt), P(work),
        (ctypes.c_int * K)(*index), K, *block.kernel_args(), plan.tile,
        plan.depth, n_iters, int(use_ka), *rect, _build.current_stream())
