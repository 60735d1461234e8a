"""Fused CRBE solves with one kernel launch per time step, PyTorch
counterpart of ``airpollution_tpu/ops/pallas_hbm.py``'s
``fused_solve_uniform_hbm``, ``fused_solve_canvas_hbm``,
``robin_rect_bounds``, ``guard_stride`` and ``_guarded_scan``.

- Kernel B2 (``fused_solve_uniform_hbm``): the uniform operator, for
  meshes past the whole-loop kernel's routing limit.
  ``csrc/uniform_step.cu``.
- Kernel B4 (``fused_solve_canvas_hbm``): the per-DOF canvas operator (a
  (21, n, n) stack: 15 coefficient canvases of the masked system, 3
  masked-mass and 3 inverse-diagonal canvases), for variable
  coefficients, Robin walls and obstacles at any mesh size.
  ``csrc/canvas_step.cu``.

Each step is one launch: one block per 2-D output tile runs the whole
step (RHS, warm start, k Chebyshev iterations) on a window with a halo in
both directions, reading the state once and writing it once. The host
loops over steps in chunks of ``guard_every``; after each chunk a
divergence flag is updated on the device, never read there, and read once
by the caller. Once the flag is set, later launches return at once.

On a CPU tensor each step is the kernel's plain version
(``fused_solver.plain_step``, :func:`plain_canvas_step`): the same step on
the full canvas.
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import fused_solver, linalg

KERNEL = _build.Kernel(
    "uniform_step", "uniform_step.cu",
    {torch.float32: "crbe_uniform_step_f32",
     torch.float64: "crbe_uniform_step_f64"},
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
CANVAS_KERNEL = _build.Kernel(
    "canvas_step", "canvas_step.cu",
    {torch.float32: "crbe_canvas_step_f32",
     torch.float64: "crbe_canvas_step_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)

#: Output tile edge, measured on an H100 (scripts/torch_port_tile_sweep.py):
#: fastest at 1025^2 with Chebyshev-8, 1,089 blocks of 512 threads.
TILE = 32
#: B4's output tile edge and block size (scripts/torch_port_tile_sweep.py).
CANVAS_TILE = 32
CANVAS_THREADS = 512


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


def kernel_step(scal, n_iters, u, up, u_out, up_out, use_ka, halt, tile,
                threads=fused_solver.THREADS):
    """One launch of B2: (u, up) -> (u_out, up_out); CUDA tensors only."""
    n = u.shape[-1]
    halo = fused_solver.halo_of(n_iters, use_ka)
    P = _build.pointer
    KERNEL.launch(u.dtype, P(scal), P(u), P(up), P(u_out), P(up_out),
                  P(halt), n, tile, halo, n_iters, int(use_ka), threads,
                  _build.current_stream())


def plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks):
    """B4's plain version: one full-canvas step with the (21, n, n) canvas
    operator ``C`` and the Chebyshev scalars ``cheb``
    (fused_solver.cheb_scalars); ``masks`` the (widened) interior
    rectangles. Returns ``(u_new, up_new)`` (``up_new`` None without
    ``up``). The coefficients of the masked system vanish outside each
    family's rows, so the matvec needs no mask; the masks enter through
    the warm start and Crank-Nicolson's ``(1 - mask) u`` term."""
    S, m, idg = C[:15], C[15:18], C[18:21]
    if use_ka:
        r = 2.0 * m * u + (1.0 - masks) * u - fused_solver.stencil_terms(S, u)
    else:
        r = m * u
    if up is None:
        x, up_new = masks * u, None
    else:
        x, up_new = masks * (2.0 * u - up), u
    r = r - fused_solver.stencil_terms(S, x)
    d = cheb[0] * (idg * r)
    for k in range(n_iters):
        x = x + d
        r = r - fused_solver.stencil_terms(S, d)
        d = cheb[1 + k] * d + cheb[1 + n_iters + k] * (idg * r)
    return x, up_new


def canvas_kernel_step(C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect,
                       halt, tile, threads=CANVAS_THREADS):
    """One launch of B4: (u, up) -> (u_out, up_out); CUDA tensors only.
    ``rect``: the interior-rectangle bounds (robin_rect_bounds)."""
    n = u.shape[-1]
    if C.shape != (21, n, n) or C.dtype != u.dtype or cheb.dtype != u.dtype:
        raise ValueError("C must be the (21, n, n) canvas operator of u, "
                         "C and cheb of u's dtype")
    halo = fused_solver.halo_of(n_iters, use_ka)
    P = _build.pointer
    CANVAS_KERNEL.launch(u.dtype, P(C), P(cheb), P(u), P(up), P(u_out),
                         P(up_out), P(halt), n, tile, halo, n_iters,
                         int(use_ka), *rect, threads,
                         _build.current_stream())


def _step_loop(step, u, up, n_steps, guard_every):
    """Run ``step`` n_steps times in guard chunks; returns ``(u, bad)``,
    ``bad`` the device-side divergence flag (see fused_solve_uniform_hbm).
    ``step(u, up, bad) -> (u, up)``."""
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
                            guard_every: int | None = None):
    """Whole time loop, one B2 launch per step (Chebyshev only).

    Same contract as fused_solver.fused_solve_uniform. With
    ``guard_every`` it returns ``(state, bad)``: ``bad`` is a 0-d int32
    tensor on the state's device holding the 1-based step that ends the
    first diverged guard chunk (non-finite or exploded state, see
    linalg.diverged_state), or -1 for a clean run.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        return (u0_fam, bad) if guard_every is not None else u0_fam
    scal = fused_solver.step_scalars(
        consts, mass_consts, inv_diag_consts, bounds, n_iters, dtype
    )
    u = fused_solver.to_canvases(spec, u0_fam)

    if u.is_cuda:
        tile = fused_solver.choose_tile(
            fused_solver.halo_of(n_iters, use_ka), dtype, TILE)
        step = _pingpong(
            lambda u, up, u_out, up_out, bad: kernel_step(
                scal, n_iters, u, up, u_out, up_out, use_ka, bad, tile),
            u, extrapolate)
    else:
        masks = fused_solver.rect_masks(u.shape[-1], dtype, device)

        def step(u, up, bad):
            if int(bad) >= 0:  # a free read on the CPU
                return u, up
            return fused_solver.plain_step(scal, n_iters, u, up, use_ka,
                                           masks)

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


def fused_solve_canvas_hbm(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                           u0_fam, *, n_steps: int, n_iters: int, bounds,
                           use_ka: bool = False, extrapolate: bool = False,
                           rect=None, guard_every: int | None = None):
    """Whole time loop with the canvas operator, one B4 launch per step
    (Chebyshev only, zero source).

    ``pattern`` a stencil.StencilPattern; ``coeffs`` the 15 coefficient
    grids of the masked system (stencil.extract_coefficients);
    ``mass_masked_fam`` zero on Dirichlet rows; ``inv_diag_fam`` the
    reciprocal system diagonal; all in family layout. ``u0_fam`` arrives
    full (boundary values included). ``rect``: interior-rectangle bounds
    for Robin walls (:func:`robin_rect_bounds`; the masks and coefficients
    must then come from the reduced Dirichlet set). Returns the final
    homogeneous state in family layout, and with ``guard_every`` the
    divergence flag as fused_solve_uniform_hbm does.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        return (u0_fam, bad) if guard_every is not None else u0_fam
    n, c = pattern.n, pattern.c
    rect = tuple(rect) if rect is not None else (1, c, 1, c)
    C = canvas_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                        dtype)
    cheb = fused_solver.cheb_scalars(bounds, n_iters, dtype, device)
    u = fused_solver.to_canvases(pattern, u0_fam)

    if u.is_cuda:
        tile = fused_solver.choose_tile(
            fused_solver.halo_of(n_iters, use_ka), dtype, CANVAS_TILE)
        step = _pingpong(
            lambda u, up, u_out, up_out, bad: canvas_kernel_step(
                C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect, bad,
                tile),
            u, extrapolate)
    else:
        masks = fused_solver.rect_masks(n, dtype, device, rect)

        def step(u, up, bad):
            if int(bad) >= 0:  # a free read on the CPU
                return u, up
            return plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks)

    u, bad = _step_loop(step, u, u.clone() if extrapolate else None,
                        n_steps, guard_every)
    out = fused_solver.from_canvases(pattern, u)
    return (out, bad) if guard_every is not None else out
