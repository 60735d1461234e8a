"""Fused CRBE solves with one kernel launch per time step, PyTorch
counterpart of ``airpollution_tpu/ops/pallas_hbm.py``'s
``fused_solve_uniform_hbm``, ``fused_solve_canvas_hbm``,
``fused_multispecies_canvas_hbm``, ``robin_rect_bounds``, ``guard_stride``
and ``_guarded_scan``.

- Kernel B2 (``fused_solve_uniform_hbm``): the uniform operator, for
  meshes past the whole-loop kernel's routing limit.
  ``csrc/uniform_step.cu``.
- Kernel B4 (``fused_solve_canvas_hbm``): the per-DOF canvas operator (a
  (21, n, n) stack: 15 coefficient canvases of the masked system, 3
  masked-mass and 3 inverse-diagonal canvases), for variable
  coefficients, Robin walls and obstacles at any mesh size, with an
  optional emission load. ``csrc/canvas_step.cu``.
- Kernel B6 (``fused_multispecies_canvas_hbm``): one Strang step of K
  species sharing the canvas operator, the (K, K) chemistry half-steps
  applied inside the kernel. ``csrc/multispecies_step.cu``.

Emission loads. The TPU kernels evaluate a problem's Python source hook
inside the kernel, on coordinates rebuilt from iotas. A Python hook cannot
be compiled into an ``nvcc`` kernel, so here each load is built in torch
from the problem's own ``source_xy`` on the same coordinates
(:func:`family_coordinates`) and handed to the kernel as one extra
(3, n, n) plane per sourced species (:class:`EmissionLoads`). A steady
source's load is built once per solve, any other's before every launch.

Each step is one launch: one block per 2-D output tile runs the whole
step (RHS, warm start, k Chebyshev iterations) on a window with a halo in
both directions, reading the state once and writing it once. The host
loops over steps in chunks of ``guard_every``; after each chunk a
divergence flag is updated on the device, never read there, and read once
by the caller. Once the flag is set, later launches return at once.

On a CPU tensor each step is the kernel's plain version
(``fused_solver.plain_step``, :func:`plain_canvas_step`,
:func:`plain_multispecies_step`): the same step on the full canvas.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import fused_solver, linalg
from airpollution_tpu_torch.problems import mix_species

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
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)
MULTISPECIES_KERNEL = _build.Kernel(
    "multispecies_step", "multispecies_step.cu",
    {torch.float32: "crbe_multispecies_step_f32",
     torch.float64: "crbe_multispecies_step_f64"},
    [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)

#: Output tile edge, measured on an H100 (scripts/torch_port_tile_sweep.py):
#: fastest at 1025^2 with Chebyshev-8, 1,089 blocks of 512 threads.
TILE = 32
#: B4's output tile edge and block size (scripts/torch_port_tile_sweep.py).
CANVAS_TILE = 32
CANVAS_THREADS = 512
#: B6's largest output tile edge and block size; the tile shrinks with K,
#: k and the dtype until the window planes fit (multispecies_tile).
MULTISPECIES_TILE = 32
MULTISPECIES_THREADS = 512
MAX_SPECIES = 8  # csrc/multispecies_step.cu kMaxSpecies
#: (x, y) offsets of each family's DOF from its cell's lower-left vertex,
#: in mesh steps: H edges at (i + 1/2, j), V at (i, j + 1/2), D at the
#: cell centre.
FAMILY_OFFSETS = ((0.5, 0.0), (0.0, 0.5), (0.5, 0.5))


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


def plain_canvas_step(C, cheb, n_iters, u, up, use_ka, masks, load=None):
    """B4's plain version: one full-canvas step with the (21, n, n) canvas
    operator ``C`` and the Chebyshev scalars ``cheb``
    (fused_solver.cheb_scalars); ``masks`` the (widened) interior
    rectangles; ``load`` an optional (3, n, n) emission load added to the
    right-hand side. Returns ``(u_new, up_new)`` (``up_new`` None without
    ``up``). The coefficients of the masked system vanish outside each
    family's rows, so the matvec needs no mask; the masks enter through
    the warm start and Crank-Nicolson's ``(1 - mask) u`` term."""
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
    for k in range(n_iters):
        x = x + d
        r = r - fused_solver.stencil_terms(S, d)
        d = cheb[1 + k] * d + cheb[1 + n_iters + k] * (idg * r)
    return x, up_new


def canvas_kernel_step(C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect,
                       halt, tile, threads=CANVAS_THREADS, load=None):
    """One launch of B4: (u, up) -> (u_out, up_out); CUDA tensors only.
    ``rect``: the interior-rectangle bounds (robin_rect_bounds); ``load``
    an optional (3, n, n) emission load."""
    n = u.shape[-1]
    if not (u.is_cuda and u_out.is_cuda and C.is_cuda and cheb.is_cuda):
        raise ValueError("canvas_kernel_step needs CUDA tensors")
    if C.shape != (21, n, n) or C.dtype != u.dtype or cheb.dtype != u.dtype:
        raise ValueError("C must be the (21, n, n) canvas operator of u, "
                         "C and cheb of u's dtype")
    if load is not None and (load.shape != u.shape or load.dtype != u.dtype):
        raise ValueError("load must be a (3, n, n) plane of u's dtype")
    halo = fused_solver.halo_of(n_iters, use_ka)
    P = _build.pointer
    CANVAS_KERNEL.launch(u.dtype, P(C), P(cheb), P(u), P(up), P(u_out),
                         P(up_out), P(halt), P(load), n, tile, halo, n_iters,
                         int(use_ka), *rect, threads,
                         _build.current_stream())


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


def family_coordinates(n: int, grid, dtype, device):
    """(X, Y): the (3, n, n) canvases of each family's DOF coordinates,
    ``x = xmin + (col + ox) h`` and ``y = ymin + (row + oy) h`` with the
    offsets of :data:`FAMILY_OFFSETS`, the coordinates the TPU kernels
    rebuild from iotas; ``grid = (xmin, ymin, h)``
    (mesh.data.structured_grid). Cells outside a family's grid get
    coordinates too; every load is masked to zero there."""
    xmin, ymin, h = (float(g) for g in grid)
    idx = torch.arange(n, dtype=dtype, device=device)
    X = torch.stack([(xmin + (idx + ox) * h).expand(n, n)
                     for ox, _ in FAMILY_OFFSETS])
    Y = torch.stack([(ymin + (idx + oy) * h)[:, None].expand(n, n)
                     for _, oy in FAMILY_OFFSETS])
    return X, Y


class EmissionLoads:
    """The per-species emission loads of a fused solve, as the kernels
    take them: one (3, n, n) plane per sourced species in ``planes`` (an
    (n_src, 3, n, n) tensor, None when no species is sourced), and
    ``index[k]``, the plane of species k or -1.

    A species' load for the step that ends at time t is, on each family
    canvas, ``(dt M) s`` (mass-lumped: ``mass3`` is the masked mass, zero
    on Dirichlet rows and dead DOFs) or ``mask (dt s)`` (the reference
    quadrature: the family rectangle ``masks``), with ``s = source_fn(X, Y,
    t)``, and zero on dead DOFs (``live`` 0 there) under either rule.
    Backward Euler samples t; Crank-Nicolson takes the trapezoid of t and
    t - dt. A steady species' plane is built once (its trapezoid 0.5 (a +
    a) is a exactly); :meth:`advance` rebuilds the others for the next
    step, in place, before that step's launches.
    """

    def __init__(self, source_fns, steady, *, grid, dt, t0, use_ka,
                 lumped, mass3, masks, live=None):
        self.index = []
        self._fns = []
        n = masks.shape[-1]
        self._X, self._Y = family_coordinates(n, grid, masks.dtype,
                                              masks.device)
        self._dt, self._t0, self._use_ka = float(dt), float(t0), use_ka
        self._lumped, self._mass3, self._masks = lumped, mass3, masks
        self._live = live
        self._step = 0
        for fn, st in zip(source_fns, steady):
            if fn is None:
                self.index.append(-1)
            else:
                self.index.append(len(self._fns))
                self._fns.append((fn, bool(st)))
        self.planes = None
        if self._fns:
            self.planes = torch.stack([self._load(fn, self._t0 + self._dt)
                                       for fn, _ in self._fns])

    def _at(self, fn, t):
        s = fn(self._X, self._Y, t)
        if self._lumped:
            load = (self._dt * self._mass3) * s
        else:
            load = self._masks * (self._dt * s)
        return load if self._live is None else load * self._live

    def _load(self, fn, t):
        if not self._use_ka:
            return self._at(fn, t)
        return 0.5 * (self._at(fn, t) + self._at(fn, t - self._dt))

    def advance(self):
        """Planes for the next step (steps count from 1)."""
        self._step += 1
        if self._step > 1:
            t = self._t0 + self._dt * self._step
            for j, (fn, steady) in enumerate(self._fns):
                if not steady:
                    self.planes[j].copy_(self._load(fn, t))
        return self.planes


def _canvas_live(pattern, dead_fam, dtype):
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
                           dt=None, dead_fam=None):
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
    ``source_xy``), loaded as :class:`EmissionLoads` describes; it needs
    ``grid`` and ``dt``, and ``dead_fam`` (family layout) zeroes its load
    on obstacle dead DOFs. Returns the final homogeneous state in family
    layout, and with ``guard_every`` the divergence flag as
    fused_solve_uniform_hbm does.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if source_fn is not None and (grid is None or dt is None):
        raise ValueError("source_fn requires grid=(xmin, ymin, h) and dt")
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
    loads = EmissionLoads(
        (source_fn,), (source_steady,), grid=grid, dt=dt, t0=t0,
        use_ka=use_ka, lumped=source_lumped, mass3=C[15:18], masks=masks,
        live=_canvas_live(pattern, dead_fam, dtype),
    ) if source_fn is not None else None

    def load_of_step():
        return None if loads is None else loads.advance()[0]

    if u.is_cuda:
        tile = fused_solver.choose_tile(
            fused_solver.halo_of(n_iters, use_ka), dtype, CANVAS_TILE)
        step = _pingpong(
            lambda u, up, u_out, up_out, bad: canvas_kernel_step(
                C, cheb, n_iters, u, up, u_out, up_out, use_ka, rect, bad,
                tile, load=load_of_step()),
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


def multispecies_tile(n_species: int, n_iters: int, use_ka: bool, dtype,
                      preferred: int = MULTISPECIES_TILE) -> int:
    """B6's output tile: the largest up to ``preferred`` whose 3K + 9
    window planes (K species x 3 families, then r, d, d_next) fit shared
    memory. Raises ValueError past the kernel's envelope."""
    if not 1 <= n_species <= MAX_SPECIES:
        raise ValueError(
            f"kernel B6 takes 1 to {MAX_SPECIES} species, got K={n_species} "
            f"— use fuse_chemistry=False (one B4 launch per species) or "
            f"the scan engines (matvec_impl='stencil'/'ell')"
        )
    try:
        return fused_solver.choose_tile(fused_solver.halo_of(n_iters, use_ka),
                                        dtype, preferred,
                                        planes=3 * n_species + 9)
    except ValueError:
        raise ValueError(
            f"kernel B6's shared-memory envelope exceeded: K={n_species} "
            f"species x 3 families + 9 planes do not fit even the smallest "
            f"tile with chebyshev_iters={n_iters} — reduce the species "
            f"count K (in-kernel chemistry holds all species resident), "
            f"lower chebyshev_iters (the halo scales with it), or use the "
            f"scan engines (matvec_impl='stencil'/'ell'), which have no "
            f"window envelope"
        ) from None


def plain_multispecies_step(C, cheb, E, n_iters, U, use_ka, masks,
                            loads=None, load_index=None):
    """B6's plain version: one Strang step of the (K, 3, n, n) species
    stack ``U``: the half-mix ``E`` (the (K, K) expm(-dt/2 R)), for each
    species B4's step without extrapolation (its load, when
    ``load_index[k] >= 0``, is ``loads[load_index[k]]``), the half-mix
    again."""
    Uh = mix_species(E, U)
    solved = []
    for k in range(U.shape[0]):
        li = -1 if load_index is None else load_index[k]
        x, _ = plain_canvas_step(C, cheb, n_iters, Uh[k], None, use_ka, masks,
                                 None if li < 0 else loads[li])
        solved.append(x)
    return mix_species(E, torch.stack(solved))


def multispecies_kernel_step(C, scal, n_iters, U, U_out, use_ka, rect, halt,
                             tile, loads=None, load_index=None,
                             threads=MULTISPECIES_THREADS):
    """One launch of B6: U -> U_out, (K, 3, n, n) species stacks; CUDA
    tensors only. ``scal``: the Chebyshev scalars then E_half row-major
    (:func:`multispecies_scalars`); ``loads`` (n_src, 3, n, n) with
    ``load_index`` as in :func:`plain_multispecies_step`."""
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
    halo = fused_solver.halo_of(n_iters, use_ka)
    P = _build.pointer
    MULTISPECIES_KERNEL.launch(
        U.dtype, P(C), P(scal), P(U), P(loads), P(U_out), P(halt),
        (ctypes.c_int * K)(*index), K, n, tile, halo, n_iters, int(use_ka),
        *rect, threads, _build.current_stream())


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
        tile = multispecies_tile(K, n_iters, use_ka, dtype)
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
        live=_canvas_live(pattern, dead_fam, dtype),
    ) if needs_t else None

    def next_loads():
        return None if loads is None else loads.advance()

    index = loads.index if loads is not None else [-1] * K
    if fuse_chemistry and U.is_cuda:
        scal = multispecies_scalars(bounds, n_iters, E_half, dtype, device)
        step = _pingpong(
            lambda U, _up, U_out, _up_out, bad: multispecies_kernel_step(
                C, scal, n_iters, U, U_out, use_ka, rect, bad, tile,
                next_loads(), index),
            U, False)
    elif U.is_cuda:
        tile = fused_solver.choose_tile(
            fused_solver.halo_of(n_iters, use_ka), dtype, CANVAS_TILE)

        def step(U, up, bad):
            planes = next_loads()
            Uh = mix_species(E, U)
            Ut = torch.empty_like(U)
            for k in range(K):
                canvas_kernel_step(
                    C, cheb, n_iters, Uh[k], None, Ut[k], None, use_ka, rect,
                    bad, tile,
                    load=None if index[k] < 0 else planes[index[k]])
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
