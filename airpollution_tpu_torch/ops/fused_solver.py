"""Whole-loop fused CRBE solves, one kernel launch per solve, PyTorch
counterpart of ``airpollution_tpu/ops/pallas_solver.py``.

Layout: the three edge families H (n x c), V (c x n), D (c x c) are
embedded into one (3, n, n) zero-padded canvas tensor. Each step forms
the RHS (backward Euler ``M mask(u)``; Crank-Nicolson ``2 M mask(u) - A u``),
adds an optional load, takes the warm start (``mask(2u - u_prev)`` when
extrapolating), and runs a fixed number of iterations.

- Kernel B1 (``fused_solve_uniform``): the translation-invariant operator
  (ops/uniform.py: 15 stencil scalars, 3 interior mass and 3
  inverse-diagonal scalars, per-family interior rectangles derived from
  indices), in two variants:

  - k Chebyshev iterations, no reductions: ``csrc/uniform_solver.cu``, a
    cooperative persistent kernel with one grid barrier per step, each
    block stepping its output tiles with ``csrc/tile_step.cuh`` (the tile
    from :func:`uniform_plan`); with a load, its second entry point reads
    one (3, n, n) plane per step;
  - k BiCGStab iterations right-preconditioned by Jacobi:
    ``csrc/uniform_bicgstab.cu``, B5's loop (``csrc/bicgstab_loop.cuh``)
    on the 15 scalars.

  A source load (ops/loads.EmissionLoads) is one plane for a steady source
  and, for any other, a stack of one plane per step, built for a window of
  steps at a time; the state and u_prev carry across the launches of the
  windows, so the result is that of one launch.
- Kernel B5 (``fused_solve``): the per-DOF canvas operator (15 coefficient
  canvases of the masked system, masked-mass, inverse-diagonal and
  interior-mask canvases) with k fixed BiCGStab iterations,
  right-preconditioned by Jacobi, zero source. Crank-Nicolson costs no
  extra coefficients: with ``P = diag(interior)``, ``B = I - P`` and the
  masked system ``S = P (M + (dt/2) ka) + B``, the CN RHS is
  ``b = 2 M_masked u + B u - S u``. ``csrc/canvas_solver.cu``, a
  cooperative persistent kernel whose grid-wide dot products are summed
  by every block in one fixed order.

On a CUDA tensor each entry point launches its kernel; on a CPU tensor it
runs the plain version (:func:`plain_solve`,
:func:`plain_uniform_bicgstab_solve`, :func:`plain_bicgstab_solve`), the
same arithmetic on the full canvas with zero-padded shifts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops.loads import EmissionLoads
from airpollution_tpu_torch.utils.profiling import span

# B1 takes the plan's tile rows and columns and depth, and a work buffer
# (null at depth 1).
KERNEL = _build.Kernel(
    "uniform_solver", "uniform_solver.cu",
    {torch.float32: "crbe_uniform_solve_f32",
     torch.float64: "crbe_uniform_solve_f64"},
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
)
LOAD_KERNEL = _build.Kernel(
    "uniform_solver_load", "uniform_solver.cu",
    {torch.float32: "crbe_uniform_solve_load_f32",
     torch.float64: "crbe_uniform_solve_load_f64"},
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
)
BICGSTAB_KERNEL = _build.Kernel(
    "uniform_bicgstab", "uniform_bicgstab.cu",
    {torch.float32: "crbe_uniform_bicgstab_f32",
     torch.float64: "crbe_uniform_bicgstab_f64"},
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
)
CANVAS_KERNEL = _build.Kernel(
    "canvas_solver", "canvas_solver.cu",
    {torch.float32: "crbe_canvas_solve_f32",
     torch.float64: "crbe_canvas_solve_f64"},
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
)

#: Shared-memory budget a tile window may use: the 227 KB a block can
#: address on Hopper, less room for the static scalar block.
SMEM_BUDGET = 227 * 1024 - 2048
MAX_ITERS = 64  # csrc/tile_step.cuh kMaxIters
#: The uniform step kernels' compiled launch shape per dtype
#: (csrc/tile_step.cuh UNIFORM_THREADS_* and UniformShape): threads per
#: block and the cells per thread compiled; a launch takes the least that
#: holds its window, each cell keeping x and r (6 values) in registers.
#: Measured on an H100 (scripts/torch_port_ab.py --sweep).
UNIFORM_SHAPE = {torch.float32: (512, (4, 8, 12)),
                 torch.float64: (256, (4, 8))}
#: The tile rows and columns :func:`uniform_plan` chooses from (before
#: they are balanced over the live cells).
UNIFORM_EDGES = (8, 16, 24, 32, 40, 48, 52, 56, 60, 64, 72)
#: The most launches one step is split into (csrc/tile_step.cuh kMaxDepth).
MAX_DEPTH = 4
#: B5's and B1's BiCGStab variant's block size (csrc/bicgstab_loop.cuh
#: kBicgstabThreads; 92 ms per 257^2 solve against 104 ms at 256 in the
#: first design on an H100) and the most blocks they run (the size of their
#: buffer of per-block partial sums; kMaxGrid).
CANVAS_THREADS = 512
CANVAS_MAX_GRID = 2048
#: The SMs of an H100, for plans made off the card; a wrapper plans with
#: its card's count.
H100_SMS = 132
#: Memory for the per-step loads of a time-dependent source on B1: one
#: window of steps is launched at a time (64 steps at 257^2 in float32
#: are 51 MB).
LOAD_WINDOW_BYTES = 64 * 1024 * 1024
_EPS = 1e-30  # BiCGStab breakdown guard, as the JAX kernel's


def to_canvases(spec, x_fam):
    """Family-layout flat vector -> (3, n, n) canvases (H, V, D)."""
    n, c = spec.n, spec.c
    nH = n * c
    out = torch.zeros((3, n, n), dtype=x_fam.dtype, device=x_fam.device)
    out[0, :, :c] = x_fam[:nH].reshape(n, c)
    out[1, :c, :] = x_fam[nH:2 * nH].reshape(c, n)
    out[2, :c, :c] = x_fam[2 * nH:].reshape(c, c)
    return out


def from_canvases(spec, u3):
    """(3, n, n) canvases -> family-layout flat vector."""
    c = spec.c
    return torch.cat([u3[0, :, :c].reshape(-1), u3[1, :c, :].reshape(-1),
                      u3[2, :c, :c].reshape(-1)])


def canvas_index(spec, device) -> torch.Tensor:
    """Flat positions in the (3, n, n) canvases of a family-layout
    vector's entries, in its order: through it the conversions of
    :func:`to_canvases` and :func:`from_canvases` are one scatter into
    zeros and one gather, two host dispatches instead of ten, for a caller
    that converts every time step (fused_hbm.apply_canvas_raw under
    raw_solve_pair)."""
    n, c = spec.n, spec.c
    plane = torch.arange(n * n, device=device).reshape(n, n)
    return torch.cat([plane[:, :c].reshape(-1),
                      n * n + plane[:c, :].reshape(-1),
                      2 * n * n + plane[:c, :c].reshape(-1)])


def cheb_scalars(bounds, n_iters, dtype, device):
    """The Chebyshev recurrence as the kernels take it: 1/theta, then
    a_k = rho_{k+1} rho_k and b_k = 2 rho_{k+1} / delta for k < n_iters.

    The recurrence depends only on the interval, so it is evaluated once
    here in double precision instead of per iteration on the device."""
    if not 1 <= n_iters <= MAX_ITERS:
        raise ValueError(f"n_iters must be in [1, {MAX_ITERS}]")
    lo, hi = float(bounds[0]), float(bounds[1])
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    a, b = [], []
    for _ in range(n_iters):
        rho_new = 1.0 / (2.0 * sigma - rho)
        a.append(rho_new * rho)
        b.append(2.0 * rho_new / delta)
        rho = rho_new
    return torch.tensor([1.0 / theta] + a + b, dtype=dtype, device=device)


def uniform_scalars(consts, mass_consts, inv_diag_consts, dtype):
    """The uniform operator's 21 scalars: 15 stencil coefficients, 3 mass
    and 3 inverse-diagonal constants (B1's BiCGStab variant takes these
    alone)."""
    return torch.cat([consts.to(dtype), mass_consts.to(dtype),
                      inv_diag_consts.to(dtype)])


def step_scalars(consts, mass_consts, inv_diag_consts, bounds, n_iters,
                 dtype):
    """The Chebyshev kernels' scalar block: :func:`uniform_scalars`, then
    :func:`cheb_scalars`."""
    return torch.cat([uniform_scalars(consts, mass_consts, inv_diag_consts,
                                      dtype),
                      cheb_scalars(bounds, n_iters, dtype, consts.device)])


def halo_of(n_iters: int, use_ka: bool) -> int:
    """Window halo: the step applies A k + 1 times (Crank-Nicolson k + 2),
    and the last application's output is never read back into x."""
    return n_iters + (1 if use_ka else 0)


def step_halo(n_iters: int, use_ka: bool, raw: bool = False) -> int:
    """The phases of one step that shrink the window: the uniform and
    canvas steps' halo k + use_ka (:func:`halo_of`), B4's raw mode's
    k - 1 (x0 = 0, so its first matvec is skipped)."""
    return n_iters - 1 if raw else n_iters + int(use_ka)


class Span(NamedTuple):
    """One launch of a split step (csrc/tile_step.cuh make_span): its
    halo, the Chebyshev iterations [it0, it1) it runs (those with a matvec,
    0 .. k - 2), and ``ext``, the halos of the spans after it."""

    halo: int
    it0: int
    it1: int
    first: bool
    last: bool
    ext: int


def depth_fits(n_iters: int, use_ka: bool, raw: bool, depth: int) -> bool:
    """Whether ``depth`` spans split the step: each later span runs at
    least one iteration, the first holds the right-hand side and the
    initial residual (raw mode: at least one iteration)."""
    H = step_halo(n_iters, use_ka, raw)
    if not 1 <= depth <= MAX_DEPTH:
        return False
    lead = 1 if raw else int(use_ka) + 1
    return depth == 1 or (depth <= H and H // depth
                          + (1 if H % depth else 0) >= lead)


def step_spans(n_iters: int, use_ka: bool, raw: bool, depth: int):
    """The spans of a step split over ``depth`` launches: the H shrinking
    phases dealt as evenly as possible, the earlier spans taking the
    remainder, as the kernels deal them."""
    if not depth_fits(n_iters, use_ka, raw, depth):
        raise ValueError(f"depth {depth} does not split a step of "
                         f"chebyshev_iters={n_iters}")
    H = step_halo(n_iters, use_ka, raw)
    halos = [H // depth + (1 if j < H % depth else 0) for j in range(depth)]
    lead = 0 if raw else int(use_ka) + 1
    spans, before = [], 0
    for j, h in enumerate(halos):
        spans.append(Span(h, 0 if j == 0 else before - lead,
                          before + h - lead, j == 0, j == depth - 1,
                          sum(halos[j + 1:])))
        before += h
    return tuple(spans)


def _elem(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


class UniformPlan(NamedTuple):
    """How a uniform step is launched (B1, B2, B8): the output tile's rows
    and columns, and the number of launches (spans) a step is split
    over."""

    th: int
    tw: int
    depth: int = 1


def uniform_plan_fits(plan: UniformPlan, n_iters: int, use_ka: bool, dtype,
                      *, shape=None) -> bool:
    """Whether every span's window fits the compiled shape's registers
    (its cells <= threads x the most cells per thread; ``shape`` another
    (threads, cells) than :data:`UNIFORM_SHAPE`'s) and its 6 planes (d and
    d_next) shared memory."""
    if not depth_fits(n_iters, use_ka, False, plan.depth):
        return False
    h = step_spans(n_iters, use_ka, False, plan.depth)[0].halo
    threads, cells = shape or UNIFORM_SHAPE[dtype]
    w = (plan.th + 2 * h) * (plan.tw + 2 * h)
    return w <= threads * max(cells) and 6 * w * _elem(dtype) <= SMEM_BUDGET


def balanced(extent: int, edge: int) -> int:
    """The tile length that covers ``extent`` cells in as many tiles as
    ``edge`` would, as evenly as possible (at most ``edge``)."""
    extent = max(extent, 1)
    return -(-extent // -(-extent // edge))


def uniform_tiles(plan: UniformPlan, n: int, live_rows: int | None = None):
    """(tile rows, tiles per row) of a uniform step on an n x n canvas, or
    on a block with ``live_rows`` live rows (csrc/tile_step.cuh
    uniform_tiling): the tiles cover the live cells, global rows and
    columns below c = n - 1."""
    rows = n - 1 if live_rows is None else live_rows
    return max(1, -(-rows // plan.th)), max(1, -(-(n - 1) // plan.tw))


def uniform_cost(plan: UniformPlan, n_iters: int, use_ka: bool, dtype,
                 n: int, live_rows: int | None = None,
                 sms: int = H100_SMS) -> int:
    """What :func:`uniform_plan` minimises: the waves of tiles (one block
    per SM) times the cell steps a thread takes over the first span's
    phases. A warp's cells run along the window's rows, so a phase saves
    warp steps only by the rows its rectangle sheds: phase s of a
    Wr x Wc window takes ceil((Wr - 2 s) Wc / threads) steps."""
    h = step_spans(n_iters, use_ka, False, plan.depth)[0].halo
    threads = UNIFORM_SHAPE[dtype][0]
    tiles_r, tiles_c = uniform_tiles(plan, n, live_rows)
    wr, wc = plan.th + 2 * h, plan.tw + 2 * h
    steps = sum(-(-(wr - 2 * s) * wc // threads) for s in range(h + 1))
    return -(-tiles_r * tiles_c // sms) * steps


def uniform_candidates(n_iters: int, use_ka: bool, dtype, n: int,
                       depth: int, live_rows: int | None = None, *,
                       shape=None):
    """The plans :func:`uniform_plan` chooses from at ``depth``: tiles of
    :data:`UNIFORM_EDGES` rows and columns, balanced over the live cells
    (:func:`balanced`, so that the last tile row and column do not overrun
    them), that fit (:func:`uniform_plan_fits`, ``shape`` as there)."""
    c = n - 1
    rows = c if live_rows is None else live_rows
    plans = {UniformPlan(balanced(rows, a), balanced(c, b), depth)
             for a in UNIFORM_EDGES for b in UNIFORM_EDGES}
    return sorted(p for p in plans
                  if uniform_plan_fits(p, n_iters, use_ka, dtype,
                                       shape=shape))


@functools.lru_cache(maxsize=None)
def uniform_plan(n_iters: int, use_ka: bool, dtype, n: int, *,
                 live_rows: int | None = None) -> UniformPlan:
    """The launch plan of a uniform step on an n x n canvas (B1's whole
    loop, B2), or on a row block with ``live_rows`` rows of global index
    below n - 1 (B8): at the least depth where a candidate fits
    (:func:`uniform_candidates`), the one of least :func:`uniform_cost`,
    then the squarer (less halo per output cell), then the wider. Raises
    ValueError when nothing fits."""
    for depth in range(1, MAX_DEPTH + 1):
        if not depth_fits(n_iters, use_ka, False, depth):
            continue
        plans = uniform_candidates(n_iters, use_ka, dtype, n, depth,
                                   live_rows)
        if plans:
            return min(plans, key=lambda p: (
                uniform_cost(p, n_iters, use_ka, dtype, n, live_rows),
                -min(p.th, p.tw), -p.tw))
    raise ValueError(f"halo {halo_of(n_iters, use_ka)} too deep for the "
                     "registers and shared memory")


def uniform_work(plan: UniformPlan, like: torch.Tensor):
    """The work planes of a split uniform step (x, r and d: 9 planes the
    shape of one of ``like``'s (rows, n) planes; two sets from depth 3
    on), or None at depth 1."""
    if plan.depth == 1:
        return None
    sets = 1 if plan.depth == 2 else 2
    return torch.empty((sets * 9,) + tuple(like.shape[-2:]),
                       dtype=like.dtype, device=like.device)


#: The most cells per thread the BiCGStab kernels keep in registers, per
#: operator and dtype (csrc/*: Op::kMaxCells): 18 vector values per cell,
#: and B5's 18 operator values. Measured on an H100
#: (scripts/torch_port_ab.py --sweep): past these the registers spill and
#: global mode is faster (the uniform loop at 513^2: 4 cells 34.1 ms, global
#: 30.5 for 200 steps; the canvas loop at 257^2: 2 cells 70.6, global 67.2
#: for 1,000).
BICGSTAB_CELLS = {("uniform", torch.float32): 2,
                  ("uniform", torch.float64): 1,
                  ("canvas", torch.float32): 1,
                  ("canvas", torch.float64): 1}


def bicgstab_cells(n: int, operator: str, dtype, sms: int = H100_SMS) -> int:
    """The cells per thread of a BiCGStab solve (B5, B1's BiCGStab variant)
    on an n x n canvas with the "uniform" or "canvas" operator: the fewest
    that cover the canvas with one 512-thread block per SM on ``sms`` SMs,
    within the operator's register capacity (:data:`BICGSTAB_CELLS`); else
    0, global mode, the vectors in device memory. The kernel sizes its grid
    (csrc/bicgstab_loop.cuh solve_grid)."""
    for cells in range(1, BICGSTAB_CELLS[(operator, dtype)] + 1):
        if n * n <= CANVAS_THREADS * cells * sms:
            return cells
    return 0


def rect_masks(n: int, dtype, device, rect=None, row0: int = 0,
               rows: int | None = None):
    """(3, n, n) interior rectangles: H rows [h_lo, h_hi) x cols [0, c),
    V rows [0, c) x cols [v_lo, v_hi), D rows [0, c) x cols [0, c).
    ``rect = (h_lo, h_hi, v_lo, v_hi)`` defaults to the all-Dirichlet
    ``(1, c, 1, c)``; Robin walls widen it (fused_hbm.robin_rect_bounds).
    ``rows``: the (3, rows, n) masks of a row block instead, whose row 0 is
    the global canvas row ``row0`` (the bounds stay global)."""
    c = n - 1
    h_lo, h_hi, v_lo, v_hi = rect if rect is not None else (1, c, 1, c)
    i = torch.arange(n, device=device)
    r = i if rows is None else torch.arange(row0, row0 + rows, device=device)
    lt = i < c
    r_in = (r >= 0) & (r < c)
    rows_in = torch.stack([(r >= h_lo) & (r < h_hi), r_in, r_in])[:, :, None]
    cols = torch.stack([lt, (i >= v_lo) & (i < v_hi), lt])[:, None, :]
    return (rows_in & cols).to(dtype)


def _shift(x, dr=0, dc=0):
    """y[i, j] = x[i + dr, j + dc], zero outside (dr, dc in {-1, 0, 1})."""
    if dr == 1:
        x = F.pad(x[1:, :], (0, 0, 0, 1))
    elif dr == -1:
        x = F.pad(x[:-1, :], (0, 0, 1, 0))
    if dc == 1:
        x = F.pad(x[:, 1:], (0, 1))
    elif dc == -1:
        x = F.pad(x[:, :-1], (1, 0))
    return x


def stencil_terms(s, x):
    """The 15 stencil terms on (3, n, n) canvases, unmasked: ``s[t]`` are
    scalars (the uniform operator) or (n, n) coefficient canvases (the
    canvas operator)."""
    H, V, D = x[0], x[1], x[2]
    yH = (s[0] * H + s[1] * _shift(V, dc=1) + s[2] * D
          + s[3] * _shift(V, dr=-1) + s[4] * _shift(D, dr=-1))
    yV = (s[5] * V + s[6] * _shift(D, dc=-1) + s[7] * _shift(H, dc=-1)
          + s[8] * _shift(H, dr=1) + s[9] * D)
    yD = (s[10] * D + s[11] * _shift(V, dc=1) + s[12] * H
          + s[13] * _shift(H, dr=1) + s[14] * V)
    return torch.stack([yH, yV, yD])


def canvas_matvec(s, x, masks):
    """Rect-masked uniform stencil on (3, n, n) canvases."""
    return masks * stencil_terms(s, x)


def load_window(n: int, dtype, n_steps: int) -> int:
    """Steps per launch of B1 with a per-step load stack: as many as
    :data:`LOAD_WINDOW_BYTES` hold, at least 1, at most ``n_steps``."""
    plane = 3 * n * n * torch.tensor([], dtype=dtype).element_size()
    return max(1, min(n_steps, LOAD_WINDOW_BYTES // plane))


def uniform_loads(source_fn, source_steady, mass_consts, masks, **kw):
    """The EmissionLoads of a source on the uniform operator: the masked
    lumped mass is the family's interior mass constant on its rectangle.
    ``kw``: EmissionLoads' grid, dt, t0, use_ka and lumped."""
    mass3 = mass_consts.to(masks.dtype).reshape(3, 1, 1) * masks
    return EmissionLoads((source_fn,), (source_steady,), mass3=mass3,
                         masks=masks, **kw)


def _load_at(load, i):
    """Step i's plane of a load: None, one (3, n, n) plane for every step,
    or an (n_steps, 3, n, n) stack."""
    if load is None or load.dim() == 3:
        return load
    return load[i]


def _check_load(load, u3, n_steps):
    if load is None:
        return
    if load.dtype != u3.dtype or load.shape[-3:] != u3.shape or not (
            load.dim() == 3 or (load.dim() == 4 and load.shape[0] >= n_steps)):
        raise ValueError("load must be a (3, n, n) plane or an (n_steps, 3, "
                         "n, n) stack of the state's dtype")


def plain_step(scal, n_iters, u, up, use_ka, masks, load=None):
    """One full-canvas time step: the arithmetic of ``tile_step``, with an
    optional (3, n, n) load added to the right-hand side. Returns
    ``(u_new, up_new)`` (``up_new`` is None without ``up``)."""
    mass = scal[15:18].reshape(3, 1, 1)
    inv_diag = scal[18:21].reshape(3, 1, 1)
    r = mass * (masks * u)
    if use_ka:
        r = 2.0 * r - canvas_matvec(scal, u, masks)
    if load is not None:
        r = r + load
    if up is None:
        x, up_new = masks * u, None
    else:
        x, up_new = masks * (2.0 * u - up), u
    r = r - canvas_matvec(scal, x, masks)
    d = (inv_diag * scal[21]) * r
    for k in range(n_iters):
        x = x + d
        r = r - canvas_matvec(scal, d, masks)
        d = scal[22 + k] * d + (scal[22 + n_iters + k] * inv_diag) * r
    return x, up_new


def _start_prev(u3, up, extrapolate):
    """The u_prev a solve starts from: ``up`` when given (carried from an
    earlier launch), else the state itself."""
    if not extrapolate:
        return None
    return u3 if up is None else up


def plain_solve(scal, u3, *, n_steps, n_iters, use_ka, extrapolate, up=None,
                load=None):
    """The whole Chebyshev loop on the full canvas (B1's plain version).
    ``up``: the u_prev to start from (default u3); ``load``: None, one
    (3, n, n) plane added every step, or an (n_steps, 3, n, n) stack.
    Returns ``(u, up)`` (``up`` None without extrapolation)."""
    _check_load(load, u3, n_steps)
    masks = rect_masks(u3.shape[-1], u3.dtype, u3.device)
    u, up = u3, _start_prev(u3, up, extrapolate)
    for i in range(n_steps):
        u, up = plain_step(scal, n_iters, u, up, use_ka, masks,
                           _load_at(load, i))
    return u, up


def kernel_solve(scal, u3, *, n_steps, n_iters, use_ka, extrapolate, up=None,
                 load=None, plan: UniformPlan | None = None):
    """The whole Chebyshev loop in one launch of B1 (CUDA tensors only);
    arguments and result as :func:`plain_solve`; ``plan`` by default
    :func:`uniform_plan`'s. With a load the launch goes to
    B1's load entry point, counted in :data:`LOAD_KERNEL`."""
    if not u3.is_cuda or not scal.is_cuda:
        raise ValueError("kernel_solve needs CUDA tensors")
    _check_load(load, u3, n_steps)
    up = _start_prev(u3, up, extrapolate)
    if n_steps == 0:
        return u3, up
    n = u3.shape[-1]
    plan = plan or uniform_plan(n_iters, use_ka, u3.dtype, n)
    ua = u3.contiguous().clone()
    ub = torch.empty_like(ua)
    upa = up.contiguous().clone() if extrapolate else None
    upb = torch.empty_like(ua) if extrapolate else None
    work = uniform_work(plan, ua)
    grid = ctypes.c_int(0)
    P = _build.pointer
    head = (P(scal.contiguous()), P(ua), P(ub), P(upa), P(upb))
    geo = (n, plan.th, plan.tw, plan.depth, n_iters, int(use_ka), n_steps)
    if load is None:
        KERNEL.launch(u3.dtype, *head, P(work), *geo,
                      _build.current_stream(), ctypes.byref(grid))
    else:
        stride = 0 if load.dim() == 3 else load[0].numel()
        LOAD_KERNEL.launch(u3.dtype, *head, P(load.contiguous()), P(work),
                           *geo, stride, _build.current_stream(),
                           ctypes.byref(grid))
    if n_steps % 2 == 0:
        return ua, upa
    return ub, upb


def _guard(a):
    return torch.where(a == 0, torch.full_like(a, _EPS), a)


def _dot(a, b):
    """Dot product of two canvas stacks, summed in double (as kernels B5
    and B1's BiCGStab variant sum; see csrc/bicgstab_loop.cuh)."""
    return torch.sum(a * b, dtype=torch.float64)


def _bicgstab_iterations(apply, idg, r, u, n_iters):
    """k fixed BiCGStab iterations from the initial residual ``r`` and
    iterate ``u``, right-preconditioned by ``idg``, with p, v reset to 0
    and (rho, alpha, omega) to 1, as the JAX kernels do. The dot products
    and the scalar recurrence are carried in double, the vectors in u's
    dtype. Returns the iterate."""
    dtype = u.dtype
    one = torch.ones((), dtype=torch.float64, device=u.device)
    rh = r
    p = torch.zeros_like(u)
    v = torch.zeros_like(u)
    rho_old, alpha, omega = one, one, one
    for _ in range(n_iters):
        rho = _dot(rh, r)
        beta = (rho / _guard(rho_old)) * (alpha / _guard(omega))
        p = r + beta.to(dtype) * (p - omega.to(dtype) * v)
        w = idg * p
        v = apply(w)
        alpha = rho / _guard(_dot(rh, v))
        u = u + alpha.to(dtype) * w
        r = r - alpha.to(dtype) * v
        w = idg * r
        t = apply(w)
        omega = _dot(t, r) / _guard(_dot(t, t))
        u = u + omega.to(dtype) * w
        r = r - omega.to(dtype) * t
        rho_old = rho
    return u


def plain_uniform_bicgstab_solve(scal, u3, *, n_steps, n_iters, use_ka,
                                 extrapolate, up=None, load=None):
    """B1's BiCGStab variant, plain: the whole loop on the full canvas with
    the uniform operator's 21 scalars (:func:`uniform_scalars`). Each
    step's RHS is that of the Chebyshev variant (:func:`plain_step`), then
    k BiCGStab iterations from the (masked) warm start. ``up`` and
    ``load`` and the result as :func:`plain_solve`."""
    _check_load(load, u3, n_steps)
    masks = rect_masks(u3.shape[-1], u3.dtype, u3.device)
    mass = scal[15:18].reshape(3, 1, 1)
    inv_diag = scal[18:21].reshape(3, 1, 1)

    def apply(x):
        return canvas_matvec(scal, x, masks)

    u, up = u3, _start_prev(u3, up, extrapolate)
    for i in range(n_steps):
        r = mass * (masks * u)
        if use_ka:
            r = 2.0 * r - apply(u)
        ld = _load_at(load, i)
        if ld is not None:
            r = r + ld
        if up is None:
            x = masks * u
        else:
            x, up = masks * (2.0 * u - up), u
        r = r - apply(x)
        u = _bicgstab_iterations(apply, inv_diag, r, x, n_iters)
    return u, up


def _bicgstab_buffers(u3, cells: int):
    """Work canvases of the cooperative BiCGStab kernels (r, p and v twice,
    u_prev's second buffer; in global mode also the own u, r, rhat, p, v,
    t), and the four per-block partial sums with the grid barrier's
    counter (csrc/bicgstab_loop.cuh launch_bicgstab)."""
    planes = 6 if cells else 12
    work = torch.empty((planes,) + tuple(u3.shape), dtype=u3.dtype,
                       device=u3.device)
    partials = torch.empty(4 * CANVAS_MAX_GRID + 1, dtype=torch.float64,
                           device=u3.device)
    return work, partials


def _device_cells(u3, operator):
    sms = torch.cuda.get_device_properties(u3.device).multi_processor_count
    return bicgstab_cells(u3.shape[-1], operator, u3.dtype, sms)


def kernel_uniform_bicgstab_solve(scal, u3, *, n_steps, n_iters, use_ka,
                                  extrapolate, up=None, load=None,
                                  cells: int | None = None):
    """The whole BiCGStab loop in one launch of B1's BiCGStab variant (CUDA
    tensors only); arguments and result as
    :func:`plain_uniform_bicgstab_solve`; ``cells`` per thread by default
    :func:`bicgstab_cells`' for the card."""
    if not u3.is_cuda or not scal.is_cuda:
        raise ValueError("kernel_uniform_bicgstab_solve needs CUDA tensors")
    if scal.numel() < 21 or scal.dtype != u3.dtype:
        raise ValueError("scal must hold the 21 uniform scalars of u3's "
                         "dtype")
    _check_load(load, u3, n_steps)
    up = _start_prev(u3, up, extrapolate)
    if n_steps == 0:
        return u3, up
    u = u3.contiguous().clone()
    up = up.contiguous().clone() if extrapolate else None
    cells = _device_cells(u, "uniform") if cells is None else cells
    work, partials = _bicgstab_buffers(u, cells)
    stride = 0 if load is None or load.dim() == 3 else load[0].numel()
    grid = ctypes.c_int(0)
    P = _build.pointer
    BICGSTAB_KERNEL.launch(
        u.dtype, P(scal.contiguous()), P(u), P(up), P(work), P(partials),
        P(None if load is None else load.contiguous()), u.shape[-1], n_steps,
        n_iters, int(use_ka), stride, cells, _build.current_stream(),
        ctypes.byref(grid))
    return u, up


def fused_solve_uniform(spec, consts, mass_consts, inv_diag_consts, u0_fam,
                        *, n_steps: int, n_iters: int, use_ka: bool = False,
                        extrapolate: bool = False,
                        method: str = "chebyshev", bounds=None,
                        source_fn=None, source_steady: bool = False,
                        source_lumped: bool = True, grid=None, t0=0.0,
                        dt=None):
    """Whole-loop fused solve with the translation-invariant operator
    (kernel B1).

    ``consts``: the 15 stencil scalars of the masked system
    (uniform.extract_constants); ``mass_consts`` / ``inv_diag_consts`` the
    per-family interior mass and 1/diagonal scalars; ``method``
    ``"chebyshev"`` (``bounds``, the interval (lo, hi), required) or
    ``"bicgstab"`` (``bounds`` None). ``u0_fam`` arrives full (boundary
    values included). Returns the final homogeneous state in family
    layout.

    ``source_fn``: an elementwise ``(x, y, t) -> s`` source hook (a
    problem's ``source_xy``), loaded as ops/loads.EmissionLoads describes
    (lumped ``dt m_f s`` or, with ``source_lumped=False``, ``dt s``,
    rect-masked); it needs ``grid = (xmin, ymin, h)`` and ``dt``; the
    solve's first step ends at ``t0 + dt``. A ``source_steady`` load is
    one plane for the whole launch; any other is built per step, a window
    of :func:`load_window` steps per launch.
    """
    if method not in ("bicgstab", "chebyshev"):
        raise ValueError(f"unknown method {method!r}")
    if (method == "chebyshev") != (bounds is not None):
        raise ValueError("bounds must be given exactly for chebyshev")
    if source_fn is not None and (grid is None or dt is None):
        raise ValueError("source_fn requires grid=(xmin, ymin, h) and dt")
    dtype = u0_fam.dtype
    with span("fused.operator"):
        if method == "chebyshev":
            scal = step_scalars(consts, mass_consts, inv_diag_consts, bounds,
                                n_iters, dtype)
        else:
            scal = uniform_scalars(consts, mass_consts, inv_diag_consts,
                                   dtype)
        u3 = to_canvases(spec, u0_fam)
        if u3.is_cuda:
            run = kernel_solve if method == "chebyshev" \
                else kernel_uniform_bicgstab_solve
        elif u3.device.type == "cpu":
            run = plain_solve if method == "chebyshev" \
                else plain_uniform_bicgstab_solve
        else:
            raise ValueError(f"unsupported device {u3.device}")
        loads = None if source_fn is None else uniform_loads(
            source_fn, source_steady, mass_consts,
            rect_masks(spec.n, dtype, u3.device), grid=grid, dt=dt, t0=t0,
            use_ka=use_ka, lumped=source_lumped)
    kw = dict(n_iters=n_iters, use_ka=use_ka, extrapolate=extrapolate)
    with span("fused.steps"):
        if loads is None:
            u, _ = run(scal, u3, n_steps=n_steps, **kw)
        elif source_steady:
            u, _ = run(scal, u3, n_steps=n_steps, load=loads.planes[0], **kw)
        else:
            window = load_window(spec.n, dtype, n_steps)
            u, up, done = u3, None, 0
            while done < n_steps:
                count = min(window, n_steps - done)
                u, up = run(scal, u, n_steps=count, up=up,
                            load=loads.window(count)[:, 0], **kw)
                done += count
    with span("crbe.lift"):
        return from_canvases(spec, u)


def coeff_canvases(pattern, coeffs):
    """The 15 coefficient grids (stencil.extract_coefficients order: 5 H-row,
    5 V-row, 5 D-row terms) embedded at their row family's region of a
    (15, n, n) zero canvas stack."""
    n, c = pattern.n, pattern.c
    out = torch.zeros((15, n, n), dtype=coeffs[0].dtype,
                      device=coeffs[0].device)
    for i, g in enumerate(coeffs):
        if i < 5:
            out[i, :, :c] = g
        elif i < 10:
            out[i, :c, :] = g
        else:
            out[i, :c, :c] = g
    return out


def bicgstab_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                      interior_fam, dtype):
    """B5's (24, n, n) operator stack: the 15 coefficient canvases, then
    the masked mass, inverse diagonal and interior mask canvases."""
    return torch.cat([
        coeff_canvases(pattern, coeffs).to(dtype),
        to_canvases(pattern, mass_masked_fam.to(dtype)),
        to_canvases(pattern, inv_diag_fam.to(dtype)),
        to_canvases(pattern, interior_fam.to(dtype)),
    ])


def plain_bicgstab_solve(C, u3, *, n_steps, n_iters, use_ka, extrapolate):
    """B5's plain version: the whole loop on the full canvas. ``C`` is the
    (24, n, n) operator stack of :func:`fused_solve` (15 coefficients, 3
    masked mass, 3 inverse diagonal, 3 interior masks); the iterations are
    :func:`_bicgstab_iterations`'."""
    S, m, idg, mk = C[:15], C[15:18], C[18:21], C[21:24]

    def apply(x):
        return stencil_terms(S, x)

    u, up = u3, (u3 if extrapolate else None)
    for _ in range(n_steps):
        if use_ka:
            r = 2.0 * m * u + (1.0 - mk) * u - apply(u)
        else:
            r = m * u
        if extrapolate:
            u, up = (2.0 * u - up) * mk, u
        else:
            u = u * mk
        r = r - apply(u)
        u = _bicgstab_iterations(apply, idg, r, u, n_iters)
    return u


def kernel_bicgstab_solve(C, u3, *, n_steps, n_iters, use_ka, extrapolate,
                          cells: int | None = None):
    """The whole loop in one launch of B5 (CUDA tensors only); ``cells``
    per thread by default :func:`bicgstab_cells`' for the card."""
    if not u3.is_cuda or not C.is_cuda:
        raise ValueError("kernel_bicgstab_solve needs CUDA tensors")
    if C.shape[0] != 24 or C.shape[1:] != u3.shape[1:] \
            or C.dtype != u3.dtype:
        raise ValueError("C must be the (24, n, n) operator stack of u3, "
                         "of u3's dtype")
    if n_steps == 0:
        return u3
    n = u3.shape[-1]
    C = C.contiguous()
    u = u3.contiguous().clone()
    up = u.clone() if extrapolate else None
    cells = _device_cells(u, "canvas") if cells is None else cells
    work, partials = _bicgstab_buffers(u, cells)
    grid = ctypes.c_int(0)
    P = _build.pointer
    CANVAS_KERNEL.launch(u.dtype, P(C), P(u), P(up), P(work),
                         P(partials), n, n_steps, n_iters, int(use_ka),
                         cells, _build.current_stream(),
                         ctypes.byref(grid))
    return u


def fused_solve(pattern, coeffs, mass_masked_fam, inv_diag_fam, u0_fam,
                interior_fam, *, n_steps: int, n_iters: int = 5,
                use_ka: bool = False, extrapolate: bool = False):
    """The whole zero-source implicit loop with the canvas operator and
    fixed-k BiCGStab (kernel B5).

    All vectors are in family layout. ``coeffs``: the 15 coefficient grids
    of the masked system (stencil.extract_coefficients);
    ``mass_masked_fam`` is zero on Dirichlet rows; ``u0_fam`` arrives full
    (boundary values included: its columns feed the first step's RHS);
    ``interior_fam`` is 1 on unknowns and 0 on Dirichlet rows. Returns the
    final homogeneous state in family layout (no boundary lift)."""
    C = bicgstab_operator(pattern, coeffs, mass_masked_fam, inv_diag_fam,
                          interior_fam, u0_fam.dtype)
    u3 = to_canvases(pattern, u0_fam)
    kw = dict(n_steps=n_steps, n_iters=n_iters, use_ka=use_ka,
              extrapolate=extrapolate)
    if u3.is_cuda:
        out = kernel_bicgstab_solve(C, u3, **kw)
    elif u3.device.type == "cpu":
        out = plain_bicgstab_solve(C, u3, **kw)
    else:
        raise ValueError(f"unsupported device {u3.device}")
    return from_canvases(pattern, out)
