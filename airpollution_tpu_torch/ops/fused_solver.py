"""The whole CRBE time loop in one kernel launch (kernel B1), PyTorch
counterpart of ``airpollution_tpu/ops/pallas_solver.py``'s
``fused_solve_uniform`` with ``method="chebyshev"``.

Layout: the three edge families H (n x c), V (c x n), D (c x c) are
embedded into one (3, n, n) zero-padded canvas tensor. The operator is
translation-invariant (ops/uniform.py): 15 stencil scalars, 3 interior
mass and 3 inverse-diagonal scalars, and per-family interior rectangles
derived from indices. Each step forms the RHS (backward Euler
``M mask(u)``; Crank-Nicolson ``2 M mask(u) - A u``), takes the warm start
(``mask(2u - u_prev)`` when extrapolating), and runs k fixed Chebyshev
iterations with no reductions.

On a CUDA tensor ``fused_solve_uniform`` launches ``csrc/uniform_solver.cu``
(a cooperative persistent kernel, one grid barrier per step); on a CPU
tensor it runs :func:`plain_solve`, the same arithmetic on the full canvas
with zero-padded shifts.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from airpollution_tpu_torch import _build

KERNEL = _build.Kernel(
    "uniform_solver", "uniform_solver.cu",
    {torch.float32: "crbe_uniform_solve_f32",
     torch.float64: "crbe_uniform_solve_f64"},
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
)

#: Shared-memory budget a tile window may use: the 227 KB a block can
#: address on Hopper, less room for the static scalar block.
SMEM_BUDGET = 227 * 1024 - 2048
TILE_CANDIDATES = (64, 56, 48, 40, 32, 24, 16, 8)
BLOCK_THREADS = (256, 512)  # the block sizes csrc/ instantiates
MAX_ITERS = 64  # csrc/tile_step.cuh kMaxIters
#: Launch shape, measured on an H100 (scripts/torch_port_tile_sweep.py):
#: 512 threads per block, and 24^2 output tiles for the whole-loop kernel.
#: At 257^2 they make 121 blocks for the 132 SMs; 32^2 tiles make 81, and
#: smaller ones pay more for the halo than they gain in occupancy.
THREADS = 512
TILE = 24


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


def step_scalars(consts, mass_consts, inv_diag_consts, bounds, n_iters,
                 dtype):
    """The kernels' scalar block: 15 stencil coefficients, 3 mass and 3
    inverse-diagonal constants, 1/theta, then the Chebyshev recurrence
    coefficients a_k = rho_{k+1} rho_k and b_k = 2 rho_{k+1} / delta.

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
    device = consts.device
    tail = torch.tensor([1.0 / theta] + a + b, dtype=dtype, device=device)
    return torch.cat([consts.to(dtype), mass_consts.to(dtype),
                      inv_diag_consts.to(dtype), tail])


def halo_of(n_iters: int, use_ka: bool) -> int:
    """Window halo: the step applies A k + 1 times (Crank-Nicolson k + 2),
    and the last application's output is never read back into x."""
    return n_iters + (1 if use_ka else 0)


def tile_fits(tile: int, halo: int, dtype) -> bool:
    """Whether four 3-family planes of a tile's window fit shared memory."""
    elem = torch.tensor([], dtype=dtype).element_size()
    return 12 * (tile + 2 * halo) ** 2 * elem <= SMEM_BUDGET


def choose_tile(halo: int, dtype, preferred: int) -> int:
    """Largest output tile up to ``preferred`` whose four 3-family window
    planes fit the shared-memory budget."""
    for t in TILE_CANDIDATES:
        if t <= preferred and tile_fits(t, halo, dtype):
            return t
    raise ValueError(f"halo {halo} too deep for the shared-memory budget")


def rect_masks(n: int, dtype, device):
    """(3, n, n) interior rectangles: H rows [1, c) x cols [0, c),
    V rows [0, c) x cols [1, c), D rows [0, c) x cols [0, c)."""
    c = n - 1
    i = torch.arange(n, device=device)
    lt = i < c
    rows = torch.stack([(i >= 1) & lt, lt, lt])[:, :, None]
    cols = torch.stack([lt, (i >= 1) & lt, lt])[:, None, :]
    return (rows & cols).to(dtype)


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


def canvas_matvec(s, x, masks):
    """Rect-masked uniform stencil on (3, n, n) canvases."""
    H, V, D = x[0], x[1], x[2]
    yH = (s[0] * H + s[1] * _shift(V, dc=1) + s[2] * D
          + s[3] * _shift(V, dr=-1) + s[4] * _shift(D, dr=-1))
    yV = (s[5] * V + s[6] * _shift(D, dc=-1) + s[7] * _shift(H, dc=-1)
          + s[8] * _shift(H, dr=1) + s[9] * D)
    yD = (s[10] * D + s[11] * _shift(V, dc=1) + s[12] * H
          + s[13] * _shift(H, dr=1) + s[14] * V)
    return masks * torch.stack([yH, yV, yD])


def plain_step(scal, n_iters, u, up, use_ka, masks):
    """One full-canvas time step: the arithmetic of ``tile_step``.
    Returns ``(u_new, up_new)`` (``up_new`` is None without ``up``)."""
    mass = scal[15:18].reshape(3, 1, 1)
    inv_diag = scal[18:21].reshape(3, 1, 1)
    r = mass * (masks * u)
    if use_ka:
        r = 2.0 * r - canvas_matvec(scal, u, masks)
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


def plain_solve(scal, u3, *, n_steps, n_iters, use_ka, extrapolate):
    """The whole loop on the full canvas (B1's plain version)."""
    masks = rect_masks(u3.shape[-1], u3.dtype, u3.device)
    u, up = u3, (u3 if extrapolate else None)
    for _ in range(n_steps):
        u, up = plain_step(scal, n_iters, u, up, use_ka, masks)
    return u


def kernel_solve(scal, u3, *, n_steps, n_iters, use_ka, extrapolate,
                 tile=None, threads=THREADS):
    """The whole loop in one launch of B1 (CUDA tensors only)."""
    if not u3.is_cuda or not scal.is_cuda:
        raise ValueError("kernel_solve needs CUDA tensors")
    if n_steps == 0:
        return u3
    n = u3.shape[-1]
    halo = halo_of(n_iters, use_ka)
    tile = tile or choose_tile(halo, u3.dtype, TILE)
    ua = u3.contiguous().clone()
    ub = torch.empty_like(ua)
    upa = ua.clone() if extrapolate else None
    upb = torch.empty_like(ua) if extrapolate else None
    grid = ctypes.c_int(0)
    P = _build.pointer
    KERNEL.launch(u3.dtype, P(scal.contiguous()), P(ua), P(ub), P(upa),
                  P(upb), n, tile, halo, n_iters, int(use_ka), n_steps,
                  threads, _build.current_stream(), ctypes.byref(grid))
    return ua if n_steps % 2 == 0 else ub


def fused_solve_uniform(spec, consts, mass_consts, inv_diag_consts, u0_fam,
                        *, n_steps: int, n_iters: int, use_ka: bool = False,
                        extrapolate: bool = False,
                        method: str = "chebyshev", bounds=None):
    """Whole-loop fused solve with the translation-invariant operator.

    ``consts``: the 15 stencil scalars of the masked system
    (uniform.extract_constants); ``mass_consts`` / ``inv_diag_consts`` the
    per-family interior mass and 1/diagonal scalars; ``bounds`` the
    Chebyshev interval (lo, hi). ``u0_fam`` arrives full (boundary values
    included). Returns the final homogeneous state in family layout.
    """
    if method != "chebyshev":
        raise NotImplementedError(
            "the fused whole-loop kernel is ported for method='chebyshev' "
            "only (the BiCGStab variant needs grid-wide dot products)"
        )
    if bounds is None:
        raise ValueError("bounds must be given for chebyshev")
    scal = step_scalars(consts, mass_consts, inv_diag_consts, bounds,
                        n_iters, u0_fam.dtype)
    u3 = to_canvases(spec, u0_fam)
    kw = dict(n_steps=n_steps, n_iters=n_iters, use_ka=use_ka,
              extrapolate=extrapolate)
    if u3.is_cuda:
        out = kernel_solve(scal, u3, **kw)
    elif u3.device.type == "cpu":
        out = plain_solve(scal, u3, **kw)
    else:
        raise ValueError(f"unsupported device {u3.device}")
    return from_canvases(spec, out)
