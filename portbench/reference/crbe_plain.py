"""Plain PyTorch reference of a CRBE forecast: the final field of a
Crouzeix-Raviart advection-diffusion forecast on a structured mesh,
worked out from the configuration and the release point alone.

It imports nothing of the system under test. Everything the forecast
depends on is derived here again:

- the structured triangulation of [-L, L]^2 (n points a side, each cell
  split along its (v00, v11) diagonal into (v00, v10, v11) and
  (v00, v11, v01), cells in row-major order);
- edge topology and DOF numbering: edges numbered in the order they are
  first met over triangles x local edges (v1, v2), (v2, v0), (v0, v1);
  boundary DOFs are the edges of one triangle;
- the local CR matrices (lumped mass |T|/3, stiffness D |T| grad.grad in
  the configuration's convention, advection |T|/3 v.grad phi_j with the
  wind at the centroid) and their assembly into
  ``S = M + c dt (K + A)`` with Dirichlet rows replaced by identity rows;
- the initial state and the Dirichlet lift from the closed form;
- the Chebyshev interval (two power iterations on the symmetric part of
  the Jacobi-scaled operator, widened by 5%), or fixed-k BiCGStab;
- the time loop: homogeneous Dirichlet state, warm start from the last
  state or extrapolated (2 u - u_prev), the lift added to the final
  field only.

Set-up (geometry, assembly, interval) runs in float64. The time loop runs
in ``loop_dtype``: float64 for the reference, a lower precision for the
control that the comparison has to fail.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
_LOCAL_EDGES = ((1, 2), (2, 0), (0, 1))
_REF_GRADS = ((2.0, 2.0), (-2.0, 0.0), (0.0, -2.0))


# --- the problems' closed forms ---------------------------------------------

def _gauss(d2, D, sigma, t):
    denom = 4.0 * D * t + sigma * sigma
    return torch.exp(-d2 / denom) / (math.pi * denom)


def closed_form(problem: str, params: dict, x, y, t: float):
    """The exact field of ``problem`` at points (x, y) and time t."""
    if problem == "ShiftedPlumeProblem":
        vx, vy = params["v"]
        cx, cy = params["center"]
        d2 = (x - cx - vx * t) ** 2 + (y - cy - vy * t) ** 2
        return _gauss(d2, params["D"], params["sigma"], t)
    raise ValueError(f"no closed form for {problem!r}")


def wind(problem: str, params: dict, x, y):
    """(vx, vy) at points (x, y)."""
    if problem == "ShiftedPlumeProblem":
        vx, vy = params["v"]
        return torch.full_like(x, vx), torch.full_like(x, vy)
    raise ValueError(f"no wind for {problem!r}")


# --- mesh and topology ------------------------------------------------------

def structured_mesh(n: int, half_width: float, device):
    """Points (n^2, 2) float64, row-major (index iy * n + ix), and
    triangles (2 (n - 1)^2, 3): per cell (v00, v10, v11), (v00, v11, v01)."""
    axis = torch.linspace(-half_width, half_width, n, dtype=F64,
                          device=device)
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    points = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
    g = torch.arange(n - 1, device=device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    v00 = (gy * n + gx).reshape(-1)
    v10, v01 = v00 + 1, v00 + n
    v11 = v01 + 1
    cells = torch.stack([torch.stack([v00, v10, v11], 1),
                         torch.stack([v00, v11, v01], 1)], dim=1)
    return points, cells.reshape(-1, 3)


def edges(triangles, n_points: int):
    """``(segments (n_seg, 2), tri_dofs (n_tri, 3), boundary (n_seg,)
    bool)``: edges numbered by first encounter over triangles x local
    edges; an edge met once lies on the boundary."""
    local = torch.tensor(_LOCAL_EDGES, device=triangles.device)
    pairs = triangles[:, local]  # (n_tri, 3, 2)
    lo = pairs.min(dim=2).values.reshape(-1)
    hi = pairs.max(dim=2).values.reshape(-1)
    keys = lo * n_points + hi
    uniq, inverse = torch.unique(keys, return_inverse=True)
    pos = torch.arange(keys.numel(), device=keys.device)
    first = torch.full((uniq.numel(),), keys.numel(), dtype=pos.dtype,
                       device=keys.device)
    first.scatter_reduce_(0, inverse, pos, reduce="amin")
    order = torch.argsort(first)
    number = torch.empty_like(order)
    number[order] = torch.arange(order.numel(), device=order.device)
    dof = number[inverse].reshape(-1, 3)
    seg_keys = uniq[order]
    segments = torch.stack([seg_keys // n_points, seg_keys % n_points], 1)
    boundary = torch.bincount(dof.reshape(-1),
                              minlength=order.numel()) == 1
    return segments, dof, boundary


# --- assembly ---------------------------------------------------------------

def local_matrices(vertices, D: float, vx, vy, convention: str):
    """Per triangle: lumped mass (n_tri,), stiffness (n_tri, 3, 3) and
    advection (n_tri, 3, 3). ``convention`` 'correct' pulls gradients back
    with J^-T; 'reference' with J^-1 (the paper's own code's transposed
    pullback), in the stiffness only."""
    p0, p1, p2 = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    det = e1[:, 0] * e2[:, 1] - e2[:, 0] * e1[:, 1]
    area = 0.5 * det.abs()
    # J = [e1 e2] (columns); inv(J) = [[e2y, -e2x], [-e1y, e1x]] / det.
    i00, i01 = e2[:, 1] / det, -e2[:, 0] / det
    i10, i11 = -e1[:, 1] / det, e1[:, 0] / det
    ref = torch.tensor(_REF_GRADS, dtype=F64, device=vertices.device)
    a, b = ref[:, 0][None, :], ref[:, 1][None, :]  # d/dxi, d/deta
    # Physical gradient (row) of phi_i: [a b] inv(J).
    gx = a * i00[:, None] + b * i10[:, None]
    gy = a * i01[:, None] + b * i11[:, None]
    if convention == "correct":
        sx, sy = gx, gy
    elif convention == "reference":
        sx = a * i00[:, None] + b * i01[:, None]
        sy = a * i10[:, None] + b * i11[:, None]
    else:
        raise ValueError(f"unknown stiffness convention {convention!r}")
    K = (D * area)[:, None, None] * (sx[:, :, None] * sx[:, None, :]
                                     + sy[:, :, None] * sy[:, None, :])
    v_dot_g = vx[:, None] * gx + vy[:, None] * gy  # (n_tri, 3)
    A = (area / 3.0)[:, None, None] * v_dot_g[:, None, :].expand(-1, 3, 3)
    return area / 3.0, K, A


class Ell:
    """A sparse matrix as padded rows: ``cols`` and ``vals`` (n, width)."""

    def __init__(self, rows, cols, vals, n: int):
        order = torch.argsort(rows * n + cols)
        rows, cols, vals = rows[order], cols[order], vals[order]
        key = rows * n + cols
        uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
        summed = torch.zeros(uniq.numel(), dtype=vals.dtype,
                             device=vals.device)
        summed.index_add_(0, inverse, vals)
        r, c = uniq // n, uniq % n
        counts = torch.bincount(r, minlength=n)
        start = torch.cumsum(counts, 0) - counts
        slot = torch.arange(uniq.numel(), device=r.device) - start[r]
        width = int(counts.max())
        self.cols = torch.arange(n, device=r.device)[:, None].repeat(1, width)
        self.vals = torch.zeros((n, width), dtype=vals.dtype,
                                device=vals.device)
        self.cols[r, slot] = c
        self.vals[r, slot] = summed

    def to(self, dtype):
        out = object.__new__(Ell)
        out.cols, out.vals = self.cols, self.vals.to(dtype)
        return out

    def __call__(self, x):
        return (self.vals * x[self.cols]).sum(dim=1)


def assemble(mid_tri_dofs, vertices, n_dofs, boundary, D, vx, vy, dt,
             order, convention):
    """``(mass, ka, system, system_T, diag)``: the lumped mass, K + A, the
    row-masked system and its transpose (ELL), and the system's
    diagonal."""
    m_loc, K, A = local_matrices(vertices, D, vx, vy, convention)
    dev = vertices.device
    mass = torch.zeros(n_dofs, dtype=F64, device=dev)
    mass.index_add_(0, mid_tri_dofs.reshape(-1),
                    m_loc[:, None].expand(-1, 3).reshape(-1))
    rows = mid_tri_dofs[:, :, None].expand(-1, 3, 3).reshape(-1)
    cols = mid_tri_dofs[:, None, :].expand(-1, 3, 3).reshape(-1)
    ka_vals = (K + A).reshape(-1)
    diag_idx = torch.arange(n_dofs, device=dev)
    ka = Ell(rows, cols, ka_vals, n_dofs)
    c = {1: 1.0, 2: 0.5}[order]
    # System rows: M + c dt (K + A) inside, identity on the boundary.
    keep = ~boundary[rows]
    s_rows = torch.cat([rows[keep], diag_idx])
    s_cols = torch.cat([cols[keep], diag_idx])
    s_vals = torch.cat([c * dt * ka_vals[keep],
                        torch.where(boundary, torch.ones_like(mass), mass)])
    system = Ell(s_rows, s_cols, s_vals, n_dofs)
    system_t = Ell(s_cols, s_rows, s_vals, n_dofs)
    diag = torch.zeros(n_dofs, dtype=F64, device=dev)
    diag.index_add_(0, s_rows[s_rows == s_cols], s_vals[s_rows == s_cols])
    return mass, ka, system, system_t, diag


# --- the Chebyshev interval -------------------------------------------------

def power_interval(system, system_t, diag, iters: int = 48,
                   margin: float = 0.05):
    """``(lo, hi)`` of the symmetric part of ``s S s`` with s = diag^-1/2,
    by power iteration (then shifted for the lowest), widened by
    ``margin``."""
    s = 1.0 / torch.sqrt(diag)

    def sym(x):
        return 0.5 * (s * system(s * x) + s * system_t(s * x))

    idx = torch.arange(diag.numel(), dtype=F64, device=diag.device)
    v0 = torch.sin(1.7 * idx + 0.3) + 0.01

    def power(op):
        v = v0 / torch.linalg.norm(v0)
        for _ in range(iters):
            w = op(v)
            v = w / torch.linalg.norm(w)
        return float(torch.dot(v, op(v)))

    lam_max = power(sym)
    shift = 1.05 * lam_max
    lam_min = shift - power(lambda x: shift * x - sym(x))
    return (1.0 - margin) * lam_min, (1.0 + margin) * lam_max


# --- the time loop ----------------------------------------------------------

def chebyshev(system, b, x, inv_diag, bounds, iters):
    lo, hi = bounds
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - system(x)
    d = inv_diag * r / theta
    for _ in range(iters):
        x = x + d
        r = r - system(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_diag * r)
        rho = rho_new
    return x


def _nonzero(a, eps=1e-30):
    return a if a != 0.0 else eps


def bicgstab(system, b, x, inv_diag, iters):
    """Fixed-k BiCGStab, right-preconditioned by the Jacobi diagonal,
    from p = v = 0 and rho = alpha = omega = 1; the scalar recurrence in
    float64, the vectors and dot products in the loop's dtype."""
    r = b - system(x)
    rh = r
    p = torch.zeros_like(x)
    v = torch.zeros_like(x)
    rho_old = alpha = omega = 1.0

    def dot(a, c):
        return float((a * c).sum())

    for _ in range(iters):
        rho = dot(rh, r)
        beta = (rho / _nonzero(rho_old)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        w = inv_diag * p
        v = system(w)
        alpha = rho / _nonzero(dot(rh, v))
        x = x + alpha * w
        r = r - alpha * v
        w = inv_diag * r
        t = system(w)
        omega = dot(t, r) / _nonzero(dot(t, t))
        x = x + omega * w
        r = r - omega * t
        rho_old = rho
    return x


def forecast(*, points_per_side: int, half_width: float, T: float,
             nt: int, problem: str, params: dict, convention: str,
             order: int, method: str, iters: int, extrapolate: bool,
             device, loop_dtype=F64) -> torch.Tensor:
    """The forecast's final field (n_dofs,) in float64, DOFs numbered by
    first encounter. ``method``: 'chebyshev' or 'bicgstab'."""
    points, tris = structured_mesh(points_per_side, half_width, device)
    segments, tri_dofs, boundary = edges(tris, points.shape[0])
    n_dofs = segments.shape[0]
    mid = 0.5 * (points[segments[:, 0]] + points[segments[:, 1]])
    vertices = points[tris]
    centroid = vertices.mean(dim=1)
    vx, vy = wind(problem, params, centroid[:, 0], centroid[:, 1])
    dt = T / (nt - 1)
    mass, ka, system, system_t, diag = assemble(
        tri_dofs, vertices, n_dofs, boundary, params["D"], vx, vy, dt,
        order, convention)
    bounds = (power_interval(system, system_t, diag)
              if method == "chebyshev" else None)
    del system_t, tris, vertices, centroid, vx, vy
    u0 = closed_form(problem, params, mid[:, 0], mid[:, 1], 0.0)
    lift = torch.where(boundary, closed_form(problem, params, mid[:, 0],
                                             mid[:, 1], dt * (nt - 1)),
                       torch.zeros_like(u0))

    system = system.to(loop_dtype)
    ka = ka.to(loop_dtype)
    inner = (~boundary).to(loop_dtype)
    mass_in = (mass * inner.to(F64)).to(loop_dtype)
    inv_diag = (1.0 / diag).to(loop_dtype)
    u = u0.to(loop_dtype)
    u_prev = u
    for _ in range(nt - 1):
        b = mass_in * u
        if order == 2:
            b = b - (0.5 * dt) * inner * ka(u)
        guess = 2.0 * u - u_prev if extrapolate else u
        x0 = inner * guess
        if method == "chebyshev":
            x = chebyshev(system, b, x0, inv_diag, bounds, iters)
        elif method == "bicgstab":
            x = bicgstab(system, b, x0, inv_diag, iters)
        else:
            raise ValueError(f"unknown method {method!r}")
        u_prev, u = u, x
    return u.to(F64) + lift
