"""Problem and domain definitions, PyTorch counterpart of
``airpollution_tpu/problems.py``.

What the structured CRBE solve reads: the ``AdDifProblem`` interface with
the class flags the solver routes on and the per-DOF hooks (variable
winds and diffusion, Robin walls, obstacles), the Gaussian-plume
``Problem`` (its closed form is IC, boundary data and oracle at once), the
square-pulse release, the rotating plume (the oracle of the variable-wind
solve) and the box ``Domain``. Methods take tensors of any device and
dtype and return tensors on the same device and dtype.

The plume (utils/common.py:47-50 of the reference):
``exp(-((x - vx t)^2 + (y - vy t)^2) / (4 D t + sigma^2)) / (pi (4 D t + sigma^2))``
with defaults ``v=(1.0, 0.5), D=0.1, sigma=1.0``.
"""

from __future__ import annotations

import abc
import dataclasses
import math

import torch

# Outward unit normals of the box sides, keyed by the side names a
# ``robin_sides`` spec may use.
SIDE_NORMALS = {
    "left": (-1.0, 0.0),
    "right": (1.0, 0.0),
    "bottom": (0.0, -1.0),
    "top": (0.0, 1.0),
}


def robin_g_customized(problem) -> bool:
    """True when the problem's Robin inhomogeneity is not identically 0:
    it overrides ``robin_g`` or ``robin_g_xy``, as a subclass method or an
    instance attribute."""
    t = type(problem)
    return ("robin_g" in vars(problem) or "robin_g_xy" in vars(problem)
            or t.robin_g is not AdDifProblem.robin_g
            or t.robin_g_xy is not AdDifProblem.robin_g_xy)


def robin_g_xy_provided(problem) -> bool:
    """True when the problem supplies the elementwise ``robin_g_xy`` hook
    (method override or instance attribute)."""
    return ("robin_g_xy" in vars(problem)
            or type(problem).robin_g_xy is not AdDifProblem.robin_g_xy)


class AdDifProblem(abc.ABC):
    """Abstract 2D advection-diffusion(-reaction) problem.

    ``v`` is held as a tuple of two floats (or None where the wind is a
    field, see ``velocity_at``), ``D`` as a float and ``reaction`` as a
    float. The class flags mirror the JAX package's: the solver refuses
    the paths a flagged problem cannot take.
    """

    # True when source_term is identically zero.
    zero_source = False
    # True when source_term does not depend on t.
    steady_source = False
    # True when v or D vary in space: assembly samples velocity_at /
    # diffusion_at at triangle centroids, and only the per-DOF (stencil,
    # canvas) paths solve such problems.
    variable_coefficients = False
    # True when v or D vary in time (refused by CRBESolver, as in the JAX
    # package, which solves them in quasi-static time chunks).
    time_varying = False
    # Robin sides: None keeps every boundary DOF Dirichlet; a dict
    # {side: alpha} imposes -D dc/dn = alpha c - g on the named sides,
    # which enters the operator as alpha |e| on the wall DOFs' diagonal
    # and the RHS as a g |e| load (models/crbe.robin_terms).
    robin_sides = None
    # Interior obstacles: None, or axis-aligned rectangles
    # ((xmin, xmax, ymin, ymax), ...). Triangles whose centroid lies in
    # one are dropped from assembly; DOFs left with no live triangle are
    # pinned to 0 (models/crbe.obstacle_masks).
    obstacles = None

    def __init__(self, v, D, reaction=0.0):
        self.v = None if v is None else tuple(float(c) for c in v)
        self.D = float(D)
        self.reaction = float(reaction)

    @abc.abstractmethod
    def initial_condition_fn(self, xy):
        """Initial condition c(x, y, 0) at points ``xy`` of shape (N, 2)."""

    @abc.abstractmethod
    def boundary_fn(self, xyt):
        """Dirichlet boundary values at space-time points ``xyt`` (N, 3)."""

    @abc.abstractmethod
    def source_term(self, xyt):
        """Source s(x, y, t) at space-time points ``xyt`` (N, 3)."""

    def robin_g(self, xy, t, side):
        """Robin inhomogeneity g(x, y, t) on the named side. Delegates to
        :meth:`robin_g_xy` (0 by default)."""
        return self.robin_g_xy(xy[..., 0], xy[..., 1], t, side)

    def robin_g_xy(self, x, y, t, side):
        """Elementwise Robin inhomogeneity on separate coordinate tensors
        (broadcast). Default 0."""
        x, y = torch.broadcast_tensors(x, y)
        return torch.zeros_like(x)

    def obstacle_fn(self, xy):
        """Boolean "inside a solid obstacle" test at (..., 2) points: the
        union of the closed ``obstacles`` rectangles."""
        x, y = xy[..., 0], xy[..., 1]
        inside = torch.zeros(xy.shape[:-1], dtype=torch.bool,
                             device=xy.device)
        for (x0, x1, y0, y1) in self.obstacles or ():
            inside = inside | ((x >= x0) & (x <= x1) & (y >= y0)
                               & (y <= y1))
        return inside

    def velocity_at(self, xy, t=None):
        """Wind field at (N, 2) points -> (N, 2). Default: the constant
        ``v`` broadcast to every point."""
        v = torch.as_tensor(self.v, dtype=xy.dtype, device=xy.device)
        return v.expand(xy.shape[:-1] + (2,))

    def diffusion_at(self, xy, t=None):
        """Diffusion field at (N, 2) points -> (N,). Default: the constant
        ``D`` broadcast to every point."""
        return torch.full(xy.shape[:-1], float(self.D), dtype=xy.dtype,
                          device=xy.device)


def _plume(num, denom, reaction, t):
    plume = torch.exp(-num / denom) / (math.pi * denom)
    if reaction == 0.0:
        return plume
    return plume * torch.exp(-reaction * t)


def _check_xyt(xyt):
    if xyt.shape[-1] != 3:
        raise ValueError("xyt must have 3 columns (x, y, t)")


def _check_xy(xy):
    if xy.shape[-1] != 2:
        raise ValueError("xy must have 2 columns (x, y)")


class Problem(AdDifProblem):
    """Default Gaussian-plume problem with a closed-form solution."""

    zero_source = True

    def __init__(self, v=(1.0, 0.5), D=0.1, sigma=1.0, reaction=0.0):
        super().__init__(v, D, reaction)
        self.sigma = float(sigma)

    def analytical_solution(self, xyt):
        """Exact solution at (N, 3) space-time points [x, y, t]; with a
        first-order ``reaction`` rate r the plume decays as exp(-r t)."""
        _check_xyt(xyt)
        x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
        denom = 4.0 * self.D * t + self.sigma ** 2
        num = (x - self.v[0] * t) ** 2 + (y - self.v[1] * t) ** 2
        return _plume(num, denom, self.reaction, t)

    def initial_condition_fn(self, xy):
        _check_xy(xy)
        t0 = torch.zeros(xy.shape[:-1] + (1,), dtype=xy.dtype,
                         device=xy.device)
        return self.analytical_solution(torch.cat([xy, t0], dim=-1))

    def boundary_fn(self, xyt):
        _check_xyt(xyt)
        return self.analytical_solution(xyt)

    def source_term(self, xyt):
        _check_xyt(xyt)
        return torch.zeros_like(xyt[..., 0])


class SquarePulseProblem(AdDifProblem):
    """Square-pulse release ("Problem 3" of the reference's case study):
    c0 = amplitude on [lo, hi]^2, zero boundary values and source."""

    zero_source = True

    def __init__(self, v=(1.0, 0.0), D=0.1, lo=8.0, hi=12.0, amplitude=1.0,
                 reaction=0.0):
        super().__init__(v, D, reaction)
        self.lo = float(lo)
        self.hi = float(hi)
        self.amplitude = float(amplitude)

    def initial_condition_fn(self, xy):
        x, y = xy[..., 0], xy[..., 1]
        inside = ((x >= self.lo) & (x <= self.hi) & (y >= self.lo)
                  & (y <= self.hi))
        return torch.where(inside, self.amplitude, 0.0).to(xy.dtype)

    def boundary_fn(self, xyt):
        return torch.zeros_like(xyt[..., 0])

    def source_term(self, xyt):
        return torch.zeros_like(xyt[..., 0])


class RotatingPlumeProblem(AdDifProblem):
    """Gaussian puff in the solid-body rotation ``v = omega (-(y - cy),
    x - cx)``: the rotating frame turns the PDE into pure diffusion, so
    the exact solution is the diffusing Gaussian at the back-rotated point
    ``xi = c + R(-omega t)(x - c)``,

        c(x, t) = exp(-|xi - x0|^2 / (4 D t + sigma^2))
                  / (pi (4 D t + sigma^2)) * exp(-reaction t).
    """

    zero_source = True
    variable_coefficients = True

    def __init__(self, omega=0.1, D=0.05, sigma=1.5, x0=5.0, y0=0.0,
                 cx=0.0, cy=0.0, reaction=0.0):
        # No constant wind: v stays None so that a constant-coefficient
        # consumer fails instead of using a wrong wind.
        super().__init__(None, D, reaction)
        self.omega = float(omega)
        self.sigma = float(sigma)
        self.x0 = float(x0)
        self.y0 = float(y0)
        self.cx = float(cx)
        self.cy = float(cy)

    def velocity_at(self, xy, t=None):
        x, y = xy[..., 0], xy[..., 1]
        return torch.stack([-self.omega * (y - self.cy),
                            self.omega * (x - self.cx)], dim=-1)

    def analytical_solution(self, xyt):
        _check_xyt(xyt)
        x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
        th = -self.omega * t
        dx, dy = x - self.cx, y - self.cy
        xi = self.cx + torch.cos(th) * dx - torch.sin(th) * dy
        eta = self.cy + torch.sin(th) * dx + torch.cos(th) * dy
        denom = 4.0 * self.D * t + self.sigma ** 2
        num = (xi - self.x0) ** 2 + (eta - self.y0) ** 2
        return _plume(num, denom, self.reaction, t)

    def initial_condition_fn(self, xy):
        _check_xy(xy)
        t0 = torch.zeros(xy.shape[:-1] + (1,), dtype=xy.dtype,
                         device=xy.device)
        return self.analytical_solution(torch.cat([xy, t0], dim=-1))

    def boundary_fn(self, xyt):
        return self.analytical_solution(xyt)

    def source_term(self, xyt):
        return torch.zeros_like(xyt[..., 0])


@dataclasses.dataclass(frozen=True)
class Domain:
    """Box domain [-Lx, Lx] x [-Ly, Ly] with time horizon [0, T]."""

    Lx: float = 20.0
    Ly: float = 20.0
    T: float = 10.0

    def is_boundary(self, x):
        """Boolean mask of points on the box boundary (atol 1e-10, as the
        reference's isclose test); any time column is ignored."""
        if x.shape[-1] < 2:
            raise ValueError("x must have at least 2 columns (x, y)")

        def near(a, b):
            return (a - b).abs() <= 1e-10

        return (near(x[..., 0], -self.Lx) | near(x[..., 0], self.Lx)
                | near(x[..., 1], -self.Ly) | near(x[..., 1], self.Ly))
