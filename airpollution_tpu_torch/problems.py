"""Problem and domain definitions, PyTorch counterpart of
``airpollution_tpu/problems.py``.

What the structured CRBE solve reads: the ``AdDifProblem`` interface with
the class flags the solver routes on and the per-DOF hooks (variable
winds and diffusion, Robin walls, obstacles), the Gaussian-plume
``Problem`` (its closed form is IC, boundary data and oracle at once), the
square-pulse release, the rotating plume (the oracle of the variable-wind
solve), the Gaussian emitter, the ``MultiSpeciesProblem`` container of
K species coupled by linear chemistry, and the box ``Domain``. Methods
take tensors of any device and dtype and return tensors on the same
device and dtype.

The plume (utils/common.py:47-50 of the reference):
``exp(-((x - vx t)^2 + (y - vy t)^2) / (4 D t + sigma^2)) / (pi (4 D t + sigma^2))``
with defaults ``v=(1.0, 0.5), D=0.1, sigma=1.0``.
"""

from __future__ import annotations

import abc
import dataclasses
import math

import numpy as np
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


def param(x):
    """A physical parameter: a tensor stays the tensor it is (its autograd
    graph included), anything else becomes a Python float."""
    return x if isinstance(x, torch.Tensor) else float(x)


def param_vector(v):
    """A constant wind ``v``: a tensor stays as it is, a sequence with a
    tensor in it becomes one stacked tensor (differentiable in each
    component), and a sequence of numbers a tuple of floats."""
    if isinstance(v, torch.Tensor):
        return v
    comps = list(v)
    ref = next((c for c in comps if isinstance(c, torch.Tensor)), None)
    if ref is None:
        return tuple(float(c) for c in comps)
    return torch.stack([
        c if isinstance(c, torch.Tensor)
        else torch.tensor(float(c), dtype=ref.dtype, device=ref.device)
        for c in comps])


def _is_zero(x) -> bool:
    """True for a Python number equal to 0 (a tensor is never taken as 0:
    its gradient must flow)."""
    return isinstance(x, (int, float)) and x == 0.0


class AdDifProblem(abc.ABC):
    """Abstract 2D advection-diffusion(-reaction) problem.

    ``v`` is held as a tuple of two floats (or None where the wind is a
    field, see ``velocity_at``), ``D`` as a float and ``reaction`` as a
    float; a tensor argument is kept as a tensor instead (:func:`param`,
    :func:`param_vector`), so that autograd reaches it through assembly,
    the hooks and the solve (diagnostics/inverse.py). The class flags
    mirror the JAX package's: the solver refuses the paths a flagged
    problem cannot take.
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
        self.v = None if v is None else param_vector(v)
        self.D = param(D)
        self.reaction = param(reaction)

    @abc.abstractmethod
    def initial_condition_fn(self, xy):
        """Initial condition c(x, y, 0) at points ``xy`` of shape (N, 2)."""

    @abc.abstractmethod
    def boundary_fn(self, xyt):
        """Dirichlet boundary values at space-time points ``xyt`` (N, 3)."""

    @abc.abstractmethod
    def source_term(self, xyt):
        """Source s(x, y, t) at space-time points ``xyt`` (N, 3)."""

    def source_xy(self, x, y, t):
        """Elementwise source on separate coordinate tensors (broadcast),
        the form the fused paths' emission loads are built from
        (ops/loads.EmissionLoads). The default wraps ``source_term``;
        a subclass with a closed form may override it."""
        x, y = torch.broadcast_tensors(x, y)
        xyt = torch.stack([x, y, torch.full_like(x, float(t))], dim=-1)
        return self.source_term(xyt)

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
        if isinstance(self.D, torch.Tensor):
            return self.D.to(dtype=xy.dtype, device=xy.device).expand(
                xy.shape[:-1])
        return torch.full(xy.shape[:-1], float(self.D), dtype=xy.dtype,
                          device=xy.device)

    def diffusion_grad_at(self, xy, t=None):
        """grad D(x, y) at (N, 2) points -> (N, 2), the term the PINN
        residual's expansion -div(D grad c) = -D lap c - grad D . grad c
        needs (ops/autodiff.pde_residual). Exact zeros for a
        constant-coefficient problem; otherwise the autograd of
        :meth:`diffusion_at` at each point (each value depends on its own
        point only), with each point's own ``t`` for a ``time_varying``
        problem. Differentiable in the problem's tensor parameters."""
        zeros = torch.zeros(xy.shape[:-1] + (2,), dtype=xy.dtype,
                            device=xy.device)
        if not self.variable_coefficients:
            return zeros
        keep_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            p = xy.detach().requires_grad_(True)
            targs = (t,) if self.time_varying else ()
            D = self.diffusion_at(p, *targs)
            if not D.requires_grad:
                return zeros
            (g,) = torch.autograd.grad(
                D.sum(), p, create_graph=keep_graph,
                allow_unused=True, materialize_grads=True)
        return g


def _plume(num, denom, reaction, t):
    plume = torch.exp(-num / denom) / (math.pi * denom)
    if _is_zero(reaction):
        return plume
    return plume * torch.exp(-reaction * t)


def _check_xyt(xyt):
    if xyt.shape[-1] != 3:
        raise ValueError("xyt must have 3 columns (x, y, t)")


def _check_xy(xy):
    if xy.shape[-1] != 2:
        raise ValueError("xy must have 2 columns (x, y)")


class Problem(AdDifProblem):
    """Default Gaussian-plume problem with a closed-form solution. ``v``,
    ``D``, ``sigma`` and ``reaction`` may be tensors (:func:`param`): the
    initial condition and the boundary lift are then differentiable in
    them, as in the JAX package."""

    zero_source = True

    def __init__(self, v=(1.0, 0.5), D=0.1, sigma=1.0, reaction=0.0):
        super().__init__(v, D, reaction)
        self.sigma = param(sigma)

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
    c0 = amplitude on [lo, hi]^2, zero boundary values and source. Each
    parameter may be a tensor (:func:`param`); the initial state is then
    differentiable in ``amplitude``."""

    zero_source = True

    def __init__(self, v=(1.0, 0.0), D=0.1, lo=8.0, hi=12.0, amplitude=1.0,
                 reaction=0.0):
        super().__init__(v, D, reaction)
        self.lo = param(lo)
        self.hi = param(hi)
        self.amplitude = param(amplitude)

    def initial_condition_fn(self, xy):
        x, y = xy[..., 0], xy[..., 1]
        inside = ((x >= self.lo) & (x <= self.hi) & (y >= self.lo)
                  & (y <= self.hi))
        amplitude = torch.as_tensor(self.amplitude, dtype=xy.dtype,
                                    device=xy.device)
        return torch.where(inside, amplitude, torch.zeros_like(amplitude))

    def boundary_fn(self, xyt):
        return torch.zeros_like(xyt[..., 0])

    def source_term(self, xyt):
        return torch.zeros_like(xyt[..., 0])


class GaussianSourceProblem(AdDifProblem):
    """Continuous Gaussian emitter: zero initial concentration, zero
    Dirichlet boundary and the steady source

        s(x, y) = q exp(-((x - xs)^2 + (y - ys)^2) / (2 sigma_s^2))
                  / (2 pi sigma_s^2),

    a total emission rate ``q`` spread over a footprint of width
    ``sigma_s`` centred at ``(xs, ys)``. It has no closed-form solution.
    ``q``, ``xs``, ``ys``, ``sigma_s``, ``v`` and ``D`` may be tensors
    (:func:`param`): the source is then differentiable in them."""

    zero_source = False
    steady_source = True  # t-independent: the fused paths build its load once

    def __init__(self, v=(1.0, 0.5), D=0.1, q=1.0, xs=0.0, ys=0.0,
                 sigma_s=1.0, reaction=0.0):
        super().__init__(v, D, reaction)
        self.q = param(q)
        self.xs = param(xs)
        self.ys = param(ys)
        self.sigma_s = param(sigma_s)

    def initial_condition_fn(self, xy):
        _check_xy(xy)
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)

    def boundary_fn(self, xyt):
        return torch.zeros_like(xyt[..., 0])

    def source_term(self, xyt):
        _check_xyt(xyt)
        return self.source_xy(xyt[..., 0], xyt[..., 1], None)

    def source_xy(self, x, y, t):
        r2 = (x - self.xs) ** 2 + (y - self.ys) ** 2
        s2 = self.sigma_s ** 2
        return self.q * torch.exp(-r2 / (2.0 * s2)) / (2.0 * math.pi * s2)


class MultiSpeciesProblem:
    """K species over one transport field, coupled by linear chemistry:

        dt c_k + v_k . grad c_k - D_k lap c_k + sum_j R[k, j] c_j = s_k.

    A container, not an :class:`AdDifProblem`: each wrapped single-species
    problem supplies its initial, boundary and source data and its (v, D);
    all chemistry lives in the (K, K) matrix ``R``, so each species'
    ``reaction`` must be 0. Robin sides (their partition, not their
    alphas) and obstacles must be common to all species. Solved by
    ``models.multispecies.MultiSpeciesSolver``.

    When every species shares (v, D), transport commutes with the
    chemistry and ``c(t) = expm(-R t) [phi_1(t), ..., phi_K(t)]`` with
    ``phi_j`` the uncoupled solution of species j: the oracle of
    :meth:`analytical_solution`, where each species has a closed form.
    """

    def __init__(self, species, R):
        self.species = tuple(species)
        if len(self.species) < 1:
            raise ValueError("need at least one species problem")
        for k, p in enumerate(self.species):
            r = getattr(p, "reaction", 0.0)
            if not (isinstance(r, (int, float)) and r == 0.0):
                raise ValueError(
                    f"species {k} has reaction={r!r}; per-species decay "
                    "belongs on the diagonal of R (set reaction=0)"
                )
            if getattr(p, "time_varying", False) or getattr(
                    p, "variable_coefficients", False):
                raise ValueError(
                    "multi-species solves support constant-coefficient "
                    f"species problems only (species {k} is variable/"
                    "time-varying)"
                )
        K = len(self.species)
        self.R = torch.as_tensor(R, dtype=torch.float64).cpu()
        if tuple(self.R.shape) != (K, K):
            raise ValueError(
                f"R must be ({K}, {K}) for {K} species, got "
                f"{tuple(self.R.shape)}"
            )
        sides0 = frozenset(getattr(self.species[0], "robin_sides", None)
                           or ())
        for k, p in enumerate(self.species[1:], start=1):
            sides = frozenset(getattr(p, "robin_sides", None) or ())
            if sides != sides0:
                raise ValueError(
                    f"species {k} names Robin sides {sorted(sides)} but "
                    f"species 0 names {sorted(sides0)} — all species "
                    "must share the Dirichlet/Robin partition "
                    "(deposition velocities may differ)"
                )
        for k, p in enumerate(self.species):
            if getattr(p, "robin_sides", None) and robin_g_customized(p):
                raise ValueError(
                    f"species {k} overrides robin_g/robin_g_xy — "
                    "multi-species Robin walls support the homogeneous "
                    "flux law only (deposition/no-flux; g = 0)"
                )
        obs0 = getattr(self.species[0], "obstacles", None) or None
        for k, p in enumerate(self.species[1:], start=1):
            if (getattr(p, "obstacles", None) or None) != obs0:
                raise ValueError(
                    f"species {k} declares different obstacles than "
                    "species 0 — obstacle geometry must be common to "
                    "every species"
                )

    @property
    def obstacles(self):
        """The common obstacle geometry, so that solver gates and
        ``obstacle_masks`` read the container like a single problem."""
        return getattr(self.species[0], "obstacles", None)

    def obstacle_fn(self, xy):
        return self.species[0].obstacle_fn(xy)

    @property
    def n_species(self):
        return len(self.species)

    @property
    def zero_source(self):
        return all(getattr(p, "zero_source", False) for p in self.species)

    @property
    def shared_transport(self):
        """True when all species share (v, D) and the Robin spec: one
        assembled operator then serves every species."""
        p0 = self.species[0]
        rb0 = getattr(p0, "robin_sides", None)
        return all(
            np.allclose(np.asarray(p.v), np.asarray(p0.v))
            and np.allclose(np.asarray(p.D), np.asarray(p0.D))
            and getattr(p, "robin_sides", None) == rb0
            for p in self.species[1:]
        )

    @property
    def has_analytical(self):
        """True when the expm-mixture oracle applies."""
        return self.shared_transport and all(
            hasattr(p, "analytical_solution") for p in self.species
        )

    # --- stacked per-species evaluations (K along dim 0) ---

    def initial_conditions(self, xy):
        """(K, N) initial concentrations at (N, 2) points."""
        return torch.stack([p.initial_condition_fn(xy)
                            for p in self.species])

    @staticmethod
    def _xyt(xy, t):
        t_col = torch.full(xy.shape[:-1] + (1,), float(t), dtype=xy.dtype,
                           device=xy.device)
        return torch.cat([xy, t_col], dim=-1)

    def boundary_values(self, xy, t, R=None):
        """(K, N) Dirichlet values at scalar time ``t``: the oracle where
        it applies (the chemistry mixture of the uncoupled boundary
        values), else the species' own ``boundary_fn`` values."""
        if self.has_analytical:
            return self.analytical_solution(xy, t, R=R)
        xyt = self._xyt(xy, t)
        return torch.stack([p.boundary_fn(xyt) for p in self.species])

    def sources(self, xy, t):
        """(K, N) source terms at scalar time ``t``."""
        xyt = self._xyt(xy, t)
        return torch.stack([p.source_term(xyt) for p in self.species])

    def analytical_solution(self, xy, t, R=None):
        """(K, N) exact coupled solution at scalar time ``t``:
        ``expm(-R t)`` (:func:`expm64`, then cast) applied across the
        uncoupled solutions as sums of K scaled rows."""
        if not self.has_analytical:
            raise ValueError(
                "the expm-mixture oracle needs shared (v, D) and "
                "analytical per-species problems"
            )
        R = self.R if R is None else torch.as_tensor(R, dtype=torch.float64)
        phi = torch.stack([p.analytical_solution(self._xyt(xy, t))
                           for p in self.species])
        E = expm64(-float(t) * R).to(phi.dtype)
        return mix_species(E.to(phi.device), phi)


def expm64(A) -> torch.Tensor:
    """Matrix exponential of a small matrix, float64 on the host, by
    scaling and squaring with a degree-18 Taylor polynomial (argument norm
    <= 1/2, truncation below 1e-22). ``torch.linalg.matrix_exp`` is not
    used: for small-norm arguments such as ``-dt/2 R`` it loses ~1e-11
    (1.6e-11 at ``-0.0625 [[0.3, -0.1], [-0.2, 0.4]]`` against scipy's
    and the JAX package's ``expm``, torch 2.13 on the CPU), an error every
    chemistry half-step would repeat."""
    A = torch.as_tensor(A, dtype=torch.float64).cpu()
    norm = float(torch.linalg.matrix_norm(A, ord=1)) if A.numel() else 0.0
    squarings = max(0, math.ceil(math.log2(norm / 0.5))) if norm > 0 else 0
    X = A / 2.0 ** squarings
    term = torch.eye(A.shape[0], dtype=torch.float64)
    out = term.clone()
    for k in range(1, 19):
        term = term @ X / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def mix_species(E, X):
    """``sum_j E[k, j] X[j]`` for every k: a (K, K) chemistry matrix
    applied across the species axis of ``X`` as sums of scaled planes
    (elementwise, so no reduced-precision matrix product can reach it)."""
    out = []
    for k in range(E.shape[0]):
        acc = E[k, 0] * X[0]
        for j in range(1, E.shape[0]):
            acc = acc + E[k, j] * X[j]
        out.append(acc)
    return torch.stack(out)


class RotatingPlumeProblem(AdDifProblem):
    """Gaussian puff in the solid-body rotation ``v = omega (-(y - cy),
    x - cx)``: the rotating frame turns the PDE into pure diffusion, so
    the exact solution is the diffusing Gaussian at the back-rotated point
    ``xi = c + R(-omega t)(x - c)``,

        c(x, t) = exp(-|xi - x0|^2 / (4 D t + sigma^2))
                  / (pi (4 D t + sigma^2)) * exp(-reaction t).

    Each parameter may be a tensor (:func:`param`): the wind, the initial
    state and the closed form are then differentiable in it.
    """

    zero_source = True
    variable_coefficients = True

    def __init__(self, omega=0.1, D=0.05, sigma=1.5, x0=5.0, y0=0.0,
                 cx=0.0, cy=0.0, reaction=0.0):
        # No constant wind: v stays None so that a constant-coefficient
        # consumer fails instead of using a wrong wind.
        super().__init__(None, D, reaction)
        self.omega = param(omega)
        self.sigma = param(sigma)
        self.x0 = param(x0)
        self.y0 = param(y0)
        self.cx = param(cx)
        self.cy = param(cy)

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
