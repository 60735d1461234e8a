"""Problem and domain definitions, PyTorch counterpart of
``airpollution_tpu/problems.py``.

Only what the structured CRBE solve reads is here: the ``AdDifProblem``
interface with the class flags the solver routes on, the Gaussian-plume
``Problem`` (its closed form is IC, boundary data and oracle at once) and
the box ``Domain``. Methods take tensors of any device and dtype and
return tensors on the same device and dtype.

The plume (utils/common.py:47-50 of the reference):
``exp(-((x - vx t)^2 + (y - vy t)^2) / (4 D t + sigma^2)) / (pi (4 D t + sigma^2))``
with defaults ``v=(1.0, 0.5), D=0.1, sigma=1.0``.
"""

from __future__ import annotations

import abc
import dataclasses
import math

import torch


class AdDifProblem(abc.ABC):
    """Abstract 2D advection-diffusion(-reaction) problem.

    ``v`` is held as a tuple of two floats and ``D``/``reaction`` as
    floats, so every method works on tensors of any device and dtype.
    The class flags mirror the JAX package's: the solver refuses the
    paths a flagged problem cannot take.
    """

    # True when source_term is identically zero.
    zero_source = False
    # True when source_term does not depend on t.
    steady_source = False
    # True when v or D vary in space; the port solves constant
    # coefficients only and refuses such problems.
    variable_coefficients = False
    # True when v or D vary in time (refused, like the JAX CRBESolver).
    time_varying = False
    # Robin sides ({side: alpha}) and interior obstacles; the port
    # supports neither yet and refuses problems that set them.
    robin_sides = None
    obstacles = None

    def __init__(self, v, D, reaction=0.0):
        self.v = tuple(float(c) for c in v)
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


class Problem(AdDifProblem):
    """Default Gaussian-plume problem with a closed-form solution."""

    zero_source = True

    def __init__(self, v=(1.0, 0.5), D=0.1, sigma=1.0, reaction=0.0):
        super().__init__(v, D, reaction)
        self.sigma = float(sigma)

    def analytical_solution(self, xyt):
        """Exact solution at (N, 3) space-time points [x, y, t]; with a
        first-order ``reaction`` rate r the plume decays as exp(-r t)."""
        if xyt.shape[-1] != 3:
            raise ValueError("xyt must have 3 columns (x, y, t)")
        x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
        denom = 4.0 * self.D * t + self.sigma ** 2
        num = (x - self.v[0] * t) ** 2 + (y - self.v[1] * t) ** 2
        plume = torch.exp(-num / denom) / (math.pi * denom)
        if self.reaction == 0.0:
            return plume
        return plume * torch.exp(-self.reaction * t)

    def initial_condition_fn(self, xy):
        if xy.shape[-1] != 2:
            raise ValueError("xy must have 2 columns (x, y)")
        t0 = torch.zeros(xy.shape[:-1] + (1,), dtype=xy.dtype,
                         device=xy.device)
        return self.analytical_solution(torch.cat([xy, t0], dim=-1))

    def boundary_fn(self, xyt):
        if xyt.shape[-1] != 3:
            raise ValueError("xyt must have 3 columns (x, y, t)")
        return self.analytical_solution(xyt)

    def source_term(self, xyt):
        if xyt.shape[-1] != 3:
            raise ValueError("xyt must have 3 columns (x, y, t)")
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
