"""Flip-solve-flip for mirrored structured grids, PyTorch counterpart of
``airpollution_tpu/mesh/mirror.py``.

A regular grid whose cells are cut along the anti-diagonal is another
finite-element space than ``create_mesh``'s, but the reflection
``sigma = diag(sx, sy)`` (one of sx, sy = -1) maps it isometrically onto
the canonical space, and the discretisation commutes with isometries: the
discrete solution of problem P on the mirrored mesh equals, DOF for DOF,
the discrete solution of the pulled-back problem ``P o sigma`` on the
canonical mesh at the reflected midpoint. The centered square's midpoint
set is sigma-symmetric, so that midpoint is itself a canonical DOF, and
the transform is a problem wrapper plus an index permutation: the
mirrored grid takes every canonical path (stencil, canvas, fused
kernels).

Usage (``read_msh`` tags such grids with ``mesh.mirror``; ``MeshData``
refuses a mirror-tagged mesh unless given ``mirror_ok=True``)::

    mesh = apt.read_msh("grid_mirrored.msh")      # mesh.mirror == (-1, 1)
    md = apt.MeshData(mesh, domain, nt=nt, mirror_ok=True)
    solver = CRBESolver(domain, mirror_problem(problem, mesh.mirror), md)
    sols = mirror_field(solver.solve(), md, mesh.mirror)

``sols[..., i]`` is then the solution of the original problem on the
file's own triangulation at ``md.midpoints[i]`` (the midpoint sets
coincide; only the diagonal edges differ between the two spaces).
"""

from __future__ import annotations

import numpy as np
import torch

from airpollution_tpu_torch.problems import (
    AdDifProblem,
    robin_g_customized,
    robin_g_xy_provided,
)

_SIDE_FLIP_X = {"left": "right", "right": "left"}
_SIDE_FLIP_Y = {"bottom": "top", "top": "bottom"}


def _flip_side(side: str, mirror) -> str:
    """Side name under sigma (an involution: also maps back)."""
    sx, sy = mirror
    if sx < 0:
        side = _SIDE_FLIP_X.get(side, side)
    if sy < 0:
        side = _SIDE_FLIP_Y.get(side, side)
    return side


def _check_mirror(mirror):
    sx, sy = (int(mirror[0]), int(mirror[1]))
    if abs(sx) != 1 or abs(sy) != 1:
        raise ValueError(f"mirror must be (+-1, +-1), got {mirror!r}")
    return sx, sy


class MirroredProblem(AdDifProblem):
    """The pullback ``P o sigma`` of ``base`` under ``sigma = diag(sx,
    sy)``.

    Every coordinate-dependent hook evaluates ``base`` at the reflected
    point; vector quantities (wind, tensor D) are conjugated by sigma;
    side-keyed configuration (``robin_sides``) and obstacle rectangles
    are reflected. Tensor parameters of ``base`` stay tensors, so the
    pullback is differentiable in them.
    """

    def __init__(self, base, mirror):
        sx, sy = _check_mirror(mirror)
        self.base = base
        self.mirror = (sx, sy)
        # Instance copies of the class flags the solver routes on.
        self.zero_source = bool(getattr(base, "zero_source", False))
        self.steady_source = bool(getattr(base, "steady_source", False))
        self.variable_coefficients = bool(
            getattr(base, "variable_coefficients", False))
        self.time_varying = bool(getattr(base, "time_varying", False))
        self.reaction = getattr(base, "reaction", 0.0)
        rb = getattr(base, "robin_sides", None)
        if rb:
            self.robin_sides = {_flip_side(s, self.mirror): a
                                for s, a in rb.items()}
        obs = getattr(base, "obstacles", None)
        if obs:
            self.obstacles = tuple(
                (min(sx * x0, sx * x1), max(sx * x0, sx * x1),
                 min(sy * y0, sy * y1), max(sy * y0, sy * y1))
                for (x0, x1, y0, y1) in obs
            )
        if ("obstacle_fn" in vars(base)
                or type(base).obstacle_fn is not AdDifProblem.obstacle_fn):
            self.obstacle_fn = lambda xy: base.obstacle_fn(
                self._flip_xy(xy))
        if hasattr(base, "analytical_solution"):
            self.analytical_solution = lambda xyt: base.analytical_solution(
                self._flip_xyt(xyt))
        # Wrap the Robin inhomogeneity only where the base customises it:
        # robin_g_customized() reads an instance attribute as a custom g
        # and would keep the g = 0 problem off the fused paths.
        if robin_g_customized(base):
            self.robin_g = lambda xy, t, side: base.robin_g(
                self._flip_xy(xy), t, _flip_side(side, self.mirror))
        if robin_g_xy_provided(base):
            self.robin_g_xy = lambda x, y, t, side: base.robin_g_xy(
                sx * x, sy * y, t, _flip_side(side, self.mirror))

    def _signs(self, like, extra=()):
        return torch.tensor(self.mirror + tuple(extra), dtype=like.dtype,
                            device=like.device)

    def _flip_xy(self, xy):
        return xy * self._signs(xy)

    def _flip_xyt(self, xyt):
        return xyt * self._signs(xyt, (1,))

    @property
    def v(self):
        v = self.base.v
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v * self._signs(v)
        return tuple(s * float(c) for s, c in zip(self.mirror, v))

    @property
    def D(self):
        D = self.base.D
        if isinstance(D, torch.Tensor) and D.ndim == 2:
            # sigma D sigma: entry (i, j) takes s_i s_j, which flips the
            # off-diagonals and keeps Dxx, Dyy.
            s = self._signs(D)
            return D * torch.outer(s, s)
        if isinstance(D, torch.Tensor) and D.ndim > 2:
            raise NotImplementedError(
                "per-triangle diffusion tensor fields are mesh-indexed: "
                "supply them through diffusion_at for mirrored grids")
        return D

    def initial_condition_fn(self, xy):
        return self.base.initial_condition_fn(self._flip_xy(xy))

    def boundary_fn(self, xyt):
        return self.base.boundary_fn(self._flip_xyt(xyt))

    def source_term(self, xyt):
        return self.base.source_term(self._flip_xyt(xyt))

    def source_xy(self, x, y, t):
        sx, sy = self.mirror
        return self.base.source_xy(sx * x, sy * y, t)

    def velocity_at(self, xy, t=None):
        flipped = self._flip_xy(xy)
        bv = (self.base.velocity_at(flipped) if t is None
              else self.base.velocity_at(flipped, t))
        return bv * self._signs(bv)

    def diffusion_at(self, xy, t=None):
        flipped = self._flip_xy(xy)
        return (self.base.diffusion_at(flipped) if t is None
                else self.base.diffusion_at(flipped, t))


def mirror_problem(problem, mirror):
    """The pullback wrapper ``P o sigma`` (:class:`MirroredProblem`);
    ``mirror=None`` or the identity returns ``problem`` itself, so callers
    can apply it to ``mesh.mirror`` unconditionally."""
    if mirror is None or tuple(mirror) == (1, 1):
        return problem
    return MirroredProblem(problem, mirror)


def mirror_dof_permutation(mesh_data, mirror) -> np.ndarray:
    """The sigma-induced permutation of canonical midpoint DOFs.

    ``perm[i]`` is the canonical DOF whose midpoint is
    ``sigma(midpoints[i])``, well defined because the centered square's
    midpoint set (H and V edge midpoints on half-integer grid lines, D
    edge midpoints at cell centres) is invariant under axis reflections.
    Host-side numpy, built once per mesh.
    """
    sx, sy = _check_mirror(mirror)
    n = getattr(mesh_data, "structured_n", None)
    if n is None:
        raise ValueError("mirror_dof_permutation needs a structured "
                         "(create_mesh-canonical) mesh")
    mid = mesh_data.midpoints.detach().cpu().numpy().astype(np.float64)
    lo = mid.min(axis=0)
    rel = mid - lo
    # Every midpoint coordinate is a multiple of h/2 from the minimum.
    # h/2 comes from the midpoints themselves (the smallest positive
    # coordinate gap), not from the domain: a mesh whose extent differs
    # from the run's domain would otherwise collapse every key to 0 and
    # pass the check below with a constant permutation.
    span = float(rel.max())
    if span <= 0.0:
        raise ValueError("degenerate midpoint set (zero extent)")
    gaps = []
    for ax in range(2):
        d = np.diff(np.unique(rel[:, ax]))
        gaps.extend(d[d > span * 1e-9])
    if not gaps:
        raise ValueError("degenerate midpoint set (no coordinate spread "
                         "on either axis)")
    h2 = float(min(gaps))
    qf = rel / h2
    q = np.rint(qf).astype(np.int64)
    if not np.allclose(qf, q, atol=1e-6 * max(1.0, span / h2)):
        raise ValueError("midpoints are not on a uniform half-grid: not a "
                         "create_mesh-canonical mesh?")
    tgt = mid * np.asarray((sx, sy), np.float64)
    qt = np.rint((tgt - lo) / h2).astype(np.int64)
    w = int(q[:, 0].max()) + 2
    key = q[:, 1] * w + q[:, 0]
    key_t = qt[:, 1] * w + qt[:, 0]
    if np.unique(key).size != key.size:
        raise ValueError("midpoint quantization collided: non-uniform grid "
                         "spacing?")
    order = np.argsort(key)
    pos = np.searchsorted(key[order], key_t)
    perm = order[np.clip(pos, 0, len(order) - 1)]
    if not np.array_equal(key[perm], key_t):
        raise ValueError("midpoint set is not mirror-symmetric: not a "
                         "canonical centered-square mesh?")
    return perm


def mirror_field(values, mesh_data, mirror):
    """Canonical-solve DOF values in the mirrored grid's frame.

    ``values`` is a tensor with DOFs on its last axis (a field (n,), a
    trajectory (nt, n), a species stack (K, n), ...); the result keeps
    its autograd graph. ``mirror=None`` passes it through. Entry i of the
    result is the mirrored grid's solution at ``mesh_data.midpoints[i]``.
    """
    if mirror is None or tuple(mirror) == (1, 1):
        return values
    perm = torch.as_tensor(mirror_dof_permutation(mesh_data, mirror),
                           device=values.device)
    return values[..., perm]
