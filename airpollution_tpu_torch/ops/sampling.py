"""Latin-Hypercube collocation sampling on tensors, PyTorch counterpart of
``airpollution_tpu/ops/sampling.py``.

Every sampler draws from an explicit ``torch.Generator`` and returns
tensors on that generator's device, so that a PINN's epoch samples its
points on the card with no host round trip. The layout contracts of the
JAX package hold:

- space-time LHS assigns column 0 to t, 1 to x and 2 to y, and returns the
  points as [x, y, t];
- boundary points come in four blocks of ``n // 4``, in the order left,
  right, bottom, top, with one shared LHS time column cut to
  ``4 * (n // 4)`` entries;
- facade points are spread over the walls of each obstacle rectangle in
  proportion to their lengths (at least 1 per wall), with unit normals
  pointing out of the solid.

The two packages cannot draw the same points from their generators: their
outputs agree in distribution, not in value.
"""

from __future__ import annotations

import torch


def lhs_unit(generator: torch.Generator, n: int, dims: int,
             dtype=torch.float32) -> torch.Tensor:
    """Latin-Hypercube sample of shape (n, dims) on [0, 1)^dims: per axis a
    random permutation of the n strata plus uniform jitter within each
    stratum (one point per stratum per axis). The dims permutations come
    from one sort of float64 random keys, row by row."""
    device = generator.device
    keys = torch.rand((dims, n), generator=generator, dtype=torch.float64,
                      device=device)
    perms = torch.argsort(keys, dim=1).T.to(dtype)
    jitter = torch.rand((n, dims), generator=generator, dtype=dtype,
                        device=device)
    return (perms + jitter) / n


def lhs_sampling(generator, n_samples, xy_ranges, time_range=None,
                 dtype=torch.float32):
    """(n, 2) space points or (n, 3) space-time points [x, y, t];
    ``xy_ranges`` is (x_min, x_max, y_min, y_max). With ``time_range`` the
    LHS column order is (t, x, y)."""
    x_min, x_max, y_min, y_max = xy_ranges
    if time_range is None:
        u = lhs_unit(generator, n_samples, 2, dtype)
        x = (x_max - x_min) * u[:, 0] + x_min
        y = (y_max - y_min) * u[:, 1] + y_min
        return torch.stack([x, y], dim=1)
    t_min, t_max = time_range
    u = lhs_unit(generator, n_samples, 3, dtype)
    t = (t_max - t_min) * u[:, 0] + t_min
    x = (x_max - x_min) * u[:, 1] + x_min
    y = (y_max - y_min) * u[:, 2] + y_min
    return torch.stack([x, y, t], dim=1)


def sample_boundary_points(generator, n_samples, xy_ranges, time_range,
                           dtype=torch.float32):
    """(4 * (n // 4), 3) points on the four box sides: blocks of
    ``n // 4`` points in the order left (x = x_min), right, bottom
    (y = y_min), top, each with LHS coordinates along its side, and one
    shared LHS time column cut to the total count."""
    x_min, x_max, y_min, y_max = xy_ranges
    t_min, t_max = time_range
    n_side = n_samples // 4
    t_all = ((t_max - t_min) * lhs_unit(generator, n_samples, 1, dtype)[:, 0]
             + t_min)[: 4 * n_side]
    # One LHS column per side: y on the left and right sides, x on the
    # bottom and top ones.
    u = lhs_unit(generator, n_side, 4, dtype).T
    y_left = (y_max - y_min) * u[0] + y_min
    y_right = (y_max - y_min) * u[1] + y_min
    x_bottom = (x_max - x_min) * u[2] + x_min
    x_top = (x_max - x_min) * u[3] + x_min

    def const(value):
        return torch.full((n_side,), value, dtype=dtype,
                          device=generator.device)

    x = torch.cat([const(x_min), const(x_max), x_bottom, x_top])
    y = torch.cat([y_left, y_right, const(y_min), const(y_max)])
    return torch.stack([x, y, t_all], dim=1)


def facade_counts(n_samples, obstacles):
    """The walls of the obstacle rectangles, (x0, y0, dx, dy, nx, ny) each
    (bottom, top, left, right per rectangle), and the points each gets:
    ``n_samples`` in proportion to wall length, rounded per wall, at least
    1 per wall."""
    walls = []
    for (x0, x1, y0, y1) in obstacles:
        w, h = float(x1 - x0), float(y1 - y0)
        walls += [
            (x0, y0, w, 0.0, w, 0.0, -1.0),   # bottom wall, normal -y
            (x0, y1, w, 0.0, w, 0.0, 1.0),    # top wall, normal +y
            (x0, y0, 0.0, h, h, -1.0, 0.0),   # left wall, normal -x
            (x1, y0, 0.0, h, h, 1.0, 0.0),    # right wall, normal +x
        ]
    perimeter = sum(s[4] for s in walls)
    counts = [max(1, int(round(n_samples * s[4] / perimeter)))
              for s in walls]
    return [(x0, y0, dx, dy, nx, ny)
            for (x0, y0, dx, dy, _, nx, ny) in walls], counts


def sample_facade_points(generator, n_samples, obstacles, time_range,
                         dtype=torch.float32):
    """Collocation points on the obstacle facades with their outward unit
    normals, ``(xyt (n', 3), normals (n', 2))``: stratified positions
    along each wall (:func:`facade_counts` per wall; n' may differ
    slightly from ``n_samples``) and LHS times. The normals point out of
    the solid, the direction of the PINN's no-flux facade residual
    dc/dn = 0."""
    device = generator.device
    walls, counts = facade_counts(n_samples, obstacles)
    pts, nrm = [], []
    for (x0, y0, dx, dy, nx, ny), c in zip(walls, counts):
        u = (torch.arange(c, dtype=dtype, device=device)
             + torch.rand((c,), generator=generator, dtype=dtype,
                          device=device)) / c
        pts.append(torch.stack([x0 + u * dx, y0 + u * dy], dim=1))
        # Filled on the device: no host-to-device copy in an epoch.
        nrm.append(torch.stack(
            [torch.full((c,), nx, dtype=dtype, device=device),
             torch.full((c,), ny, dtype=dtype, device=device)], dim=1))
    t0, t1 = time_range
    t = t0 + (t1 - t0) * lhs_unit(generator, sum(counts), 1, dtype)[:, 0]
    xyt = torch.cat([torch.cat(pts, dim=0), t[:, None]], dim=1)
    return xyt, torch.cat(nrm, dim=0)
