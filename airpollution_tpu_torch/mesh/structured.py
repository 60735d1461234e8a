"""Triangulations of the square domain, a copy of
``airpollution_tpu/mesh/structured.py``'s ``Mesh``, ``create_mesh`` and
``create_unstructured_mesh``.

``create_mesh``: a regular n x n vertex grid on [-L, L]^2, each cell split
into two counter-clockwise triangles along its (v00, v11) diagonal.
``create_unstructured_mesh``: the same grid with its interior nodes
jittered, Delaunay-triangulated (the gmsh-like general mesh, solved on the
ELL path). Host-side numpy: ``MeshData`` moves the arrays to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Vertex coordinates (N, 2) float64 and triangles (T, 3) int32.

    ``n_points_per_axis`` is set by :func:`create_mesh` and unlocks the
    structured stencil paths. ``mirror`` marks a mesh that is the
    reflection of its source grid (``MeshData`` refuses it unless told
    the caller handles the reflection).
    """

    points: np.ndarray
    triangles: np.ndarray
    n_points_per_axis: int | None = None
    mirror: tuple[int, int] | None = None


def create_mesh(n_points_per_axis: int = 20, domain_size: float = 2.0) -> Mesh:
    """Triangulate [-domain_size, domain_size]^2 with a structured grid::

        v01 --- v11        tri A: (v00, v10, v11)
         |  B  / |         tri B: (v00, v11, v01)
         |   /   |
         | /  A  |
        v00 --- v10
    """
    n = int(n_points_per_axis)
    if n < 2:
        raise ValueError("n_points_per_axis must be >= 2")
    L = float(domain_size)

    axis = np.linspace(-L, L, n)
    xx, yy = np.meshgrid(axis, axis, indexing="xy")
    points = np.stack([xx.ravel(), yy.ravel()], axis=1)  # row-major: iy*n+ix

    gx, gy = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="xy")
    v00 = (gy * n + gx).ravel()
    v10 = v00 + 1
    v01 = v00 + n
    v11 = v01 + 1

    tri_a = np.stack([v00, v10, v11], axis=1)
    tri_b = np.stack([v00, v11, v01], axis=1)
    # Interleave A, B per cell so triangle order follows cell order.
    triangles = np.empty((2 * tri_a.shape[0], 3), dtype=np.int32)
    triangles[0::2] = tri_a
    triangles[1::2] = tri_b

    return Mesh(points=points, triangles=triangles, n_points_per_axis=n)


def create_unstructured_mesh(n_points_per_axis: int = 20,
                             domain_size: float = 2.0,
                             jitter: float = 0.3,
                             seed: int = 0) -> Mesh:
    """Unstructured Delaunay triangulation of the box: the grid points of
    :func:`create_mesh` with interior nodes moved by up to ``jitter * h``
    (``np.random.default_rng(seed)``), triangulated by
    ``scipy.spatial.Delaunay`` and oriented counter-clockwise. Leaves
    ``n_points_per_axis`` None, so solvers take the general ELL path."""
    from scipy.spatial import Delaunay

    base = create_mesh(n_points_per_axis, domain_size)
    pts = base.points.copy()
    n = int(n_points_per_axis)
    L = float(domain_size)
    h = 2 * L / (n - 1)
    rng = np.random.default_rng(seed)
    interior = (
        (np.abs(pts[:, 0]) < L - 1e-12) & (np.abs(pts[:, 1]) < L - 1e-12)
    )
    pts[interior] += rng.uniform(-jitter * h, jitter * h,
                                 size=(int(interior.sum()), 2))

    triangles = Delaunay(pts).simplices.astype(np.int32)
    return Mesh(points=pts, triangles=orient_ccw(pts, triangles),
                n_points_per_axis=None)


def orient_ccw(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Swap the last two vertices of every clockwise triangle, in place
    (assembly assumes positive signed areas). Returns ``triangles``."""
    p0 = points[triangles[:, 0]]
    p1 = points[triangles[:, 1]]
    p2 = points[triangles[:, 2]]
    signed = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
        p2[:, 0] - p0[:, 0]
    ) * (p1[:, 1] - p0[:, 1])
    flip = signed < 0
    triangles[flip, 1], triangles[flip, 2] = (
        triangles[flip, 2].copy(), triangles[flip, 1].copy()
    )
    return triangles
