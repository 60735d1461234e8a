"""Structured triangulation of the square domain, a copy of
``airpollution_tpu/mesh/structured.py``'s ``Mesh`` and ``create_mesh``.

A regular n x n vertex grid on [-L, L]^2; each cell is split into two
counter-clockwise triangles along its (v00, v11) diagonal. Host-side numpy:
``MeshData`` moves the arrays to the device.
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
