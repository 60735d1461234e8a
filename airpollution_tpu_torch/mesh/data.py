"""MeshData: mesh geometry, CR DOF topology and sparsity pattern as
tensors on one device. PyTorch counterpart of
``airpollution_tpu/mesh/data.py``; attribute names follow the reference's
``MeshData`` (crbe.py:47-164) as the JAX package's do.

Geometry is computed in float64 numpy on the host and cast once to the
requested dtype on the requested device. Index arrays are int64 tensors
(PyTorch's index type).
"""

from __future__ import annotations

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.mesh import topology as topo_mod
from airpollution_tpu_torch.mesh.structured import Mesh


class MeshData:
    """Mesh geometry + CR DOF topology on ``device`` (default: the CUDA
    card; raises without one unless ``device='cpu'`` is given)."""

    def __init__(self, mesh: Mesh, domain, nt: int, dtype=torch.float32,
                 device=None, mirror_ok: bool = False):
        if getattr(mesh, "mirror", None) and not mirror_ok:
            raise ValueError(
                f"mesh carries mirror={mesh.mirror}: it is the reflection "
                f"of the source grid, and solving on it computes the "
                f"reflected problem. Pass mirror_ok=True only when the "
                f"problem and the output are mapped through the reflection"
            )
        self.device = resolve_device(device)
        self.mesh = mesh
        self.domain = domain
        self.nt = int(nt)
        self.dtype = dtype

        pts = np.asarray(mesh.points, dtype=np.float64)[:, :2]
        tris = np.asarray(mesh.triangles, dtype=np.int32)
        topo = topo_mod.enumerate_edges(tris, n_points=pts.shape[0])
        segs = topo.segments

        midpoints = 0.5 * (pts[segs[:, 0]] + pts[segs[:, 1]])
        seg_lengths = np.linalg.norm(pts[segs[:, 0]] - pts[segs[:, 1]], axis=1)
        p0, p1, p2 = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
        cross = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
            p2[:, 0] - p0[:, 0]
        ) * (p1[:, 1] - p0[:, 1])
        areas = 0.5 * np.abs(cross)
        edge_len = np.stack([
            np.linalg.norm(p0 - p1, axis=1),
            np.linalg.norm(p1 - p2, axis=1),
            np.linalg.norm(p2 - p0, axis=1),
        ], axis=1)
        self.diameter = float(edge_len.max()) if edge_len.size else 0.0

        def real(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        def index(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self.points = real(pts)
        self.number_of_points = pts.shape[0]
        self.triangles = index(tris)
        self.number_of_triangles = tris.shape[0]
        self.segments = index(segs)
        self.triangle_to_segments = index(topo.triangle_to_segments)
        self.number_of_segments = segs.shape[0]
        self.midpoints = real(midpoints)
        self.segment_lengths = real(seg_lengths)
        self.triangle_areas = real(areas)
        self.boundary_segments = index(topo.boundary_segments)
        self.boundary_triangles = index(topo.boundary_triangles)
        self.boundary_triangle_first_segment = index(
            topo.boundary_triangle_first_segment
        )
        self.time_discr = torch.linspace(0.0, float(domain.T), self.nt,
                                         dtype=dtype, device=self.device)
        bmask = np.zeros(segs.shape[0], dtype=bool)
        bmask[topo.boundary_segments] = True
        self.boundary_mask = torch.as_tensor(bmask, device=self.device)

        # Structured-mesh metadata (enables the stencil paths) and the
        # host topology the stencil pattern is built from.
        self.structured_n = getattr(mesh, "n_points_per_axis", None)
        self._host_t2s = topo.triangle_to_segments
        self._ell_pattern = None

    def _ensure_ell(self):
        if self._ell_pattern is None:
            self._ell_pattern = topo_mod.build_ell_pattern(
                self._host_t2s, n_seg=self.number_of_segments
            )
        return self._ell_pattern

    def _ell_tensor(self, name):
        return torch.as_tensor(
            np.asarray(getattr(self._ensure_ell(), name), dtype=np.int64),
            device=self.device,
        )

    @property
    def ell_cols(self):
        return self._ell_tensor("cols")

    @property
    def ell_entry_to_slot(self):
        return self._ell_tensor("entry_to_slot")

    @property
    def ell_diag_slot(self):
        return self._ell_tensor("diag_slot")

    @property
    def ell_width(self):
        return self._ensure_ell().width

    @property
    def _host_ell_cols(self):
        return self._ensure_ell().cols


def boundary_side_masks(mesh_data):
    """``{'left', 'right', 'bottom', 'top'} -> (n_seg,) bool``: boundary
    DOFs whose midpoint lies on that side of the box. The walls are the
    mesh's own extent (min/max vertex coordinates), matched with the
    Domain's atol of 1e-10. Works on any view that carries ``points``,
    ``midpoints`` and ``boundary_mask`` (e.g. the family-layout view)."""
    md = mesh_data
    if not hasattr(md, "points") or not hasattr(md, "boundary_mask"):
        raise ValueError("boundary_side_masks needs geometry (points, "
                         "midpoints, boundary_mask)")
    pts, mid, bmask = md.points, md.midpoints, md.boundary_mask
    xmin, xmax = pts[:, 0].min(), pts[:, 0].max()
    ymin, ymax = pts[:, 1].min(), pts[:, 1].max()

    def on(coord, wall):
        return bmask & ((coord - wall).abs() <= 1e-10)

    return {
        "left": on(mid[:, 0], xmin),
        "right": on(mid[:, 0], xmax),
        "bottom": on(mid[:, 1], ymin),
        "top": on(mid[:, 1], ymax),
    }


def structured_grid(mesh_data):
    """(xmin, ymin, h) of the structured vertex grid, as host floats."""
    if getattr(mesh_data, "structured_n", None) is None:
        raise ValueError("structured_grid requires a structured mesh")
    pts = mesh_data.points.detach().cpu().numpy()
    xmin = float(pts[:, 0].min())
    h = (float(pts[:, 0].max()) - xmin) / (mesh_data.structured_n - 1)
    return xmin, float(pts[:, 1].min()), h
