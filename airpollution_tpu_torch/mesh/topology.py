"""Edge enumeration and ELL sparsity pattern, a copy of
``airpollution_tpu/mesh/topology.py`` (the native enumeration through
mesh/native.py, the vectorised numpy path otherwise).

Crouzeix-Raviart DOFs are edge midpoints. Edges are numbered in
first-encounter order over triangles x local edges ``[(v1, v2), (v2, v0),
(v0, v1)]`` (the reference's enumeration contract, crbe.py:109-131), and the
three global operators share one ELL pattern of width <= 5. Host-side
numpy, run once per mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Local edge order within each triangle (opposite vertex 0, 1, 2).
_LOCAL_EDGES = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class EdgeTopology:
    """Edge enumeration of a triangulation.

    segments: (n_seg, 2) int32 vertex pairs (a < b), first-encounter order.
    triangle_to_segments: (n_tri, 3) int32 segment id of each local edge.
    boundary_segments: (n_bseg,) int32 ascending, edges of one triangle.
    boundary_triangles: (n_btri,) int32 triangles with a boundary edge.
    boundary_triangle_first_segment: (n_btri,) int32 the first boundary
      edge of each, in local edge order.
    """

    segments: np.ndarray
    triangle_to_segments: np.ndarray
    boundary_segments: np.ndarray
    boundary_triangles: np.ndarray
    boundary_triangle_first_segment: np.ndarray


#: Triangle count from which the native enumeration (mesh/native.py) is
#: tried first, as in the JAX package.
NATIVE_MIN_TRIANGLES = 4096


def enumerate_edges(triangles: np.ndarray, n_points: int) -> EdgeTopology:
    """Enumerate unique edges in first-encounter order: the native C++
    pass for meshes of at least :data:`NATIVE_MIN_TRIANGLES` triangles when
    its library is available, else vectorised numpy (the same output)."""
    tris = np.asarray(triangles, dtype=np.int64)
    n_tri = tris.shape[0]

    found = None
    if n_tri >= NATIVE_MIN_TRIANGLES:
        from airpollution_tpu_torch.mesh import native

        found = native.enumerate_edges_native(tris, n_points)
    if found is not None:
        segments, triangle_to_segments = found
        seg_ids = triangle_to_segments.reshape(-1).astype(np.int64)
    else:
        segments, triangle_to_segments, seg_ids = _enumerate_numpy(
            tris, n_points)

    counts = np.bincount(seg_ids, minlength=segments.shape[0])
    boundary_segments = np.nonzero(counts == 1)[0].astype(np.int32)

    tri_bmask = (counts == 1)[triangle_to_segments]  # (n_tri, 3)
    boundary_triangles = np.nonzero(tri_bmask.any(axis=1))[0].astype(np.int32)
    first_local = np.argmax(tri_bmask[boundary_triangles], axis=1)
    boundary_triangle_first_segment = triangle_to_segments[
        boundary_triangles, first_local
    ].astype(np.int32)

    return EdgeTopology(
        segments=segments,
        triangle_to_segments=triangle_to_segments,
        boundary_segments=boundary_segments,
        boundary_triangles=boundary_triangles,
        boundary_triangle_first_segment=boundary_triangle_first_segment,
    )


def _enumerate_numpy(tris, n_points):
    """``(segments, triangle_to_segments, flat segment ids)`` by sorting
    edge keys."""
    n_tri = tris.shape[0]
    # (n_tri, 3, 2): local edges in contract order, canonical (min, max).
    edges = tris[:, _LOCAL_EDGES]
    lo = edges.min(axis=2)
    hi = edges.max(axis=2)
    keys = (lo * n_points + hi).ravel()  # int64 key per undirected edge

    # np.unique sorts the keys; remap ranks so ids follow each key's
    # first occurrence in ``keys``.
    _, first_idx, inverse = np.unique(
        keys, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    rank_to_id = np.empty_like(order)
    rank_to_id[order] = np.arange(order.size)
    seg_ids = rank_to_id[inverse.reshape(-1)]

    seg_keys = keys[np.sort(first_idx)]
    segments = np.stack(
        [seg_keys // n_points, seg_keys % n_points], axis=1
    ).astype(np.int32)
    return segments, seg_ids.reshape(n_tri, 3).astype(np.int32), seg_ids


@dataclasses.dataclass(frozen=True)
class EllPattern:
    """Static ELL sparsity pattern of the CR global operators.

    cols: (n_seg, width) int32 column per slot; padding slots hold column 0
      (their value is always 0).
    entry_to_slot: (9 * n_tri,) int32 flat slot ``row * width + k`` of each
      local-matrix entry (tri, a, b), flattened in that order.
    diag_slot: (n_seg,) int32 flat slot of each row's diagonal.
    width: ELL width (5 for interior rows of a triangular mesh).
    tslot: (n_seg * width,) int64 flat slot of the transposed entry
      (ops/sparse.transpose_slots), ``n_seg * width`` on padding slots.
    """

    cols: np.ndarray
    entry_to_slot: np.ndarray
    diag_slot: np.ndarray
    width: int
    tslot: np.ndarray


def build_ell_pattern(triangle_to_segments: np.ndarray, n_seg: int) -> EllPattern:
    """Precompute the ELL layout and the local-entry -> slot scatter map."""
    t2s = np.asarray(triangle_to_segments, dtype=np.int64)
    n_tri = t2s.shape[0]

    rows = np.repeat(t2s, 3, axis=1).reshape(n_tri, 3, 3)  # rows[t, a, b]
    cols = np.stack([t2s] * 3, axis=1)  # cols[t, a, b] = t2s[t, b]
    pair_keys = (rows * n_seg + cols).ravel()

    uniq, inverse = np.unique(pair_keys, return_inverse=True)
    inverse = inverse.reshape(-1)
    uniq_rows = uniq // n_seg
    uniq_cols = uniq % n_seg

    # uniq is sorted by (row, col): slot k is the entry's rank in its row.
    row_starts = np.searchsorted(uniq_rows, np.arange(n_seg))
    k_within_row = np.arange(uniq.size) - row_starts[uniq_rows]
    width = int(k_within_row.max()) + 1 if uniq.size else 0

    ell_cols = np.zeros((n_seg, width), dtype=np.int32)
    ell_cols[uniq_rows, k_within_row] = uniq_cols

    slot_of_uniq = (uniq_rows * width + k_within_row).astype(np.int32)
    entry_to_slot = slot_of_uniq[inverse]

    diag_rank = np.searchsorted(uniq, np.arange(n_seg) * (n_seg + 1))
    if not np.array_equal(uniq[diag_rank], np.arange(n_seg) * (n_seg + 1)):
        raise ValueError("every row must have a diagonal entry")
    diag_slot = slot_of_uniq[diag_rank]

    # Local entry (t, a, b) lies in slot (row t2s[t, a], col t2s[t, b]);
    # (t, b, a) lies in the transposed slot, so the pattern is symmetric
    # by construction and padding slots are never written.
    e2s = entry_to_slot.astype(np.int64)
    e2s_t = e2s.reshape(n_tri, 3, 3).transpose(0, 2, 1).reshape(-1)
    tslot = np.full(n_seg * width, n_seg * width, dtype=np.int64)
    tslot[e2s] = e2s_t

    return EllPattern(
        cols=ell_cols,
        entry_to_slot=entry_to_slot.astype(np.int32),
        diag_slot=diag_slot.astype(np.int32),
        width=width,
        tslot=tslot,
    )
