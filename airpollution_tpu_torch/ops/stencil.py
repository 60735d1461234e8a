"""Family-layout stencil operator for structured CR meshes, PyTorch
counterpart of ``airpollution_tpu/ops/stencil.py``.

On the structured triangulation the CR edge DOFs form three regular
families: horizontal edges H (n x c grid), vertical edges V (c x n) and
diagonal edges D (c x c), c = n - 1. In that layout every operator row
couples a DOF with fixed-offset neighbours, so a matvec is 15
shift-multiply-add terms with no gather. Cell (i, j) has triangles
A = (v00, v10, v11) and B = (v00, v11, v01), so

  t2s[A] = [V(i+1,j), D(i,j), H(i,j)]
  t2s[B] = [H(i,j+1), V(i,j), D(i,j)]

and each H row couples {H, V(i+1,j), D(i,j), V(i,j-1), D(i,j-1)}, each V
row {V, D(i-1,j), H(i-1,j), H(i,j+1), D(i,j)}, each D row
{D, V(i+1,j), H(i,j), H(i,j+1), V(i,j)}.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from airpollution_tpu_torch.ops.linalg import BoundMatvec


@dataclasses.dataclass(frozen=True)
class StencilPattern:
    """Host-precomputed static data for the family-grid stencil.

    perm: (n_seg,) family-layout position -> global DOF id.
    inv_perm: (n_seg,) global DOF id -> family-layout position.
    term_slots: 15 grids of flat indices into the ELL value array, one per
      stencil term (0 where invalid).
    term_valid: matching validity masks.
    """

    n: int
    c: int
    perm: np.ndarray
    inv_perm: np.ndarray
    term_slots: tuple
    term_valid: tuple


def _family_ids(t2s: np.ndarray, n: int):
    """Global DOF id grids for the three edge families."""
    c = n - 1
    jj, ii = np.meshgrid(np.arange(c), np.arange(c), indexing="ij")
    A = 2 * (jj * c + ii)  # triangle A of cell (i, j)
    B = A + 1

    H = np.empty((n, c), dtype=np.int64)
    H[:c, :] = t2s[A, 2]
    H[c, :] = t2s[B[c - 1, :], 0]

    V = np.empty((c, n), dtype=np.int64)
    V[:, :c] = t2s[B, 1]
    V[:, c] = t2s[A[:, c - 1], 0]

    D = t2s[A, 1].astype(np.int64)
    return H, V, D


def build_family_perm(t2s, n: int, ids=None):
    """Family-layout permutation and its inverse."""
    H, V, D = ids if ids is not None else _family_ids(np.asarray(t2s), n)
    perm = np.concatenate([H.ravel(), V.ravel(), D.ravel()]).astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv_perm


def get_family_perm(mesh_data):
    """(perm, inv_perm), cached on the MeshData (the pattern's when built)."""
    pattern = getattr(mesh_data, "_stencil_pattern", None)
    if pattern is not None:
        return pattern.perm, pattern.inv_perm
    cached = getattr(mesh_data, "_family_perm", None)
    if cached is None:
        cached = build_family_perm(mesh_data._host_t2s,
                                   mesh_data.structured_n)
        mesh_data._family_perm = cached
    return cached


def build_stencil_pattern(t2s, ell_cols, n: int) -> StencilPattern:
    """Permutations and per-term ELL slot grids (host, once)."""
    t2s = np.asarray(t2s)
    ell_cols = np.asarray(ell_cols)
    width = ell_cols.shape[1]
    c = n - 1
    H, V, D = _family_ids(t2s, n)
    perm, inv_perm = build_family_perm(t2s, n, ids=(H, V, D))

    def term(rows, col_grid, valid):
        """Flat ELL slot of entry (row, col) per grid cell, + validity."""
        match = ell_cols[rows] == col_grid[..., None]
        k = np.argmax(match, axis=-1)
        found = match.any(axis=-1) & valid
        slots = (rows * width + k).astype(np.int64)
        slots[~found] = 0
        return slots, found

    def grid_like(shape):
        return np.zeros(shape, dtype=np.int64), np.zeros(shape, dtype=bool)

    terms = []
    # --- H rows (n, c) ---
    terms.append(term(H, H, np.ones((n, c), bool)))  # HH
    col, val = grid_like((n, c))
    col[:c, :], val[:c, :] = V[:, 1:], True  # V(i+1, j)
    terms.append(term(H, col, val))
    col, val = grid_like((n, c))
    col[:c, :], val[:c, :] = D, True  # D(i, j)
    terms.append(term(H, col, val))
    col, val = grid_like((n, c))
    col[1:, :], val[1:, :] = V[:, :c], True  # V(i, j-1)
    terms.append(term(H, col, val))
    col, val = grid_like((n, c))
    col[1:, :], val[1:, :] = D, True  # D(i, j-1)
    terms.append(term(H, col, val))
    # --- V rows (c, n) ---
    terms.append(term(V, V, np.ones((c, n), bool)))  # VV
    col, val = grid_like((c, n))
    col[:, 1:], val[:, 1:] = D, True  # D(i-1, j)
    terms.append(term(V, col, val))
    col, val = grid_like((c, n))
    col[:, 1:], val[:, 1:] = H[:c, :], True  # H(i-1, j)
    terms.append(term(V, col, val))
    col, val = grid_like((c, n))
    col[:, :c], val[:, :c] = H[1:, :], True  # H(i, j+1)
    terms.append(term(V, col, val))
    col, val = grid_like((c, n))
    col[:, :c], val[:, :c] = D, True  # D(i, j)
    terms.append(term(V, col, val))
    # --- D rows (c, c) ---
    terms.append(term(D, D, np.ones((c, c), bool)))  # DD
    terms.append(term(D, V[:, 1:], np.ones((c, c), bool)))  # V(i+1, j)
    terms.append(term(D, H[:c, :], np.ones((c, c), bool)))  # H(i, j)
    terms.append(term(D, H[1:, :], np.ones((c, c), bool)))  # H(i, j+1)
    terms.append(term(D, V[:, :c], np.ones((c, c), bool)))  # V(i, j)

    return StencilPattern(
        n=n, c=c, perm=perm, inv_perm=inv_perm,
        term_slots=tuple(s for s, _ in terms),
        term_valid=tuple(v for _, v in terms),
    )


def canvases_from_local(n: int, local, local_mass=None):
    """The 15 stencil coefficient grids straight from per-triangle local
    matrices, on a structured mesh: each term is a fixed one- or
    two-slice combination of the local matrices of the one or two
    triangles that couple its family pair (the neighbour table of the
    module docstring), placed with static pads. No scatter and no gather,
    so it keeps autograd through plain slicing.

    ``local``: (n_tri, 3, 3) local matrices in mesh order (triangle A of
    cell (row j, column i) at ``2 (j c + i)``, triangle B at the next
    index); ``local_mass``: optional (n_tri, 3) diagonal local masses.
    Returns ``(coeffs, mass)``: the 15 grids in
    :func:`extract_coefficients` order of the UNMASKED assembled operator
    (the per-DOF diagonal adds and the Dirichlet masking are the caller's,
    models/crbe.assemble_canvas), and the assembled mass grids (mH, mV,
    mD), or None without ``local_mass``."""
    c = n - 1
    L = local.reshape(c, c, 2, 3, 3)
    LA, LB = L[:, :, 0], L[:, :, 1]
    # H rows (n, c): H(j, i) is edge 2 of A(j, i) (j < c) and edge 0 of
    # B(j - 1, i) (j >= 1).
    cHH = _pad(LA[:, :, 2, 2], bottom=1) + _pad(LB[:, :, 0, 0], top=1)
    cHVu = _pad(LA[:, :, 2, 0], bottom=1)
    cHDu = _pad(LA[:, :, 2, 1], bottom=1)
    cHVd = _pad(LB[:, :, 0, 1], top=1)
    cHDd = _pad(LB[:, :, 0, 2], top=1)
    # V rows (c, n): V(j, i) is edge 1 of B(j, i) (i < c) and edge 0 of
    # A(j, i - 1) (i >= 1).
    cVV = _pad(LB[:, :, 1, 1], right=1) + _pad(LA[:, :, 0, 0], left=1)
    cVDl = _pad(LA[:, :, 0, 1], left=1)
    cVHl = _pad(LA[:, :, 0, 2], left=1)
    cVHr = _pad(LB[:, :, 1, 0], right=1)
    cVDr = _pad(LB[:, :, 1, 2], right=1)
    # D rows (c, c): D(j, i) is edge 1 of A(j, i) and edge 2 of B(j, i).
    cDD = LA[:, :, 1, 1] + LB[:, :, 2, 2]
    coeffs = (cHH, cHVu, cHDu, cHVd, cHDd,
              cVV, cVDl, cVHl, cVHr, cVDr,
              cDD, LA[:, :, 1, 0], LA[:, :, 1, 2], LB[:, :, 2, 0],
              LB[:, :, 2, 1])
    if local_mass is None:
        return coeffs, None
    m = local_mass.reshape(c, c, 2, 3)
    mA, mB = m[:, :, 0], m[:, :, 1]
    mass = (_pad(mA[:, :, 2], bottom=1) + _pad(mB[:, :, 0], top=1),
            _pad(mB[:, :, 1], right=1) + _pad(mA[:, :, 0], left=1),
            mA[:, :, 1] + mB[:, :, 2])
    return coeffs, mass


def extract_coefficients(pattern: StencilPattern, ell_vals) -> tuple:
    """The 15 coefficient grids from the flat ELL values (one gather)."""
    if not pattern.term_slots:
        raise ValueError("extracting coefficients needs the pattern's ELL "
                         "slot grids (get_pattern, not family_pattern)")
    flat = ell_vals.reshape(-1)
    out = []
    for slots, valid in zip(pattern.term_slots, pattern.term_valid):
        s = torch.as_tensor(slots, device=flat.device)
        v = torch.as_tensor(valid, device=flat.device)
        out.append(torch.where(v, flat[s], torch.zeros((), dtype=flat.dtype,
                                                        device=flat.device)))
    return tuple(out)


def split_families(n: int, x_fam):
    """Family-layout vectors (..., N) -> (H (..., n, c), V (..., c, n),
    D (..., c, c)) views; leading dims (e.g. species) are kept."""
    c = n - 1
    nH = n * c
    lead = tuple(x_fam.shape[:-1])
    return (x_fam[..., :nH].reshape(lead + (n, c)),
            x_fam[..., nH:2 * nH].reshape(lead + (c, n)),
            x_fam[..., 2 * nH:].reshape(lead + (c, c)))


def _pad(x, top=0, bottom=0, left=0, right=0):
    """Zero-pad a 2-D tensor by rows (top/bottom) and columns."""
    return F.pad(x, (left, right, top, bottom))


def stencil_matvec_terms(n: int, coeffs, xH, xV, xD):
    """The 15 shift-multiply-add terms; ``coeffs`` entries may be grids
    or scalars, the x grids may carry leading dims. Returns (yH, yV,
    yD)."""
    c = n - 1
    (cHH, cHVu, cHDu, cHVd, cHDd,
     cVV, cVDl, cVHl, cVHr, cVDr,
     cDD, cDVr, cDHd, cDHu, cDVl) = coeffs
    yH = (cHH * xH
          + cHVu * _pad(xV[..., 1:], bottom=1)
          + cHDu * _pad(xD, bottom=1)
          + cHVd * _pad(xV[..., :c], top=1)
          + cHDd * _pad(xD, top=1))
    yV = (cVV * xV
          + cVDl * _pad(xD, left=1)
          + cVHl * _pad(xH[..., :c, :], left=1)
          + cVHr * _pad(xH[..., 1:, :], right=1)
          + cVDr * _pad(xD, right=1))
    yD = (cDD * xD
          + cDVr * xV[..., 1:]
          + cDHd * xH[..., :c, :]
          + cDHu * xH[..., 1:, :]
          + cDVl * xV[..., :c])
    return yH, yV, yD


def stencil_matvec(pattern: StencilPattern, coeffs: tuple, x_fam):
    """y = A @ x in family layout: 15 shift-multiply-adds, no gathers.
    ``x_fam`` is (N,) or (..., N), e.g. one row per species."""
    yH, yV, yD = stencil_matvec_terms(
        pattern.n, coeffs, *split_families(pattern.n, x_fam)
    )
    lead = tuple(x_fam.shape[:-1])
    return torch.cat([yH.reshape(lead + (-1,)), yV.reshape(lead + (-1,)),
                      yD.reshape(lead + (-1,))], dim=-1)


def transpose_coefficients(coeffs: tuple) -> tuple:
    """Coefficient grids of the TRANSPOSED operator, in the same 15-term
    layout and padding: ``stencil_matvec(pattern,
    transpose_coefficients(c), x) == A^T x``.

    Each directed term (row family -> column family at a fixed offset) has
    one reverse term (column family -> row family at the negated offset);
    transposing moves each grid into its reverse term's slot, shifted to be
    indexed by the new row. The diagonal terms (HH, VV, DD) stay. The
    adjoint sweep of the differentiable fused engine runs kernel B4's raw
    mode over these (ops/fused_hbm.chebyshev_apply_canvas_hbm)."""
    (cHH, cHVu, cHDu, cHVd, cHDd,
     cVV, cVDl, cVHl, cVHr, cVDr,
     cDD, cDVr, cDHd, cDHu, cDVl) = coeffs
    c = cDD.shape[0]
    return (
        cHH,
        _pad(cVHl[:, 1:], bottom=1),  # H->V(up): reverse of V->H(left)
        _pad(cDHd, bottom=1),         # H->D(up): reverse of D->H(down)
        _pad(cVHr[:, :c], top=1),     # H->V(down): reverse of V->H(right)
        _pad(cDHu, top=1),            # H->D(down): reverse of D->H(up)
        cVV,
        _pad(cDVr, left=1),           # V->D(left): reverse of D->V(right)
        _pad(cHVu[:c, :], left=1),    # V->H(left): reverse of H->V(up)
        _pad(cHVd[1:, :], right=1),   # V->H(right): reverse of H->V(down)
        _pad(cDVl, right=1),          # V->D(right): reverse of D->V(left)
        cDD,
        cVDl[:, 1:],                  # D->V(right): reverse of V->D(left)
        cHDu[:c, :],                  # D->H(down): reverse of H->D(up)
        cHDd[1:, :],                  # D->H(up): reverse of H->D(down)
        cVDr[:, :c],                  # D->V(left): reverse of V->D(right)
    )


def get_pattern(mesh_data) -> StencilPattern:
    """Build (and cache on the MeshData instance) the stencil pattern."""
    pattern = getattr(mesh_data, "_stencil_pattern", None)
    if pattern is None:
        pattern = build_stencil_pattern(
            mesh_data._host_t2s, mesh_data._host_ell_cols,
            mesh_data.structured_n,
        )
        mesh_data._stencil_pattern = pattern
    return pattern


def family_pattern(mesh_data) -> StencilPattern:
    """The family layout (n, c and the permutations) without the ELL slot
    grids: what the canvas paths that read no ELL operator need
    (models/crbe.assemble_canvas and its consumers). The full pattern
    where it is already built; else a few ms at 1025^2, where
    :func:`get_pattern` takes seconds on the host."""
    pattern = getattr(mesh_data, "_stencil_pattern", None)
    if pattern is not None:
        return pattern
    perm, inv_perm = get_family_perm(mesh_data)
    n = mesh_data.structured_n
    return StencilPattern(n=n, c=n - 1, perm=perm, inv_perm=inv_perm,
                          term_slots=(), term_valid=())


@dataclasses.dataclass(frozen=True)
class FamilyView:
    """The fields run_time_loop reads, permuted to family layout.

    ``points`` (unpermuted) supplies only the box extent, so that
    models/crbe.robin_terms can derive the Robin side masks in family
    order; ``obstacle_dead_mask`` is the obstacle dead-DOF mask in family
    order (models/crbe.obstacle_masks honours it), or None."""

    midpoints: torch.Tensor
    boundary_mask: torch.Tensor
    segment_lengths: torch.Tensor
    points: torch.Tensor
    nt: int
    obstacle_dead_mask: torch.Tensor | None = None


def family_view(mesh_data, perm, dead_mask=None) -> FamilyView:
    """MeshData stand-in with fields permuted by ``perm`` (family order);
    ``dead_mask`` (global order) is permuted the same way."""
    perm = torch.as_tensor(np.asarray(perm, dtype=np.int64),
                           device=mesh_data.device)
    return FamilyView(
        midpoints=mesh_data.midpoints[perm],
        boundary_mask=mesh_data.boundary_mask[perm],
        segment_lengths=mesh_data.segment_lengths[perm],
        points=mesh_data.points, nt=mesh_data.nt,
        obstacle_dead_mask=None if dead_mask is None else dead_mask[perm],
    )


def family_operators(pattern: StencilPattern, ops, order: int,
                     kernel: bool = False):
    """Permuted diagonal operators plus stencil matvec closures (system,
    and K+A for Crank-Nicolson) for a family-layout time loop; the system
    matvec is a linalg.BoundMatvec over the 15 coefficient grids, so that
    a differentiable loop can take the operator's gradient through them.
    With ``kernel`` the matvecs run kernel B3, bound once here to each
    coefficient tuple (ops/fused_stencil.StencilOperator); else the plain
    :func:`stencil_matvec`."""
    perm = torch.as_tensor(pattern.perm.astype(np.int64),
                           device=ops.mass_diag.device)
    coeffs = extract_coefficients(pattern, ops.system.vals)
    ka_coeffs = (extract_coefficients(pattern, ops.ka.vals) if order == 2
                 else None)
    ka_matvec = None
    if kernel:
        from airpollution_tpu_torch.ops.fused_stencil import StencilOperator

        matvec = BoundMatvec(StencilOperator(pattern, coeffs).matvec,
                             *coeffs)
        if ka_coeffs is not None:
            ka_matvec = StencilOperator(pattern, ka_coeffs)
    else:
        matvec = BoundMatvec(lambda x, *cs: stencil_matvec(pattern, cs, x),
                             *coeffs)
        if ka_coeffs is not None:
            ka_matvec = functools.partial(stencil_matvec, pattern, ka_coeffs)
    ops_fam = ops._replace(mass_diag=ops.mass_diag[perm],
                           system_diag=ops.system_diag[perm])
    return ops_fam, matvec, ka_matvec
