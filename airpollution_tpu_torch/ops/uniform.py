"""Translation-invariant (uniform) stencil operator, PyTorch counterpart
of ``airpollution_tpu/ops/uniform.py``.

On ``create_mesh`` grids with constant ``v`` and ``D`` every cell is
congruent, so each of the 15 stencil terms carries one scalar over its
whole validity region, Dirichlet rows are identity rows, and within each
edge family the validity regions collapse to one interior rectangle. The
operator is 15 scalars plus the per-family mass and diagonal constants:
the 21 scalars the fused kernels take. Patch assembly
(:func:`patch_constants`) takes them from a tiny congruent mesh instead of
the assembled global operator, for meshes too large to assemble.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from airpollution_tpu_torch.ops.linalg import BoundMatvec
from airpollution_tpu_torch.ops.stencil import (
    StencilPattern,
    split_families,
    stencil_matvec_terms,
)


@dataclasses.dataclass(frozen=True)
class UniformSpec:
    """Static description of the uniform operator.

    center_slots: (15,) flat ELL slots, one interior sample per term.
    center_dofs: (3,) global DOF ids of one interior H, V and D DOF.
    """

    n: int
    c: int
    center_slots: np.ndarray
    center_dofs: np.ndarray

    @property
    def interior_rects(self):
        """Per-family interior rectangle (rows [lo, hi), cols [lo, hi)) in
        (n, n)-canvas coordinates, outside which family DOFs are Dirichlet
        rows or canvas padding."""
        c = self.c
        return {"H": (1, c, 0, c), "V": (0, c, 1, c), "D": (0, c, 0, c)}


def build_uniform_spec(pattern: StencilPattern) -> UniformSpec:
    """Derive the uniform-operator spec from a stencil pattern (n >= 3)."""
    n, c = pattern.n, pattern.c
    if n < 3:
        raise ValueError("uniform operator requires n_points_per_axis >= 3")
    slots = []
    for t, (slot_grid, valid) in enumerate(
        zip(pattern.term_slots, pattern.term_valid)
    ):
        r, col = valid.shape[0] // 2, valid.shape[1] // 2
        if not valid[r, col]:
            raise AssertionError(
                f"stencil term {t}: grid center not in validity region"
            )
        slots.append(slot_grid[r, col])
    h_idx = (n // 2) * c + c // 2
    v_idx = n * c + (c // 2) * n + n // 2
    d_idx = n * c + c * n + (c // 2) * c + c // 2
    center_dofs = pattern.perm[np.array([h_idx, v_idx, d_idx])]
    return UniformSpec(
        n=n, c=c,
        center_slots=np.asarray(slots, dtype=np.int64),
        center_dofs=np.asarray(center_dofs, dtype=np.int64),
    )


def make_spec_lite(n: int) -> UniformSpec:
    """A UniformSpec with the grid geometry (n, c) only, for the constants
    of :func:`patch_constants`: the matvec, the canvas embedding and the
    fused kernels read only ``n`` and ``c``. Its sample indices are -1, so
    that :func:`extract_constants` and :func:`family_constants` refuse it
    instead of gathering slot 0."""
    if n < 3:
        raise ValueError("uniform operator requires n_points_per_axis >= 3")
    return UniformSpec(n=n, c=n - 1,
                       center_slots=np.full(15, -1, dtype=np.int64),
                       center_dofs=np.full(3, -1, dtype=np.int64))


def extract_constants(spec: UniformSpec, ell_vals) -> torch.Tensor:
    """The 15 scalar stencil coefficients."""
    if np.any(spec.center_slots < 0):
        raise ValueError(
            "spec carries no center-sample slots (make_spec_lite); use "
            "patch_constants to obtain coefficients for a lite spec")
    idx = torch.as_tensor(spec.center_slots, device=ell_vals.device)
    return ell_vals.reshape(-1)[idx]


def family_constants(spec: UniformSpec, vec) -> torch.Tensor:
    """Per-family (H, V, D) interior constants of a global DOF vector."""
    if np.any(spec.center_dofs < 0):
        raise ValueError(
            "spec carries no center-sample DOFs (make_spec_lite); use "
            "patch_constants to obtain per-family constants")
    return vec[torch.as_tensor(spec.center_dofs, device=vec.device)]


def patch_constants(n: int, domain_size: float, problem, dt: float,
                    order: int, stiffness_convention: str = "correct", *,
                    patch_n: int = 9, dtype=None, device="cpu"):
    """The uniform operator's scalars without assembling the global
    operator: ``(sys_consts (15,), ka_consts (15,), mass_c (3,),
    sys_diag_c (3,))``, ka_consts the raw K + A stencil scalars.

    With constant (v, D) every cell of a structured mesh is congruent, so
    the scalars of the n x n mesh of half-width ``domain_size`` (cell size
    h = 2 domain_size / (n - 1)) are those of a ``patch_n`` x ``patch_n``
    mesh of the same h, assembled by :func:`models.crbe.assemble` at
    O(patch_n^2) cost; they match the full extraction up to the rounding
    of the patch's coordinates. Variable coefficients are refused: the
    patch sits at its own coordinates and would sample them in the wrong
    place."""
    from airpollution_tpu_torch.mesh import MeshData, create_mesh
    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.ops.stencil import get_pattern
    from airpollution_tpu_torch.problems import Domain

    if getattr(problem, "variable_coefficients", False):
        raise ValueError(
            "patch_constants requires constant (v, D): spatially varying "
            "coefficients are not translation-invariant")
    h = 2.0 * domain_size / (n - 1)
    patch_L = h * (patch_n - 1) / 2.0
    kwargs = {} if dtype is None else {"dtype": dtype}
    md = MeshData(create_mesh(patch_n, patch_L),
                  Domain(Lx=patch_L, Ly=patch_L, T=1.0), nt=2,
                  device=device, **kwargs)
    ops = crbe.assemble(md, problem, dt, order, stiffness_convention)
    spec = build_uniform_spec(get_pattern(md))
    return (extract_constants(spec, ops.system.vals),
            extract_constants(spec, ops.ka.vals),
            family_constants(spec, ops.mass_diag),
            family_constants(spec, ops.system_diag))


def family_const_vector(spec: UniformSpec, c3):
    """Family-layout vector filled blockwise with 3 per-family constants."""
    n, c = spec.n, spec.c
    counts = torch.tensor([n * c, c * n, c * c], device=c3.device)
    return torch.repeat_interleave(c3, counts)


def family_diag_vector(spec: UniformSpec, diag_c, bmask_fam):
    """Family-layout diagonal from the 3 constants; Dirichlet rows are 1."""
    vec = family_const_vector(spec, diag_c)
    return torch.where(bmask_fam, torch.ones_like(vec), vec)


def uniform_matvec(spec: UniformSpec, consts, x_fam, *,
                   boundary: str = "identity"):
    """y = A @ x in family layout from 15 scalar coefficients.

    ``boundary="identity"``: y = x on Dirichlet rows (the row-masked
    system). ``boundary="drop"``: y = 0 there (the unmasked K+A of the
    Crank-Nicolson RHS, whose boundary rows the loop discards). ``x_fam``
    is (N,) or (..., N), e.g. one row per species.
    """
    if boundary not in ("identity", "drop"):
        raise ValueError(f"unknown boundary mode {boundary!r}")
    n = spec.n
    xH, xV, xD = split_families(n, x_fam)
    yH, yV, yD = stencil_matvec_terms(n, tuple(consts), xH, xV, xD)

    # Dirichlet rows: H rows {0, n-1} and V cols {0, n-1}; no D edge lies
    # on the boundary.
    idx = torch.arange(n, device=x_fam.device)
    h_bnd = ((idx == 0) | (idx == n - 1))[:, None]
    v_bnd = ((idx == 0) | (idx == n - 1))[None, :]
    if boundary == "identity":
        yH = torch.where(h_bnd, xH, yH)
        yV = torch.where(v_bnd, xV, yV)
    else:
        yH = torch.where(h_bnd, torch.zeros_like(yH), yH)
        yV = torch.where(v_bnd, torch.zeros_like(yV), yV)
    lead = tuple(x_fam.shape[:-1])
    return torch.cat([yH.reshape(lead + (-1,)), yV.reshape(lead + (-1,)),
                      yD.reshape(lead + (-1,))], dim=-1)


def uniform_family_operators(spec: UniformSpec, pattern: StencilPattern,
                             ops, order: int):
    """Uniform-operator analogue of stencil.family_operators: the permuted
    diagonal operators, the system matvec as a linalg.BoundMatvec over the
    15 scalar coefficients (gathered from the assembled values, so the
    gradient reaches D and v through 15 elements instead of 15 grids), and
    for Crank-Nicolson the K+A matvec with ``boundary="drop"``."""
    perm = torch.as_tensor(pattern.perm.astype(np.int64),
                           device=ops.mass_diag.device)
    consts = extract_constants(spec, ops.system.vals)
    matvec = BoundMatvec(lambda x, c: uniform_matvec(spec, c, x), consts)
    ka_matvec = None
    if order == 2:
        ka_consts = extract_constants(spec, ops.ka.vals)
        ka_matvec = functools.partial(uniform_matvec, spec, ka_consts,
                                      boundary="drop")
    ops_fam = ops._replace(mass_diag=ops.mass_diag[perm],
                           system_diag=ops.system_diag[perm])
    return ops_fam, matvec, ka_matvec
