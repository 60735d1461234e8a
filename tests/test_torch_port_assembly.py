"""The port's assembly and operators (models/crbe.assemble, ops/sparse,
ops/stencil, ops/uniform, ops/lifting) against the JAX package's, float64:
ELL values and columns, diagonals, the 15 + 3 + 3 uniform scalars and the
matvecs, within 1e-12 relative."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.ops import lifting as j_lifting
from airpollution_tpu.ops import sparse as j_sparse
from airpollution_tpu.ops import stencil as j_stencil
from airpollution_tpu.ops import uniform as j_uniform

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models import crbe as t_crbe
from airpollution_tpu_torch.ops import lifting as t_lifting
from airpollution_tpu_torch.ops import sparse as t_sparse
from airpollution_tpu_torch.ops import stencil as t_stencil
from airpollution_tpu_torch.ops import uniform as t_uniform

from torch_port_helpers import mesh_pair, rel_diff

TOL = 1e-12


def _assembled(ms, convention, order, **problem_kw):
    jmd, tmd = mesh_pair(ms, nt=11)
    dt = 10.0 / 10
    jops = j_crbe.assemble(jmd, japt.Problem(**problem_kw), dt, order,
                           convention)
    tops = t_crbe.assemble(tmd, tapt.Problem(**problem_kw), dt, order,
                           convention)
    return jmd, tmd, jops, tops


@pytest.mark.parametrize("ms", [9, 17])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("convention", ["correct", "reference"])
def test_assembly_matches_jax(ms, order, convention):
    jmd, tmd, jops, tops = _assembled(ms, convention, order)
    for name in ("stiffness", "advection", "ka", "system"):
        jm, tm = getattr(jops, name), getattr(tops, name)
        np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
        assert rel_diff(tm.vals, jm.vals) <= TOL, name
    assert rel_diff(tops.mass_diag, jops.mass_diag) <= TOL
    assert rel_diff(tops.system_diag, jops.system_diag) <= TOL

    jpat, tpat = j_stencil.get_pattern(jmd), t_stencil.get_pattern(tmd)
    jspec = j_uniform.build_uniform_spec(jpat)
    tspec = t_uniform.build_uniform_spec(tpat)
    for ell in ("system", "ka"):
        assert rel_diff(
            t_uniform.extract_constants(tspec, getattr(tops, ell).vals),
            j_uniform.extract_constants(jspec, getattr(jops, ell).vals),
        ) <= TOL
    for vec in ("mass_diag", "system_diag"):
        assert rel_diff(
            t_uniform.family_constants(tspec, getattr(tops, vec)),
            j_uniform.family_constants(jspec, getattr(jops, vec)),
        ) <= TOL


def test_reaction_folds_into_the_operator_like_jax():
    _, _, jops, tops = _assembled(9, "correct", 2, reaction=0.3)
    assert rel_diff(tops.ka.vals, jops.ka.vals) <= TOL
    assert rel_diff(tops.system.vals, jops.system.vals) <= TOL


def test_local_matrices_match_jax():
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(20, 3, 2))
    # Orient counter-clockwise, as the meshes are.
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    flip = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0
    verts[flip, 1], verts[flip, 2] = verts[flip, 2].copy(), verts[flip, 1].copy()
    areas = np.full(20, 0.7)
    for conv in ("correct", "reference"):
        j = j_crbe.local_matrices(jnp.asarray(verts), jnp.asarray(areas),
                                  0.1, jnp.asarray([1.0, 0.5]), conv)
        t = t_crbe.local_matrices(torch.tensor(verts), torch.tensor(areas),
                                  0.1, (1.0, 0.5), conv)
        for a, b in zip(t, j):
            assert rel_diff(a, b) <= TOL


@pytest.mark.parametrize("order", [1, 2])
def test_matvecs_match_jax(order):
    jmd, tmd, jops, tops = _assembled(17, "reference", order)
    rng = np.random.default_rng(2)
    x = rng.normal(size=tmd.number_of_segments)
    xt = torch.tensor(x)
    for name in ("system", "ka"):
        assert rel_diff(t_sparse.ell_matvec(getattr(tops, name), xt),
                        j_sparse.ell_matvec(getattr(jops, name),
                                            jnp.asarray(x))) <= TOL
    jpat, tpat = j_stencil.get_pattern(jmd), t_stencil.get_pattern(tmd)
    jc = j_stencil.extract_coefficients(jpat, jops.system.vals)
    tc = t_stencil.extract_coefficients(tpat, tops.system.vals)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=0)
    assert rel_diff(t_stencil.stencil_matvec(tpat, tc, xt),
                    j_stencil.stencil_matvec(jpat, jc, jnp.asarray(x))) <= TOL
    jspec = j_uniform.build_uniform_spec(jpat)
    tspec = t_uniform.build_uniform_spec(tpat)
    for ell, boundary in (("system", "identity"), ("ka", "drop")):
        jk = j_uniform.extract_constants(jspec, getattr(jops, ell).vals)
        tk = t_uniform.extract_constants(tspec, getattr(tops, ell).vals)
        assert rel_diff(
            t_uniform.uniform_matvec(tspec, tk, xt, boundary=boundary),
            j_uniform.uniform_matvec(jspec, jk, jnp.asarray(x),
                                     boundary=boundary),
        ) <= TOL
    bm = tmd.boundary_mask[torch.as_tensor(tpat.perm.astype(np.int64))]
    dc = t_uniform.family_constants(tspec, tops.system_diag)
    assert rel_diff(
        t_uniform.family_diag_vector(tspec, dc, bm),
        j_uniform.family_diag_vector(
            jspec, j_uniform.family_constants(jspec, jops.system_diag),
            jnp.asarray(bm.numpy())),
    ) <= TOL


def test_sparse_helpers_match_jax():
    jmd, tmd, jops, tops = _assembled(9, "correct", 1)
    np.testing.assert_array_equal(
        t_sparse.ell_diagonal(tops.system, tmd.ell_diag_slot).numpy(),
        np.asarray(j_sparse.ell_diagonal(jops.system, jmd.ell_diag_slot)))
    tm = t_sparse.ell_mask_dirichlet_rows(tops.ka, tmd.boundary_mask,
                                          tmd.ell_diag_slot)
    jm = j_sparse.ell_mask_dirichlet_rows(jops.ka, jmd.boundary_mask,
                                          jmd.ell_diag_slot)
    assert rel_diff(tm.vals, jm.vals) <= TOL


def test_lift_matches_jax():
    jmd, tmd = mesh_pair(9)
    jl = j_lifting.make_lift(japt.Problem(), jmd.midpoints, jmd.boundary_mask)
    tl = t_lifting.make_lift(tapt.Problem(), tmd.midpoints, tmd.boundary_mask)
    u = np.random.default_rng(3).normal(size=tmd.number_of_segments)
    got = t_lifting.lifted_final_state(tl, torch.tensor(u), 0.5, 7)
    want = j_lifting.lifted_final_state(jl, jnp.asarray(u), 0.5, 7)
    assert got.shape == (1, tmd.number_of_segments)
    assert rel_diff(got, want) <= TOL
