"""The uniform scan route (``matvec_impl="uniform"``: the 15-scalar
translation-invariant operator in the Python step loop, with full or
patch assembly), the large-mesh policy, the solver's accessors and
``MultiSpeciesSolver(matvec_impl="uniform")`` against the JAX package, on
the CPU in float64 unless stated.

The JAX solves are compiled once per configuration and shared by the
cases that read them. Tolerances: the solutions to UNIFORM_TOL of
max|u| (BiCGStab at solver_tol=1e-12; Chebyshev on intervals that the two
packages estimate from the same operator to ~1e-15)."""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.models.multispecies import (
    MultiSpeciesSolver as JMultiSpeciesSolver,
)

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models import crbe as t_crbe

from torch_port_helpers import mesh_pair, rel_diff

UNIFORM_TOL = 1e-10

SOURCE = dict(q=2.0, xs=-4.0, ys=2.5, sigma_s=2.0)

# (id, kwargs of both solvers, sourced, store, collect_iters)
CASES = [
    ("be-bicgstab-full", dict(time_scheme_order=1, solver_method="bicgstab",
                              assembly="full", solver_tol=1e-12),
     False, True, True),
    ("cn-chebyshev-patch-snapshots",
     dict(time_scheme_order=2, solver_method="chebyshev", chebyshev_iters=10,
          assembly="patch", extrapolate_warm_start=True, snapshot_every=4),
     False, True, False),
    ("be-chebyshev-full-sourced",
     dict(time_scheme_order=1, solver_method="chebyshev", chebyshev_iters=10,
          assembly="full"), True, False, False),
    ("cn-bicgstab-patch-sourced-snapshots",
     dict(time_scheme_order=2, solver_method="bicgstab", assembly="patch",
          solver_tol=1e-12, snapshot_every=4), True, True, False),
]


def _problems(sourced):
    if sourced:
        return (japt.GaussianSourceProblem(**SOURCE),
                tapt.GaussianSourceProblem(**SOURCE))
    return japt.Problem(), tapt.Problem()


@pytest.fixture(scope="module")
def meshes():
    return mesh_pair(12, nt=17)


@pytest.fixture(scope="module")
def jax_solves(meshes):
    """Each case's JAX solution (and iteration counts), computed once."""
    jmd, _ = meshes
    out = {}
    for cid, kw, sourced, store, collect in CASES:
        jp, _ = _problems(sourced)
        s = j_crbe.CRBESolver(japt.Domain(), jp, jmd, matvec_impl="uniform",
                              **kw)
        u = np.asarray(s.solve(store_solutions=store, collect_iters=collect))
        its = (np.asarray(s.solver_iterations) if collect else None)
        out[cid] = (u, its)
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_uniform_route_matches_jax(meshes, jax_solves, case):
    cid, kw, sourced, store, collect = case
    _, tmd = meshes
    _, tp = _problems(sourced)
    s = t_crbe.CRBESolver(tapt.Domain(), tp, tmd, matvec_impl="uniform",
                          device="cpu", **kw)
    assert s._use_patch() == (kw["assembly"] == "patch")
    u = s.solve(store_solutions=store, collect_iters=collect)
    want, its = jax_solves[cid]
    assert u.shape == want.shape
    assert rel_diff(u, want) <= UNIFORM_TOL
    if kw["assembly"] == "patch":
        assert s._ops is None  # no global operator was assembled
    if collect:
        assert len(s.solver_iterations) == len(its) == tmd.nt - 1
        assert max(abs(a - int(b)) for a, b in
                   zip(s.solver_iterations, its)) <= 1


@pytest.mark.parametrize("order", [1, 2])
def test_uniform_route_matches_the_stencil_path(meshes, order):
    """The uniform operator is the assembled one on a structured mesh: the
    route agrees with the port's stencil scan to the solver tolerance."""
    _, tmd = meshes
    kw = dict(time_scheme_order=order, solver_tol=1e-12, device="cpu")
    ref = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), tmd,
                            matvec_impl="stencil", **kw).solve()
    got = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), tmd,
                            matvec_impl="uniform", **kw).solve()
    assert rel_diff(got, ref.numpy()) <= UNIFORM_TOL


def test_uniform_route_needs_a_structured_mesh():
    md = tapt.MeshData(tapt.create_unstructured_mesh(8, 20.0),
                       tapt.Domain(), nt=9, device="cpu")
    s = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), md,
                          matvec_impl="uniform", device="cpu")
    with pytest.raises(ValueError, match="structured"):
        s.solve()


def _policy(pkg, dtype, ms, nt, tol):
    """Apply the large-mesh policy directly (a 6M-DOF mesh is not built
    in a test) to a uniform BiCGStab solver; returns (method, k, tol,
    warning texts)."""
    if pkg == "jax":
        md = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(), nt=nt,
                           dtype=getattr(jnp, dtype))
        s = j_crbe.CRBESolver(japt.Domain(), japt.Problem(), md,
                              matvec_impl="uniform", solver_tol=tol)
    else:
        md = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=nt,
                           dtype=getattr(torch, dtype), device="cpu")
        s = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), md,
                              matvec_impl="uniform", solver_tol=tol,
                              device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s._apply_large_mesh_solver_policy(s._require_ops())
    return (s.solver_method, s.chebyshev_iters, s.solver_tol,
            [str(x.message) for x in w])


@pytest.mark.parametrize("dtype,ms,nt,tol,method", [
    ("float32", 16, 65, 1e-10, "chebyshev"),
    ("float32", 6, 4, 1e-10, "bicgstab"),
    ("float64", 16, 65, 1e-10, "bicgstab"),
], ids=["f32-chebyshev", "f32-tolerance-floor", "f64-unchanged"])
def test_large_mesh_policy_matches_jax(dtype, ms, nt, tol, method):
    j = _policy("jax", dtype, ms, nt, tol)
    t = _policy("torch", dtype, ms, nt, tol)
    assert t[0] == j[0] == method
    assert t[1] == j[1]
    assert t[2] == pytest.approx(j[2], rel=1e-12)
    assert len(t[3]) == len(j[3])
    if dtype == "float64":
        assert t[2] == tol and not t[3]
    elif method == "chebyshev":
        assert "auto-switching" in t[3][0] and t[1] >= 8
    else:
        assert t[2] > tol and "raising solver_tol" in t[3][0]


def test_auto_routes_past_the_threshold(monkeypatch):
    """Past LARGE_MESH_DOFS (patched down to a small mesh) 'auto' takes the
    uniform route with patch assembly, and a float32 BiCGStab solve goes
    through the policy: the result is the explicit route's, bit for bit;
    'fused_hbm' takes patch assembly there too."""
    monkeypatch.setattr(t_crbe, "LARGE_MESH_DOFS", 500)
    md = tapt.MeshData(tapt.create_mesh(16, 20.0), tapt.Domain(), nt=65,
                       device="cpu")
    assert md.number_of_segments > 500
    s = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), md, device="cpu")
    assert s.matvec_impl == "uniform" and s._use_patch()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = s.solve(store_solutions=False)
    assert s._large_mesh_policy_applied
    assert any("auto-switching" in str(x.message) for x in w)
    assert s.solver_method == "chebyshev" and s._ops is None
    ref = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), md,
                            matvec_impl="uniform", assembly="patch",
                            solver_method="chebyshev",
                            chebyshev_iters=s.chebyshev_iters, device="cpu")
    assert torch.equal(got, ref.solve(store_solutions=False))
    for kw in (dict(assembly="full"), dict(preconditioner="spectral"),
               dict(problem=_Robin())):
        p = kw.pop("problem", tapt.Problem())
        s = t_crbe.CRBESolver(tapt.Domain(), p, md, device="cpu", **kw)
        assert s.matvec_impl == "auto" and not s._use_patch()
    s = t_crbe.CRBESolver(tapt.Domain(), tapt.Problem(), md,
                          matvec_impl="fused_hbm", solver_method="chebyshev",
                          device="cpu")
    assert s._use_patch()


class _Robin(tapt.Problem):
    robin_sides = {"left": 0.1}


class _JRobin(japt.Problem):
    robin_sides = {"left": 0.1}


def test_accessors_match_jax(meshes):
    jmd, tmd = meshes
    j = j_crbe.CRBESolver(japt.Domain(), _JRobin(), jmd)
    t = t_crbe.CRBESolver(tapt.Domain(), _Robin(), tmd, device="cpu")
    assert rel_diff(t.global_mass_diag, j.global_mass_diag) <= 1e-14
    for name in ("global_stiffness", "global_advection"):
        a, b = getattr(t, name), getattr(j, name)
        np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
        assert rel_diff(a.vals, b.vals) <= 1e-14
    for time_ in (0.0, 3.7):
        want = np.asarray(j.boundary_values(time_))
        got = t.boundary_values(time_)
        assert rel_diff(got, want) <= 1e-14
        assert float(got[~tmd.boundary_mask].abs().max()) == 0.0
    assert t_crbe.ElementCR().get_jacobian() is None
    assert j_crbe.ElementCR().get_jacobian() is None


def _chemistry(pkg):
    m = japt if pkg == "jax" else tapt
    return m.MultiSpeciesProblem(
        (m.GaussianSourceProblem(**SOURCE), m.Problem(sigma=2.0)),
        [[0.3, 0.0], [-0.3, 0.1]])


@pytest.mark.parametrize("kw", [
    dict(time_scheme_order=2, solver_method="bicgstab", solver_tol=1e-12),
    dict(time_scheme_order=1, solver_method="chebyshev", chebyshev_iters=10),
], ids=["cn-bicgstab", "be-chebyshev"])
def test_multispecies_uniform_matches_jax(meshes, kw):
    jmd, tmd = meshes
    j = JMultiSpeciesSolver(japt.Domain(), _chemistry("jax"), jmd,
                            matvec_impl="uniform", splitting="strang", **kw)
    want = np.asarray(j.solve(store_solutions=False))
    t = tapt.MultiSpeciesSolver(tapt.Domain(), _chemistry("torch"), tmd,
                                matvec_impl="uniform", splitting="strang",
                                device="cpu", **kw)
    got = t.solve(store_solutions=False)
    assert got.shape == want.shape
    assert rel_diff(got, want) <= UNIFORM_TOL


def test_multispecies_uniform_refusals():
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=5,
                       device="cpu")

    class Walled(tapt.Problem):
        robin_sides = {"bottom": 0.05}

    class Blocked(tapt.Problem):
        obstacles = ((-2.0, 2.0, -2.0, 2.0),)

    for species in ((Walled(), Walled()), (Blocked(), Blocked())):
        chem = tapt.MultiSpeciesProblem(species, [[0.1, 0.0], [-0.1, 0.0]])
        with pytest.raises(ValueError):
            tapt.MultiSpeciesSolver(tapt.Domain(), chem, md,
                                    matvec_impl="uniform", device="cpu")
