"""The port's CRBESolver as a whole: reference parity on its own, and
against the JAX CRBESolver on one operator and one Chebyshev interval for
the scan ('stencil', 'ell') and fused ('fused' -> B1, 'fused_hbm' -> B2)
paths, float64."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models.crbe import CRBESolver as JaxSolver

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models.crbe import CRBESolver, _fused_fits

from torch_port_helpers import mesh_pair, port_operators, rel_diff


@pytest.mark.parametrize("ms,expect", [(16, 1.741805), (32, 0.787025)])
def test_reference_parity(ms, expect):
    """The reference solver's rel-L2 on this mesh (tests/test_fem.py
    oracle): BE, nt=128, 'reference' stiffness convention."""
    md = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=128,
                       dtype=torch.float64, device="cpu")
    s = CRBESolver(tapt.Domain(), tapt.Problem(), md, solver_tol=1e-11,
                   stiffness_convention="reference", device="cpu")
    sols = s.solve()
    assert sols.shape == (128, md.number_of_segments)
    rel_l2, l2, mx = s.compute_errors(tapt.Problem().analytical_solution)
    assert abs(rel_l2 - expect) < 1e-5, rel_l2
    assert 0 < mx <= l2
    fem = s.compute_fem_errors(tapt.Problem().analytical_solution)
    assert all(np.isfinite(fem))


def _run_pair(impl, order, extrapolate, method, ms=13, nt=9, **kw):
    jmd, tmd = mesh_pair(ms, nt=nt)
    common = dict(time_scheme_order=order, stiffness_convention="reference",
                  matvec_impl=impl, solver_method=method,
                  extrapolate_warm_start=extrapolate, chebyshev_iters=4,
                  solver_tol=1e-12, **kw)
    js = JaxSolver(japt.Domain(), japt.Problem(), jmd, **common)
    store = impl not in ("fused", "fused_hbm")
    want = js.solve(store_solutions=store)
    # The fused paths solve with the interval the JAX solver cached; its
    # scan path estimates its own inside the loop, and so does the port's.
    bounds = js._cheb_bounds if not store else None
    ts = CRBESolver(tapt.Domain(), tapt.Problem(), tmd, cheb_bounds=bounds,
                    device="cpu", **common)
    ts.set_operators(port_operators(js._ops))
    got = ts.solve(store_solutions=store)
    assert got.shape == want.shape
    return js, ts, got, want


@pytest.mark.parametrize("impl,order,extrapolate,method", [
    ("stencil", 1, False, "bicgstab"),
    ("stencil", 2, True, "bicgstab"),
    ("ell", 1, True, "bicgstab"),
    ("stencil", 1, True, "chebyshev"),
    ("stencil", 2, False, "chebyshev"),
])
def test_scan_paths_match_jax(impl, order, extrapolate, method):
    _, _, got, want = _run_pair(impl, order, extrapolate, method)
    assert rel_diff(got, want) <= 1e-10


@pytest.mark.parametrize("impl,order", [("fused", 1), ("fused", 2),
                                        ("fused_hbm", 1), ("fused_hbm", 2)])
def test_fused_paths_match_jax(impl, order):
    js, ts, got, want = _run_pair(impl, order, True, "chebyshev", ms=13,
                                  nt=21)
    assert ts.fused_kernel == ("B1" if impl == "fused" else "B2")
    assert rel_diff(got, want) <= 1e-10
    assert ts.compute_errors(tapt.Problem().analytical_solution) == \
        pytest.approx(js.compute_errors(japt.Problem().analytical_solution),
                      rel=1e-9)


def test_port_assembly_drives_the_same_solve():
    """Without carried-over operators the port assembles its own, and the
    fused path agrees with the port's scan path run as Chebyshev on the
    same fixed interval."""
    md = tapt.MeshData(tapt.create_mesh(17, 20.0), tapt.Domain(), nt=21,
                       dtype=torch.float64, device="cpu")
    kw = dict(stiffness_convention="reference", solver_method="chebyshev",
              chebyshev_iters=4, extrapolate_warm_start=True,
              cheb_bounds=(0.47, 1.7), device="cpu")
    fused = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                       matvec_impl="fused", **kw)
    scan = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                      matvec_impl="stencil", **kw)
    a = fused.solve(store_solutions=False)
    b = scan.solve(store_solutions=False)
    assert fused._cheb_bounds == scan._cheb_bounds == (0.47, 1.7)
    assert float((a - b).abs().max()) <= 1e-12


def test_routing_rule_matches_jax():
    """B1 below the JAX package's resident budget, B2 above it."""
    from airpollution_tpu.models.crbe import _pallas_fused_fits
    from airpollution_tpu.ops import uniform as j_uniform

    for n in (257, 480, 481, 600, 1025):
        for ext in (False, True):
            spec = j_uniform.make_spec_lite(n)
            assert _fused_fits(n, ext) == _pallas_fused_fits(
                spec, ext, uniform=True, method="chebyshev")
    assert _fused_fits(257, True) and not _fused_fits(1025, True)


def test_divergence_guard_raises_once_per_configuration():
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=9,
                       dtype=torch.float64, device="cpu")
    for impl in ("fused", "fused_hbm"):
        s = CRBESolver(tapt.Domain(), tapt.Problem(), md, matvec_impl=impl,
                       solver_method="chebyshev", chebyshev_iters=3,
                       chebyshev_policy="warn", cheb_bounds=(0.01, 0.02),
                       device="cpu")
        with pytest.warns(UserWarning):
            with pytest.raises(FloatingPointError, match="diverged"):
                s.solve(store_solutions=False)
        s.solve(store_solutions=False)  # guard already read: no raise


def test_divergent_chebyshev_is_rerouted_or_refused():
    # Coarse mesh, large dt: advection-dominated spectrum.
    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=3,
                       dtype=torch.float64, device="cpu")
    scan = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                      matvec_impl="stencil", solver_method="chebyshev",
                      device="cpu")
    with pytest.warns(UserWarning, match="auto-switching"):
        scan.solve(store_solutions=False)
    assert scan.solver_method == "bicgstab"
    # 'fused' on the uniform operator switches to B1's BiCGStab variant, as
    # the JAX solver does; the per-step kernels are Chebyshev-only.
    fused = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                       matvec_impl="fused", solver_method="chebyshev",
                       device="cpu")
    with pytest.warns(UserWarning, match="auto-switching"):
        fused.solve(store_solutions=False)
    assert fused.solver_method == "bicgstab"
    assert fused.fused_kernel == "B1-BiCGStab"
    hbm = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                     matvec_impl="fused_hbm", solver_method="chebyshev",
                     device="cpu")
    with pytest.raises(ValueError, match="Chebyshev-only"):
        hbm.solve(store_solutions=False)


def test_fused_returns_final_state_only():
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=41,
                       dtype=torch.float64, device="cpu")
    s = CRBESolver(tapt.Domain(), tapt.Problem(), md, matvec_impl="fused",
                   solver_method="chebyshev", device="cpu")
    with pytest.raises(ValueError, match="final state only"):
        s.solve()
