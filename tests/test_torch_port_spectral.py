"""The port's spectral preconditioner (ops/spectral.py) and
``CRBESolver(preconditioner="spectral")`` against the JAX package's, on
the CPU. The symbol is built and inverted in complex64 in both packages
(whatever the solve's dtype), so it agrees bit for bit, and its
application agrees to float32 level (SPECTRAL_TOL: the two inverses come
from different LAPACK paths). The preconditioner changes only the
iteration count: the converged solves agree to the solver's tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.ops import spectral as j_spectral
from airpollution_tpu.ops import stencil as j_stencil

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.ops import spectral as t_spectral
from airpollution_tpu_torch.ops import stencil as t_stencil

from torch_port_helpers import mesh_pair, port_operators, rel_diff

SPECTRAL_TOL = 1e-6  # of max|z|: a complex64 symbol inverted twice
SOLVE_TOL = 1e-8  # of max|u|: two solves converged to solver_tol=1e-10


@pytest.fixture(scope="module")
def pieces():
    jmd, tmd = mesh_pair(16, nt=8)
    jops = j_crbe.assemble(jmd, japt.Problem(), 10.0 / 7, 1)
    tops = port_operators(jops)
    jp, tp = j_stencil.get_pattern(jmd), t_stencil.get_pattern(tmd)
    return (jmd, tmd, jp, tp, j_stencil.extract_coefficients(
        jp, jops.system.vals), t_stencil.extract_coefficients(
        tp, tops.system.vals))


def test_symbol_matches_jax_bitwise(pieces):
    _, _, jp, tp, jco, tco = pieces
    jsym = np.asarray(j_spectral.build_symbol(jp, jco))
    tsym = t_spectral.build_symbol(tp, tco)
    assert tsym.dtype == torch.complex64 and tsym.shape == jsym.shape
    np.testing.assert_array_equal(tsym.numpy(), jsym)
    for a, b in zip(t_spectral.interior_coefficients(tp, tco),
                    j_spectral.interior_coefficients(jp, jco)):
        assert float(a) == float(b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_application_matches_jax(pieces, dtype):
    jmd, _, jp, tp, jco, tco = pieces
    x = np.random.default_rng(3).normal(
        size=jmd.number_of_segments).astype(dtype)
    jz = j_spectral.spectral_preconditioner(jp, jco)(jnp.asarray(x))
    tz = t_spectral.spectral_preconditioner(tp, tco)(torch.tensor(x))
    assert tz.dtype == getattr(torch, dtype)
    assert rel_diff(tz, jz) <= SPECTRAL_TOL


def test_inverts_interior_operator(pieces):
    """precond(S x) == x for x supported deep in the interior, where the
    operator is the block-circulant one (the JAX package's test, in f64
    with the complex64 symbol)."""
    _, tmd, _, tp, _, tco = pieces
    h = 40.0 / 15
    mid = tmd.midpoints.numpy()[np.asarray(tp.perm)]
    deep = np.abs(mid).max(axis=1) < 20 - 2.5 * h
    x = torch.tensor(np.where(deep, np.random.default_rng(0).normal(
        size=mid.shape[0]), 0.0))
    z = t_spectral.spectral_preconditioner(tp, tco)(
        t_stencil.stencil_matvec(tp, tco, x))
    assert float((z - x).abs().max()) <= 2e-6


@pytest.fixture(scope="module")
def solves():
    """Spectral and Jacobi BiCGStab solves at ms=32, nt=16 (f64), in both
    packages for the spectral one, BE and CN."""
    out = {}
    for order in (1, 2):
        jmd, tmd = mesh_pair(32, nt=16)
        s = j_crbe.CRBESolver(japt.Domain(), japt.Problem(), jmd,
                              matvec_impl="stencil", solver_tol=1e-10,
                              time_scheme_order=order,
                              preconditioner="spectral")
        j_u = np.asarray(s.solve(store_solutions=False, collect_iters=True))
        runs = {}
        for pc in ("jacobi", "spectral"):
            t = CRBESolver(tapt.Domain(), tapt.Problem(), tmd,
                           matvec_impl="stencil", solver_tol=1e-10,
                           time_scheme_order=order, preconditioner=pc,
                           device="cpu")
            u = t.solve(store_solutions=False, collect_iters=True)
            runs[pc] = (u, float(np.mean(t.solver_iterations)))
        out[order] = (j_u, float(np.asarray(s.solver_iterations).mean()),
                      runs)
    return out


@pytest.mark.parametrize("order", [1, 2])
def test_spectral_solve_matches_jax_and_jacobi(solves, order):
    j_u, j_iters, runs = solves[order]
    u, iters = runs["spectral"]
    assert rel_diff(u, j_u) <= SOLVE_TOL
    assert iters == pytest.approx(j_iters, abs=0.5)
    assert rel_diff(u, runs["jacobi"][0].numpy()) <= SOLVE_TOL
    # A near-exact interior inverse: ~3 iterations a step at this tight
    # tolerance, against Jacobi's ~3x more.
    assert 2 * iters < runs["jacobi"][1]


def test_spectral_requires_the_stencil_path():
    md = tapt.MeshData(tapt.create_mesh(8, 20.0), tapt.Domain(), nt=4,
                       device="cpu")
    for impl in ("ell", "fused"):
        s = CRBESolver(tapt.Domain(), tapt.Problem(), md, matvec_impl=impl,
                       preconditioner="spectral", device="cpu")
        with pytest.raises(ValueError):
            s.solve(store_solutions=False)
    with pytest.raises(ValueError):
        CRBESolver(tapt.Domain(), tapt.Problem(), md, preconditioner="nope",
                   device="cpu")
