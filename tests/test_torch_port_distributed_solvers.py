"""The port's sharded solvers on 3 gloo ranks (parallel/stencil_shard,
fem_shard, sweep; ensemble_forecast and make_plume_dataset with a 'trial'
mesh) against the JAX package's sharded functions at the same shard count
on the fake CPU devices of tests/conftest.py, float64.

One ``launch.spawn`` (a module-scoped fixture, deadline 120 s) runs every
case on the ranks (tests/torch_port_distributed_ranks.solver_cases); each
rank writes its results, every rank's must be the same, and the JAX
references run here. Tolerances, max|port - JAX| / max|JAX|: 1e-12 where
only halos move (Chebyshev), 1e-9 for the psum BiCGStab, 1e-10 for the
row-sharded BiCGStab solve and the sweep, 1e-12 for the members."""

import numpy as np
import pytest

import jax.numpy as jnp

import airpollution_tpu as japt
from airpollution_tpu.diagnostics.ensemble import ensemble_forecast
from airpollution_tpu.models import fno as jfno
from airpollution_tpu.models.crbe import CRBESolver
from airpollution_tpu.parallel import (build_halo_solver, build_sharded_solver,
                                       crbe_diffusion_sweep, make_mesh,
                                       pad_operators)

from airpollution_tpu_torch.parallel import launch

import torch_port_distributed_ranks as ranks
from torch_port_helpers import rel_diff

N_RANKS = 3


class _SourcedProblem(japt.Problem):
    """tests/test_parallel.py's sourced problem."""

    zero_source = False

    def source_term(self, xyt):
        x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
        return 0.05 * jnp.exp(-(x ** 2 + y ** 2) / 8.0) * jnp.cos(0.3 * t)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    """Case name -> the ranks' result (checked equal on every rank)."""
    out = tmp_path_factory.mktemp("solver_ranks")
    launch.spawn(ranks.solver_cases, N_RANKS, backend="gloo",
                 args=(str(out),), timeout_s=120)
    results = {}
    for f in sorted(out.glob("rank0_*.npy")):
        case = f.name[len("rank0_"):-len(".npy")]
        first = np.load(f)
        for r in range(1, N_RANKS):
            np.testing.assert_array_equal(
                np.load(out / f"rank{r}_{case}.npy"), first)
        results[case] = first
    return results


def _md(ms, nt, T=None):
    dom = japt.Domain() if T is None else japt.Domain(T=T)
    return japt.MeshData(japt.create_mesh(ms, 20.0), dom, nt=nt,
                         dtype=jnp.float64)


def _jax_halo(problem, order, iters, nt, **kw):
    md = _md(12, nt)
    serial = CRBESolver(japt.Domain(), problem, md, matvec_impl="uniform",
                        time_scheme_order=order,
                        solver_method=kw.get("solver_method", "chebyshev"),
                        chebyshev_iters=iters)
    solve = build_halo_solver(make_mesh({"mp": N_RANKS}), md, problem,
                              serial.dt, order=order, iters=iters, **kw)
    return np.asarray(solve(serial._require_ops(),
                            serial.set_initial_condition()))


@pytest.mark.parametrize("order", [1, 2], ids=["be", "cn"])
def test_halo_chebyshev_matches_jax(got, order):
    want = _jax_halo(japt.Problem(), order, 14, 16)
    assert got[f"halo_cheb_{order}"].shape == want.shape
    assert rel_diff(got[f"halo_cheb_{order}"], want) <= 1e-12


def test_halo_psum_bicgstab_matches_jax(got):
    want = _jax_halo(_SourcedProblem(), 2, 8, 9, solver_method="bicgstab",
                     tol=1e-10, maxiter=300)
    assert rel_diff(got["halo_bicgstab"], want) <= 1e-9


def test_halo_sourced_strided_matches_jax(got):
    want = _jax_halo(_SourcedProblem(), 1, 14, 16, snapshot_every=5)
    assert got["halo_strided"].shape == want.shape == (4, want.shape[1])
    assert rel_diff(got["halo_strided"], want) <= 1e-12


def test_pad_operators_and_row_sharded_solve_match_jax(got):
    md = _md(8, 16)
    solver = CRBESolver(japt.Domain(), japt.Problem(), md, solver_tol=1e-11)
    ops, n_pad = pad_operators(solver._require_ops(), md.number_of_segments,
                               N_RANKS)
    assert got["pad"].tolist() == [n_pad, ops.system.vals.shape[0]]
    assert rel_diff(got["pad_system"], ops.system.vals) <= 1e-14
    sharded = build_sharded_solver(make_mesh({"mp": N_RANKS}), md,
                                   japt.Problem(), solver.dt, tol=1e-11)
    want = np.asarray(sharded(ops, solver.set_initial_condition()))
    assert got["fem"].shape == want.shape
    assert rel_diff(got["fem"], want) <= 1e-10


def test_diffusion_sweep_matches_jax(got):
    out = crbe_diffusion_sweep(_md(8, 16), japt.Domain(), [0.01, 0.1, 1.0],
                               tol=1e-11, mesh=make_mesh({"trial": N_RANKS}))
    for i, k in enumerate(("rel_l2_error", "l2_error", "max_error")):
        np.testing.assert_allclose(got["sweep"][i], np.asarray(out[k]),
                                   rtol=1e-10, atol=0)


def test_sharded_ensemble_matches_jax(got):
    """Four members padded to six over three ranks."""
    md = _md(8, 9, T=1.0)
    members = [japt.ShiftedPlumeProblem(v=(0.5 + 0.1 * k, -0.2 * k),
                                        D=0.1 + 0.05 * k, center=(k, -k))
               for k in range(4)]
    want = ensemble_forecast(md, md.domain, members, order=2,
                             thresholds=(0.01, 0.05), tol=1e-11,
                             mesh=make_mesh({"trial": N_RANKS}))
    for k in ("members", "mean", "std"):
        assert got[f"ensemble_{k}"].shape == want[k].shape
        assert rel_diff(got[f"ensemble_{k}"], want[k]) <= 1e-12
    # JAX takes the member fraction's mean in float32 (ROADMAP.md C).
    np.testing.assert_allclose(got["ensemble_exceedance"],
                               np.asarray(want["exceedance"]), atol=1e-7)


def test_sharded_plume_dataset_matches_jax(got, monkeypatch):
    Ds, vs = np.array([0.1, 0.2, 0.3]), np.array([[0.5, 0.2], [-0.3, 0.4],
                                                   [0.1, -0.6]])
    probs = [japt.ShiftedPlumeProblem(v=tuple(vs[i]), D=float(Ds[i]),
                                      sigma=1.0 + 0.2 * i, center=(i, -i))
             for i in range(3)]
    monkeypatch.setattr(jfno, "_sample_plume_problems",
                        lambda *a: (probs, Ds, vs))
    md = _md(9, 9, T=1.0)
    X, Y, _ = jfno.make_plume_dataset(md, md.domain, None, 3, tol=1e-11,
                                      mesh=make_mesh({"trial": N_RANKS}))
    assert got["plume_X"].shape == X.shape and got["plume_Y"].shape == Y.shape
    assert rel_diff(got["plume_X"], X) <= 1e-12
    assert rel_diff(got["plume_Y"], Y) <= 1e-12
