"""The port's block-sharded multispecies solver (kernel B10's plain
version, airpollution_tpu_torch/parallel/hbm_shard.
build_multispecies_hbm_halo_solver) on the CPU, float64: Strang chemistry
with both half-mixes in the step, per-species emissions, Robin alpha walls
and obstacles.

Held against the JAX sharded builder and the JAX serial Strang loop
(models/multispecies.run_multispecies_loop, jitted as the solver jits it)
on one case (interpret mode on the 8-device CPU mesh, within 1e-10), and
against the port's whole-canvas fused solve (B6's plain version, to
equality) on 40 points per axis and 3 blocks, so that real rows cross the
block boundaries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.models import multispecies as j_ms
from airpollution_tpu.parallel.device_mesh import make_mesh as j_make_mesh
from airpollution_tpu.parallel.hbm_shard import (
    build_multispecies_hbm_halo_solver as j_build_multispecies,
)

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models.crbe import obstacle_masks
from airpollution_tpu_torch.models.multispecies import MultiSpeciesSolver
from airpollution_tpu_torch.parallel import (
    build_multispecies_hbm_halo_solver,
    make_mesh,
)

from torch_port_helpers import port_operators, rel_diff
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.kernels

K = 10
R = np.array([[0.3, 0.0], [-0.3, 0.1]])


def _chain(pkg, walls=True):
    """tests/test_hbm_shard.py's sourced chain: an emitter decaying into a
    second species, with a deposition floor and a building."""
    src = pkg.GaussianSourceProblem(q=2.0, xs=-6.0, ys=2.0, sigma_s=2.0,
                                    v=(0.4, -0.1), D=0.6)
    other = pkg.Problem(v=(0.4, -0.1), D=0.6, sigma=1.5)
    if walls:
        for sp in (src, other):
            sp.robin_sides = {"bottom": 0.3}
            sp.obstacles = ((2.0, 6.0, -2.0, 2.0),)
    return pkg.MultiSpeciesProblem((src, other), R)


def test_multispecies_block_solver_matches_jax():
    """CN on 8 blocks at 12^2, nt=9, final state: the JAX sharded builder
    and the JAX serial Strang loop on the same assembled operator."""
    domain = japt.Domain(T=1.0)
    jmd = japt.MeshData(japt.create_mesh(12, 20.0), domain, nt=9,
                        dtype=jnp.float64)
    jp = _chain(japt)
    dt = 1.0 / 8
    jops = j_crbe.assemble(jmd, jp.species[0], dt, 2, "correct")
    C0 = jp.initial_conditions(jmd.midpoints)
    want = np.asarray(j_build_multispecies(
        j_make_mesh({"mp": 8}), jmd, jp, dt, order=2, iters=K, stripe_rows=8,
        interpret=True)(jops, C0))
    serial = np.asarray(jax.jit(functools.partial(
        j_ms.run_multispecies_loop, mesh_data=jmd, problem=jp, dt=dt,
        order=2, tol=1e-7, maxiter=200, store_solutions=False,
        solver="chebyshev", chebyshev_iters=K))(jops, C0)[0])
    tmd = tapt.MeshData(tapt.create_mesh(12, 20.0), tapt.Domain(T=1.0),
                        nt=9, dtype=torch.float64, device="cpu")
    got = build_multispecies_hbm_halo_solver(
        make_mesh({"mp": 8}, device="cpu"), tmd, _chain(tapt), dt, order=2,
        iters=K)(port_operators(jops), torch.tensor(np.asarray(C0)))
    assert got.shape == want.shape == (1, 2, tmd.number_of_segments)
    assert rel_diff(got, want) <= 1e-10
    assert rel_diff(got, serial) <= 1e-10


@pytest.mark.parametrize("walls", [True, False],
                         ids=["walls-obstacle", "open"])
@pytest.mark.parametrize("order", [1, 2], ids=["be", "cn"])
def test_multispecies_block_solver_matches_whole_canvas(order, walls):
    """Strided rows and the final state on 3 blocks against the
    whole-canvas Strang solve on B6's plain version; the building stays
    exactly 0 in every species and row."""
    domain = tapt.Domain(T=1.0)
    md = tapt.MeshData(tapt.create_mesh(40, 20.0), domain, nt=9,
                       dtype=torch.float64, device="cpu")
    problem = _chain(tapt, walls)
    for snap in (4, None):
        s = MultiSpeciesSolver(domain, problem, md, time_scheme_order=order,
                               matvec_impl="fused_hbm", splitting="strang",
                               solver_method="chebyshev", chebyshev_iters=K,
                               snapshot_every=snap, device="cpu")
        want = s.solve(store_solutions=snap is not None)
        got = build_multispecies_hbm_halo_solver(
            make_mesh({"mp": 3}, device="cpu"), md, problem, s.dt,
            order=order, iters=K, snapshot_every=snap)(
            s._require_ops(), s.set_initial_condition())
        assert got.shape == want.shape
        assert rel_diff(got, want) <= 1e-12, rel_diff(got, want)
        if walls:
            _, dead = obstacle_masks(md, problem.species[0])
            assert float(got[:, :, dead].abs().max()) == 0.0


def test_multispecies_guards():
    domain = tapt.Domain(T=1.0)
    md = tapt.MeshData(tapt.create_mesh(12, 20.0), domain, nt=9,
                       dtype=torch.float64, device="cpu")
    mesh = make_mesh({"mp": 8}, device="cpu")
    split = tapt.MultiSpeciesProblem(
        (tapt.Problem(v=(1.0, 0.0)), tapt.Problem(v=(0.0, 1.0))), R)
    with pytest.raises(ValueError, match="shared"):
        build_multispecies_hbm_halo_solver(mesh, md, split, 0.1)
    solver = build_multispecies_hbm_halo_solver(mesh, md, _chain(tapt), 0.1)
    with pytest.raises(ValueError, match="GlobalOperators"):
        solver(None, torch.zeros((2, md.number_of_segments)))
    with pytest.raises(ValueError, match="source_quadrature"):
        build_multispecies_hbm_halo_solver(mesh, md, _chain(tapt), 0.1,
                                           source_quadrature="bogus")
