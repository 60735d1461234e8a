"""The port's block-sharded canvas solver (kernel B9's plain version,
airpollution_tpu_torch/parallel/hbm_shard.build_canvas_hbm_halo_solver)
on the CPU, float64: variable winds, Robin walls with and without flux
data, obstacles and sources.

Held against the JAX sharded builder (one case, interpret mode on the
8-device CPU mesh, within 1e-10), the JAX serial loop (models/crbe.
run_time_loop, jitted as CRBESolver's ELL route runs it: the same ELL
interval estimate, within 1e-10), and the port's whole-canvas fused solve
(B4's plain version, to equality). The port-only cases run 40 points per
axis on 3 blocks, so real rows cross the block boundaries.
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.parallel.device_mesh import make_mesh as j_make_mesh
from airpollution_tpu.parallel.hbm_shard import (
    build_canvas_hbm_halo_solver as j_build_canvas_hbm_halo_solver,
)

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.models.crbe import CRBESolver, obstacle_masks
from airpollution_tpu_torch.parallel import (build_canvas_hbm_halo_solver,
                                             make_mesh)

from torch_port_helpers import mesh_pair, port_operators, rel_diff
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.kernels

K = 10


def _cpu_mesh(n_blocks):
    return make_mesh({"mp": n_blocks}, device="cpu")


def _md(ms, nt, domain):
    return tapt.MeshData(tapt.create_mesh(ms, 20.0), domain, nt=nt,
                         dtype=torch.float64, device="cpu")


def _check(problem, domain, nt, order=1, ext=False, snap=None, ms=40,
           n_blocks=3):
    """Block solve against the whole-canvas solve, to equality; returns
    (block result, whole-canvas solver)."""
    md = _md(ms, nt, domain)
    s = CRBESolver(domain, problem, md, matvec_impl="fused_hbm",
                   time_scheme_order=order, extrapolate_warm_start=ext,
                   solver_method="chebyshev", chebyshev_iters=K,
                   snapshot_every=snap, device="cpu")
    want = s.solve(store_solutions=snap is not None)
    got = build_canvas_hbm_halo_solver(
        _cpu_mesh(n_blocks), md, problem, s.dt, order=order, iters=K,
        extrapolate=ext, snapshot_every=snap)(s._require_ops(),
                                              s.set_initial_condition())
    assert got.shape == want.shape
    assert rel_diff(got, want) <= 1e-12, rel_diff(got, want)
    return got, s


@functools.lru_cache(maxsize=None)
def _jax_case():
    jmd, tmd = mesh_pair(12, nt=13)
    problem = japt.RotatingPlumeProblem(omega=0.03, D=0.3)
    dt = 10.0 / 12
    jops = j_crbe.assemble(jmd, problem, dt, 1, "correct")
    return jmd, tmd, problem, jops, problem.initial_condition_fn(
        jmd.midpoints), dt


def test_canvas_block_solver_matches_jax():
    """A rotating wind on 8 blocks, BE: the JAX sharded builder and the
    JAX serial loop on the same operator and initial state."""
    jmd, tmd, problem, jops, u0, dt = _jax_case()
    want = np.asarray(j_build_canvas_hbm_halo_solver(
        j_make_mesh({"mp": 8}), jmd, problem, dt, iters=K, stripe_rows=8,
        interpret=True)(jops, u0))
    serial = jax.jit(functools.partial(
        j_crbe.run_time_loop, mesh_data=jmd, problem=problem, dt=dt, order=1,
        tol=1e-7, maxiter=200, store_solutions=False, solver="chebyshev",
        chebyshev_iters=K))(jops, u0)[0]
    got = build_canvas_hbm_halo_solver(
        _cpu_mesh(8), tmd, tapt.RotatingPlumeProblem(omega=0.03, D=0.3), dt,
        iters=K)(port_operators(jops), torch.tensor(np.asarray(u0)))
    assert got.shape == want.shape
    assert rel_diff(got, want) <= 1e-10
    assert rel_diff(got, np.asarray(serial)) <= 1e-10


@pytest.mark.parametrize("order,ext", [(1, False), (1, True), (2, True)],
                         ids=["be", "be-ext", "cn-ext"])
def test_canvas_block_solver_variable_wind(order, ext):
    _check(tapt.RotatingPlumeProblem(omega=0.03, D=0.3), tapt.Domain(), 13,
           order, ext)


def _pulse(**attrs):
    p = tapt.SquarePulseProblem(v=(0.3, -0.2), D=0.8, lo=5.0, hi=19.0)
    for name, value in attrs.items():
        setattr(p, name, value)
    return p


def test_canvas_block_solver_robin_walls():
    """Robin walls on all four sides (global rectangle bounds, the first
    and last blocks' wall rows), CN, strided rows; the walls remove mass."""
    p = _pulse(robin_sides={"bottom": 0.4, "top": 0.1, "left": 0.2,
                            "right": 0.3})
    traj, s = _check(p, tapt.Domain(T=1.0), 9, order=2, snap=4)
    masses = traj @ s._require_ops().mass_diag
    assert float(masses[-1]) < float(masses[0])


def test_canvas_block_solver_obstacles():
    """An obstacle and a deposition floor: the carved initial state and
    every strided row are exactly 0 on the dead DOFs."""
    p = _pulse(obstacles=((-5.0, -1.0, -3.0, 3.0),),
               robin_sides={"bottom": 0.4})
    traj, s = _check(p, tapt.Domain(T=1.0), 9, order=2, snap=4)
    _, dead = obstacle_masks(s.mesh_data, p)
    assert bool(dead.any())
    assert float(traj[:, dead].abs().max()) == 0.0


class _GFlux(tapt.SquarePulseProblem):
    """Inhomogeneous Robin flux data (tests/test_hbm_shard.py's)."""

    robin_sides = {"bottom": 0.4, "top": 0.1, "left": 0.2}

    def robin_g_xy(self, x, y, t, side):
        if side == "bottom":
            return 0.3 * (1.0 + torch.sin(0.2 * x)) * (1.0 + 0.5 * t) + 0 * y
        if side == "left":
            return 0.2 * torch.exp(-(((y - 5.0) / 8.0) ** 2)) + 0 * x
        return torch.zeros_like(x + y)


def test_canvas_block_solver_robin_flux_load():
    """The robin_g_xy flux load on each block's part of the wall lines;
    the inflow adds mass against the pure-deposition twin."""
    kw = dict(v=(0.3, -0.2), D=0.8, lo=5.0, hi=19.0)
    traj, s = _check(_GFlux(**kw), tapt.Domain(T=1.0), 9, order=2, snap=4)
    twin, _ = _check(_pulse(robin_sides=dict(_GFlux.robin_sides)),
                     tapt.Domain(T=1.0), 9, order=2, snap=4)
    m = s._require_ops().mass_diag
    assert float(traj[-1] @ m) > float(twin[-1] @ m) + 1e-3
    _check(_GFlux(**kw), tapt.Domain(T=1.0), 9, order=1, ext=True)


class _RotatingEmitter(tapt.RotatingPlumeProblem):
    """A rotating wind with a steady emitter."""

    zero_source = False
    steady_source = True

    def source_term(self, xyt):
        return self.source_xy(xyt[..., 0], xyt[..., 1], xyt[..., 2])

    def source_xy(self, x, y, t):
        return 2.0 * torch.exp(-((x + 3.0) ** 2 + (y - 2.0) ** 2) / 8.0)


def test_canvas_block_solver_sourced_variable_wind():
    got, _ = _check(_RotatingEmitter(omega=0.03, D=0.3), tapt.Domain(), 13,
                    ext=True)
    plain, _ = _check(tapt.RotatingPlumeProblem(omega=0.03, D=0.3),
                      tapt.Domain(), 13, ext=True)
    assert rel_diff(got, plain) > 1e-2  # the emitter acts


def test_canvas_block_solver_steps_from_t0():
    """``n_steps`` steps from time ``t0`` (the solve the JAX package's
    chunk driver makes): two chunks of 4 BE steps, the second from the
    first's lifted state (its lift rides masked rows only), equal the
    whole-canvas solve of 8 steps, time-dependent flux load included."""
    domain = tapt.Domain(T=1.0)
    p = _GFlux(v=(0.3, -0.2), D=0.8, lo=5.0, hi=19.0)
    md = _md(40, 9, domain)
    s = CRBESolver(domain, p, md, matvec_impl="fused_hbm",
                   solver_method="chebyshev", chebyshev_iters=K,
                   device="cpu")
    want = s.solve(store_solutions=False)
    solver = build_canvas_hbm_halo_solver(_cpu_mesh(3), md, p, s.dt,
                                          iters=K, n_steps=4)
    ops = s._require_ops()
    mid = solver(ops, s.set_initial_condition())
    got = solver(ops, mid[0], t0=4 * s.dt)
    assert rel_diff(got, want) <= 1e-12


def test_canvas_guards():
    domain = tapt.Domain(T=1.0)
    md = _md(12, 9, domain)
    mesh = _cpu_mesh(8)

    class _G(tapt.SquarePulseProblem):
        robin_sides = {"bottom": 0.1}

        def robin_g(self, xy, t, side):
            return torch.ones(xy.shape[0], dtype=xy.dtype)

    with pytest.raises(ValueError, match="robin_g"):
        build_canvas_hbm_halo_solver(mesh, md, _G(), 0.1)
    solver = build_canvas_hbm_halo_solver(mesh, md, _pulse(), 0.1)
    u0 = torch.zeros(md.number_of_segments, dtype=torch.float64)
    with pytest.raises(ValueError, match="GlobalOperators"):
        solver(None, u0)
    # With coeff_time the stack comes from assemble_canvas, not from ops.
    from airpollution_tpu_torch.models.crbe import assemble

    ops = assemble(md, _pulse(), 0.1, 1)
    u0 = _pulse().initial_condition_fn(md.midpoints)
    assert rel_diff(solver(None, u0, coeff_time=0.5),
                    solver(ops, u0).numpy()) <= 1e-8
    with pytest.raises(ValueError, match="divisor"):
        build_canvas_hbm_halo_solver(mesh, md, _pulse(), 0.1,
                                     snapshot_every=3)
