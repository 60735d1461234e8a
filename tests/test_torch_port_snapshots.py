"""Strided snapshots (``snapshot_every``) and sourced fused routes of the
port's CRBESolver against the JAX CRBESolver, float64, on one operator and
one Chebyshev interval: the scan paths ('stencil', 'ell') and the fused
kernels B1 (both variants), B2 and B4, mirroring
tests/test_pallas_solver.py:230, tests/test_pallas_hbm.py:187-221, 397,
498 and tests/test_robin.py:426, 515, 545; a Robin flux wall that an
obstacle touches, against the JAX scan; and MultiSpeciesSolver's commute
route with snapshots.

Tolerances: 1e-10 relative max-norm (the same arithmetic in another
order); 1e-9 where BiCGStab iterates (its rounding is amplified by the
recurrence; the JAX kernel sums its dot products in the state dtype, the
port in double).
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu import problems as j_problems
from airpollution_tpu.models.crbe import CRBESolver as JaxSolver
from airpollution_tpu.models.multispecies import (
    MultiSpeciesSolver as JaxMultiSpecies,
)

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import problems as t_problems
from airpollution_tpu_torch.mesh.data import boundary_side_masks
from airpollution_tpu_torch.models import crbe as t_crbe
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.models.multispecies import MultiSpeciesSolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver

from torch_port_helpers import port_operators, rel_diff

TOL = 1e-10
BICGSTAB_TOL = 1e-9
T_END = 1.0
WALLS = {"bottom": 0.05, "top": 0.0}


def _mesh_pair(ms, nt):
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(T=T_END),
                        nt=nt, dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(T=T_END),
                        nt=nt, dtype=torch.float64, device="cpu")
    return jmd, tmd


def _ramp(mod):
    """tests/test_pallas_solver.py:233's ramp source, in one package."""
    xp = jnp if mod is j_problems else torch

    class RampSource(mod.Problem):
        zero_source = False
        steady_source = False

        def source_term(self, xyt):
            x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
            return t * xp.exp(-0.05 * ((x - 2.0) ** 2 + y ** 2))

        def source_xy(self, x, y, t):
            return t * xp.exp(-0.05 * ((x - 2.0) ** 2 + y ** 2))

    return RampSource()


def _gaussian(mod):
    return mod.GaussianSourceProblem(q=80.0, xs=-3.0, ys=2.0, sigma_s=5.0)


def _flux_walls(mod, obstacles=None):
    """A Gaussian emitter behind a deposition floor with re-emission
    (robin_g_xy, varying in x and t) and a no-flux lid."""
    class FluxWalls(mod.GaussianSourceProblem):
        robin_sides = WALLS

        def robin_g_xy(self, x, y, t, side):
            g0 = 0.004 if side == "bottom" else 0.0
            return g0 * (1.0 + 0.5 * t) * (1.0 + 0.02 * x) + 0.0 * y

    FluxWalls.obstacles = obstacles
    return FluxWalls(q=20.0, xs=-3.0, ys=-14.0, sigma_s=3.0)


PROBLEMS = {"ramp": _ramp, "gaussian": _gaussian, "walls": _flux_walls}


def _solver_pair(pname, ms, nt, **kw):
    """A JAX and a port CRBESolver of one configuration; the port's takes
    the JAX assembly and its Chebyshev interval (interop)."""
    jmd, tmd = _mesh_pair(ms, nt)
    js = JaxSolver(japt.Domain(T=T_END), PROBLEMS[pname](j_problems), jmd,
                   **kw)
    js.build_global_matrices()
    if kw.get("solver_method") == "chebyshev":
        js._check_chebyshev_applicable(js._ops)
    bounds = getattr(js, "_cheb_bounds", None)
    ts = CRBESolver(tapt.Domain(T=T_END), PROBLEMS[pname](t_problems), tmd,
                    cheb_bounds=bounds, device="cpu", **kw)
    ts.set_operators(port_operators(js._ops))
    return js, ts


@pytest.mark.parametrize("impl,method,order,pname,kernel", [
    ("stencil", "bicgstab", 1, "gaussian", None),
    ("ell", "bicgstab", 2, "ramp", None),
    ("stencil", "chebyshev", 2, "walls", None),
    ("fused", "chebyshev", 1, "ramp", "B1"),
    ("fused", "chebyshev", 2, "gaussian", "B1"),
    ("fused", "bicgstab", 1, "ramp", "B1-BiCGStab"),
    ("fused", "bicgstab", 2, "gaussian", "B1-BiCGStab"),
    ("fused_hbm", "chebyshev", 1, "gaussian", "B2"),
    ("fused_hbm", "chebyshev", 2, "ramp", "B2"),
    ("fused_hbm", "chebyshev", 1, "walls", "B4"),
    ("fused_hbm", "chebyshev", 2, "walls", "B4"),
], ids=["stencil", "ell", "stencil-walls", "B1-BE", "B1-CN",
        "B1-BiCGStab-BE", "B1-BiCGStab-CN", "B2-BE", "B2-CN", "B4-BE",
        "B4-CN"])
def test_strided_rows_match_jax(impl, method, order, pname, kernel):
    """Every snapshot row of a sourced solve (ms=17, nt=9, a row every 4
    steps): row 0 the full initial condition, the chunks restarting the
    extrapolated warm start and their loads at t0 = 4 dt j, as in JAX."""
    js, ts = _solver_pair(pname, 17, 9, matvec_impl=impl,
                          solver_method=method, time_scheme_order=order,
                          chebyshev_iters=10, fused_iters=5,
                          extrapolate_warm_start=True, snapshot_every=4,
                          solver_tol=1e-12, solver_maxiter=400)
    want = js.solve(store_solutions=True)
    got = ts.solve(store_solutions=True)
    assert got.shape == want.shape == (3, ts.mesh_data.number_of_segments)
    assert getattr(ts, "fused_kernel", None) == kernel
    assert float(np.abs(np.asarray(want[-1])).max()) > 1e-3
    bicgstab = method == "bicgstab"
    assert rel_diff(got, want) <= (BICGSTAB_TOL if bicgstab else TOL)
    assert all(k.launches == 0 for k in (
        fused_solver.LOAD_KERNEL, fused_solver.BICGSTAB_KERNEL,
        fused_hbm.LOAD_KERNEL, fused_hbm.CANVAS_KERNEL))


@pytest.mark.parametrize("impl,kernel", [
    ("fused", "B1"), ("fused_hbm", "B2"), ("fused_hbm-canvas", "B4")])
def test_sourced_final_state_matches_jax(impl, kernel):
    """The final state of a sourced solve (BE, extrapolated, ms=17, 11
    steps), one launch (B1) or one per step (B2, B4)."""
    kw = dict(matvec_impl=impl.split("-")[0], solver_method="chebyshev",
              chebyshev_iters=10, extrapolate_warm_start=True)
    if impl.endswith("canvas"):
        kw["fused_operator"] = "canvas"
    js, ts = _solver_pair("gaussian", 17, 12, **kw)
    want = js.solve(store_solutions=False)
    got = ts.solve(store_solutions=False)
    assert ts.fused_kernel == kernel
    assert rel_diff(got, want) <= TOL


def test_strided_errors_match_jax():
    """snapshot_every must divide nt-1 on every path; without it the fused
    paths return the final state only; the last row of a strided solve
    without extrapolation is the final state bit for bit."""
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(T=T_END),
                       nt=9, dtype=torch.float64, device="cpu")
    for impl in ("fused", "fused_hbm", "stencil", "ell"):
        s = CRBESolver(tapt.Domain(T=T_END), tapt.Problem(), md,
                       matvec_impl=impl, solver_method="chebyshev",
                       snapshot_every=3, device="cpu")
        with pytest.raises(ValueError, match="divide nt-1"):
            s.solve(store_solutions=True)
    s = CRBESolver(tapt.Domain(T=T_END), tapt.Problem(), md,
                   matvec_impl="fused", solver_method="chebyshev",
                   device="cpu")
    with pytest.raises(ValueError, match="final state only"):
        s.solve(store_solutions=True)
    for impl in ("fused", "fused_hbm"):
        s = CRBESolver(tapt.Domain(T=T_END), _gaussian(t_problems), md,
                       matvec_impl=impl, solver_method="chebyshev",
                       snapshot_every=4, device="cpu")
        rows = s.solve(store_solutions=True)
        assert torch.equal(rows[-1], s.solve(store_solutions=False)[0])
    scan = CRBESolver(tapt.Domain(T=T_END), tapt.Problem(), md,
                      matvec_impl="stencil", device="cpu")
    full = scan.solve(store_solutions=True)
    strided = CRBESolver(tapt.Domain(T=T_END), tapt.Problem(), md,
                         matvec_impl="stencil", snapshot_every=4,
                         device="cpu").solve(store_solutions=True)
    assert torch.equal(strided, full[::4])


def test_flux_wall_touched_by_an_obstacle_matches_jax_scan():
    """A solid block standing on the Robin floor: the flux load is zero on
    the dead wall DOFs, as the JAX scan path masks it, so the fused B4
    state stays exactly 0 there and agrees with the converged JAX scan
    (Chebyshev-30 per step against BiCGStab to 1e-13; the tolerance is
    the fixed-k solve's residual, not rounding)."""
    block = ((-4.0, 4.0, -20.0, -12.0),)
    jmd, tmd = _mesh_pair(17, 9)
    jp = _flux_walls(j_problems, block)
    js = JaxSolver(japt.Domain(T=T_END), jp, jmd, matvec_impl="stencil",
                   solver_tol=1e-13, solver_maxiter=400,
                   time_scheme_order=2)
    want = js.solve(store_solutions=False)
    tp = _flux_walls(t_problems, block)
    ts = CRBESolver(tapt.Domain(T=T_END), tp, tmd, matvec_impl="fused_hbm",
                    solver_method="chebyshev", chebyshev_iters=30,
                    time_scheme_order=2, device="cpu")
    ts.set_operators(port_operators(js._ops))
    got = ts.solve(store_solutions=False)
    dead = t_crbe.obstacle_masks(tmd, tp)[1]
    bottom = boundary_side_masks(tmd)["bottom"]
    assert ts.fused_kernel == "B4" and ts._robin_g_fused
    assert bool((dead & bottom).any())
    assert float(got[0][dead].abs().max()) == 0.0
    assert rel_diff(got, want) <= 1e-7


@pytest.mark.parametrize("impl", ["stencil", "fused_hbm"])
def test_commute_route_snapshots_match_jax(impl):
    """MultiSpeciesSolver's commute route (no sources, shared transport)
    with snapshot_every: K CRBESolver strided solves, then the expm(-R t)
    mixture of each row."""
    R = [[0.3, -0.1], [-0.2, 0.4]]
    jms = j_problems.MultiSpeciesProblem(
        [japt.Problem(sigma=1.0), japt.Problem(sigma=2.0)], np.array(R))
    tms = t_problems.MultiSpeciesProblem(
        [tapt.Problem(sigma=1.0), tapt.Problem(sigma=2.0)], R)
    jmd, tmd = _mesh_pair(13, 9)
    kw = dict(matvec_impl=impl, solver_method="chebyshev",
              chebyshev_iters=10, time_scheme_order=2, snapshot_every=4)
    js = JaxMultiSpecies(japt.Domain(T=T_END), jms, jmd, **kw)
    want = js.solve(store_solutions=True)
    ts = MultiSpeciesSolver(tapt.Domain(T=T_END), tms, tmd, device="cpu",
                            **kw)
    ts.set_operators(port_operators(js._transport_solvers[0]._ops))
    got = ts.solve(store_solutions=True)
    assert js.splitting == ts.splitting == "commute"
    assert got.shape == want.shape == (3, 2, tmd.number_of_segments)
    assert rel_diff(got, want) <= TOL
