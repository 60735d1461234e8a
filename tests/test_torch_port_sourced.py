"""Sourced, Robin-flux and BiCGStab fused solves of the port against the
JAX package, float64: the plain versions of kernel B1 (both variants, with
a steady and a time-dependent source load), B2 (with both loads) and B4
(with a source and an inhomogeneous Robin flux load) against the Pallas
kernels in interpret mode on one operator and one interval; the routing
rule with a steady source; the reroute of a divergent Chebyshev
configuration to B1's BiCGStab variant; and the production scenario
(``scripts/torch_port_production_scenario.py`` against
``scripts/production_scenario.py``) end to end, snapshot rows and budget.

Tolerances: 1e-10 relative max-norm where both sides run the same
arithmetic in another order; 1e-9 for BiCGStab, whose iterates keep
iterating at rounding level (the JAX kernel sums its dot products in the
state dtype, the port in double), so rounding differences are amplified
by the recurrence.
"""

import functools
import importlib.util
import types
import warnings
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu import problems as j_problems
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.models.crbe import CRBESolver as JaxSolver
from airpollution_tpu.ops import pallas_hbm, pallas_solver
from airpollution_tpu.ops import stencil as j_stencil
from airpollution_tpu.ops import uniform as j_uniform

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import interop
from airpollution_tpu_torch import problems as t_problems
from airpollution_tpu_torch.mesh.data import structured_grid
from airpollution_tpu_torch.models import crbe as t_crbe
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver, loads
from airpollution_tpu_torch.ops import stencil as t_stencil
from airpollution_tpu_torch.ops import uniform as t_uniform

from torch_port_helpers import mesh_pair, port_operators, rel_diff

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-10
BICGSTAB_TOL = 1e-9
MS, N_STEPS, K = 17, 11, 4
T_END = 1.0
DT = T_END / N_STEPS
T0 = 0.25  # a solve that starts mid-trajectory, as a snapshot chunk does
BOUNDS = (0.5, 1.6)  # one Chebyshev interval fed to both packages
WALLS = {"bottom": 0.05, "top": 0.0, "left": 0.02}


def _ramp(mod):
    """tests/test_pallas_hbm.py's time-dependent source, in one package."""
    xp = jnp if mod is j_problems else torch

    class Ramp(mod.Problem):
        zero_source = False
        steady_source = False

        def source_term(self, xyt):
            x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
            return (0.2 + 0.1 * t) * xp.exp(-0.03 * (x ** 2 + y ** 2))

        def source_xy(self, x, y, t):
            return (0.2 + 0.1 * t) * xp.exp(-0.03 * (x ** 2 + y ** 2))

    return Ramp(sigma=1.0)


def _source(mod, kind):
    if kind == "ramp":
        return _ramp(mod)
    return mod.GaussianSourceProblem(q=30.0, xs=-3.0, ys=2.0, sigma_s=4.0)


def _flux(_mod):
    """An inhomogeneous Robin flux g(x, y, t) on the walls of WALLS,
    varying along the wall and in time (the same closed form in both
    packages: plain arithmetic on their arrays)."""
    def g(x, y, t, side):
        base = {"bottom": 0.01, "top": 0.02, "left": 0.015}[side]
        return base * (1.0 + t) * (1.0 + 0.05 * x + 0.02 * y)

    return g


def _grid(jmd):
    pts = np.asarray(jmd.points)
    xmin, ymin = float(pts[:, 0].min()), float(pts[:, 1].min())
    return xmin, ymin, (float(pts[:, 0].max()) - xmin) / (jmd.structured_n - 1)


def _uniform_inputs(order):
    """One uniform operator and initial family state in both packages."""
    jmd, tmd = mesh_pair(MS, nt=N_STEPS + 1)
    ops = j_crbe.assemble(jmd, japt.Problem(), DT, order, "reference")
    pattern = j_stencil.get_pattern(jmd)
    jspec = j_uniform.build_uniform_spec(pattern)
    tspec = t_uniform.build_uniform_spec(t_stencil.get_pattern(tmd))
    u0 = japt.Problem().initial_condition_fn(jmd.midpoints)[
        jnp.asarray(pattern.perm)]
    j_args = (
        j_uniform.extract_constants(jspec, ops.system.vals),
        j_uniform.family_constants(jspec, ops.mass_diag),
        1.0 / j_uniform.family_constants(jspec, ops.system_diag),
        u0,
    )
    t_args = tuple(torch.tensor(np.asarray(a)) for a in j_args)
    assert structured_grid(tmd) == pytest.approx(_grid(jmd), rel=1e-15)
    return jspec, j_args, tspec, t_args, _grid(jmd)


def _src_kw(kind, quadrature, grid, mod):
    return dict(source_fn=_source(mod, kind).source_xy,
                source_steady=kind == "steady",
                source_lumped=quadrature == "mass_lumped", grid=grid,
                t0=T0, dt=DT)


@pytest.mark.parametrize("method", ["chebyshev", "bicgstab"])
@pytest.mark.parametrize("kind,quadrature", [
    ("steady", "mass_lumped"), ("ramp", "mass_lumped"),
    ("steady", "reference"), ("ramp", "reference")])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b1_with_loads_matches_pallas_solver(monkeypatch, order, kind,
                                                   quadrature, method):
    """B1's Chebyshev and BiCGStab variants with a steady or a
    time-dependent source, BE and CN, both quadratures, extrapolated. The
    time-dependent load goes in windows of 4 steps (3 launches for 11
    steps), which must carry the state and u_prev as one launch does."""
    plane = 3 * MS * MS * 8
    monkeypatch.setattr(fused_solver, "LOAD_WINDOW_BYTES", 4 * plane)
    assert fused_solver.load_window(MS, torch.float64, N_STEPS) == 4
    jspec, j_args, tspec, t_args, grid = _uniform_inputs(order)
    kw = dict(n_steps=N_STEPS, use_ka=order == 2, extrapolate=True,
              method=method,
              n_iters=K if method == "chebyshev" else 5,
              bounds=BOUNDS if method == "chebyshev" else None)
    want = pallas_solver.fused_solve_uniform(
        jspec, *j_args, interpret=True, **kw,
        **_src_kw(kind, quadrature, grid, j_problems))
    got = fused_solver.fused_solve_uniform(
        tspec, *t_args, **kw, **_src_kw(kind, quadrature, grid, t_problems))
    assert fused_solver.LOAD_KERNEL.launches == 0
    assert fused_solver.BICGSTAB_KERNEL.launches == 0
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    assert rel_diff(got, want) <= (TOL if method == "chebyshev"
                                   else BICGSTAB_TOL)


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b1_bicgstab_matches_pallas_solver(order, extrapolate):
    """B1's BiCGStab variant without a source (the JAX solver's default
    fused route)."""
    jspec, j_args, tspec, t_args, _ = _uniform_inputs(order)
    kw = dict(n_steps=N_STEPS, n_iters=5, use_ka=order == 2,
              extrapolate=extrapolate, method="bicgstab")
    want = pallas_solver.fused_solve_uniform(jspec, *j_args, interpret=True,
                                             **kw)
    got = fused_solver.fused_solve_uniform(tspec, *t_args, **kw)
    assert rel_diff(got, want) <= BICGSTAB_TOL


@pytest.mark.parametrize("method", ["chebyshev", "bicgstab"])
def test_b1_windows_equal_one_launch(monkeypatch, method):
    """A time-dependent load in windows of 1, 3 and all 11 steps gives the
    same state bit for bit: the windows carry u and u_prev."""
    _, _, tspec, t_args, grid = _uniform_inputs(2)
    kw = dict(n_steps=N_STEPS, use_ka=True, extrapolate=True, method=method,
              n_iters=K if method == "chebyshev" else 5,
              bounds=BOUNDS if method == "chebyshev" else None,
              **_src_kw("ramp", "mass_lumped", grid, t_problems))
    outs = []
    for window in (1, 3, N_STEPS):
        monkeypatch.setattr(fused_solver, "LOAD_WINDOW_BYTES",
                            window * 3 * MS * MS * 8)
        outs.append(fused_solver.fused_solve_uniform(tspec, *t_args, **kw))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("kind", ["steady", "ramp"])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b2_with_loads_matches_pallas_hbm(order, kind):
    jspec, j_args, tspec, t_args, grid = _uniform_inputs(order)
    kw = dict(n_steps=N_STEPS, n_iters=K, use_ka=order == 2,
              extrapolate=True, bounds=BOUNDS)
    want = pallas_hbm.fused_solve_uniform_hbm(
        jspec, *j_args, stripe_rows=8, interpret=True, **kw,
        **_src_kw(kind, "mass_lumped", grid, j_problems))
    got, bad = fused_hbm.fused_solve_uniform_hbm(
        tspec, *t_args, guard_every=N_STEPS, **kw,
        **_src_kw(kind, "mass_lumped", grid, t_problems))
    assert fused_hbm.LOAD_KERNEL.launches == 0
    assert int(bad) == -1
    assert rel_diff(got, want) <= TOL


def _walled_canvas_inputs(order):
    """The canvas operator of a plume behind three Robin walls, as the
    JAX solver builds it, and the same carried to the port."""
    jmd, tmd = mesh_pair(MS, nt=N_STEPS + 1)
    jp = type("Walled", (j_problems.Problem,), {"robin_sides": WALLS})()
    ops = j_crbe.assemble(jmd, jp, DT, order)
    pattern = j_stencil.get_pattern(jmd)
    perm = jnp.asarray(pattern.perm)
    bm = j_crbe.robin_terms(jmd, jp)[0][perm]
    coeffs = j_stencil.extract_coefficients(pattern, ops.system.vals)
    mass = jnp.where(bm, 0.0, ops.mass_diag[perm])
    inv_diag = 1.0 / ops.system_diag[perm]
    u0 = jp.initial_condition_fn(jmd.midpoints)[perm]
    t_coeffs, t_mass, t_inv = interop.canvas_operator_from_numpy(
        coeffs=[np.asarray(g) for g in coeffs], mass_fam=np.asarray(mass),
        inv_diag_fam=np.asarray(inv_diag), device="cpu")
    return ((pattern, coeffs, mass, inv_diag, u0),
            (t_stencil.get_pattern(tmd), t_coeffs, t_mass, t_inv,
             torch.tensor(np.asarray(u0))), _grid(jmd), pattern.c)


@pytest.mark.parametrize("kind", ["steady", "ramp", None])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b4_with_source_and_flux_matches_pallas_hbm(order, kind):
    """B4 with a source load and the Robin flux load g |e| on three walls
    (H rows 0 and c, V column 0), one plane: BE samples t, CN takes the
    trapezoid of t and t - dt for g always."""
    j_args, t_args, grid, c = _walled_canvas_inputs(order)
    rect = pallas_hbm.robin_rect_bounds(c, WALLS)
    assert rect == fused_hbm.robin_rect_bounds(c, WALLS)
    kw = dict(n_steps=N_STEPS, n_iters=K, bounds=BOUNDS, use_ka=order == 2,
              extrapolate=True, rect=rect)
    sides = tuple(sorted(WALLS))

    def extra(mod):
        out = dict(robin_g_fn=_flux(mod), robin_sides=sides, grid=grid,
                   t0=T0, dt=DT)
        if kind is not None:
            out.update(_src_kw(kind, "mass_lumped", grid, mod))
        return out

    want = pallas_hbm.fused_solve_canvas_hbm(*j_args, stripe_rows=8,
                                             interpret=True, **kw,
                                             **extra(j_problems))
    got, bad = fused_hbm.fused_solve_canvas_hbm(*t_args, guard_every=N_STEPS,
                                                **kw, **extra(t_problems))
    assert fused_hbm.CANVAS_KERNEL.launches == 0
    assert int(bad) == -1
    assert rel_diff(got, want) <= TOL


def test_robin_flux_load_lives_on_the_wall_lines():
    """The flux load is dt g |e| on H rows 0 / c and V columns 0 / c of the
    Robin sides only, masked by the widened rectangle and by live DOFs."""
    n, c = 9, 8
    rect = fused_hbm.robin_rect_bounds(c, WALLS)
    masks = fused_solver.rect_masks(n, torch.float64, "cpu", rect)
    live = torch.ones((3, n, n), dtype=torch.float64)
    live[0, 0, 3] = 0.0  # a dead DOF on the bottom wall
    walls = loads.RobinFluxLoads(
        lambda x, y, t, side: 0.0 * x + {"bottom": 1.0, "top": 2.0,
                                         "left": 3.0}[side],
        tuple(WALLS), grid=(-20.0, -20.0, 5.0), dt=0.1, use_ka=False,
        masks=masks, live=live)
    plane = torch.zeros((3, n, n), dtype=torch.float64)
    walls.add(plane, None, 0.5)
    expect = torch.zeros_like(plane)
    expect[0, 0, :c] = 0.1 * 1.0 * 5.0
    expect[0, 0, 3] = 0.0
    expect[0, c, :c] = 0.1 * 2.0 * 5.0
    expect[1, :c, 0] = 0.1 * 3.0 * 5.0  # V rows [0, c) of column 0
    assert torch.equal(plane != 0, expect != 0)
    torch.testing.assert_close(plane, expect, rtol=1e-15, atol=0.0)


def test_fused_fits_counts_a_steady_source():
    """_fused_fits with source_steady picks the JAX package's route: at
    481^2 with extrapolation a steady source tips the uniform Chebyshev
    solve to B2 (18 canvases, 16.6 MB > 14 MiB)."""
    from airpollution_tpu.models.crbe import _pallas_fused_fits

    for n in (257, 321, 361, 401, 441, 481, 513):
        for ext in (False, True):
            for method in ("chebyshev", "bicgstab"):
                for steady in (False, True):
                    want = _pallas_fused_fits(types.SimpleNamespace(n=n), ext,
                                              method=method,
                                              source_steady=steady)
                    assert t_crbe._fused_fits(
                        n, ext, method=method, source_steady=steady) == want
    assert t_crbe._fused_fits(481, True)
    assert not t_crbe._fused_fits(481, True, source_steady=True)


def _fake_mesh(n):
    """Just what CRBESolver's routing reads of a MeshData."""
    return types.SimpleNamespace(device=torch.device("cpu"), nt=11,
                                 structured_n=n,
                                 number_of_segments=(n - 1) * (3 * n - 1))


@pytest.mark.parametrize("n,impl,method,problem,kernel", [
    (481, "fused", "chebyshev", "steady", "B2"),
    (481, "fused", "chebyshev", "ramp", "B1"),
    (257, "fused", "bicgstab", "steady", "B1-BiCGStab"),
    (257, "fused", "bicgstab", None, "B1-BiCGStab"),
    (481, "fused_hbm", "chebyshev", "steady", "B2"),
    (481, "fused", "bicgstab", "steady", None),
])
def test_sourced_routing_matches_jax(n, impl, method, problem, kernel):
    """Extrapolated, the steady source's hoisted load moves a 481^2
    Chebyshev solve to B2, as in the JAX package; a time-dependent one
    stays on B1. BiCGStab takes B1's variant while it fits and is refused
    past it (the per-step kernels are Chebyshev-only)."""
    p = tapt.Problem() if problem is None else _source(t_problems, problem)
    kw = dict(matvec_impl=impl, solver_method=method,
              extrapolate_warm_start=True, device="cpu")
    if kernel is None:
        with pytest.raises(ValueError, match="solver_method='chebyshev'"):
            CRBESolver(tapt.Domain(), p, _fake_mesh(n), **kw)
        return
    s = CRBESolver(tapt.Domain(), p, _fake_mesh(n), **kw)
    assert s._fused_plan() == (True, kernel)


def test_reroute_switches_uniform_fused_to_bicgstab():
    """An advection-dominated Chebyshev configuration on 'fused' with the
    uniform operator switches to B1's BiCGStab variant in both packages,
    and both states agree; 'fused_hbm' still raises."""
    jmd, tmd = mesh_pair(6, nt=4)
    kw = dict(matvec_impl="fused", solver_method="chebyshev",
              chebyshev_iters=10)
    js = JaxSolver(japt.Domain(), japt.Problem(), jmd, **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        want = js.solve(store_solutions=False)
    assert any("auto-switching" in str(x.message) for x in w)
    ts = CRBESolver(tapt.Domain(), tapt.Problem(), tmd, device="cpu", **kw)
    ts.set_operators(port_operators(js._ops))
    with pytest.warns(UserWarning, match="auto-switching"):
        got = ts.solve(store_solutions=False)
    assert js.solver_method == ts.solver_method == "bicgstab"
    assert ts.fused_kernel == "B1-BiCGStab"
    assert rel_diff(got, want) <= BICGSTAB_TOL
    hbm = CRBESolver(tapt.Domain(), tapt.Problem(), tmd, device="cpu",
                     **dict(kw, matvec_impl="fused_hbm"))
    with pytest.raises(ValueError, match="Chebyshev-only"):
        hbm.solve(store_solutions=False)


def _load_script(name, module):
    spec = importlib.util.spec_from_file_location(module,
                                                  REPO / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("c_comp", [0.0, 0.005])
def test_production_scenario_matches_jax(monkeypatch, c_comp):
    """The production scenario end to end at 17^2, nt=21, a snapshot every
    5 steps: both packages' run() on one Chebyshev interval, float64;
    every snapshot row and every budget term. With c_comp the Robin flux
    load rides B4's load plane."""
    jscript = _load_script("production_scenario.py", "jax_production")
    tscript = _load_script("torch_port_production_scenario.py",
                           "torch_production")
    captured = {}

    class Capture(JaxSolver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            captured["solver"] = self

    monkeypatch.setattr(jscript, "CRBESolver", Capture)
    monkeypatch.setattr(jscript.apt, "MeshData",
                        functools.partial(japt.MeshData, dtype=jnp.float64))
    monkeypatch.setattr(jscript, "log", lambda *a: None)
    monkeypatch.setattr(tscript, "log", lambda *a: None)
    want = jscript.run(17, 21, 5, 8, c_comp=c_comp, warm=False)
    js = captured["solver"]
    got, ts = tscript.run(17, 21, 5, 8, c_comp=c_comp, warm=False,
                          device="cpu", dtype=torch.float64,
                          cheb_bounds=js._cheb_bounds)
    assert ts.fused_kernel == "B4"
    assert ts._robin_g_fused == js._robin_g_fused == bool(c_comp)
    assert ts.solutions.shape == js.solutions.shape == (5, 3 * 16 * 16
                                                        + 2 * 16)
    assert rel_diff(ts.solutions, js.solutions) <= TOL
    for name, value in want.items():
        if name in ("warm_solve_s", "steps_per_sec", "scheme"):
            continue
        assert got[name] == pytest.approx(value, rel=1e-9, abs=1e-14), name
    assert got["deposited"] > 0.0 and got["mass_final"] > 0.0
