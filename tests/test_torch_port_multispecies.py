"""The port's multispecies chemistry-transport slice against the JAX
package, float64 on the CPU: the problem classes; the plain versions of
kernel B6 (ops/fused_hbm.fused_multispecies_canvas_hbm) and of B4 with an
emission load (ops/fused_hbm.fused_solve_canvas_hbm) against the Pallas
kernels in interpret mode on one operator and one Chebyshev interval;
MultiSpeciesSolver end to end on every route; and the validation errors.

Under the reference source quadrature the JAX kernels leave a load on
obstacle dead DOFs (their load is masked by the family rectangle only);
the port zeroes it there, as the JAX scan path does, so those cases
compare live DOFs and require the port's dead DOFs to be exactly 0.0."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu import problems as j_problems
from airpollution_tpu.mesh.data import structured_grid as j_grid
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.models.multispecies import (
    MultiSpeciesSolver as JaxSolver,
)
from airpollution_tpu.ops import pallas_hbm
from airpollution_tpu.ops import stencil as j_stencil
from jax.scipy.linalg import expm

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import interop
from airpollution_tpu_torch import problems as t_problems
from airpollution_tpu_torch.mesh.data import structured_grid as t_grid
from airpollution_tpu_torch.models import multispecies as t_ms
from airpollution_tpu_torch.models.multispecies import MultiSpeciesSolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver
from airpollution_tpu_torch.ops import loads as t_loads
from airpollution_tpu_torch.ops import stencil as t_stencil

from torch_port_helpers import port_operators, rel_diff

TOL = 1e-10  # f64, the same operator and interval on both sides
KERNEL_TOL = 1e-12  # f64, one plain kernel against its Pallas twin
BOUNDS = (0.5, 1.6)
ROBIN = {"bottom": 0.3}
BLOCK = ((-5.0, 1.0, -3.0, 3.0),)  # 3 dead DOFs at ms=12
R2 = [[0.3, -0.1], [-0.2, 0.4]]
R3 = [[0.3, 0.0, 0.0], [-0.3, 0.2, 0.0], [0.0, -0.2, 0.1]]


def _species(mod, K, sourced, walls):
    """K species of one package: a Gaussian emitter (or a plume) and
    plumes, optionally all with a deposition floor and a solid block."""
    first = (mod.GaussianSourceProblem(q=2.0, xs=1.0, ys=-2.0, sigma_s=2.0)
             if sourced else mod.Problem(sigma=1.0))
    species = [first, mod.Problem(sigma=2.0)]
    if K == 3:
        species.append(mod.Problem(sigma=1.5))
    if walls:
        for sp in species:
            sp.robin_sides = dict(ROBIN)
            sp.obstacles = BLOCK
    return species


def _problem_pair(K=2, sourced=True, walls=False):
    R = R2 if K == 2 else R3
    return (j_problems.MultiSpeciesProblem(
                _species(j_problems, K, sourced, walls), np.array(R)),
            t_problems.MultiSpeciesProblem(
                _species(t_problems, K, sourced, walls), R))


def _mesh_pair(ms=12, nt=17, T=2.0):
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(T=T), nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(T=T), nt=nt,
                        dtype=torch.float64, device="cpu")
    return jmd, tmd


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- problems ---------------------------------------------------------


def test_problems_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20.0, 20.0, size=(64, 2))
    xyt = np.concatenate([xy, rng.uniform(0.0, 2.0, size=(64, 1))], axis=1)
    jxy, txy = jnp.asarray(xy), torch.tensor(xy)
    jg = j_problems.GaussianSourceProblem(q=2.0, xs=-6.0, ys=0.5,
                                          sigma_s=1.5)
    tg = t_problems.GaussianSourceProblem(q=2.0, xs=-6.0, ys=0.5,
                                          sigma_s=1.5)
    assert tg.steady_source and not tg.zero_source
    pairs = [
        (jg.source_term(jnp.asarray(xyt)), tg.source_term(torch.tensor(xyt))),
        (jg.source_xy(jxy[:, 0], jxy[:, 1], 0.3),
         tg.source_xy(txy[:, 0], txy[:, 1], 0.3)),
        (jg.initial_condition_fn(jxy), tg.initial_condition_fn(txy)),
        (jg.boundary_fn(jnp.asarray(xyt)), tg.boundary_fn(torch.tensor(xyt))),
        # The default source_xy wraps source_term.
        (japt.Problem().source_xy(jxy[:, 0], jxy[:, 1], 0.3),
         tapt.Problem().source_xy(txy[:, 0], txy[:, 1], 0.3)),
    ]
    jm, tm = _problem_pair(K=3, sourced=False)
    for t in (0.0, 0.7):
        pairs += [(jm.analytical_solution(jxy, t),
                   tm.analytical_solution(txy, t)),
                  (jm.boundary_values(jxy, t), tm.boundary_values(txy, t)),
                  (jm.sources(jxy, t), tm.sources(txy, t))]
    pairs.append((jm.initial_conditions(jxy), tm.initial_conditions(txy)))
    js, ts = _problem_pair(K=2, sourced=True, walls=True)
    pairs += [(js.boundary_values(jxy, 0.5), ts.boundary_values(txy, 0.5)),
              (js.sources(jxy, 0.5), ts.sources(txy, 0.5)),
              (js.initial_conditions(jxy), ts.initial_conditions(txy))]
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-300)
    for jp, tp in ((jm, tm), (js, ts)):
        for attr in ("n_species", "zero_source", "shared_transport",
                     "has_analytical", "obstacles"):
            assert getattr(tp, attr) == getattr(jp, attr), attr
        np.testing.assert_array_equal(_np(tp.obstacle_fn(txy)),
                                      np.asarray(jp.obstacle_fn(jxy)))
    unshared = [tapt.Problem(D=0.1), tapt.Problem(D=0.02)]
    assert not t_problems.MultiSpeciesProblem(unshared,
                                              np.zeros((2, 2))).shared_transport


class _RobinG(t_problems.Problem):
    robin_sides = {"left": 0.1}

    def robin_g_xy(self, x, y, t, side):
        return 0.0 * x + 1.0


class _JRobinG(j_problems.Problem):
    robin_sides = {"left": 0.1}

    def robin_g_xy(self, x, y, t, side):
        return 0.0 * x + 1.0


def _invalid_problems(mod, robin_g):
    walled = mod.Problem()
    walled.robin_sides = {"left": 0.1}
    blocked = mod.Problem()
    blocked.obstacles = BLOCK

    class Variable(mod.Problem):
        variable_coefficients = True

    return [
        ((), np.zeros((0, 0))),
        ((mod.Problem(reaction=0.1),), np.zeros((1, 1))),
        ((Variable(),), np.zeros((1, 1))),
        ((mod.Problem(), mod.Problem()), np.zeros((3, 3))),
        ((walled, mod.Problem()), np.zeros((2, 2))),
        ((robin_g(), robin_g()), np.zeros((2, 2))),
        ((mod.Problem(), blocked), np.zeros((2, 2))),
    ]


@pytest.mark.parametrize("case", range(7))
def test_problem_validation_matches_jax(case):
    j_species, j_R = _invalid_problems(j_problems, _JRobinG)[case]
    t_species, t_R = _invalid_problems(t_problems, _RobinG)[case]
    with pytest.raises(ValueError) as want:
        j_problems.MultiSpeciesProblem(j_species, j_R)
    with pytest.raises(ValueError) as got:
        t_problems.MultiSpeciesProblem(t_species, t_R)
    if case != 3:  # the shape in the message prints differently
        assert str(got.value) == str(want.value)


# --- plain kernels against the Pallas kernels in interpret mode --------


def _canvas_operator(jp_species, order, jmd, tmd, dt):
    """The JAX package's canvas operator for the first species' transport
    (as its MultiSpeciesSolver builds it), the same carried across to the
    port, the dead-DOF mask, and the grids."""
    sp0 = jp_species[0]
    ops = j_crbe.assemble(jmd, sp0, dt, order)
    pattern = j_stencil.get_pattern(jmd)
    perm = jnp.asarray(pattern.perm)
    bmask = j_crbe.robin_terms(jmd, sp0)[0]
    _, dead = j_crbe.obstacle_masks(jmd, sp0)
    if dead is not None:
        bmask = bmask | dead
    coeffs = j_stencil.extract_coefficients(pattern, ops.system.vals)
    mass = jnp.where(bmask[perm], 0.0, ops.mass_diag[perm])
    inv_diag = 1.0 / ops.system_diag[perm]
    C0 = jnp.stack([sp.initial_condition_fn(jmd.midpoints)
                    for sp in jp_species])
    if dead is not None:
        C0 = jnp.where(dead[None], 0.0, C0)
    C0 = C0[:, perm]
    t_coeffs, t_mass, t_inv = interop.canvas_operator_from_numpy(
        coeffs=[np.asarray(g) for g in coeffs], mass_fam=np.asarray(mass),
        inv_diag_fam=np.asarray(inv_diag), device="cpu")
    dead_fam = None if dead is None else np.asarray(dead[perm])
    j_args = (pattern, coeffs, mass, inv_diag, C0)
    t_args = (t_stencil.get_pattern(tmd), t_coeffs, t_mass, t_inv,
              torch.tensor(np.asarray(C0)))
    assert j_grid(jmd) == pytest.approx(t_grid(tmd), abs=1e-14)
    return j_args, t_args, dead_fam, j_grid(jmd)


def _check_dead(got, want, dead_fam, reference):
    """Live DOFs within KERNEL_TOL; the port's dead DOFs exactly 0.0."""
    got, want = _np(got), np.asarray(want)
    if dead_fam is None:
        assert rel_diff(got, want) <= KERNEL_TOL
        return
    live = ~dead_fam
    assert (np.abs(got[..., live] - want[..., live]).max()
            / np.abs(want).max()) <= KERNEL_TOL
    assert np.abs(got[..., dead_fam]).max() == 0.0
    if reference:
        # The fault this port does not inherit (the JAX kernels' load).
        assert np.abs(want[..., dead_fam]).max() > 0.0


@pytest.mark.parametrize("K,order,sourced,walls,quadrature", [
    (2, 1, True, True, "reference"),
    (2, 2, True, True, "mass_lumped"),
    (2, 2, False, True, "mass_lumped"),
    (2, 1, False, False, "mass_lumped"),
    (3, 1, True, False, "mass_lumped"),
    (3, 2, True, False, "reference"),
    (3, 2, False, False, "mass_lumped"),
    (3, 1, False, True, "mass_lumped"),
], ids=["K2-BE-src-walls-ref", "K2-CN-src-walls", "K2-CN-walls",
        "K2-BE", "K3-BE-src", "K3-CN-src-ref", "K3-CN", "K3-BE-walls"])
def test_plain_b6_matches_pallas(K, order, sourced, walls, quadrature):
    jms, tms = _problem_pair(K, sourced, walls)
    nt, T = 7, 1.0
    jmd, tmd = _mesh_pair(nt=nt, T=T)
    dt = T / (nt - 1)
    j_args, t_args, dead_fam, grid = _canvas_operator(jms.species, order,
                                                      jmd, tmd, dt)
    E = np.asarray(expm(-(0.5 * dt) * jnp.asarray(jms.R)))
    c = t_args[0].c
    rect = pallas_hbm.robin_rect_bounds(c, ROBIN) if walls else None
    assert rect == (fused_hbm.robin_rect_bounds(c, ROBIN) if walls else None)
    kw = dict(n_steps=nt - 1, n_iters=6, bounds=BOUNDS, use_ka=order == 2,
              rect=rect, source_lumped=quadrature == "mass_lumped",
              grid=grid, dt=dt)
    j_src = (jms.species[0].source_xy,) + (None,) * (K - 1)
    t_src = (tms.species[0].source_xy,) + (None,) * (K - 1)
    want = pallas_hbm.fused_multispecies_canvas_hbm(
        *j_args, E, source_fns=j_src if sourced else None, interpret=True,
        **kw)
    for fuse in (True, False):
        got, bad = fused_hbm.fused_multispecies_canvas_hbm(
            *t_args, E, source_fns=t_src if sourced else None,
            source_steady=(True,) + (False,) * (K - 1),
            dead_fam=None if dead_fam is None else torch.tensor(dead_fam),
            fuse_chemistry=fuse, guard_every=3, **kw)
        assert int(bad) == -1
        _check_dead(got, want, dead_fam,
                    sourced and quadrature == "reference")
    assert fused_hbm.MULTISPECIES_KERNEL.launches == 0
    assert fused_hbm.CANVAS_KERNEL.launches == 0


@pytest.mark.parametrize("order,quadrature", [
    (1, "reference"), (2, "mass_lumped"), (2, "reference")])
def test_plain_b4_with_load_matches_pallas(order, quadrature):
    jms, tms = _problem_pair(2, True, True)
    nt, T = 7, 1.0
    jmd, tmd = _mesh_pair(nt=nt, T=T)
    dt = T / (nt - 1)
    j_args, t_args, dead_fam, grid = _canvas_operator(jms.species[:1],
                                                      order, jmd, tmd, dt)
    rect = pallas_hbm.robin_rect_bounds(t_args[0].c, ROBIN)
    kw = dict(n_steps=nt - 1, n_iters=6, bounds=BOUNDS, use_ka=order == 2,
              rect=rect, source_lumped=quadrature == "mass_lumped",
              grid=grid, dt=dt, extrapolate=True)
    want = pallas_hbm.fused_solve_canvas_hbm(
        *j_args[:4], j_args[4][0], source_fn=jms.species[0].source_xy,
        source_steady=True, stripe_rows=8, interpret=True, **kw)
    for steady in (True, False):
        got = fused_hbm.fused_solve_canvas_hbm(
            *t_args[:4], t_args[4][0], source_fn=tms.species[0].source_xy,
            source_steady=steady, dead_fam=torch.tensor(dead_fam), **kw)
        _check_dead(got, want, dead_fam, quadrature == "reference")
    assert fused_hbm.CANVAS_KERNEL.launches == 0


def test_emission_load_coordinates_and_trapezoid():
    """The load planes sit on the DOF midpoints of each family, and a
    time-dependent source takes the trapezoid of t and t - dt."""
    md = tapt.MeshData(tapt.create_mesh(7, 20.0), tapt.Domain(), nt=5,
                       dtype=torch.float64, device="cpu")
    pattern = t_stencil.get_pattern(md)
    perm = torch.as_tensor(pattern.perm.astype(np.int64))
    X, Y = t_loads.family_coordinates(pattern.n, t_grid(md),
                                      torch.float64, "cpu")
    mid = md.midpoints[perm]
    for i, P in ((0, X), (1, Y)):
        np.testing.assert_allclose(
            fused_solver.from_canvases(pattern, P).numpy(),
            mid[:, i].numpy(), atol=1e-12)
    n = pattern.n
    masks = fused_solver.rect_masks(n, torch.float64, "cpu")
    mass3 = torch.ones((3, n, n), dtype=torch.float64)
    loads = t_loads.EmissionLoads(
        (None, lambda x, y, t: 0.0 * x + t), (False, False),
        grid=t_grid(md), dt=0.5, t0=1.0, use_ka=True, lumped=True,
        mass3=mass3, masks=masks)
    assert loads.index == [-1, 0]
    first = loads.advance()[0].clone()
    second = loads.advance()[0]
    assert float(first.max()) == pytest.approx(0.5 * 0.5 * (1.5 + 1.0))
    assert float(second.max()) == pytest.approx(0.5 * 0.5 * (2.0 + 1.5))


# --- the slice end to end ----------------------------------------------


def _pair(jms, tms, jmd, tmd, jkw, tkw=None):
    """A JAX and a port solver of one configuration; the port's takes the
    JAX assembly (interop)."""
    js = JaxSolver(japt.Domain(T=2.0), jms, jmd, **jkw)
    ts = MultiSpeciesSolver(tapt.Domain(T=2.0), tms, tmd, device="cpu",
                            **{**jkw, **(tkw or {})})
    return js, ts


FUSED = dict(time_scheme_order=2, matvec_impl="fused_hbm",
             splitting="strang", solver_method="chebyshev",
             chebyshev_iters=12)


@pytest.mark.parametrize("walls,quadrature", [
    (False, "mass_lumped"), (True, "reference")], ids=["plain", "walls-ref"])
def test_fused_strang_matches_jax(walls, quadrature):
    """B6's route (fuse on and off) and its strided rows against the JAX
    fused path on one interval; dead DOFs exactly 0.0."""
    jms, tms = _problem_pair(2, True, walls)
    jmd, tmd = _mesh_pair()
    kw = dict(FUSED, source_quadrature=quadrature)
    js, _ = _pair(jms, tms, jmd, tmd, kw)
    want = js.solve(store_solutions=False)
    bounds = js._fused_bounds_cache[1]
    ops = port_operators(js._ops)
    dead = t_ms.obstacle_masks(tmd, tms)[1]
    for fuse in (True, False):
        ts = MultiSpeciesSolver(tapt.Domain(T=2.0), tms, tmd, device="cpu",
                                cheb_bounds=bounds, fuse_chemistry=fuse,
                                **kw)
        ts.set_operators(ops)
        got = ts.solve(store_solutions=False)
        assert got.shape == want.shape == (1, 2, tmd.number_of_segments)
        if dead is None:
            assert rel_diff(got, want) <= TOL
        else:
            live = ~dead.numpy()
            assert rel_diff(got[..., live], np.asarray(want)[..., live]) \
                <= TOL
            assert float(got[..., dead].abs().max()) == 0.0
    if not walls:
        js = JaxSolver(japt.Domain(T=2.0), jms, jmd, snapshot_every=8, **kw)
        want = js.solve(store_solutions=True)
        ts = MultiSpeciesSolver(tapt.Domain(T=2.0), tms, tmd, device="cpu",
                                snapshot_every=8, cheb_bounds=bounds, **kw)
        ts.set_operators(ops)
        got = ts.solve(store_solutions=True)
        assert got.shape == want.shape == (3, 2, tmd.number_of_segments)
        assert rel_diff(got, want) <= TOL
        # The last strided row is the final state, bit for bit.
        assert torch.equal(got[-1], ts.solve(store_solutions=False)[0])


@pytest.mark.parametrize("impl,method,order,case", [
    ("ell", "bicgstab", 1, "shared"),
    ("ell", "chebyshev", 2, "shared"),
    ("ell", "bicgstab", 2, "stacked"),
    ("ell", "chebyshev", 1, "stacked"),
    ("stencil", "bicgstab", 2, "shared"),
    ("stencil", "chebyshev", 1, "shared"),
    ("ell", "bicgstab", 2, "walls"),
    ("auto", "bicgstab", 1, "commute"),
    ("stencil", "chebyshev", 2, "commute"),
], ids=["ell-bicgstab", "ell-chebyshev", "stacked-bicgstab",
        "stacked-chebyshev", "stencil-bicgstab", "stencil-chebyshev",
        "ell-walls", "commute", "commute-chebyshev"])
def test_scan_routes_match_jax(impl, method, order, case):
    """The Strang scan routes ('ell' shared and stacked, 'stencil') and the
    commute route, against the JAX solver on the JAX assembly."""
    if case == "stacked":
        sp_j = [japt.Problem(D=0.1), japt.Problem(D=0.05, sigma=2.0)]
        sp_t = [tapt.Problem(D=0.1), tapt.Problem(D=0.05, sigma=2.0)]
        sp_j[0] = j_problems.GaussianSourceProblem(D=0.1, q=2.0, xs=1.0)
        sp_t[0] = t_problems.GaussianSourceProblem(D=0.1, q=2.0, xs=1.0)
        jms = j_problems.MultiSpeciesProblem(sp_j, np.array(R2))
        tms = t_problems.MultiSpeciesProblem(sp_t, R2)
    else:
        jms, tms = _problem_pair(
            3 if case == "commute" else 2, case != "commute",
            case == "walls")
    jmd, tmd = _mesh_pair()
    kw = dict(time_scheme_order=order, matvec_impl=impl,
              solver_method=method, chebyshev_iters=12, solver_tol=1e-13,
              solver_maxiter=400)
    if case != "commute":
        kw["splitting"] = "strang"
    js, ts = _pair(jms, tms, jmd, tmd, kw)
    store = case != "commute"
    want = js.solve(store_solutions=store)
    if case == "stacked":
        assert js._ops.mass_diag.ndim == 2
        ts.set_operators(interop.stacked_operators_from_numpy([
            {name: (np.asarray(getattr(js._ops, name).vals[k]),
                    np.asarray(getattr(js._ops, name).cols[k]))
             for name in ("stiffness", "advection", "ka", "system")}
            | {"mass_diag": np.asarray(js._ops.mass_diag[k]),
               "system_diag": np.asarray(js._ops.system_diag[k])}
            for k in range(2)], device="cpu"))
    elif case == "commute":
        assert js.splitting == ts.splitting == "commute"
        ts.set_operators(port_operators(js._transport_solvers[0]._ops))
    else:
        ts.set_operators(port_operators(js._ops))
    got = ts.solve(store_solutions=store)
    assert got.shape == want.shape
    assert rel_diff(got, want) <= TOL
    if case == "walls":
        dead = t_ms.obstacle_masks(tmd, tms)[1]
        assert float(got[..., dead].abs().max()) == 0.0
    if case == "commute":
        got_err, want_err = ts.compute_errors(), js.compute_errors()
        assert got_err["rel_l2_error"] == pytest.approx(
            want_err["rel_l2_error"], rel=1e-9)
        for g, w in zip(got_err["per_species"], want_err["per_species"]):
            for name in ("max_error", "l2_error", "rel_l2_error"):
                assert g[name] == pytest.approx(w[name], rel=1e-9)


@pytest.mark.parametrize("kw", [
    dict(time_scheme_order=3),
    dict(solver_method="cg"),
    dict(splitting="lie"),
    dict(splitting="commute", sourced=True),
    dict(transport_solver_kwargs={"fused_iters": 3}, splitting="strang"),
    dict(matvec_impl="pallas"),
    dict(matvec_impl="fused_hbm", unshared=True, solver_method="chebyshev"),
    dict(matvec_impl="fused_hbm"),
    dict(matvec_impl="uniform", walls=True),
    dict(matvec_impl="stencil", walls=True),
    dict(matvec_impl="stencil", unshared=True),
    dict(snapshot_every=5),
    dict(matvec_impl="fused_hbm", solver_method="chebyshev",
         splitting="strang", store_solutions=True),
    dict(matvec_impl="fused_hbm", solver_method="chebyshev",
         splitting="strang", dt_large=True),
], ids=["order", "solver", "splitting", "commute-sourced", "kwargs-strang",
        "impl", "fused-unshared", "fused-bicgstab", "uniform-robin",
        "stencil-obstacles", "stencil-unshared", "snapshot", "fused-store",
        "fused-gate"])
def test_validation_errors_match_jax(kw):
    """The same ValueError, with the same message, as the JAX solver."""
    kw = dict(kw)
    sourced = kw.pop("sourced", False)
    walls = kw.pop("walls", False)
    unshared = kw.pop("unshared", False)
    store = kw.pop("store_solutions", None)
    T = 200.0 if kw.pop("dt_large", False) else 2.0
    if unshared:
        jms = j_problems.MultiSpeciesProblem(
            (japt.Problem(D=0.1), japt.Problem(D=0.02)), np.zeros((2, 2)))
        tms = t_problems.MultiSpeciesProblem(
            (tapt.Problem(D=0.1), tapt.Problem(D=0.02)), np.zeros((2, 2)))
    else:
        jms, tms = _problem_pair(2, sourced, walls)
    jmd, tmd = _mesh_pair(nt=17, T=T)

    def run(cls, dom, ms, md, **extra):
        s = cls(dom, ms, md, **kw, **extra)
        if store is not None:
            s.solve(store_solutions=store)
        else:
            s.solve(store_solutions=False)

    with pytest.raises(ValueError) as want:
        run(JaxSolver, japt.Domain(T=T), jms, jmd)
    with pytest.raises(ValueError) as got:
        run(MultiSpeciesSolver, tapt.Domain(T=T), tms, tmd, device="cpu")
    assert str(got.value) == str(want.value)


def test_b6_envelope_raises_naming_k_and_iterations():
    with pytest.raises(ValueError, match="K=8.*chebyshev_iters=60"):
        fused_hbm.multispecies_tile(8, 60, True, torch.float64)
    with pytest.raises(ValueError, match="1 to 8 species"):
        fused_hbm.multispecies_tile(9, 4, False, torch.float32)
    # The demo's row fits a 32^2 tile in f32 (180 KB) and 16^2 in f64.
    assert fused_hbm.multispecies_tile(3, 8, True, torch.float32) == 32
    assert fused_hbm.multispecies_tile(3, 8, True, torch.float64) == 16
