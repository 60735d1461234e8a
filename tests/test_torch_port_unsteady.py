"""The port's time-varying layer (airpollution_tpu_torch/models/unsteady.py,
models/crbe.assemble_canvas, ops/stencil.canvases_from_local, the turning
wind, the block solver's ``coeff_time``) against the JAX package's, on the
CPU in float64 from the same scalars and numpy inputs.

The port's fused chunks run B4's plain version (and its raw mode, and
B9's). The JAX reference is its scan route, which needs no kernel, or,
for the differentiable fused chunks, its fused route with the raw_b kernel
replaced by the same polynomial (torch_port_helpers.jax_plain_raw). JAX
assembly runs jitted: its eager first call costs seconds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.models import crbe as jcrbe  # noqa: E402
from airpollution_tpu.models import pinn as jpinn  # noqa: E402
from airpollution_tpu.models.unsteady import (  # noqa: E402
    solve_time_varying as jsolve,
)
from airpollution_tpu.ops import pallas_hbm as jhbm  # noqa: E402
from airpollution_tpu.ops import stencil as jstencil  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.models import crbe as tcrbe  # noqa: E402
from airpollution_tpu_torch.models import pinn as tpinn  # noqa: E402
from airpollution_tpu_torch.models.crbe import (  # noqa: E402
    CRBESolver,
    obstacle_masks,
)
from airpollution_tpu_torch.models.unsteady import (  # noqa: E402
    solve_time_varying,
)
from airpollution_tpu_torch.ops import autodiff as tad  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402
from airpollution_tpu_torch.ops import linalg as tlinalg  # noqa: E402
from airpollution_tpu_torch.ops import stencil as tstencil  # noqa: E402
from airpollution_tpu_torch.parallel import make_mesh  # noqa: E402

from torch_port_helpers import jax_plain_raw, mesh_pair, rel_diff  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import (  # noqa: E402
    boundary_points, jax_params, np_params, points, port_mlp, tree_rel)

F64 = torch.float64
TURNING = dict(speed=1.0, omega_t=0.5, D=0.3)
# The JAX test's fused-chunk settings (tests/test_unsteady.py:271-295).
FUSED_KW = dict(reassemble_every=4, time_scheme_order=2, chebyshev_iters=8,
                extrapolate_warm_start=True, store_solutions=False)


def _g_bottom(lib, x, y, t):
    """An inflow on the bottom wall that varies in x and t."""
    return 0.3 * (1.0 + lib.cos(0.15 * x)) * (1.0 + 0.5 * t) + 0.0 * y


class JFlux(japt.TurningWindProblem):
    robin_sides = {"bottom": 0.4, "left": 0.2}

    def robin_g_xy(self, x, y, t, side):
        x, y = jnp.asarray(x), jnp.asarray(y)
        if side == "bottom":
            return _g_bottom(jnp, x, y, t)
        return jnp.zeros_like(x + y)


class TFlux(tapt.TurningWindProblem):
    robin_sides = {"bottom": 0.4, "left": 0.2}

    def robin_g_xy(self, x, y, t, side):
        x, y = torch.broadcast_tensors(x, y)
        if side == "bottom":
            return _g_bottom(torch, x, y, t)
        return torch.zeros_like(x)


from airpollution_tpu.problems import _register_problem_pytree  # noqa: E402

_register_problem_pytree(
    JFlux, ("v", "D", "speed", "omega_t", "phi0", "sigma", "x0", "y0",
            "reaction"))


def turning_pair(case="plain", **kw):
    """(JAX problem, port problem) of one turning-wind case."""
    kw = dict(TURNING, **kw)
    if case == "flux":
        return JFlux(**kw), TFlux(**kw)
    pair = (japt.TurningWindProblem(**kw), tapt.TurningWindProblem(**kw))
    for p in pair:
        if case == "robin_obstacle":
            p.robin_sides = {"bottom": 0.4, "left": 0.2}
            p.obstacles = ((-5.0, -1.0, -3.0, 3.0),)
        elif case == "obstacle":
            p.obstacles = ((-5.0, -1.0, -3.0, 3.0),)
    return pair


def test_canvases_from_local_match_jax():
    """Random local matrices and masses: the 15 grids and the mass grids
    equal JAX's, and assembling the same locals through the ELL route and
    extracting gives the same grids."""
    n = 9
    n_tri = 2 * (n - 1) ** 2
    rng = np.random.default_rng(3)
    local = rng.standard_normal((n_tri, 3, 3))
    mass = rng.standard_normal((n_tri, 3))
    jc, jm = jax.jit(lambda a, b: jstencil.canvases_from_local(n, a, b))(
        jnp.asarray(local), jnp.asarray(mass))
    tc, tm = tstencil.canvases_from_local(n, torch.tensor(local),
                                          torch.tensor(mass))
    for got, want in zip(tc + tm, jc + jm):
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-15
    assert tstencil.canvases_from_local(n, torch.tensor(local))[1] is None
    _, tmd = mesh_pair(n)
    flat = torch.zeros(tmd.number_of_segments * tmd.ell_width, dtype=F64)
    flat.index_add_(0, tmd.ell_entry_to_slot, torch.tensor(local).reshape(-1))
    ext = tstencil.extract_coefficients(tstencil.get_pattern(tmd), flat)
    assert max(float((a - b).abs().max()) for a, b in zip(tc, ext)) <= 1e-15


@pytest.mark.parametrize("case,order,coeff_time,reaction", [
    ("plain", 2, 1.7, 0.0),
    ("robin_obstacle", 1, 0.4, 0.2),
], ids=["turning", "robin_obstacle_reaction"])
def test_assemble_canvas_matches_jax_and_ell(case, order, coeff_time,
                                             reaction):
    """assemble_canvas against JAX's and against the port's
    extract_coefficients(assemble(...)), at 1e-12: the turning wind at a
    coeff_time (CN), and Robin walls (their alphas overridden by tensors)
    with an obstacle and reaction (BE)."""
    jmd, tmd = mesh_pair(12, nt=13)
    jp, tp = turning_pair(case, reaction=reaction)
    dt = 10.0 / 12
    jalpha = talpha = None
    if case == "robin_obstacle":
        jalpha = {"bottom": jnp.asarray(0.7), "left": jnp.asarray(0.1)}
        talpha = {"bottom": torch.tensor(0.7, dtype=F64),
                  "left": torch.tensor(0.1, dtype=F64)}
    want = jax.jit(lambda p, a: jcrbe.assemble_canvas(
        jmd, p, dt, order, coeff_time=coeff_time, robin_alpha=a))(jp, jalpha)
    got = tcrbe.assemble_canvas(tmd, tp, dt, order, coeff_time=coeff_time,
                                robin_alpha=talpha)
    for g, w in zip(got[0] + got[1:], tuple(want[0]) + tuple(want[1:])):
        assert rel_diff(g, w) <= 1e-12
    ops = tcrbe.assemble(tmd, tp, dt, order, coeff_time=coeff_time,
                         robin_alpha=talpha)
    pattern = tstencil.get_pattern(tmd)
    ext = tstencil.extract_coefficients(pattern, ops.system.vals)
    perm = torch.as_tensor(pattern.perm.astype(np.int64))
    for g, w in zip(got[0] + got[1:],
                    ext + (ops.mass_diag[perm], ops.system_diag[perm])):
        assert rel_diff(g, w.numpy()) <= 1e-12


@pytest.mark.parametrize("omega", [0.5, 0.0])
def test_turning_wind_closed_form_and_residual(omega):
    """The closed form and the wind against JAX's; the PDE residual of the
    closed form (through the per-point time-varying hooks) vanishes; its
    d/d omega_t is finite at omega_t = 0 (the safe denominator) and equals
    a central difference away from it."""
    x = np.array([[1.0, 2.0, 3.0], [0.5, -1.0, 7.0], [2.0, 1.0, 0.4],
                  [-3.0, 4.0, 9.5]])
    kw = dict(speed=1.0, phi0=0.3, D=0.1)
    jp = japt.TurningWindProblem(omega_t=omega, **kw)
    jc, jv = jax.jit(lambda p, q: (p.analytical_solution(q), p.velocity_at(
        q[:, :2], q[:, 2])))(jp, jnp.asarray(x))
    om = torch.tensor(omega, dtype=F64, requires_grad=True)
    tp = tapt.TurningWindProblem(omega_t=om, **kw)
    tx = torch.tensor(x)
    assert rel_diff(tp.analytical_solution(tx), jc) <= 1e-12
    assert rel_diff(tp.velocity_at(tx[:, :2], tx[:, 2]), jv) <= 1e-12
    assert tp.velocity_at(tx[:, :2], 2.5).shape == (4, 2)
    res = tad.problem_pde_residual(tp.analytical_solution, tx, tp,
                                   torch.zeros(4, dtype=F64))
    assert float(res.detach().abs().max()) <= 1e-12
    (g_res,) = torch.autograd.grad(res.sum(), om, retain_graph=True)
    (g,) = torch.autograd.grad(tp.analytical_solution(tx).sum(), om)
    assert np.isfinite(float(g_res)) and np.isfinite(float(g))
    if omega != 0.0:
        h = 1e-6

        def total(w):
            return float(tapt.TurningWindProblem(
                omega_t=w, **kw).analytical_solution(tx).sum())
        fd = (total(omega + h) - total(omega - h)) / (2 * h)
        assert abs(float(g) - fd) <= 1e-7 * abs(fd)


@pytest.mark.parametrize("order", [1, 2])
def test_scan_chunks_match_jax(order):
    """BiCGStab scan chunks, stored rows (13, n), at 1e-9 of max|u|."""
    jmd, tmd = mesh_pair(12, nt=13)
    jp, tp = turning_pair()
    kw = dict(reassemble_every=4, time_scheme_order=order, tol=1e-12,
              maxiter=500)
    want = jsolve(jp, jmd, **kw)
    got = solve_time_varying(tp, tmd, **kw)
    assert got.shape == want.shape == (13, tmd.number_of_segments)
    assert rel_diff(got, want) <= 1e-9
    last = solve_time_varying(tp, tmd, store_solutions=False, **kw)
    assert float((last[0] - got[-1]).abs().max()) <= 1e-12


class _FrozenHooks(tapt.TurningWindProblem):
    """time_varying, but the hooks ignore t: any chunking must give the
    constant-wind trajectory."""

    def velocity_at(self, xy, t=None):
        v = torch.tensor([1.0, 0.5], dtype=xy.dtype)
        return v.expand(xy.shape[:-1] + (2,))

    def analytical_solution(self, xyt):
        return tapt.Problem(v=(1.0, 0.5), D=self.D,
                            sigma=self.sigma).analytical_solution(xyt)


def test_chunking_is_exact_on_frozen_hooks():
    _, tmd = mesh_pair(12, nt=13)
    p = _FrozenHooks(D=0.1)
    kw = dict(tol=1e-12, maxiter=500)
    a = solve_time_varying(p, tmd, reassemble_every=12, **kw)
    b = solve_time_varying(p, tmd, reassemble_every=1, **kw)
    assert float((a - b).abs().max()) <= 1e-9
    const = CRBESolver(tapt.Domain(), tapt.Problem(v=(1.0, 0.5), D=0.1),
                       tmd, solver_tol=1e-12, solver_maxiter=500,
                       matvec_impl="ell", device="cpu")
    c = const.solve(store_solutions=True)
    assert float((a - c).abs().max()) <= 1e-9


@pytest.mark.parametrize("case", ["plain", "flux_obstacle"])
def test_fused_chunks_match_jax_scan_chunks(case):
    """The fused chunks (B4's plain version with its load plane, a fresh
    stack per chunk) against the JAX scan-Chebyshev chunks at the same k,
    within 1e-5 of max|u| (the JAX test's bound: the intervals come from
    two matvec layouts); then with Robin walls, an inhomogeneous flux and
    an obstacle, whose dead DOFs stay exactly 0 and whose flux moves the
    answer."""
    jmd, tmd = mesh_pair(12, nt=13)
    jp, tp = turning_pair("flux" if case != "plain" else "plain")
    for p in (jp, tp):
        if case != "plain":
            p.obstacles = ((-5.0, -1.0, -3.0, 3.0),)
    want = jsolve(jp, jmd, solver="chebyshev", **FUSED_KW)
    got = solve_time_varying(tp, tmd, matvec_impl="fused_hbm", **FUSED_KW)
    assert float(np.abs(np.asarray(want)).max()) > 1e-4
    assert rel_diff(got, want) <= 1e-5
    if case != "plain":
        _, dead = obstacle_masks(tmd, tp)
        assert int(dead.sum()) > 0
        assert float(got[0][dead].abs().max()) == 0.0
        _, t0 = turning_pair("robin_obstacle")
        no_flux = solve_time_varying(t0, tmd, matvec_impl="fused_hbm",
                                     **FUSED_KW)
        assert rel_diff(no_flux, got.numpy()) > 1e-3


def test_canvas_interval_takes_the_explicit_transpose():
    """fused_hbm.canvas_interval (power_bounds over the stencil matvec and
    the matvec over the transposed grids, B3 on the card) against
    power_bounds with the autograd transpose, at 1e-12; the slot-free
    family pattern refuses an ELL extraction."""
    _, tmd = mesh_pair(12, nt=13)
    coeffs, _, diag = tcrbe.assemble_canvas(tmd, turning_pair()[1], 0.5, 2,
                                            coeff_time=1.0)
    pattern = tstencil.family_pattern(tmd)
    got = fused_hbm.canvas_interval(pattern, coeffs, diag)
    want = tlinalg.power_bounds(
        lambda x: tstencil.stencil_matvec(pattern, coeffs, x),
        torch.zeros_like(diag), scale=1.0 / torch.sqrt(diag))
    for g, w in zip(got, want):
        assert abs(g - float(w)) <= 1e-12 * abs(float(w))
    with pytest.raises(ValueError, match="slot grids"):
        tstencil.extract_coefficients(pattern, torch.zeros(4, dtype=F64))


def test_frozen_bounds_match_reestimated():
    """reestimate_bounds=False (one mid-horizon interval, widened 10%)
    against the per-chunk estimate, within 1e-6 of max|u| (k = 12)."""
    _, tmd = mesh_pair(12, nt=13)
    _, tp = turning_pair()
    kw = dict(FUSED_KW, chebyshev_iters=12, matvec_impl="fused_hbm")
    ref = solve_time_varying(tp, tmd, **kw)
    frozen = solve_time_varying(tp, tmd, reestimate_bounds=False, **kw)
    assert float(ref.abs().max()) > 1e-4
    assert rel_diff(frozen, ref.numpy()) <= 1e-6


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_gradient_wrt_turning_rate(monkeypatch, route):
    """d/d omega_t of sum(u_T^2) through every chunk (CN, Chebyshev-8,
    extrapolated) against jax.grad, at 1e-8 relative: the scan route
    against JAX's, and the differentiable fused chunks (B4's raw mode,
    plain) against JAX's (its raw_b kernel replaced by the same
    polynomial); the fused primal equals the forward fused chunks. The
    BiCGStab adjoint of the scan chunks is test_unsteady.py's (JAX) and
    tests/test_torch_port_inverse.py's loop."""
    jmd, tmd = mesh_pair(8, nt=9)
    kw = dict(reassemble_every=4, time_scheme_order=2, chebyshev_iters=8,
              extrapolate_warm_start=True, store_solutions=False)
    if route == "scan":
        kw.update(solver="chebyshev")
    else:
        monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm",
                            jax_plain_raw)
        kw.update(matvec_impl="fused_hbm")

    def jloss(om):
        p = japt.TurningWindProblem(speed=1.0, omega_t=om, D=0.1)
        sols = jsolve(p, jmd, differentiable=True, **kw)
        return jnp.sum(sols[-1] ** 2)

    jg = float(jax.grad(jloss)(jnp.asarray(0.4)))
    om = torch.tensor(0.4, dtype=F64, requires_grad=True)
    p = tapt.TurningWindProblem(speed=1.0, omega_t=om, D=0.1)
    sols = solve_time_varying(p, tmd, differentiable=True, **kw)
    (g,) = torch.autograd.grad((sols[-1] ** 2).sum(), om)
    assert abs(float(g) - jg) <= 1e-8 * abs(jg)
    if route == "fused":
        fwd = solve_time_varying(tapt.TurningWindProblem(
            speed=1.0, omega_t=0.4, D=0.1), tmd, **kw)
        assert rel_diff(sols.detach(), fwd.numpy()) <= 1e-12


@pytest.mark.parametrize("case", ["plain", "flux_obstacle"])
def test_blocks_equal_serial_fused_chunks(case):
    """solve_time_varying(mesh=...) on 4 row blocks (B9's plain version,
    the stack rebuilt at each chunk's coeff_time) against the serial fused
    chunks, at 1e-12."""
    _, tmd = mesh_pair(33, nt=13)
    _, tp = turning_pair("flux" if case != "plain" else "plain")
    if case != "plain":
        tp.obstacles = ((-5.0, -1.0, -3.0, 3.0),)
    kw = dict(FUSED_KW, matvec_impl="fused_hbm")
    want = solve_time_varying(tp, tmd, **kw)
    got = solve_time_varying(tp, tmd, mesh=make_mesh({"mp": 4}, device="cpu"),
                             **kw)
    assert got.shape == want.shape == (1, tmd.number_of_segments)
    assert rel_diff(got, want.numpy()) <= 1e-12


def _solve_err(**kw):
    _, tmd = mesh_pair(8, nt=5)
    problem = kw.pop("problem", tapt.TurningWindProblem())
    return solve_time_varying(problem, tmd, **kw)


class _GOnly(tapt.TurningWindProblem):
    robin_sides = {"bottom": 0.1}

    def robin_g(self, xy, t, side):
        return torch.ones(xy.shape[0], dtype=xy.dtype)


@pytest.mark.parametrize("call,match", [
    (lambda: _solve_err(reassemble_every=2, matvec_impl="fused_hbm"),
     "final-state-only"),
    (lambda: _solve_err(reassemble_every=2, matvec_impl="fused_hbm",
                        store_solutions=False, differentiable=True,
                        mesh=make_mesh({"mp": 2}, device="cpu")),
     "not differentiable"),
    (lambda: _solve_err(reassemble_every=2, store_solutions=False,
                        mesh=make_mesh({"mp": 2}, device="cpu")),
     "fused_hbm"),
    (lambda: _solve_err(reassemble_every=3), "divisor"),
    (lambda: _solve_err(reassemble_every=2, problem=tapt.Problem()),
     "time_varying"),
    (lambda: _solve_err(reassemble_every=2, matvec_impl="ell"),
     "matvec_impl"),
    (lambda: _solve_err(reassemble_every=2, problem=_GOnly(),
                        matvec_impl="fused_hbm", store_solutions=False),
     "robin_g"),
    (lambda: CRBESolver(tapt.Domain(), tapt.TurningWindProblem(),
                        mesh_pair(8, nt=5)[1], device="cpu"), "unsteady"),
    (lambda: tcrbe.assemble(mesh_pair(8, nt=5)[1],
                            tapt.TurningWindProblem(), 0.1, 1), "coeff_time"),
    (lambda: tcrbe.assemble_canvas(mesh_pair(8, nt=5)[1],
                                   tapt.TurningWindProblem(), 0.1, 1),
     "coeff_time"),
], ids=["fused-rows", "mesh-adjoint", "mesh-scan", "not-divisor", "steady",
        "unknown-impl", "robin_g-fused", "crbe-solver", "assemble",
        "assemble_canvas"])
def test_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_pinn_loss_on_the_turning_wind():
    """The composite loss and its gradient on TurningWindProblem (the
    residual samples the wind at each point's own t) against JAX's, on
    carried parameters and points, at 1e-12."""
    jp, tp = turning_pair()
    params = np_params([3, 8, 8, 1], seed=11)
    pde, ic, bc = points(64, 12), points(32, 13), boundary_points(40, 14)
    ic[:, 2] = 0.0
    ic_t = np.asarray(jp.initial_condition_fn(jnp.asarray(ic[:, :2])))
    bc_t = np.asarray(jp.boundary_fn(jnp.asarray(bc)))
    lam = {"pde": 2.0, "ic": 10.0, "bc": 5.0}
    arrays = (pde, ic, ic_t.reshape(-1, 1), bc, bc_t.reshape(-1, 1))

    def jloss(p):
        return jpinn.composite_loss(p, jp, *map(jnp.asarray, arrays), lam,
                                    None, "adaptive_tanh", t_final=10.0)

    (jtotal, jaux), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax_params(params))
    mlp = port_mlp(params)
    total, aux = tpinn.composite_loss(mlp, tp, *map(torch.tensor, arrays),
                                      lam, None, t_final=10.0)
    for got, want in zip((total,) + tuple(aux), (jtotal,) + tuple(jaux)):
        assert abs(float(got.detach()) - float(want)) <= 1e-12 * abs(
            float(want))
    (g,) = torch.autograd.grad(total, mlp.flat)
    assert tree_rel(mlp.params_tree(g), jgrad) <= 1e-12
