"""The port's anisotropic plume, shifted plume, exact_robin_g and
fit_anisotropic_diffusion against the JAX package's, and the anisotropic
plume on the port's uniform fused routes against its scan route; on the
CPU in float64 from the same scalars and numpy inputs. The JAX side runs
jitted where its eager first call would cost seconds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.models import crbe as jcrbe  # noqa: E402
from airpollution_tpu.problems import exact_robin_g as j_exact_robin_g  # noqa: E402,E501

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.models import crbe as tcrbe  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.ops import autodiff as tad  # noqa: E402
from airpollution_tpu_torch.problems import exact_robin_g  # noqa: E402

from torch_port_helpers import mesh_pair, rel_diff  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
ANISO = dict(v=(1.0, 0.5), Dx=0.2, Dy=0.02, sigma=1.5)
X = np.array([[1.0, 2.0, 3.0], [0.5, -1.0, 7.0], [2.0, 1.0, 0.4],
              [-3.0, 4.0, 9.5], [0.0, 0.0, 0.0]])


@pytest.mark.parametrize("order,reaction", [(1, 0.0), (2, 0.15)])
def test_anisotropic_plume_and_assembly_match_jax(order, reaction):
    """The closed form, its initial condition and the assembled operator
    (the tensor weak form, with reaction) against JAX's at 1e-12; the
    closed form solves the tensor PDE (the port's Hessian contraction);
    Dx and Dy stay differentiable."""
    jp = japt.AnisotropicPlumeProblem(reaction=reaction, **ANISO)
    Dx = torch.tensor(ANISO["Dx"], dtype=F64, requires_grad=True)
    tp = tapt.AnisotropicPlumeProblem(
        v=ANISO["v"], Dx=Dx, Dy=ANISO["Dy"], sigma=ANISO["sigma"],
        reaction=reaction)
    assert tp.D.shape == (2, 2) and tp.D.dtype == F64
    jc, jic = jax.jit(lambda p, q: (p.analytical_solution(q),
                                    p.initial_condition_fn(q[:, :2])))(
        jp, jnp.asarray(X))
    tx = torch.tensor(X)
    assert rel_diff(tp.analytical_solution(tx), jc) <= 1e-12
    assert rel_diff(tp.initial_condition_fn(tx[:, :2]), jic) <= 1e-12
    res = tad.problem_pde_residual(tp.analytical_solution, tx[:4], tp,
                                   torch.zeros(4, dtype=F64),
                                   reaction=reaction)
    assert float(res.detach().abs().max()) <= 1e-12
    jmd, tmd = mesh_pair(9)
    want = jax.jit(lambda p: jcrbe.assemble(jmd, p, 0.5, order))(jp)
    got = tcrbe.assemble(tmd, tp, 0.5, order)
    for name in ("mass_diag", "system_diag"):
        assert rel_diff(getattr(got, name), getattr(want, name)) <= 1e-12
    assert rel_diff(got.system.vals, want.system.vals) <= 1e-12
    (g,) = torch.autograd.grad((got.system.vals ** 2).sum(), Dx)
    assert float(g) != 0.0


@pytest.mark.parametrize("impl,kernel", [("fused", "B1"),
                                         ("fused_hbm", "B2")])
def test_anisotropic_plume_on_the_uniform_routes(impl, kernel):
    """A constant tensor keeps the operator translation-invariant: the
    uniform fused routes (B1, B2 plain; full and patch assembly) give the
    stencil scan's Chebyshev solve."""
    domain = tapt.Domain()
    p = tapt.AnisotropicPlumeProblem(Dx=0.2, Dy=0.02)
    md = tapt.MeshData(tapt.create_mesh(17, 20.0), domain, nt=21,
                       dtype=F64, device="cpu")
    kw = dict(time_scheme_order=2, solver_method="chebyshev",
              chebyshev_iters=8, extrapolate_warm_start=True, device="cpu")
    scan = CRBESolver(domain, p, md, matvec_impl="stencil", **kw)
    want = scan.solve(store_solutions=False)
    for assembly in ("full", "patch"):
        s = CRBESolver(domain, p, md, matvec_impl=impl, assembly=assembly,
                       **kw)
        got = s.solve(store_solutions=False)
        assert s.fused_kernel == kernel
        assert rel_diff(got, want.numpy()) <= 1e-10


ROBIN = {"left": 0.1, "right": 0.0, "bottom": 0.3, "top": 0.05}


def _robin_problem(base, D):
    p = base(v=(0.7, -0.4), D=D, sigma=2.0)
    p.robin_sides = dict(ROBIN)
    return p


@pytest.mark.parametrize("per_point", [False, True],
                         ids=["scalar_t", "per_point_t"])
def test_exact_robin_g_matches_jax(per_point):
    """g = alpha c + D dc/dn on each side against JAX's, at one time or at
    each point's own; with D a tensor parameter, d sum(g) / dD (through
    the normal derivative's graph) equals jax.grad's."""
    rng = np.random.default_rng(5)
    ys = rng.uniform(-20.0, 20.0, 6)
    walls = {"left": (-20.0, None), "right": (20.0, None),
             "bottom": (None, -20.0), "top": (None, 20.0)}
    t = rng.uniform(0.0, 10.0, 6) if per_point else 2.5
    xys = {side: np.stack([np.full(6, x0) if x0 is not None else ys,
                           np.full(6, y0) if y0 is not None else ys], axis=1)
           for side, (x0, y0) in walls.items()}

    def jg(D, side, xy):
        return j_exact_robin_g(_robin_problem(japt.Problem, D), xy,
                               jnp.asarray(t), side)

    @jax.jit
    def jax_sides(D, qs):
        return {s: (jg(D, s, q), jax.grad(lambda d: jnp.sum(jg(d, s, q)))(D))
                for s, q in qs.items()}

    want = jax_sides(jnp.asarray(0.3),
                     {s: jnp.asarray(q) for s, q in xys.items()})
    for side, xy in xys.items():
        D = torch.tensor(0.3, dtype=F64, requires_grad=True)
        got = exact_robin_g(_robin_problem(tapt.Problem, D),
                            torch.tensor(xy),
                            torch.tensor(t) if per_point else t, side)
        assert rel_diff(got, want[side][0]) <= 1e-12
        (g,) = torch.autograd.grad(got.sum(), D)
        jgrad = float(want[side][1])
        assert abs(float(g) - jgrad) <= 1e-12 * max(abs(jgrad), 1e-12)


def test_shifted_plume_matches_jax():
    """The plume released at (cx, cy): closed form, initial condition and
    d/d cx against JAX's at 1e-12."""
    kw = dict(v=(0.8, -0.3), D=0.2, sigma=1.2)
    jp = japt.ShiftedPlumeProblem(center=(3.0, -2.0), **kw)
    cx = torch.tensor(3.0, dtype=F64, requires_grad=True)
    tp = tapt.ShiftedPlumeProblem(center=(cx, -2.0), **kw)
    tx = torch.tensor(X)

    def jsum(c):
        return jnp.sum(japt.ShiftedPlumeProblem(
            center=(c, -2.0), **kw).analytical_solution(jnp.asarray(X)))

    jc, jgrad = jax.jit(jax.value_and_grad(jsum))(jnp.asarray(3.0))
    got = tp.analytical_solution(tx)
    assert abs(float(got.detach().sum()) - float(jc)) <= 1e-12 * abs(
        float(jc))
    assert rel_diff(tp.initial_condition_fn(tx[:, :2]),
                    jp.initial_condition_fn(jnp.asarray(X[:, :2]))) <= 1e-12
    (g,) = torch.autograd.grad(got.sum(), cx)
    assert abs(float(g) - float(jgrad)) <= 1e-12 * abs(float(jgrad))


def test_fit_anisotropic_diffusion_adam_steps_match_jax():
    """Three Adam steps of fit_anisotropic_diffusion (snapshots, scan
    engine) from the same observations (the port's solve, as numpy):
    losses and (Dx, Dy) equal JAX's (optax.adam)."""
    jmd, tmd = mesh_pair(9, nt=9)
    idx = [2, 4, 8]
    kw = dict(engine="scan", tol=1e-10, maxiter=500)
    obs = tinv.solve_snapshots(tapt.AnisotropicPlumeProblem(Dx=0.3, Dy=0.05),
                               tmd, indices=idx, **kw).numpy()
    kw.update(snapshot_indices=idx, Dx0=0.1, Dy0=0.1, steps=3, lr=0.08)
    jres, jlosses = jinv.fit_anisotropic_diffusion(jnp.asarray(obs), jmd,
                                                   **kw)
    tres, tlosses = tinv.fit_anisotropic_diffusion(obs, tmd, **kw)
    assert len(tlosses) == 3 and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    for key in ("Dx", "Dy"):
        assert abs(tres[key] - jres[key]) <= 1e-7 * jres[key], key
