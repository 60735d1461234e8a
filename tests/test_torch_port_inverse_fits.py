"""The rest of the port's inverse layer against the JAX package's, in
float64 from the same numpy-seeded inputs: nested parameter trees in
``fit_parameters`` and ``posterior_covariance``, ``fit_wind`` (with its
``omega_grid`` search), ``fit_initial_condition`` (4D-Var) and
``receptor_footprint``; and the fused engine's interval, estimated once
per fit while the operator carries no gradient."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.ops import pallas_hbm as jhbm  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.ops import linalg as tlinalg  # noqa: E402

from torch_port_helpers import (  # noqa: E402,F401 (autouse fixture)
    jax_plain_raw,
    mesh_pair,
    one_torch_thread,
    rel_diff,
)

F64 = torch.float64
SCAN = dict(engine="scan", tol=1e-12, maxiter=500)


def _source_obs(jmd, idx, sens):
    truth = jinv.solve_snapshots(
        japt.GaussianSourceProblem(q=2.0, xs=-1.0, ys=1.5, sigma_s=3.0), jmd,
        indices=idx, **SCAN)
    return np.asarray(truth)[:, sens]


def _nested_source(lib):
    cls = (japt.GaussianSourceProblem if lib == "jax"
           else tapt.GaussianSourceProblem)
    exp = jnp.exp if lib == "jax" else torch.exp

    def make_problem(p):
        return cls(q=exp(p["src"]["log_q"]), xs=p["src"]["xs"],
                   ys=p["loc"][0], sigma_s=3.0)
    return make_problem


def test_nested_parameter_trees_match_jax():
    """A nested {"src": {"log_q", "xs"}, "loc": [ys]} tree: three Adam
    steps of fit_parameters (losses and parameters within 1e-9 relative,
    the same nesting back) and the posterior (labels in ravel_pytree
    order, covariance within 1e-8)."""
    jmd, tmd = mesh_pair(9, nt=9)
    idx = [3, 6, 8]
    sens = list(range(0, jmd.number_of_segments, 7))
    obs = _source_obs(jmd, idx, sens)
    init = {"src": {"xs": np.asarray(0.0), "log_q": np.asarray(np.log(0.5))},
            "loc": [np.asarray(0.5)]}
    kw = dict(snapshot_indices=idx, sensor_indices=sens, steps=3, lr=0.1,
              **SCAN)
    jp, jl = jinv.fit_parameters(obs, jmd, _nested_source("jax"),
                                 jax.tree.map(jnp.asarray, init), **kw)
    tp, tl = tinv.fit_parameters(obs, tmd, _nested_source("torch"), init,
                                 **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert set(tp) == {"src", "loc"} and set(tp["src"]) == {"log_q", "xs"}
    assert isinstance(tp["loc"], list) and len(tp["loc"]) == 1
    for got, want in ((tp["src"]["log_q"], jp["src"]["log_q"]),
                      (tp["src"]["xs"], jp["src"]["xs"]),
                      (tp["loc"][0], jp["loc"][0])):
        assert float(got) == pytest.approx(float(want), rel=1e-9)
    pkw = dict(snapshot_indices=idx, sensor_indices=sens, observed=obs,
               tol=1e-12, maxiter=500)
    juq = jinv.posterior_covariance(jmd, _nested_source("jax"), jp, **pkw)
    tuq = tinv.posterior_covariance(tmd, _nested_source("torch"), tp, **pkw)
    assert tuq["labels"] == juq["labels"]
    assert "src.log_q" in tuq["labels"]
    assert rel_diff(tuq["cov"], juq["cov"]) <= 1e-8


def _rotating(lib, **kw):
    cls = (japt.RotatingPlumeProblem if lib == "jax"
           else tapt.RotatingPlumeProblem)
    return cls(sigma=1.5, x0=5.0, y0=0.0, **kw)


@pytest.mark.parametrize("engine", ["scan", "fused_hbm"])
def test_wind_gradient_matches_jax(monkeypatch, engine):
    """The snapshots and d sum(u^2)/d(omega, D) of the rotating plume, the
    wind entering the per-DOF stencil (through B4's raw mode over its
    canvases on the fused engine): within 1e-9 / 1e-7 of JAX's."""
    monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm", jax_plain_raw)
    jmd, tmd = mesh_pair(9, nt=9)
    kw = SCAN if engine == "scan" else dict(engine=engine,
                                            chebyshev_iters=24)
    idx = [2, 5, 8]

    def jloss(th):
        u = jinv.solve_snapshots(_rotating("jax", omega=th[0], D=th[1]),
                                 jmd, indices=idx, **kw)
        return jnp.sum(u ** 2), u

    (_, ju), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray([0.12, 0.08]))
    th = torch.tensor([0.12, 0.08], dtype=F64, requires_grad=True)
    u = tinv.solve_snapshots(_rotating("torch", omega=th[0], D=th[1]), tmd,
                             indices=idx, **kw)
    (g,) = torch.autograd.grad(torch.sum(u ** 2), th)
    assert rel_diff(u, ju) <= 1e-9
    assert rel_diff(g, jg) <= 1e-7


def test_fit_wind_with_grid_matches_jax():
    """fit_wind with ``omega_grid`` and ``fit_diffusion`` at the JAX
    tests' size (8^2, nt=9, truth omega 0.2, D 0.08): the grid's pick,
    three Adam steps' losses and the fitted (omega, D) within 1e-9."""
    jmd, tmd = mesh_pair(8, nt=9)
    idx = [2, 4, 6, 8]
    obs = np.asarray(jinv.solve_snapshots(
        _rotating("jax", omega=0.2, D=0.08), jmd, indices=idx, tol=1e-12,
        maxiter=500))
    kw = dict(snapshot_indices=idx, omega0=0.05, D=0.05, fit_diffusion=True,
              steps=3, lr=0.02, tol=1e-12, maxiter=500, sigma=1.5, x0=5.0,
              y0=0.0, omega_grid=[0.01, 0.1, 0.2, 0.3])
    jres, jl = jinv.fit_wind(obs, jmd, **kw)
    tres, tl = tinv.fit_wind(obs, tmd, **kw)
    assert tres["omega0"] == jres["omega0"] == 0.2
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    for key in ("omega", "D"):
        assert tres[key] == pytest.approx(jres[key], rel=1e-9), key
    tres, tl = tinv.fit_wind(obs, tmd, **dict(kw, omega_grid=None,
                                              fit_diffusion=False))
    assert set(tres) == {"omega"} and len(tl) == 3


@pytest.mark.parametrize("case", ["plain", "nonnegative_sensors",
                                  "u0_init_fused"])
def test_fit_initial_condition_matches_jax(monkeypatch, case):
    """Three Adam steps of 4D-Var at 8^2, nt=8 (the JAX tests' problem):
    the field within 1e-9 and the losses within 1e-9 relative; the
    softplus field with a sensor network; a first guess on the fused
    engine."""
    monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm", jax_plain_raw)
    jmd, tmd = mesh_pair(8, nt=8)
    jprob = japt.Problem(v=(1.0, 0.5), D=0.1, sigma=2.0)
    tprob = tapt.Problem(v=(1.0, 0.5), D=0.1, sigma=2.0)
    idx = [1, 3, 7]
    obs = np.asarray(jinv.solve_snapshots(jprob, jmd, indices=idx))
    kw = dict(snapshot_indices=idx, steps=3, lr=0.05, smoothness=1e-3)
    if case == "nonnegative_sensors":
        sens = list(range(0, jmd.number_of_segments, 3))
        obs = obs[:, sens]
        kw.update(sensor_indices=sens, nonnegative=True, lr=0.1)
    elif case == "u0_init_fused":
        rng = np.random.default_rng(3)
        kw.update(u0_init=0.1 * np.abs(rng.standard_normal(
            jmd.number_of_segments)), nonnegative=True, engine="fused_hbm",
            chebyshev_iters=24)
    ju, jl = jinv.fit_initial_condition(obs, jmd, jprob, **kw)
    tu, tl = tinv.fit_initial_condition(obs, tmd, tprob, **kw)
    assert tu.shape == (tmd.number_of_segments,) and not tu.requires_grad
    assert rel_diff(tu, ju) <= 1e-9
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    if kw.get("nonnegative"):
        assert bool((tu >= 0).all())


def test_fit_initial_condition_requires_snapshots():
    _, tmd = mesh_pair(6, nt=6)
    with pytest.raises(ValueError, match="snapshot_indices"):
        tinv.fit_initial_condition(np.zeros((0, 1)), tmd, tapt.Problem(),
                                   snapshot_indices=[])


def test_fused_interval_is_estimated_once_per_fit(monkeypatch):
    """While the operator carries no gradient (fit_source's parameters
    enter only the load) the fused engine's interval is estimated once
    per fit, and every step's loss is bitwise what a fresh estimate per
    step gives; with an operator parameter (D) it is estimated in every
    step."""
    _, tmd = mesh_pair(9, nt=9)
    idx = [3, 6, 8]
    obs = tinv.solve_snapshots(tapt.GaussianSourceProblem(
        q=2.0, xs=-1.0, ys=1.5, sigma_s=3.0), tmd, indices=idx).detach()
    calls = []
    real = tlinalg.power_bounds

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tlinalg, "power_bounds", spy)
    kw = dict(snapshot_indices=idx, sigma_s=3.0, q0=0.5, steps=3, lr=0.1,
              engine="fused_hbm", chebyshev_iters=16)
    _, once = tinv.fit_source(obs, tmd, **kw)
    assert len(calls) == 1
    monkeypatch.setattr(tinv, "_cached_interval", lambda *a: None)
    calls.clear()
    _, fresh = tinv.fit_source(obs, tmd, **kw)
    assert len(calls) == 3 and once == fresh
    monkeypatch.undo()
    monkeypatch.setattr(tlinalg, "power_bounds", spy)
    calls.clear()
    tinv.fit_diffusion(obs[-1], tmd, D0=0.2, v=(1.0, 0.5), steps=2,
                       engine="fused_hbm", chebyshev_iters=16)
    assert len(calls) == 2


@pytest.mark.parametrize("robin", [False, True])
def test_receptor_footprint_matches_jax(robin):
    """The footprint map F[r, j] = d c(x_r, T)/d s_j at the JAX test's
    size (8^2, nt=9, Domain(T=2)), with and without a Robin wall: within
    1e-9 of the JAX function's (jacrev of its loop)."""
    jdom, tdom = japt.Domain(T=2.0), tapt.Domain(T=2.0)
    jmd = japt.MeshData(japt.create_mesh(8, 20.0), jdom, nt=9,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(8, 20.0), tdom, nt=9, dtype=F64,
                        device="cpu")
    jp = japt.Problem(v=(1.0, 0.5), D=0.2)
    tp = tapt.Problem(v=(1.0, 0.5), D=0.2)
    if robin:
        jp.robin_sides = tp.robin_sides = {"right": 0.4}
    rec = [int(jmd.number_of_segments // 2), 7, 30]
    F_j = np.asarray(jinv.receptor_footprint(jmd, jdom, jp, rec))
    F_t = tinv.receptor_footprint(tmd, tdom, tp, rec)
    assert F_t.shape == (3, tmd.number_of_segments)
    assert not F_t.requires_grad
    assert rel_diff(F_t, F_j) <= 1e-9


class _CardState:
    """A stand-in for a state tensor on the card (checkpoint_steps reads
    its device, size and item size only)."""

    def __init__(self, n):
        self.device = torch.device("cuda")
        self._n = n

    def numel(self):
        return self._n

    def element_size(self):
        return 4


def test_checkpoint_steps_keeps_what_fits(monkeypatch):
    """On the card the differentiable loop keeps every step's saved
    tensors when nt x STEP_SAVED_VECTORS vectors fit in half the free
    memory, and checkpoints otherwise; on the CPU it always checkpoints.
    Without the checkpoint the gradients are bitwise the checkpointed ones
    (the fused engine with the wind's operator under the gradient, the
    scan engine, the multispecies loop)."""
    from airpollution_tpu_torch.models import crbe as tcrbe

    free = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *_: (free, free))
    vectors = tcrbe.STEP_SAVED_VECTORS
    n = 787_456  # I1's 513^2 mesh
    assert not tcrbe.checkpoint_steps(127, _CardState(n))
    assert tcrbe.checkpoint_steps(
        int(free // 2 // (vectors * 4 * n)) + 1, _CardState(n))
    assert tcrbe.checkpoint_steps(1, torch.zeros(3))

    _, tmd = mesh_pair(9, nt=9)
    msp = tapt.MultiSpeciesProblem((tapt.Problem(sigma=1.0),
                                    tapt.Problem(sigma=2.0)),
                                   [[0.25, 0.0], [-0.25, 0.1]])

    def grads():
        th = torch.tensor([0.12, 0.08], dtype=F64, requires_grad=True)
        u = tinv.solve_snapshots(_rotating("torch", omega=th[0], D=th[1]),
                                 tmd, indices=[2, 5, 8], engine="fused_hbm",
                                 chebyshev_iters=12)
        s = tinv.solve_snapshots(_rotating("torch", omega=th[0], D=th[1]),
                                 tmd, indices=[8], **SCAN)
        R = torch.tensor([[0.2, 0.01], [-0.2, 0.15]], dtype=F64,
                         requires_grad=True)
        c = tinv.solve_multispecies_snapshots(msp, tmd, R=R, indices=[8])
        return torch.autograd.grad(
            torch.sum(u ** 2) + torch.sum(s ** 2) + torch.sum(c ** 2),
            (th, R))

    kept = []
    monkeypatch.setattr(tcrbe, "checkpoint_steps",
                        lambda *a: kept.append(1) or False)
    from airpollution_tpu_torch.models import multispecies as tms
    monkeypatch.setattr(tms, "checkpoint_steps", tcrbe.checkpoint_steps)
    g_kept = grads()
    assert len(kept) == 3
    monkeypatch.undo()
    g_checkpointed = grads()
    for a, b in zip(g_kept, g_checkpointed):
        assert torch.equal(a, b)
