"""Ensemble forecasting, assimilation and sensor placement of the port
(``airpollution_tpu_torch/diagnostics/ensemble.py``, the member axis of
``models/crbe.run_time_loop``, ``ops/linalg.bicgstab_members``, kernel
B7's shared-column stacks) against the JAX package, float64 on the CPU.

The JAX package integrates the members as one ``vmap`` of its loop; the
port as one loop over a (K, n) state. Members agree to 1e-10 and each
member's BiCGStab iteration counts equal those of JAX's batched loop and
of the port's serial solve."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import airpollution_tpu as japt
from airpollution_tpu.diagnostics import ensemble as jens
from airpollution_tpu.models import crbe as jcrbe

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.diagnostics import ensemble as tens
from airpollution_tpu_torch.models import crbe as tcrbe
from airpollution_tpu_torch.models.multispecies import (run_multispecies_loop,
                                                        stack_operators)
from airpollution_tpu_torch.ops import gather, linalg, sparse
from airpollution_tpu_torch import parallel as tpar
from airpollution_tpu_torch.parallel import launch

import torch_port_distributed_ranks as ranks
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)
from torch_port_helpers import rel_diff

TOL = 1e-10
F64 = torch.float64
DS = (0.01, 0.1, 0.4, 2.0)  # members that converge at different counts


def _meshes(ms=8, nt=9, T=2.0):
    jd, td = japt.Domain(T=T), tapt.Domain(T=T)
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), jd, nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), td, nt=nt, dtype=F64,
                        device="cpu")
    return jd, td, jmd, tmd


_JAX_ITERS = {}


def _jax_member_iterations(jmd, problems, dt, order):
    """Per-member, per-step BiCGStab counts of the JAX ensemble's own
    program (ensemble_forecast's vmapped solve_one, collect_iters on),
    one jitted program per order."""
    if order not in _JAX_ITERS:
        def solve_one(problem, u0):
            ops = jcrbe.assemble(jmd, problem, dt, order)
            _, its = jcrbe.run_time_loop(
                ops, u0, mesh_data=jmd, problem=problem, dt=dt, order=order,
                tol=1e-7, maxiter=200, store_solutions=False,
                collect_iters=True)
            return its

        _JAX_ITERS[order] = jax.jit(jax.vmap(solve_one))
    batched = jens.stack_problems(problems)
    u0 = jax.vmap(lambda p: p.initial_condition_fn(jmd.midpoints))(batched)
    return np.asarray(_JAX_ITERS[order](batched, u0))


@pytest.mark.parametrize("order", [1, 2], ids=["BE", "CN"])
def test_members_and_iterations_match_jax(order):
    jd, td, jmd, tmd = _meshes()
    jp = [japt.Problem(v=(1.0, 0.5), D=d) for d in DS]
    tp = [tapt.Problem(v=(1.0, 0.5), D=d) for d in DS]
    want = jens.ensemble_forecast(jmd, jd, jp, order=order)
    got = tens.ensemble_forecast(tmd, td, tp, order=order)
    assert got["members"].shape == (len(DS), tmd.number_of_segments)
    np.testing.assert_allclose(got["members"].numpy(),
                               np.asarray(want["members"]), rtol=0,
                               atol=TOL)

    # The port's member loop, counts collected, against JAX's batched
    # loop and the port's serial solves.
    dt = td.T / (tmd.nt - 1)
    ops = tens.member_operators(tmd, tp, dt, order)
    batched = tens.stack_problems(tp, dtype=F64)
    sols, its = tcrbe.run_time_loop(
        ops, tens.member_initial_state(tmd, batched, len(tp)),
        mesh_data=tmd, problem=batched, dt=dt, order=order, tol=1e-7,
        maxiter=200, store_solutions=False, collect_iters=True)
    counts = torch.stack(its).T.numpy()  # (K, nt - 1)
    np.testing.assert_array_equal(
        counts, _jax_member_iterations(jmd, jp, dt, order))
    assert len({tuple(c) for c in counts}) > 1  # counts differ by member
    for k, p in enumerate(tp):
        s = tcrbe.CRBESolver(td, p, tmd, matvec_impl="ell",
                             time_scheme_order=order, device="cpu")
        ref = s.solve(store_solutions=False, collect_iters=True)[0]
        assert s.solver_iterations == counts[k].tolist()
        np.testing.assert_allclose(sols[0, k].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("order,quadrature", [
    (1, "mass_lumped"), (2, "reference")], ids=["BE-lumped", "CN-reference"])
def test_gaussian_source_forecast_matches_jax_forecast(order, quadrature):
    """Members that differ in their emitter (rate, position, width) and
    transport, held against JAX's own ensemble_forecast: the stacked
    problem's (K, 1) source columns in the member loop's load, under both
    source quadratures."""
    jd, td, jmd, tmd = _meshes()
    params = [dict(q=q, xs=xs, ys=ys, sigma_s=s, v=(1.0, vy), D=d)
              for q, xs, ys, s, vy, d in ((1.0, -2.0, 1.0, 1.5, 0.5, 0.1),
                                          (2.5, 0.0, -1.0, 2.0, 0.2, 0.3),
                                          (0.5, 3.0, 2.0, 1.0, -0.4, 0.05))]
    kw = dict(order=order, source_quadrature=quadrature)
    want = jens.ensemble_forecast(
        jmd, jd, [japt.GaussianSourceProblem(**p) for p in params], **kw)
    got = tens.ensemble_forecast(
        tmd, td, [tapt.GaussianSourceProblem(**p) for p in params], **kw)
    w = np.asarray(want["members"])
    assert float(np.abs(w).max()) > 0.0
    np.testing.assert_allclose(got["members"].numpy(), w, rtol=0, atol=TOL)


def test_square_pulse_restart_matches_jax_forecast():
    """Square-pulse members restarted from given states at t0 (the cycling
    filter's windows, scripts/da_cycling_demo.py): two windows, the second
    started from the first's members, CN, each against JAX's
    ensemble_forecast(u0_members=, t0=) from the same states."""
    jd, td, jmd, tmd = _meshes(nt=5, T=1.0)
    params = [dict(v=(1.0 + a, 0.5 - a), D=d)
              for a, d in ((0.0, 0.1), (0.3, 0.05), (-0.2, 0.2))]
    jp = [japt.SquarePulseProblem(**p) for p in params]
    tp = [tapt.SquarePulseProblem(**p) for p in params]
    rng = np.random.default_rng(3)
    X = np.abs(rng.standard_normal((len(params), tmd.number_of_segments)))
    for t0 in (0.0, 1.0):
        want = jens.ensemble_forecast(jmd, jd, jp, order=2,
                                      u0_members=jnp.asarray(X), t0=t0)
        got = tens.ensemble_forecast(tmd, td, tp, order=2,
                                     u0_members=torch.tensor(X), t0=t0)
        X = np.asarray(want["members"])
        np.testing.assert_allclose(got["members"].numpy(), X, rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["std"].numpy(),
                                   np.asarray(want["std"]), rtol=0, atol=TOL)


@pytest.mark.parametrize("order", [1, 2], ids=["BE", "CN"])
def test_member_state_refuses_chebyshev(order):
    """The member axis has BiCGStab only (the solver ensemble_forecast and
    both FNO datasets use); Chebyshev over a (K, n) state raises."""
    _, td, _, tmd = _meshes()
    tp = [tapt.Problem(v=(1.0, 0.5), D=d) for d in DS]
    dt = td.T / (tmd.nt - 1)
    batched = tens.stack_problems(tp, dtype=F64)
    with pytest.raises(ValueError, match="BiCGStab"):
        tcrbe.run_time_loop(
            tens.member_operators(tmd, tp, dt, order),
            tens.member_initial_state(tmd, batched, len(tp)), mesh_data=tmd,
            problem=batched, dt=dt, order=order, tol=1e-7, maxiter=200,
            solver="chebyshev", chebyshev_iters=6)


def test_statistics_and_exceedance():
    jd, td, jmd, tmd = _meshes()
    Ds = (0.05, 0.1, 0.2, 0.4)
    taus = (0.01, 0.05)
    want = jens.ensemble_forecast(jmd, jd, [japt.Problem(D=d) for d in Ds],
                                  thresholds=taus)
    got = tens.ensemble_forecast(tmd, td, [tapt.Problem(D=d) for d in Ds],
                                 thresholds=taus)
    assert set(got) == set(want)
    m = got["members"].numpy()
    for key in ("mean", "std"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(got["std"].numpy(), m.std(0, ddof=1),
                               rtol=1e-12, atol=1e-15)
    exc = got["exceedance"].numpy()
    assert exc.shape == (2, tmd.number_of_segments)
    for i, tau in enumerate(taus):
        np.testing.assert_array_equal(exc[i], (m > tau).mean(0))
        # JAX's bool mean rounds to float32.
        np.testing.assert_allclose(exc[i], np.asarray(want["exceedance"][i]),
                                   rtol=0, atol=1e-7)


# Three emitters: strength, place and width differ (the (K, 1) columns of
# the source) and so do the wind and the diffusivity.
SOURCE_MEMBERS = [dict(q=2.0 + k, xs=-4.0 + 2.0 * k, ys=1.0 - k,
                       sigma_s=1.5 + 0.5 * k, v=(0.5, 0.1 * k), D=0.2 + 0.1 * k)
                  for k in range(3)]


def _jax_source_members(jmd, jd):
    return jens.ensemble_forecast(
        jmd, jd, [japt.GaussianSourceProblem(**p) for p in SOURCE_MEMBERS],
        order=2, tol=1e-11)["members"]


def test_gaussian_source_members_match_jax():
    """GaussianSourceProblem members (CN, the source's trapezoid) held
    against the JAX ensemble serially; each source column is its member's
    own emitter."""
    jd, td, jmd, tmd = _meshes(T=1.0)
    ps = [tapt.GaussianSourceProblem(**p) for p in SOURCE_MEMBERS]
    b = tens.stack_problems(ps, dtype=F64)
    assert b.q.shape == b.xs.shape == b.sigma_s.shape == (3, 1)
    xyt = torch.tensor([[-4.0, 1.0, 0.5], [0.0, -1.0, 0.5]], dtype=F64)
    np.testing.assert_allclose(
        b.source_term(xyt).numpy(),
        [p.source_term(xyt).numpy() for p in ps],
        rtol=1e-15)
    got = tens.ensemble_forecast(tmd, td, ps, order=2, tol=1e-11)
    want = _jax_source_members(jmd, jd)
    assert np.abs(np.asarray(want)).max() > 0
    assert rel_diff(got["members"], want) <= TOL


def test_gaussian_source_members_on_two_ranks_match_jax(tmp_path):
    """The same members sharded over a 'trial' mesh of 2 gloo ranks
    (three members padded to four): every rank's members against JAX."""
    jd, _, jmd, _ = _meshes(T=1.0)
    launch.spawn(ranks.gaussian_source_members, 2, backend="gloo",
                 args=(str(tmp_path), SOURCE_MEMBERS), timeout_s=120)
    want = _jax_source_members(jmd, jd)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}_members.npy")
        assert got.shape == want.shape
        assert rel_diff(got, want) <= TOL


def test_identical_and_single_members():
    _, td, _, tmd = _meshes()
    out = tens.ensemble_forecast(tmd, td, [tapt.Problem(D=0.1)] * 3)
    assert float(out["std"].abs().max()) <= 1e-15
    assert torch.equal(out["members"][0], out["members"][2])
    one = tens.ensemble_forecast(tmd, td, [tapt.Problem(D=0.1)])
    assert torch.equal(one["std"], torch.zeros_like(one["std"]))
    assert "exceedance" not in one


def test_restart_matches_one_serial_solve():
    """u0_members and t0: two chained windows give one serial solve over
    the whole horizon (square pulses, the JAX test's members)."""
    dom_w = tapt.Domain(T=1.0)
    md_w = tapt.MeshData(tapt.create_mesh(8, 20.0), dom_w, nt=5, dtype=F64,
                         device="cpu")
    probs = [tapt.SquarePulseProblem(v=(1.0, 0.3), D=0.1),
             tapt.SquarePulseProblem(v=(0.8, 0.5), D=0.2)]
    out1 = tens.ensemble_forecast(md_w, dom_w, probs)
    out2 = tens.ensemble_forecast(md_w, dom_w, probs,
                                  u0_members=out1["members"], t0=1.0)
    dom_f = tapt.Domain(T=2.0)
    md_f = tapt.MeshData(tapt.create_mesh(8, 20.0), dom_f, nt=9, dtype=F64,
                         device="cpu")
    jdom = japt.Domain(T=2.0)
    jmd = japt.MeshData(japt.create_mesh(8, 20.0), jdom, nt=9,
                        dtype=jnp.float64)
    jw = jens.ensemble_forecast(
        jmd, jdom, [japt.SquarePulseProblem(v=(1.0, 0.3), D=0.1),
                    japt.SquarePulseProblem(v=(0.8, 0.5), D=0.2)])
    for k, p in enumerate(probs):
        s = tcrbe.CRBESolver(dom_f, p, md_f, matvec_impl="ell",
                             device="cpu")
        ref = s.solve(store_solutions=False)[0]
        np.testing.assert_allclose(out2["members"][k].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(out2["members"][k].numpy(),
                                   np.asarray(jw["members"][k]), rtol=0,
                                   atol=TOL)


class _Reads:
    """Counts host reads of tensors (bool, float, int, item, tolist)."""

    NAMES = ("__bool__", "__float__", "__int__", "item", "tolist")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **kw):
                self.n += 1
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)


def test_member_bicgstab_stops_each_member_on_its_own(monkeypatch):
    """The member-batched BiCGStab on K systems whose members converge at
    different iterations: each member's x and count equal its serial
    solve's, a member that reached maxiter stops there, and the loop reads
    the host once per iteration (plus the check that ends it)."""
    rng = np.random.default_rng(3)
    K, n = 4, 40
    mats, rhs = [], []
    for k in range(K):
        a = rng.standard_normal((n, n)) * (0.02 + 0.12 * k)
        mats.append(torch.tensor(np.eye(n) * (1.0 + k) + a))
        rhs.append(torch.tensor(rng.standard_normal(n)))
    A, B = torch.stack(mats), torch.stack(rhs)
    diag = torch.diagonal(A, dim1=1, dim2=2)

    def matvec(X):
        return torch.einsum("kij,kj->ki", A, X)

    kw = dict(tol=1e-11, maxiter=200,
              precond=linalg.jacobi_preconditioner(diag))
    reads = _Reads(monkeypatch)
    res = linalg.bicgstab_members(matvec, B, **kw)
    n_reads = reads.n
    monkeypatch.undo()
    counts = res.iterations.tolist()
    assert len(set(counts)) > 1
    assert n_reads == max(counts) + 1
    for k in range(K):
        one = linalg.bicgstab(lambda x, k=k: A[k] @ x, B[k], tol=1e-11,
                              maxiter=200,
                              precond=linalg.jacobi_preconditioner(diag[k]))
        assert one.iterations == counts[k]
        np.testing.assert_allclose(res.x[k].numpy(), one.x.numpy(), rtol=0,
                                   atol=1e-13)
    capped = linalg.bicgstab_members(matvec, B, tol=1e-11, maxiter=3,
                                     precond=kw["precond"])
    assert capped.iterations.tolist() == [min(c, 3) for c in counts]


def test_errors_match_jax():
    jd, td, jmd, tmd = _meshes(ms=6, nt=3, T=1.0)
    for pkg, dom, md in ((japt, jd, jmd), (tapt, td, tmd)):
        ef = (jens if pkg is japt else tens).ensemble_forecast
        with pytest.raises(ValueError, match="share a problem class"):
            ef(md, dom, [pkg.Problem(), pkg.SquarePulseProblem()])
        with pytest.raises(ValueError, match="empty"):
            ef(md, dom, [])
        with pytest.raises(ValueError, match="u0_members"):
            ef(md, dom, [pkg.Problem(D=0.1), pkg.Problem(D=0.2)],
               u0_members=np.zeros((3, md.number_of_segments)))
        walled = pkg.Problem()
        walled.robin_sides = {"right": 0.5}
        with pytest.raises(ValueError, match="Robin boundaries"):
            ef(md, dom, [walled, walled])
    # A mesh shards the members (a one-rank gloo 'trial' mesh runs them
    # all on its rank); what is not a mesh raises.
    members = [tapt.Problem(D=0.1), tapt.Problem(D=0.2)]
    with launch.process_group("gloo"):
        got = tens.ensemble_forecast(tmd, td, members,
                                     mesh=tpar.make_mesh({"trial": 1}))
    want = tens.ensemble_forecast(tmd, td, members)
    assert torch.equal(got["members"], want["members"])
    with pytest.raises(TypeError):
        tens.ensemble_forecast(tmd, td, [tapt.Problem()], mesh=object())
    walled = tapt.Problem()
    walled.robin_sides = {"left": 0.1}
    with pytest.raises(ValueError, match="share a problem class"):
        tens.stack_problems([tapt.Problem(), walled])


def test_stack_problems_puts_members_first():
    """Each parameter becomes a (K, 1) column and the wind a pair of them,
    so the hooks give (K, n): ``v[0]`` is every member's x wind, never
    member 0's wind."""
    ps = [tapt.ShiftedPlumeProblem(v=(1.0 + k, 0.5 - k), D=0.1 * (k + 1),
                                   center=(k, -k)) for k in range(3)]
    b = tens.stack_problems(ps)
    assert b.D.shape == (3, 1) and b.cx.shape == (3, 1)
    assert isinstance(b.v, tuple) and b.v[0].flatten().tolist() == [1, 2, 3]
    xyt = torch.tensor(np.random.default_rng(0).uniform(-5, 5, (11, 3)))
    xyt[:, 2] = xyt[:, 2].abs()
    got = b.analytical_solution(xyt)
    assert got.shape == (3, 11)
    for k, p in enumerate(ps):
        assert torch.equal(got[k], p.analytical_solution(xyt))
    with pytest.raises(TypeError, match="MEMBER_FIELDS"):
        class Mine(tapt.Problem):
            pass
        tens.stack_problems([Mine(), Mine()])


def test_b7_shared_columns_equal_copied_columns_bitwise(monkeypatch):
    """A stack keeps one (n, w) column index: its plain product equals the
    product over K copies of the columns bit for bit, and so does a
    multispecies solve on stacked operators (the product the port made
    before the columns were shared)."""
    md = tapt.MeshData(tapt.create_mesh(7, 20.0), tapt.Domain(T=1.0), nt=5,
                       dtype=F64, device="cpu")
    ops = [tcrbe.assemble(md, tapt.Problem(D=d, v=(1.0, -0.3 * d)), 0.1, 2)
           for d in (0.05, 0.2, 0.7)]
    S = sparse.stack_ell([o.system for o in ops])
    K, (n, w) = len(ops), S.cols.shape
    assert S.cols is ops[0].system.cols and S.cols.shape == (n, w)
    X = torch.tensor(np.random.default_rng(1).standard_normal((K, n)))

    def copied(vals, cols, x):
        if vals.dim() == 3 and x.dim() == 2:
            c3 = cols.expand(vals.shape[0], n, w).contiguous()
            got = torch.gather(x, 1, c3.reshape(x.shape[0], n * w))
            return torch.sum(vals * got.reshape(vals.shape), dim=-1)
        return torch.sum(vals * x[..., cols], dim=-1)

    assert torch.equal(sparse.ell_matvec_stacked(S, X),
                       copied(S.vals, S.cols, X))
    species = [tapt.Problem(D=0.05), tapt.Problem(D=0.2, sigma=2.0)]
    msp = tapt.MultiSpeciesProblem(species, np.array([[0.2, 0.0],
                                                      [-0.2, 0.1]]))
    stacked = stack_operators([tcrbe.assemble(md, p, 0.25, 2)
                               for p in species])
    C0 = torch.stack([p.initial_condition_fn(md.midpoints)
                      for p in species])
    kw = dict(mesh_data=md, problem=msp, dt=0.25, order=2, tol=1e-12,
              maxiter=200)
    for solver in ("bicgstab", "chebyshev"):
        now, _ = run_multispecies_loop(stacked, C0, solver=solver, **kw)
        with monkeypatch.context() as m:
            m.setattr(gather, "plain_matvec", copied)
            before, _ = run_multispecies_loop(stacked, C0, solver=solver,
                                              **kw)
        assert torch.equal(now, before)


def test_enkf_update_matches_jax_on_identical_noise():
    rng = np.random.default_rng(7)
    K, n, m = 12, 40, 5
    X = rng.standard_normal((K, n))
    y = rng.standard_normal(m)
    sensors = [3, 11, 19, 27, 35]
    eps = 0.25 * rng.standard_normal((K, m))
    for inflation in (1.0, 1.15):
        want = jens._enkf_update(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(sensors), jnp.asarray(0.25),
                                 jnp.asarray(eps), jnp.asarray(inflation))
        got = tens._enkf_update(torch.tensor(X), torch.tensor(y),
                                torch.tensor(sensors), 0.25,
                                torch.tensor(eps), inflation)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    gen = torch.Generator().manual_seed(4)
    Xa = tens.enkf_update(torch.tensor(X), y, sensors, 0.25, gen)
    assert Xa.shape == (K, n) and bool(torch.isfinite(Xa).all())
    with pytest.raises(ValueError, match="must match sensor_indices"):
        tens.enkf_update(torch.tensor(X), y[:3], sensors, 0.25, gen)
    with pytest.raises(ValueError, match="at least 2"):
        tens.enkf_update(torch.tensor(X[:1]), y, sensors, 0.25, gen)


def test_place_sensors_matches_jax():
    rng = np.random.default_rng(0)
    K, n = 20, 200
    A = np.zeros((K, n))
    for loc, amp in ((10, 3.0), (50, 2.0), (120, 1.0)):
        bump = np.exp(-0.5 * ((np.arange(n) - loc) / 4.0) ** 2)
        A += amp * np.outer(rng.standard_normal(K), bump)
    X = A + 0.5
    cands = list(range(0, n, 3))
    for kw in ({}, {"candidate_indices": cands}):
        jp, jr = jens.place_sensors(jnp.asarray(X), 5, obs_std=0.05, **kw)
        tp, tr = tens.place_sensors(torch.tensor(X), 5, obs_std=0.05, **kw)
        assert tp == jp
        np.testing.assert_allclose(tr, jr, rtol=0, atol=TOL)
    assert set(tp) <= set(cands)
    Xt = torch.tensor(X[:, :30])
    with pytest.raises(ValueError, match="candidate"):
        tens.place_sensors(Xt, 6, obs_std=0.1, candidate_indices=[1, 2, 3])
    with pytest.raises(ValueError, match="members"):
        tens.place_sensors(Xt[:1], 2, obs_std=0.1)
    with pytest.raises(ValueError, match="n_sensors"):
        tens.place_sensors(Xt, 0, obs_std=0.1)
