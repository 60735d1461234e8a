"""The port's general-mesh slice against the JAX package, on the CPU:
unstructured meshes, gmsh ``.msh`` files (read, write, regular-grid and
mirror detection, the error paths), the flip-solve-flip pullback of a
mirrored grid, the native edge enumeration, and the ELL solves on an
unstructured mesh (CRBESolver, MultiSpeciesSolver, the differentiable
solve and its posterior), all through kernel B7's plain version.

The same numpy-seeded inputs go through both packages, in float64 unless
stated; the solves compare within 1e-12 (the same algorithm in both, only
the summation order differs), the gradients within 1e-10."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu import problems as jproblems  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.mesh import mirror as jmirror  # noqa: E402
from airpollution_tpu.models.crbe import CRBESolver as JSolver  # noqa: E402
from airpollution_tpu.models.multispecies import (  # noqa: E402
    MultiSpeciesSolver as JMulti,
)

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch import problems as tproblems  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.mesh import mirror as tmirror  # noqa: E402
from airpollution_tpu_torch.mesh import native, topology  # noqa: E402
from airpollution_tpu_torch.ops import gather  # noqa: E402

from torch_port_helpers import rel_diff  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
F64 = torch.float64


def _unstructured_pair(ms=9, nt=9, seed=1, T=10.0):
    jmd = japt.MeshData(japt.create_unstructured_mesh(ms, 20.0, seed=seed),
                        japt.Domain(T=T), nt=nt, dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_unstructured_mesh(ms, 20.0, seed=seed),
                        tapt.Domain(T=T), nt=nt, dtype=F64, device="cpu")
    return jmd, tmd


# --- meshes and files ----------------------------------------------------

@pytest.mark.parametrize("ms,seed,jitter", [(17, 1, 0.3), (33, 7, 0.45)])
def test_unstructured_mesh_bit_equal_to_jax(ms, seed, jitter):
    j = japt.create_unstructured_mesh(ms, 20.0, jitter=jitter, seed=seed)
    t = tapt.create_unstructured_mesh(ms, 20.0, jitter=jitter, seed=seed)
    assert t.n_points_per_axis is None and t.triangles.dtype == np.int32
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.triangles, j.triangles)


@pytest.mark.parametrize("name", ["square_4_v22.msh", "square_4_v40.msh",
                                  "square_5.msh"])
@pytest.mark.parametrize("structured", ["auto", False])
def test_read_msh_matches_jax(name, structured):
    j = japt.read_msh(str(DATA / name), structured=structured)
    t = tapt.read_msh(str(DATA / name), structured=structured)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.triangles, j.triangles)
    assert (t.n_points_per_axis, t.mirror) == (j.n_points_per_axis,
                                               j.mirror)


def test_write_msh_matches_jax(tmp_path):
    mesh = tapt.create_unstructured_mesh(6, 20.0, seed=3)
    tp = tapt.write_msh(mesh, str(tmp_path / "t.msh"))
    jp = japt.write_msh(japt.create_unstructured_mesh(6, 20.0, seed=3),
                        str(tmp_path / "j.msh"))
    assert Path(tp).read_text() == Path(jp).read_text()
    back = tapt.read_msh(tp)
    np.testing.assert_array_equal(back.points, mesh.points)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


ERROR_FILES = {
    "binary-flag": "$MeshFormat\n4.1 1 8\n$EndMeshFormat\n",
    "binary-bytes": "$MeshFormat\n4.1 0 8\n\x00\x01\n$EndMeshFormat\n",
    "not-msh": "hello\nworld\n",
    "no-nodes": "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n",
    "no-triangles": ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                     "$Nodes\n1\n1 0 0 0\n$EndNodes\n"
                     "$Elements\n1\n1 15 2 1 1 1\n$EndElements\n"),
    "undefined-tag": ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
                      "$Nodes\n3\n1 0 0 0\n2 1 0 0\n3 0 1 0\n$EndNodes\n"
                      "$Elements\n1\n1 2 2 0 1 1 2 9\n$EndElements\n"),
    "unterminated": "$MeshFormat\n2.2 0 8\n",
    "old-version": ("$MeshFormat\n1.0 0 8\n$EndMeshFormat\n"
                    "$Nodes\n0\n$EndNodes\n$Elements\n0\n$EndElements\n"),
}


@pytest.mark.parametrize("case", sorted(ERROR_FILES))
def test_msh_error_paths_match_jax(tmp_path, case):
    path = tmp_path / f"{case}.msh"
    path.write_text(ERROR_FILES[case])
    with pytest.raises(ValueError) as jerr:
        japt.read_msh(str(path))
    with pytest.raises(ValueError) as terr:
        tapt.read_msh(str(path))
    assert str(terr.value) == str(jerr.value)


def _grid_msh(tmp_path, n, diagonal):
    """A regular n x n grid cut along the anti-diagonal ("anti") or along
    alternating diagonals ("mixed"), written with write_msh."""
    m = tapt.create_mesh(n, 20.0)
    tris = []
    for j in range(n - 1):
        for i in range(n - 1):
            v00, v10 = j * n + i, j * n + i + 1
            v01, v11 = (j + 1) * n + i, (j + 1) * n + i + 1
            if diagonal == "mixed" and (i + j) % 2:
                tris += [[v00, v10, v11], [v00, v11, v01]]
            else:
                tris += [[v00, v10, v01], [v10, v11, v01]]
    path = str(tmp_path / f"{diagonal}_{n}.msh")
    tapt.write_msh(tapt.Mesh(points=m.points,
                             triangles=np.asarray(tris, np.int32)), path)
    return path


@pytest.mark.parametrize("n,diagonal", [(5, "anti"), (9, "anti"),
                                        (5, "mixed")])
def test_grid_detection_matches_jax(tmp_path, n, diagonal):
    path = _grid_msh(tmp_path, n, diagonal)
    for structured in ("auto", False):
        j = japt.read_msh(path, structured=structured)
        t = tapt.read_msh(path, structured=structured)
        assert (t.n_points_per_axis, t.mirror) == (j.n_points_per_axis,
                                                   j.mirror)
        np.testing.assert_array_equal(t.points, j.points)
        np.testing.assert_array_equal(t.triangles, j.triangles)
    if diagonal == "mixed":
        with pytest.raises(ValueError, match="structured=True"):
            tapt.read_msh(path, structured=True)
    else:
        assert tapt.read_msh(path).mirror in ((-1, 1), (1, -1))
    with pytest.raises(ValueError, match="structured must be"):
        tapt.read_msh(path, structured="yes")


@pytest.mark.parametrize("ms,L", [(7, 20.0), (7, 1.0), (12, 20.0)])
@pytest.mark.parametrize("mirror", [(-1, 1), (1, -1), (-1, -1)])
def test_mirror_dof_permutation_matches_jax(ms, L, mirror):
    jmd = japt.MeshData(japt.create_mesh(ms, L), japt.Domain(), nt=3)
    tmd = tapt.MeshData(tapt.create_mesh(ms, L), tapt.Domain(), nt=3,
                        device="cpu")
    perm = tmirror.mirror_dof_permutation(tmd, mirror)
    np.testing.assert_array_equal(
        perm, jmirror.mirror_dof_permutation(jmd, mirror))
    np.testing.assert_array_equal(perm[perm], np.arange(perm.size))
    with pytest.raises(ValueError, match="structured"):
        tmirror.mirror_dof_permutation(
            tapt.MeshData(tapt.create_unstructured_mesh(5, 20.0),
                          tapt.Domain(), nt=3, device="cpu"), mirror)


def test_mirrored_problem_hooks_match_jax():
    """The pullback's hooks, wind and diffusion tensor against JAX's, at
    random points, for a Gaussian emitter, a rotating plume and a problem
    with Robin sides and an obstacle."""
    rng = np.random.default_rng(2)
    xy = rng.uniform(-20, 20, size=(11, 2))
    xyt = np.concatenate([xy, rng.uniform(0, 5, size=(11, 1))], axis=1)

    def pair(name):
        if name == "emitter":
            kw = dict(q=2.0, xs=-3.0, ys=4.0, sigma_s=2.0, D=0.2)
            return (jproblems.GaussianSourceProblem(**kw),
                    tproblems.GaussianSourceProblem(**kw))
        if name == "rotating":
            kw = dict(omega=0.07, D=0.1, x0=4.0, y0=-2.0, cx=1.0)
            return (jproblems.RotatingPlumeProblem(**kw),
                    tproblems.RotatingPlumeProblem(**kw))
        j, t = jproblems.Problem(D=0.2), tproblems.Problem(D=0.2)
        for p in (j, t):
            p.robin_sides = {"left": 0.1, "top": 0.2}
            p.obstacles = ((-3.0, 1.0, 2.0, 5.0),)
        return j, t

    for name in ("emitter", "rotating", "walls"):
        jb, tb = pair(name)
        for mirror in ((-1, 1), (1, -1)):
            jp = jmirror.mirror_problem(jb, mirror)
            tp = tmirror.mirror_problem(tb, mirror)
            T = torch.tensor(xy, dtype=F64)
            TT = torch.tensor(xyt, dtype=F64)
            for hook, arg, targ in (("initial_condition_fn", xy, T),
                                    ("boundary_fn", xyt, TT),
                                    ("source_term", xyt, TT),
                                    ("velocity_at", xy, T),
                                    ("obstacle_fn", xy, T)):
                np.testing.assert_allclose(
                    getattr(tp, hook)(targ).numpy(),
                    np.asarray(getattr(jp, hook)(jnp.asarray(arg))),
                    rtol=1e-13, atol=1e-15, err_msg=f"{name} {hook}")
            assert tp.robin_sides == jp.robin_sides
            assert tp.obstacles == jp.obstacles
            assert tmirror.mirror_problem(tb, None) is tb


def test_flip_solve_flip_matches_general_ell(tmp_path):
    """The mirrored 9^2 grid: the canonical mesh with the pulled-back
    problem (stencil path) and the field permuted back equals the
    general-ELL solve of the file's own triangulation, DOF for DOF, within
    1e-9 (f64, solver_tol 1e-12, nt=9), as the JAX package's test holds
    its own."""
    path = _grid_msh(tmp_path, 9, "anti")
    domain, problem = tapt.Domain(), tapt.Problem()
    md_gen = tapt.MeshData(tapt.read_msh(path, structured=False), domain,
                           nt=9, dtype=F64, device="cpu")
    s_gen = tapt.CRBESolver(domain, problem, md_gen, matvec_impl="ell",
                            solver_tol=1e-12, device="cpu")
    u_gen = s_gen.solve(store_solutions=False)[-1].numpy()
    got = tapt.read_msh(path)
    with pytest.raises(ValueError, match="mirror"):
        tapt.MeshData(got, domain, nt=9, device="cpu")
    md_can = tapt.MeshData(got, domain, nt=9, dtype=F64, device="cpu",
                           mirror_ok=True)
    s_can = tapt.CRBESolver(domain, tmirror.mirror_problem(problem,
                                                           got.mirror),
                            md_can, matvec_impl="stencil", solver_tol=1e-12,
                            device="cpu")
    u_can = tmirror.mirror_field(s_can.solve(store_solutions=False)[-1],
                                 md_can, got.mirror).numpy()

    def order(md):
        mid = md.midpoints.numpy()
        q = np.rint((mid - mid.min(0)) / (20.0 / 8)).astype(int)
        return np.lexsort((q[:, 0], q[:, 1]))

    og, oc = order(md_gen), order(md_can)
    np.testing.assert_allclose(md_gen.midpoints.numpy()[og],
                               md_can.midpoints.numpy()[oc], atol=1e-12)
    np.testing.assert_allclose(u_gen[og], u_can[oc], atol=1e-9)


def test_mirror_field_keeps_the_graph():
    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=3,
                       dtype=F64, device="cpu")
    u = torch.arange(md.number_of_segments, dtype=F64, requires_grad=True)
    out = tmirror.mirror_field(2.0 * u, md, (-1, 1))
    (g,) = torch.autograd.grad(out.sum(), u)
    assert torch.equal(g, torch.full_like(u, 2.0))
    assert tmirror.mirror_field(u, md, None) is u


# --- the native edge enumeration -----------------------------------------

@pytest.mark.parametrize("make", ["structured", "unstructured"])
def test_native_enumeration_matches_numpy(make):
    mesh = (tapt.create_mesh(64, 2.0) if make == "structured"
            else tapt.create_unstructured_mesh(48, 2.0, seed=4))
    tris = np.asarray(mesh.triangles, np.int64)
    assert tris.shape[0] >= topology.NATIVE_MIN_TRIANGLES
    segs, t2s, _ = topology._enumerate_numpy(tris, len(mesh.points))
    got = native.enumerate_edges_native(tris, len(mesh.points))
    assert got is not None, native.load_error()
    np.testing.assert_array_equal(got[0], segs)
    np.testing.assert_array_equal(got[1], t2s)
    full = topology.enumerate_edges(mesh.triangles, len(mesh.points))
    np.testing.assert_array_equal(full.segments, segs)
    assert str(native.library_path()).startswith(str(REPO / "build"))
    with pytest.raises(ValueError):
        native.enumerate_edges_native(np.array([[0, 1, 99]]), n_points=3)


def test_native_can_be_turned_off():
    out = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        from airpollution_tpu_torch.mesh import native
        assert native.enumerate_edges_native([[0, 1, 2]], 3) is None
        print(native.load_error())
    """)], cwd=REPO, env=dict(os.environ, APT_NATIVE="0"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "APT_NATIVE=0" in out.stdout, out.stderr


# --- solves on an unstructured mesh --------------------------------------

@pytest.mark.parametrize("order,method", [(1, "bicgstab"), (2, "bicgstab"),
                                          (1, "chebyshev")],
                         ids=["be", "cn", "chebyshev-12"])
def test_crbe_unstructured_matches_jax(order, method):
    jmd, tmd = _unstructured_pair(13, nt=17)
    kw = dict(time_scheme_order=order, matvec_impl="auto",
              solver_method=method, solver_tol=1e-13, solver_maxiter=500)
    if method == "chebyshev":
        kw.update(chebyshev_iters=12, extrapolate_warm_start=True)
    js = JSolver(japt.Domain(), japt.Problem(), jmd, **kw)
    ts = tapt.CRBESolver(tapt.Domain(), tapt.Problem(), tmd, device="cpu",
                         **kw)
    want = np.asarray(js.solve())
    got = ts.solve()
    assert not ts._use_stencil() and got.shape == want.shape
    assert ts.solver_method == js.solver_method == method
    assert rel_diff(got, want) <= 1e-12
    if method == "chebyshev":
        assert ts._cheb_bounds == pytest.approx(js._cheb_bounds, rel=1e-12)


@pytest.mark.parametrize("case", ["shared", "stacked"])
def test_multispecies_unstructured_matches_jax(case):
    jmd, tmd = _unstructured_pair(11, nt=9, T=2.0)
    R = [[0.3, -0.1], [-0.2, 0.4]]

    def species(mod):
        D2 = 0.1 if case == "shared" else 0.05
        return (mod.GaussianSourceProblem(D=0.1, q=2.0, xs=1.0, ys=-2.0,
                                          sigma_s=2.0),
                mod.Problem(D=D2, sigma=2.0))

    kw = dict(time_scheme_order=2, matvec_impl="ell", splitting="strang",
              solver_method="bicgstab", solver_tol=1e-13,
              solver_maxiter=400)
    js = JMulti(japt.Domain(T=2.0),
                jproblems.MultiSpeciesProblem(species(jproblems),
                                              np.array(R)), jmd, **kw)
    ts = tapt.MultiSpeciesSolver(
        tapt.Domain(T=2.0), tproblems.MultiSpeciesProblem(
            species(tproblems), R), tmd, device="cpu", **kw)
    want = np.asarray(js.solve())
    got = ts.solve()
    assert (ts._ops.mass_diag.ndim == 2) == (case == "stacked")
    assert rel_diff(got, want) <= 1e-12


def _emitter(lib, th):
    cls = (jproblems.GaussianSourceProblem if lib == "jax"
           else tproblems.GaussianSourceProblem)
    exp = jnp.exp if lib == "jax" else torch.exp
    return cls(q=exp(th[0]), xs=th[1], ys=th[2], sigma_s=3.0, D=th[3])


@pytest.mark.parametrize("order", [1, 2])
def test_inverse_gradients_unstructured_match_jax(order):
    """The gradient of a weighted sum of solve_final_state in the
    emitter's (log q, xs, ys) and in D: B7's transposed product inside
    every adjoint step."""
    jmd, tmd = _unstructured_pair(13, nt=9)
    theta = [np.log(2.0), -1.0, 1.5, 0.1]
    w = np.random.default_rng(7).standard_normal(jmd.number_of_segments)
    kw = dict(engine="scan", tol=1e-13, maxiter=500,
              time_scheme_order=order)

    def jloss(th):
        return jnp.sum(jnp.asarray(w) * jinv.solve_final_state(
            _emitter("jax", th), jmd, **kw))

    jg = jax.jit(jax.grad(jloss))(jnp.asarray(theta))
    th = torch.tensor(theta, dtype=F64, requires_grad=True)
    loss = torch.sum(torch.tensor(w) * tinv.solve_final_state(
        _emitter("torch", th), tmd, **kw))
    (g,) = torch.autograd.grad(loss, th)
    assert rel_diff(g, jg) <= 1e-10


def test_posterior_unstructured_matches_jax():
    """posterior_covariance on an unstructured mesh (forward-mode
    tangents through the double backward of B7's Function)."""
    jmd, tmd = _unstructured_pair(11, nt=9)
    idx = [4, 8]
    sens = list(range(0, jmd.number_of_segments, 7))
    truth = jinv.solve_snapshots(
        jproblems.GaussianSourceProblem(q=2.0, xs=-1.0, ys=1.5, sigma_s=3.0,
                                        D=0.12),
        jmd, indices=idx, engine="scan", tol=1e-13, maxiter=500)
    obs = np.asarray(truth)[:, sens]
    obs = obs + 0.01 * np.abs(obs).max() * np.random.default_rng(0) \
        .standard_normal(obs.shape)
    params = {"log_q": np.asarray(0.6), "xy": np.asarray([-1.2, 1.4]),
              "D": np.asarray(0.1)}

    def make(lib):
        def make_problem(p):
            th = [p["log_q"], p["xy"][0], p["xy"][1], p["D"]]
            return _emitter(lib, th)
        return make_problem

    kw = dict(snapshot_indices=idx, sensor_indices=sens, observed=obs,
              tol=1e-13, maxiter=500)
    juq = jinv.posterior_covariance(
        jmd, make("jax"), {k: jnp.asarray(v) for k, v in params.items()},
        **kw)
    tuq = tinv.posterior_covariance(tmd, make("torch"), params, **kw)
    assert tuq["labels"] == juq["labels"]
    for key in ("cov", "corr"):
        assert rel_diff(tuq[key], juq[key]) <= 1e-10, key
    assert gather.KERNEL.launches == 0
