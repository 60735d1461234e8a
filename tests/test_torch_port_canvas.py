"""The port's per-DOF (canvas) operator against the JAX package, float64:
problem hooks, wall and obstacle masks, assembly with variable
coefficients, Robin walls and obstacles; the plain versions of kernels B3
(ops/fused_stencil), B4 (ops/fused_hbm.fused_solve_canvas_hbm) and B5
(ops/fused_solver.fused_solve) against the Pallas kernels in interpret
mode on one operator and one Chebyshev interval; CRBESolver end to end on
the three canvas routes; and the routing rules."""

import types

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu import problems as j_problems
from airpollution_tpu.mesh.data import boundary_side_masks as j_side_masks
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.models.crbe import CRBESolver as JaxSolver
from airpollution_tpu.ops import pallas_hbm, pallas_solver, pallas_stencil
from airpollution_tpu.ops import stencil as j_stencil

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import interop
from airpollution_tpu_torch import problems as t_problems
from airpollution_tpu_torch.mesh.data import (
    boundary_side_masks as t_side_masks,
)
from airpollution_tpu_torch.models import crbe as t_crbe
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver, fused_stencil
from airpollution_tpu_torch.ops import stencil as t_stencil

from torch_port_helpers import port_operators, rel_diff

TOL = 1e-10
ROBIN = {"bottom": 0.05, "top": 0.0}
BLOCK = ((-4.0, 4.0, -4.0, 4.0),)
BOUNDS = (0.5, 1.6)  # one Chebyshev interval fed to both packages


def _walled(base):
    """``base`` with C3's Robin walls and solid block."""
    return type(f"Walled{base.__name__}", (base,),
                {"robin_sides": ROBIN, "obstacles": BLOCK})


def _rotating(walled=False):
    """(JAX, port) rotating-wind problems with C1's parameters."""
    jp, tp = j_problems.RotatingPlumeProblem, t_problems.RotatingPlumeProblem
    if walled:
        jp, tp = _walled(jp), _walled(tp)
    return jp(omega=0.05, D=0.3), tp(omega=0.05, D=0.3)


def _c3():
    """(JAX, port) C3 problems: the plume with Robin walls and a block."""
    return (_walled(j_problems.Problem)(sigma=3.0),
            _walled(t_problems.Problem)(sigma=3.0))


def _mesh_pair(ms, nt, T=1.0):
    """Both packages' MeshData of one mesh; T=1 keeps dt |v| / h small
    enough for Chebyshev on these coarse meshes."""
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(T=T), nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(T=T), nt=nt,
                        dtype=torch.float64, device="cpu")
    return jmd, tmd


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- problem hooks, masks, assembly ---------------------------------------


def test_problem_hooks_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20.0, 20.0, size=(64, 2))
    xyt = np.concatenate([xy, rng.uniform(0.0, 10.0, size=(64, 1))], axis=1)
    jxy, txy = jnp.asarray(xy), torch.tensor(xy)
    jrot, trot = _rotating(walled=True)
    pairs = [
        (jrot.velocity_at(jxy), trot.velocity_at(txy)),
        (jrot.diffusion_at(jxy), trot.diffusion_at(txy)),
        (jrot.analytical_solution(jnp.asarray(xyt)),
         trot.analytical_solution(torch.tensor(xyt))),
        (jrot.initial_condition_fn(jxy), trot.initial_condition_fn(txy)),
        (japt.Problem().velocity_at(jxy), tapt.Problem().velocity_at(txy)),
        (j_problems.SquarePulseProblem(lo=-5.0).initial_condition_fn(jxy),
         t_problems.SquarePulseProblem(lo=-5.0).initial_condition_fn(txy)),
    ]
    for side in t_problems.SIDE_NORMALS:
        pairs.append((jrot.robin_g(jxy, 0.5, side),
                      trot.robin_g(txy, 0.5, side)))
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-14,
                                   atol=1e-300)
    np.testing.assert_array_equal(_np(trot.obstacle_fn(txy)),
                                  np.asarray(jrot.obstacle_fn(jxy)))
    assert t_problems.SIDE_NORMALS == j_problems.SIDE_NORMALS

    class JG(j_problems.Problem):
        def robin_g_xy(self, x, y, t, side):
            return x

    class TG(t_problems.Problem):
        def robin_g_xy(self, x, y, t, side):
            return x

    for jp, tp in ((japt.Problem(), tapt.Problem()), (JG(), TG())):
        assert (t_problems.robin_g_customized(tp)
                == j_problems.robin_g_customized(jp))
        assert (t_problems.robin_g_xy_provided(tp)
                == j_problems.robin_g_xy_provided(jp))


def test_wall_and_obstacle_masks_match_jax():
    jmd, tmd = _mesh_pair(9, 4)
    jside, tside = j_side_masks(jmd), t_side_masks(tmd)
    for side in t_problems.SIDE_NORMALS:
        np.testing.assert_array_equal(_np(tside[side]),
                                      np.asarray(jside[side]))
    jp, tp = _rotating(walled=True)
    for want, got in zip(j_crbe.robin_terms(jmd, jp),
                         t_crbe.robin_terms(tmd, tp)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for want, got in zip(j_crbe.obstacle_masks(jmd, jp),
                         t_crbe.obstacle_masks(tmd, tp)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert bool(t_crbe.obstacle_masks(tmd, tp)[1].any())
    assert t_crbe.obstacle_masks(tmd, tapt.Problem()) == (None, None)


@pytest.mark.parametrize("d_kind", ["field", "tensor", "tensor-field"])
def test_local_matrices_with_fields_match_jax(d_kind):
    rng = np.random.default_rng(1)
    n_tri = 24
    verts = rng.normal(size=(n_tri, 3, 2))
    e1, e2 = verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0]
    flip = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0
    verts[flip, 1:] = verts[flip, 2:0:-1].copy()
    areas = rng.uniform(0.5, 1.0, n_tri)
    v = rng.normal(size=(n_tri, 2))
    a = rng.normal(size=(n_tri, 2, 2))
    D = {"field": rng.uniform(0.05, 0.3, n_tri),
         "tensor": np.array([[0.2, 0.05], [0.05, 0.1]]),
         "tensor-field": a @ a.transpose(0, 2, 1) + 0.1 * np.eye(2)}[d_kind]
    for conv in ("correct", "reference"):
        want = j_crbe.local_matrices(jnp.asarray(verts), jnp.asarray(areas),
                                     jnp.asarray(D), jnp.asarray(v), conv)
        got = t_crbe.local_matrices(torch.tensor(verts), torch.tensor(areas),
                                    torch.tensor(D), torch.tensor(v), conv)
        for g, w in zip(got, want):
            assert rel_diff(g, w) <= 1e-12


@pytest.mark.parametrize("order", [1, 2])
def test_canvas_assembly_matches_jax(order):
    """Variable wind, Robin walls and a solid block at once."""
    jmd, tmd = _mesh_pair(17, 11)
    jp, tp = _rotating(walled=True)
    jops = j_crbe.assemble(jmd, jp, 0.1, order)
    tops = t_crbe.assemble(tmd, tp, 0.1, order)
    for name in ("stiffness", "advection", "ka", "system"):
        jm, tm = getattr(jops, name), getattr(tops, name)
        np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
        assert rel_diff(tm.vals, jm.vals) <= 1e-12, name
    assert rel_diff(tops.mass_diag, jops.mass_diag) <= 1e-12
    assert rel_diff(tops.system_diag, jops.system_diag) <= 1e-12


# --- plain kernels against the Pallas kernels in interpret mode ------------


def _canvas_operator(jp, order, ms=17):
    """The JAX package's canvas operator (as its CRBESolver builds it) and
    the same carried across to the port, plus both initial family states."""
    jmd, tmd = _mesh_pair(ms, 12)
    ops = j_crbe.assemble(jmd, jp, 0.1, order)
    pattern = j_stencil.get_pattern(jmd)
    perm = jnp.asarray(pattern.perm)
    dmask = j_crbe.robin_terms(jmd, jp)[0]
    _, dead = j_crbe.obstacle_masks(jmd, jp)
    if dead is not None:
        dmask = dmask | dead
    bm = dmask[perm]
    coeffs = j_stencil.extract_coefficients(pattern, ops.system.vals)
    mass = jnp.where(bm, 0.0, ops.mass_diag[perm])
    inv_diag = 1.0 / ops.system_diag[perm]
    u0 = jp.initial_condition_fn(jmd.midpoints)
    if dead is not None:
        u0 = jnp.where(dead, 0.0, u0)
    u0 = u0[perm]
    interior = 1.0 - bm.astype(u0.dtype)
    j_args = (pattern, coeffs, mass, inv_diag, u0)
    t_coeffs, t_mass, t_inv = interop.canvas_operator_from_numpy(
        coeffs=[np.asarray(g) for g in coeffs], mass_fam=np.asarray(mass),
        inv_diag_fam=np.asarray(inv_diag), device="cpu")
    t_args = (t_stencil.get_pattern(tmd), t_coeffs, t_mass, t_inv,
              torch.tensor(np.asarray(u0)))
    return j_args, t_args, interior


def test_plain_b3_matches_pallas_stencil():
    j_args, t_args, _ = _canvas_operator(_c3()[0], 1)
    x = np.random.default_rng(2).normal(size=t_args[4].shape[0])
    want = pallas_stencil.stencil_matvec_pallas(j_args[0], j_args[1],
                                                jnp.asarray(x),
                                                interpret=True)
    got = fused_stencil.stencil_matvec_fused(t_args[0], t_args[1],
                                             torch.tensor(x))
    assert fused_stencil.KERNEL.launches == 0
    assert rel_diff(got, want) <= TOL
    for n in (129, 257, 386, 387, 388, 600):
        p = types.SimpleNamespace(n=n, c=n - 1)
        assert fused_stencil.fits_vmem(p) == pallas_stencil.fits_vmem(p)


@pytest.mark.parametrize("robin", [False, True])
@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b4_matches_pallas_hbm(order, extrapolate, robin):
    jp = _rotating(walled=robin)[0]
    j_args, t_args, _ = _canvas_operator(jp, order)
    c = t_args[0].c
    rect = pallas_hbm.robin_rect_bounds(c, ROBIN) if robin else None
    assert rect == (fused_hbm.robin_rect_bounds(c, ROBIN) if robin else None)
    kw = dict(n_steps=11, n_iters=4, bounds=BOUNDS, use_ka=order == 2,
              extrapolate=extrapolate, rect=rect)
    want = pallas_hbm.fused_solve_canvas_hbm(*j_args, stripe_rows=8,
                                             interpret=True, **kw)
    got, bad = fused_hbm.fused_solve_canvas_hbm(*t_args, guard_every=11, **kw)
    assert fused_hbm.CANVAS_KERNEL.launches == 0
    assert int(bad) == -1
    assert rel_diff(got, want) <= TOL


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_plain_b5_matches_pallas_solver(order, extrapolate):
    j_args, t_args, interior = _canvas_operator(_rotating(walled=True)[0],
                                                order)
    kw = dict(n_steps=11, n_iters=5, use_ka=order == 2,
              extrapolate=extrapolate)
    want = pallas_solver.fused_solve(*j_args, interior, interpret=True, **kw)
    got = fused_solver.fused_solve(*t_args,
                                   torch.tensor(np.asarray(interior)), **kw)
    assert fused_solver.CANVAS_KERNEL.launches == 0
    assert rel_diff(got, want) <= TOL


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("use_ka", [False, True])
def test_canvas_step_reach_fits_the_kernel_halo(k, use_ka):
    """Kernel B4 computes a tile from a window with halo_of(k, use_ka) cells
    on each side: a change of u or u_prev at one cell must not move the
    plain step's output farther away than that."""
    n, mid = 33, 16
    rng = np.random.default_rng(3)
    C = torch.tensor(rng.uniform(-0.3, 0.3, size=(21, n, n)))
    cheb = fused_solver.cheb_scalars(BOUNDS, k, torch.float64, "cpu")
    u = torch.tensor(rng.standard_normal((3, n, n)))
    up = torch.tensor(rng.standard_normal((3, n, n)))
    masks = fused_solver.rect_masks(n, torch.float64, "cpu", (0, n, 1, n - 1))
    base, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, up, use_ka, masks)
    halo = fused_solver.halo_of(k, use_ka)
    for f in range(3):
        for which in ("u", "up"):
            du, dup = u.clone(), up.clone()
            (du if which == "u" else dup)[f, mid, mid] += 1.0
            out, _ = fused_hbm.plain_canvas_step(C, cheb, k, du, dup, use_ka,
                                                 masks)
            _, rows, cols = torch.nonzero(out != base, as_tuple=True)
            assert rows.numel() > 0
            reach = int(torch.maximum((rows - mid).abs(),
                                      (cols - mid).abs()).max())
            assert reach <= halo, (f, which, reach, halo)


# --- the slice end to end -------------------------------------------------


@pytest.mark.parametrize("case", [
    ("C1", "fused_hbm", "chebyshev", 1, "B4"),
    ("C1", "fused_hbm", "chebyshev", 2, "B4"),
    ("C2", "fused", "bicgstab", 1, "B5"),
    ("C2", "fused", "bicgstab", 2, "B5"),
    ("C3", "fused_hbm", "chebyshev", 2, "B4"),
    ("C3", "pallas", "bicgstab", 1, None),
], ids=["C1-BE", "C1-CN", "C2-BE", "C2-CN", "C3-B4", "C3-B3"])
def test_slice_matches_jax_solver(case):
    """Port CRBESolver vs JAX CRBESolver on one operator and one interval:
    C1's and C2's rotating wind, C3's Robin walls and block, ms=17."""
    name, impl, method, order, kernel = case
    jp, tp = _c3() if name == "C3" else _rotating()
    jmd, tmd = _mesh_pair(17, 11)
    kw = dict(time_scheme_order=order, matvec_impl=impl, solver_method=method,
              chebyshev_iters=8 if name == "C3" else 14, fused_iters=5,
              extrapolate_warm_start=True, solver_tol=1e-12)
    js = JaxSolver(japt.Domain(T=1.0), jp, jmd, **kw)
    store = impl == "pallas"
    want = js.solve(store_solutions=store)
    bounds = js._cheb_bounds if method == "chebyshev" else None
    ts = CRBESolver(tapt.Domain(T=1.0), tp, tmd, cheb_bounds=bounds,
                    device="cpu", **kw)
    ts.set_operators(port_operators(js._ops))
    got = ts.solve(store_solutions=store)
    assert got.shape == want.shape
    assert getattr(ts, "fused_kernel", None) == kernel
    assert rel_diff(got, want) <= TOL
    if name == "C3":
        dead = t_crbe.obstacle_masks(tmd, tp)[1]
        assert bool(dead.any()) and float(got[-1][dead].abs().max()) == 0.0
    assert ts.compute_errors(tp.analytical_solution) == pytest.approx(
        js.compute_errors(jp.analytical_solution), rel=1e-9)


def _fake_mesh(n):
    """Just what CRBESolver's routing reads of a MeshData."""
    return types.SimpleNamespace(device=torch.device("cpu"), nt=11,
                                 structured_n=n,
                                 number_of_segments=(n - 1) * (3 * n - 1))


def test_canvas_routing_matches_jax():
    """B5 while the JAX package's canvas budget holds, a ValueError past it
    (the per-step kernel is Chebyshev-only); Chebyshev always on B4."""
    from airpollution_tpu.models.crbe import _pallas_fused_fits

    domain, problem = tapt.Domain(), _rotating()[1]
    for n in (65, 257, 262, 263, 300, 1025):
        for ext in (False, True):
            fits = _pallas_fused_fits(types.SimpleNamespace(n=n), ext,
                                      uniform=False)
            assert t_crbe._fused_fits(n, ext, uniform=False) == fits
            kw = dict(matvec_impl="fused", extrapolate_warm_start=ext,
                      device="cpu")
            if fits:
                s = CRBESolver(domain, problem, _fake_mesh(n),
                               solver_method="bicgstab", **kw)
                assert s._fused_plan() == (False, "B5")
            else:
                with pytest.raises(ValueError,
                                   match="solver_method='chebyshev'"):
                    CRBESolver(domain, problem, _fake_mesh(n),
                               solver_method="bicgstab", **kw)
            s = CRBESolver(domain, problem, _fake_mesh(n),
                           solver_method="chebyshev", **kw)
            assert s._fused_plan() == (False, "B4")
    # A constant-coefficient problem takes the canvas operator on request,
    # the uniform one otherwise.
    for op, plan in (("canvas", (False, "B4")), ("auto", (True, "B1"))):
        s = CRBESolver(domain, tapt.Problem(), _fake_mesh(65),
                       matvec_impl="fused", solver_method="chebyshev",
                       fused_operator=op, device="cpu")
        assert s._fused_plan() == plan
