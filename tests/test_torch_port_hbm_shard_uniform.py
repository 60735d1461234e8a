"""The port's block-sharded uniform solver (kernel B8's plain version,
airpollution_tpu_torch/parallel/hbm_shard.build_hbm_halo_solver) and
patch assembly on the CPU, float64.

Held against the JAX sharded builder (one case: the 8-device CPU mesh,
interpret mode, as tests/test_hbm_shard.py runs it, within 1e-10), the
JAX serial loop (models/crbe.run_time_loop, jitted as CRBESolver's ELL
route runs it; it estimates its Chebyshev interval in another DOF order,
so it is held at tests/test_hbm_shard.py's own serial tolerance, atol
2e-6), and the port's whole-canvas fused solve (B2's plain version, to
equality). With 12 points per axis on 8 blocks, block 0 owns every
real row and the exchange moves zeros; the 48-row case on 2 blocks and
the 40-row cases on 3 blocks carry real rows across block boundaries.
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.ops import uniform as j_uniform
from airpollution_tpu.parallel.device_mesh import make_mesh as j_make_mesh
from airpollution_tpu.parallel.hbm_shard import (
    build_hbm_halo_solver as j_build_hbm_halo_solver,
)

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import _build
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver
from airpollution_tpu_torch.ops import uniform as t_uniform
from airpollution_tpu_torch.parallel import (build_hbm_halo_solver,
                                             dp_tp_split, hbm_shard,
                                             make_mesh)

from torch_port_helpers import mesh_pair, port_operators, rel_diff
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.kernels

K = 14


def _cpu_mesh(n_blocks):
    return make_mesh({"mp": n_blocks}, device="cpu")


def _md(ms, nt, domain=None):
    return tapt.MeshData(tapt.create_mesh(ms, 20.0), domain or tapt.Domain(),
                         nt=nt, dtype=torch.float64, device="cpu")


def _whole(md, problem, order=1, ext=False, iters=K, snap=None,
           domain=None, **kw):
    """The port's whole-canvas fused solve (B2's plain version) and its
    result."""
    s = CRBESolver(domain or tapt.Domain(), problem, md,
                   matvec_impl="fused_hbm", time_scheme_order=order,
                   extrapolate_warm_start=ext, solver_method="chebyshev",
                   chebyshev_iters=iters, snapshot_every=snap, device="cpu",
                   **kw)
    return s, s.solve(store_solutions=snap is not None)


def _equal(got, want, tol=1e-12):
    assert got.shape == want.shape
    assert rel_diff(got, want) <= tol, rel_diff(got, want)


@functools.lru_cache(maxsize=None)
def _jax_case(order):
    """(JAX mesh data, port mesh data, JAX operators, u0, dt) at 12^2,
    nt=16, float64."""
    jmd, tmd = mesh_pair(12, nt=16)
    dt = 10.0 / 15
    jops = j_crbe.assemble(jmd, japt.Problem(), dt, order, "correct")
    u0 = japt.Problem().initial_condition_fn(jmd.midpoints)
    return jmd, tmd, jops, u0, dt


def _jax_serial(order, ext):
    jmd, _, jops, u0, dt = _jax_case(order)
    fn = jax.jit(functools.partial(
        j_crbe.run_time_loop, mesh_data=jmd, problem=japt.Problem(), dt=dt,
        order=order, tol=1e-7, maxiter=200, store_solutions=False,
        solver="chebyshev", chebyshev_iters=K,
        extrapolate_warm_start=ext))
    return np.asarray(fn(jops, u0)[0])


def test_block_solver_matches_jax_sharded():
    """BE on 8 blocks: the JAX sharded builder on the same assembled
    operator and initial state, within 1e-10 of max|u|."""
    jmd, tmd, jops, u0, dt = _jax_case(1)
    want = np.asarray(j_build_hbm_halo_solver(
        j_make_mesh({"mp": 8}), jmd, japt.Problem(), dt, iters=K,
        stripe_rows=8, interpret=True)(jops, u0))
    got = build_hbm_halo_solver(_cpu_mesh(8), tmd, tapt.Problem(), dt,
                                iters=K)(port_operators(jops),
                                         torch.tensor(np.asarray(u0)))
    assert got.shape == want.shape
    assert rel_diff(got, want) <= 1e-10


@pytest.mark.parametrize("order,ext", [(1, False), (1, True), (2, True)],
                         ids=["be", "be-ext", "cn-ext"])
def test_block_solver_matches_serial_and_whole_canvas(order, ext):
    """8 blocks at 12^2 against the JAX serial loop and the whole-canvas
    solve, and 3 blocks at 40^2 (real rows cross the block boundaries)
    against the whole-canvas solve, to equality."""
    _, tmd, jops, u0, dt = _jax_case(order)
    got = build_hbm_halo_solver(_cpu_mesh(8), tmd, tapt.Problem(), dt,
                                order=order, iters=K, extrapolate=ext)(
        port_operators(jops), torch.tensor(np.asarray(u0)))
    np.testing.assert_allclose(got.numpy(), _jax_serial(order, ext),
                               atol=2e-6)
    for ms, n_blocks in ((12, 8), (40, 3)):
        md = _md(ms, 16)
        s, want = _whole(md, tapt.Problem(), order, ext)
        got = build_hbm_halo_solver(_cpu_mesh(n_blocks), md, tapt.Problem(),
                                    s.dt, order=order, iters=K,
                                    extrapolate=ext)(
            s._require_ops(), s.set_initial_condition())
        _equal(got, want)


def test_block_solver_strided_trajectory():
    """snapshot_every=k: the strided rows of the whole-canvas solve (row 0
    the full initial state, later rows lifted)."""
    md = _md(40, 13)
    s, want = _whole(md, tapt.Problem(), snap=4)
    got = build_hbm_halo_solver(_cpu_mesh(3), md, tapt.Problem(), s.dt,
                                iters=K, snapshot_every=4)(
        s._require_ops(), s.set_initial_condition())
    assert got.shape == (4, md.number_of_segments)
    _equal(got, want)


@pytest.mark.parametrize("order", [1, 2], ids=["be", "cn"])
def test_block_solver_sourced(order):
    """A steady emitter loaded per block on global coordinates (B8's load
    entry point's plain version) against the whole-canvas solve."""
    md = _md(40, 16)
    problem = tapt.GaussianSourceProblem(q=80.0, xs=-4.0, ys=3.0,
                                         sigma_s=5.0)
    s, want = _whole(md, problem, order)
    assert float(want.abs().max()) > 1e-3
    got = build_hbm_halo_solver(_cpu_mesh(3), md, problem, s.dt,
                                order=order, iters=K)(
        s._require_ops(), s.set_initial_condition())
    _equal(got, want)


class _Ramp(tapt.Problem):
    """A time-dependent source (tests/test_hbm_shard.py's)."""

    zero_source = False
    steady_source = False

    def source_term(self, xyt):
        return self.source_xy(xyt[..., 0], xyt[..., 1], xyt[..., 2])

    def source_xy(self, x, y, t):
        return (0.3 + 0.2 * t) * torch.exp(-0.04 * (x ** 2 + y ** 2))


def test_block_solver_time_dependent_source_strided():
    """Each block rebuilds its load every step at the step's time; the
    strided rows equal the whole-canvas solve's."""
    md = _md(40, 13)
    s, want = _whole(md, _Ramp(), snap=4)
    got = build_hbm_halo_solver(_cpu_mesh(3), md, _Ramp(), s.dt, iters=K,
                                snapshot_every=4)(
        s._require_ops(), s.set_initial_condition())
    _equal(got, want)


def _swapped_exchange(ext, local, halo):
    """The exchange with its two directions swapped."""
    ext[1:, ..., :halo, :] = ext[:-1, ..., halo:2 * halo, :]
    ext[0, ..., :halo, :] = 0
    ext[:-1, ..., halo + local:, :] = ext[1:, ..., local:local + halo, :]
    ext[-1, ..., halo + local:, :] = 0


def test_real_boundary_crossing(monkeypatch):
    """2 blocks on a 48-row canvas, k=6 (halo 8 rows, interiors of 24):
    the plume straddles the block boundary, so the exchange carries real
    rows. Equal to the whole-canvas solve, and a swapped exchange fails."""
    md = _md(48, 33)
    s, want = _whole(md, tapt.Problem(), iters=6)
    solver = build_hbm_halo_solver(_cpu_mesh(2), md, tapt.Problem(), s.dt,
                                   iters=6)
    args = (s._require_ops(), s.set_initial_condition())
    _equal(solver(*args), want)
    monkeypatch.setattr(hbm_shard, "exchange", _swapped_exchange)
    assert rel_diff(solver(*args), want) > 1e-3


def test_block_solver_takes_the_plain_kernel_on_cpu(monkeypatch):
    """A CPU block solve builds nothing and launches nothing: each block
    step is B8's plain version; the wrapper itself refuses CPU tensors."""
    def no_build(*_a, **_k):
        raise AssertionError("a CPU solve must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_build)
    calls = []
    real = fused_hbm.plain_block_step
    monkeypatch.setattr(fused_hbm, "plain_block_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    md = _md(12, 5)
    s = CRBESolver(tapt.Domain(), tapt.Problem(), md, device="cpu")
    out = build_hbm_halo_solver(_cpu_mesh(2), md, tapt.Problem(), s.dt,
                                iters=4)(s._require_ops(),
                                         s.set_initial_condition())
    assert bool(torch.isfinite(out).all())
    assert len(calls) == 2 * (md.nt - 1)
    assert fused_hbm.BLOCK_KERNEL.launches == 0
    block = fused_hbm.BlockRows(12, -8, 8, 8)
    u = torch.zeros((3, block.rows, 12), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_hbm.block_kernel_step(torch.zeros(30), 4, u, None, u, None,
                                    False, None, 8, block)


@pytest.mark.parametrize("order", [1, 2])
def test_patch_constants_match_jax(order):
    """The port's patch scalars against the JAX package's at the same
    inputs."""
    problem = japt.Problem()
    want = j_uniform.patch_constants(33, 20.0, problem, 0.25, order,
                                     dtype=jnp.float64)
    got = t_uniform.patch_constants(33, 20.0, tapt.Problem(), 0.25, order,
                                    dtype=torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    lite = t_uniform.make_spec_lite(33)
    assert (lite.n, lite.c) == (33, 32)
    with pytest.raises(ValueError, match="make_spec_lite"):
        t_uniform.extract_constants(lite, torch.zeros(10))
    with pytest.raises(ValueError, match="constant"):
        t_uniform.patch_constants(33, 20.0, tapt.RotatingPlumeProblem(),
                                  0.25, 1)


def test_patch_assembly_matches_full():
    """assembly='patch' on the fused uniform routes (B1, B2) and on the
    block solver (solve(None, u0)) against full assembly: the JAX test's
    tolerance for CRBESolver (atol 2e-6), equality for the block solver's
    patch route against its full one within 1e-12."""
    md = _md(12, 16)
    for impl, kernel in (("fused", "B1"), ("fused_hbm", "B2")):
        full = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                          matvec_impl=impl, solver_method="chebyshev",
                          chebyshev_iters=K, assembly="full", device="cpu")
        patch = CRBESolver(tapt.Domain(), tapt.Problem(), md,
                           matvec_impl=impl, solver_method="chebyshev",
                           chebyshev_iters=K, assembly="patch", device="cpu")
        want = full.solve(store_solutions=False)
        got = patch.solve(store_solutions=False)
        assert patch.fused_kernel == kernel and patch._ops is None
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    u0 = full.set_initial_condition()
    blocks = [build_hbm_halo_solver(_cpu_mesh(8), md, tapt.Problem(),
                                    full.dt, iters=K, assembly=a)
              for a in ("full", "patch")]
    _equal(blocks[1](None, u0), blocks[0](full._require_ops(), u0))
    with pytest.raises(ValueError, match="GlobalOperators"):
        blocks[0](None, u0)
    with pytest.raises(ValueError, match="patch"):
        CRBESolver(tapt.Domain(), tapt.Problem(), md, matvec_impl="stencil",
                   assembly="patch", device="cpu")


def test_block_layout_and_exchange():
    """Interiors cover the canvas, are multiples of 8 and at least the
    halo, and are no larger than that needs; the halo covers the block
    kernels' window; the exchange moves neighbours' interior rows and
    zeros at the chain ends."""
    for n in (12, 48, 129, 257, 513, 1025, 2049):
        for n_blocks in (1, 2, 3, 4, 8):
            for k, use_ka in ((4, False), (8, True), (14, False)):
                halo = hbm_shard.halo_rows(k, use_ka)
                assert halo % 8 == 0
                assert halo >= fused_solver.halo_of(k, use_ka) + 1
                blocks = hbm_shard.RowBlocks(n, n_blocks, halo)
                local = blocks.local
                assert local % 8 == 0 and local >= halo
                assert n_blocks * local >= n
                assert local - 8 < max(-(-n // n_blocks), halo)
                assert [b.row0 for b in blocks.blocks] == [
                    d * local - halo for d in range(n_blocks)]
    blocks = hbm_shard.RowBlocks(12, 3, 8)
    canvas = torch.arange(12 * 12, dtype=torch.float64).reshape(12, 12) + 1
    ext = blocks.split(canvas)
    assert ext.shape == (3, blocks.rows, 12)
    assert torch.equal(blocks.join(ext), canvas)
    interior = ext.clone()
    ext[:, :8] = -1.0
    ext[:, -8:] = -1.0
    hbm_shard.exchange(ext, blocks.local, blocks.halo)
    assert torch.equal(ext, interior)  # neighbours' rows, zeros past ends
    assert float(ext[0, :8].abs().max()) == 0.0
    assert float(ext[-1, -8:].abs().max()) == 0.0
    assert dp_tp_split(8) == (4, 2) and dp_tp_split(5) == (5, 1)


class _Robin(tapt.Problem):
    robin_sides = {"left": 0.1}


class _Obstacle(tapt.Problem):
    obstacles = ((-1.0, 1.0, -1.0, 1.0),)


def test_guards():
    md = _md(8, 8)
    mesh = _cpu_mesh(8)
    for problem in (_Robin(), _Obstacle(), tapt.RotatingPlumeProblem()):
        with pytest.raises(ValueError, match="build_canvas_hbm_halo_solver"):
            build_hbm_halo_solver(mesh, md, problem, 1.0)
    md_u = tapt.MeshData(tapt.create_unstructured_mesh(8, 20.0, seed=1),
                         tapt.Domain(), nt=8, device="cpu")
    with pytest.raises(ValueError, match="structured"):
        build_hbm_halo_solver(mesh, md_u, tapt.Problem(), 1.0)
    with pytest.raises(ValueError, match="divisor"):
        build_hbm_halo_solver(mesh, md, tapt.Problem(), 1.0,
                              snapshot_every=3)
    with pytest.raises(ValueError, match="source_quadrature"):
        build_hbm_halo_solver(mesh, md, tapt.Problem(), 1.0,
                              source_quadrature="bogus")
    with pytest.raises(ValueError, match="assembly"):
        build_hbm_halo_solver(mesh, md, tapt.Problem(), 1.0,
                              assembly="bogus")
    with pytest.raises(ValueError, match="axis"):
        build_hbm_halo_solver(mesh, md, tapt.Problem(), 1.0, axis="dp")
    with pytest.raises(ValueError, match="differs"):
        build_hbm_halo_solver(make_mesh({"mp": 2}, device="meta"), md,
                              tapt.Problem(), 1.0)
    with pytest.raises(ValueError, match="positive"):
        make_mesh({"mp": 0}, device="cpu")
