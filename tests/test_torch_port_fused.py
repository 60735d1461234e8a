"""The plain versions of the port's two fused kernels against the JAX
package's Pallas kernels in interpret mode, float64, on one operator and
one Chebyshev interval: B1 (ops/fused_solver.fused_solve_uniform vs
pallas_solver.fused_solve_uniform) and B2 (ops/fused_hbm.
fused_solve_uniform_hbm vs pallas_hbm.fused_solve_uniform_hbm with
8-row stripes), within 1e-10."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.ops import pallas_hbm, pallas_solver
from airpollution_tpu.ops import stencil as j_stencil
from airpollution_tpu.ops import uniform as j_uniform

from airpollution_tpu_torch.ops import fused_hbm, fused_solver
from airpollution_tpu_torch.ops import stencil as t_stencil
from airpollution_tpu_torch.ops import uniform as t_uniform

from torch_port_helpers import mesh_pair, rel_diff

pytestmark = pytest.mark.kernels

TOL = 1e-10
MS, N_STEPS, K = 17, 11, 4
BOUNDS = (0.55, 1.55)  # fed to both packages


def _inputs(order):
    jmd, tmd = mesh_pair(MS, nt=N_STEPS + 1)
    ops = j_crbe.assemble(jmd, japt.Problem(), 10.0 / N_STEPS, order,
                          "reference")
    jspec = j_uniform.build_uniform_spec(j_stencil.get_pattern(jmd))
    tspec = t_uniform.build_uniform_spec(t_stencil.get_pattern(tmd))
    pattern = j_stencil.get_pattern(jmd)
    u0 = japt.Problem().initial_condition_fn(jmd.midpoints)[
        jnp.asarray(pattern.perm)]
    j_args = (
        j_uniform.extract_constants(jspec, ops.system.vals),
        j_uniform.family_constants(jspec, ops.mass_diag),
        1.0 / j_uniform.family_constants(jspec, ops.system_diag),
        u0,
    )
    t_args = tuple(torch.tensor(np.asarray(a)) for a in j_args)
    return jspec, j_args, tspec, t_args


CASES = [(1, False), (1, True), (2, False), (2, True)]


@pytest.mark.parametrize("order,extrapolate", CASES)
def test_plain_b1_matches_pallas_solver(order, extrapolate):
    jspec, j_args, tspec, t_args = _inputs(order)
    kw = dict(n_steps=N_STEPS, n_iters=K, use_ka=order == 2,
              extrapolate=extrapolate, bounds=BOUNDS)
    want = pallas_solver.fused_solve_uniform(
        jspec, *j_args, method="chebyshev", interpret=True, **kw)
    got = fused_solver.fused_solve_uniform(tspec, *t_args, **kw)
    assert fused_solver.KERNEL.launches == 0
    assert rel_diff(got, want) <= TOL


@pytest.mark.parametrize("order,extrapolate", CASES)
def test_plain_b2_matches_pallas_hbm(order, extrapolate):
    jspec, j_args, tspec, t_args = _inputs(order)
    kw = dict(n_steps=N_STEPS, n_iters=K, use_ka=order == 2,
              extrapolate=extrapolate, bounds=BOUNDS)
    want = pallas_hbm.fused_solve_uniform_hbm(
        jspec, *j_args, stripe_rows=8, interpret=True, **kw)
    got, bad = fused_hbm.fused_solve_uniform_hbm(tspec, *t_args,
                                                 guard_every=N_STEPS, **kw)
    assert fused_hbm.KERNEL.launches == 0
    assert int(bad) == -1
    assert rel_diff(got, want) <= TOL


def test_canvas_round_trip_matches_jax():
    jspec, j_args, tspec, t_args = _inputs(1)
    u = t_args[-1]
    canv = fused_solver.to_canvases(tspec, u)
    for f, jc in enumerate(pallas_solver.to_canvases(jspec, j_args[-1])):
        np.testing.assert_array_equal(canv[f].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        fused_solver.from_canvases(tspec, canv).numpy(), u.numpy())


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("use_ka", [False, True])
def test_step_reach_fits_the_kernel_halo(k, use_ka):
    """The CUDA kernels compute a tile from a window with halo_of(k, use_ka)
    cells on each side: a change of u or u_prev at one cell must not move
    the step's output farther away than that."""
    n, mid = 41, 20
    rng = np.random.default_rng(7)
    scal = torch.tensor(np.concatenate([
        rng.uniform(-0.3, 0.3, 15), [0.5, 0.6, 0.7], [1.1, 1.2, 1.3], [0.9],
        rng.uniform(0.1, 1.0, 2 * k)]))
    u = torch.tensor(rng.standard_normal((3, n, n)))
    up = torch.tensor(rng.standard_normal((3, n, n)))
    masks = fused_solver.rect_masks(n, torch.float64, "cpu")
    base, _ = fused_solver.plain_step(scal, k, u, up, use_ka, masks)
    halo = fused_solver.halo_of(k, use_ka)
    for f in range(3):
        for which in ("u", "up"):
            du, dup = u.clone(), up.clone()
            (du if which == "u" else dup)[f, mid, mid] += 1.0
            out, _ = fused_solver.plain_step(scal, k, du, dup, use_ka, masks)
            _, rows, cols = torch.nonzero(out != base, as_tuple=True)
            assert rows.numel() > 0
            reach = int(torch.maximum((rows - mid).abs(),
                                      (cols - mid).abs()).max())
            assert reach <= halo, (f, which, reach, halo)


def test_guard_flags_the_first_diverged_chunk():
    jspec, j_args, tspec, t_args = _inputs(1)
    # An interval far below the spectrum makes Chebyshev diverge.
    out, bad = fused_hbm.fused_solve_uniform_hbm(
        tspec, *t_args, n_steps=12, n_iters=K, bounds=(0.01, 0.02),
        guard_every=fused_hbm.guard_stride(12, target=4))
    assert int(bad) in (4, 8, 12)
    assert fused_hbm.guard_stride(1000) == 50
    assert fused_hbm.guard_stride(1000) == pallas_hbm.guard_stride(1000)
    assert fused_hbm.guard_stride(97) == pallas_hbm.guard_stride(97) == 1
