"""The port's L-BFGS (ops/lbfgs.py) against optax.lbfgs(memory_size=20,
linesearch=scale_by_zoom_linesearch(32)), the optimiser of the JAX
package's PINN.finetune_lbfgs, in float64: iterates and losses within
1e-9 on Rosenbrock and on a tiny PINN's composite loss, the latter through
both packages' finetune_lbfgs on the same points."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.models import pinn as jpinn  # noqa: E402
from airpollution_tpu.ops import sampling as jsampling  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.ops import sampling as tsampling  # noqa: E402
from airpollution_tpu_torch.ops.lbfgs import LBFGS  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import (  # noqa: E402
    F64, boundary_points, jax_params, np_params, points, problem_pair,
    tree_rel)

TOL = 1e-9


def _optax_lbfgs():
    return optax.lbfgs(memory_size=20,
                       linesearch=optax.scale_by_zoom_linesearch(
                           max_linesearch_steps=32))


def _rosenbrock(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("seed", [0, 3])
def test_rosenbrock_iterates_match_optax(seed):
    x0 = np.random.default_rng(seed).uniform(-1.5, 1.5, 6)

    def jf(x):
        return _rosenbrock(x, jnp)

    opt = _optax_lbfgs()
    vg = optax.value_and_grad_from_state(jf)

    @jax.jit
    def step(p, state):
        value, grad = vg(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad,
                                    value_fn=jf)
        p = optax.apply_updates(p, updates)
        return p, state, jf(p)

    p = jnp.asarray(x0)
    state = opt.init(p)
    want = []
    for _ in range(30):
        p, state, f = step(p, state)
        want.append((np.asarray(p), float(f)))

    def tvg(x):
        x = x.detach().requires_grad_(True)
        value = _rosenbrock(x, torch)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad, None

    lb = LBFGS(memory_size=20)
    x = torch.tensor(x0)
    state = lb.init(x)
    searches = []
    for p_want, f_want in want:
        x, state = lb.step(x, state, tvg)
        searches.append(state.linesearch_steps)
        assert np.abs(x.numpy() - p_want).max() <= TOL * max(
            1.0, np.abs(p_want).max())
        assert abs(float(state.value) - f_want) <= TOL * max(1.0, f_want)
    # The zoom phase ran (a search of more than one trial step).
    assert max(searches) > 1
    assert want[-1][1] < want[0][1]


def test_finetune_lbfgs_matches_jax(monkeypatch):
    """Ten finetune_lbfgs steps of a [3, 8, 8, 1] adaptive-tanh PINN on the
    same PDE, IC and BC points (both packages' samplers patched to return
    them): the history and the parameters within 1e-9 of JAX's."""
    pde, ic, bc = points(200, 21), points(40, 22)[:, :2], \
        boundary_points(40, 23)
    monkeypatch.setattr(
        jsampling, "lhs_sampling",
        lambda key, n, xy, t=None, dtype=None: jnp.asarray(
            pde if t is not None else ic))
    monkeypatch.setattr(jsampling, "sample_boundary_points",
                        lambda *a, **k: jnp.asarray(bc))
    monkeypatch.setattr(
        tsampling, "lhs_sampling",
        lambda g, n, xy, t=None, dtype=None: torch.tensor(
            pde if t is not None else ic))
    monkeypatch.setattr(tsampling, "sample_boundary_points",
                        lambda *a, **k: torch.tensor(bc))
    params = np_params([3, 8, 8, 1], seed=5)
    jp, tp = problem_pair("plume")
    sizes = {"pde": 200, "ic": 40, "bc": 40}
    lam = {"pde": 2.0, "ic": 10.0, "bc": 5.0}
    jm = jpinn.PINN([3, 8, 8, 1], jp, japt.Domain(), dtype=jnp.float64)
    jm.params = jax_params(params)
    jh = jm.finetune_lbfgs(sizes, 10, lam)
    tm = tapt.PINN([3, 8, 8, 1], tp, tapt.Domain(), dtype=F64,
                   device="cpu")
    tm.params = params
    th = tm.finetune_lbfgs(sizes, 10, lam)
    for k in ("total_loss", "pde_loss", "ic_loss", "bc_loss"):
        assert len(th[k]) == 10
        np.testing.assert_allclose(th[k], jh[k], rtol=TOL)
    assert jh["total_loss"][-1] < 0.5 * jh["total_loss"][0]
    assert tree_rel(tm.params, jm.params, skip=()) <= TOL
