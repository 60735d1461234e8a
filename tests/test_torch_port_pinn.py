"""The port's PINN pieces against the JAX package's, in float64 on the
same parameters (numpy-made, carried into both) and the same points:
the network, the hard-IC ansatz, residual autodiff, the composite loss and
its gradient under every training option, the errors, output_scale='auto'
and the parameter counts. Tolerance 1e-12 relative throughout."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.models import pinn as jpinn  # noqa: E402
from airpollution_tpu.ops import autodiff as jad  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.models import pinn as tpinn  # noqa: E402
from airpollution_tpu_torch.ops import autodiff as tad  # noqa: E402

from torch_port_helpers import mesh_pair, one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import (  # noqa: E402
    F64, boundary_points, jax_params, np_params, points, port_mlp,
    problem_pair, rel, tree_rel)

TOL = 1e-12
ACTS = ("adaptive_tanh", "tanh", "sine", "swish")


@pytest.mark.parametrize("fourier,amp", [(0, None), (6, 0.3)])
@pytest.mark.parametrize("act", ACTS)
def test_mlp_matches_mlp_apply(act, fourier, amp):
    params = np_params([3, 8, 8, 1], act, fourier=fourier, amp=amp)
    x = points(40, 1)
    want = jpinn.mlp_apply(jax_params(params), jnp.asarray(x), act)
    got = port_mlp(params, act)(torch.tensor(x))
    assert got.shape == want.shape == (40, 1)
    assert rel(got, want) <= TOL


def test_mlp_layout_and_init():
    """The flat parameter's views are the JAX layout; a fresh network has
    Xavier-normal weights, zero biases, unit alphas, the amplitude and a
    B divided by the input half-widths."""
    g = torch.Generator().manual_seed(0)
    mlp = tpinn.MLP([3, 64, 64, 1], "adaptive_tanh", fourier_features=4,
                    input_scales=(20.0, 10.0, 5.0), output_scale=0.25,
                    dtype=F64, device="cpu", generator=g)
    tree = mlp.params_tree()
    assert [sorted(d) for d in tree] == [["B"], ["W", "alpha", "b"],
                                         ["W", "alpha", "b"],
                                         ["W", "amp", "b"]]
    assert tree[1]["W"].shape == (8, 64) and tree[3]["W"].shape == (64, 1)
    assert float(tree[3]["amp"].detach()) == 0.25
    assert all(float(d["b"].detach().abs().max()) == 0.0 for d in tree[1:])
    assert all(bool((d["alpha"] == 1).all()) for d in tree[1:3])
    std = float(tree[2]["W"].detach().std())
    assert abs(std - np.sqrt(2 / 128)) < 0.01
    assert mlp.B.shape == (3, 4)
    assert tpinn.count_trainable_parameters(mlp) == mlp.flat.numel() == (
        8 * 64 + 64 + 64 + 64 * 64 + 64 + 64 + 64 + 1 + 1)
    jtree = jpinn.init_mlp_params(jax.random.PRNGKey(0), [3, 64, 64, 1],
                                  fourier_features=4, output_scale=0.25)
    assert tpinn.count_trainable_parameters(tree) == \
        jpinn.count_trainable_parameters(jtree)
    assert tpinn.count_parameters([3, 20, 20, 1]) == \
        jpinn.count_parameters([3, 20, 20, 1])


@pytest.mark.parametrize("hard_ic", [False, True])
def test_ansatz_matches(hard_ic):
    params = np_params([3, 8, 8, 1], "tanh", amp=0.5)
    jp, tp = problem_pair("plume")
    x = points(30, 2)
    want = jpinn.ansatz_apply(jax_params(params), jnp.asarray(x), "tanh",
                              jp, hard_ic, 10.0)
    got = tpinn.ansatz_apply(port_mlp(params, "tanh"), torch.tensor(x), tp,
                             hard_ic, 10.0)
    assert rel(got, want) <= TOL


def _fields(params=None):
    """(JAX point function, port batch function): an analytic field, or the
    network of ``params``."""
    if params is None:
        def jf(p):
            return p[0] ** 2 * jnp.sin(p[1] / 3.0) + p[2] * p[0] * p[1] \
                + jnp.exp(-p[1] ** 2 / 50.0) * p[2] ** 2

        def tf(P):
            x, y, t = P[:, 0], P[:, 1], P[:, 2]
            return x ** 2 * torch.sin(y / 3.0) + t * x * y \
                + torch.exp(-y ** 2 / 50.0) * t ** 2

        return jf, tf
    jpar, mlp = jax_params(params), port_mlp(params)
    return (lambda p: jpinn.mlp_apply(jpar, p, "adaptive_tanh")[0],
            lambda P: mlp(P)[:, 0])


@pytest.mark.parametrize("field", ["analytic", "network"])
def test_gradients_laplacian_hessian(field):
    params = None if field == "analytic" else np_params(
        [3, 8, 8, 1], fourier=4, amp=0.7)
    jf, tf = _fields(params)
    x = points(25, 3)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    for want, got in zip(jad.gradient_and_laplacian_xy(jf, jx),
                         tad.gradient_and_laplacian_xy(tf, tx)):
        assert got.shape == want.shape and rel(got, want) <= TOL
    for want, got in zip(jad.gradient_and_hessian_xy(jf, jx),
                         tad.gradient_and_hessian_xy(tf, tx)):
        assert got.shape == want.shape and rel(got, want) <= TOL


def test_laplacian_of_the_plume_residual_vanishes():
    """The closed form satisfies the PDE: the residual through the correct
    Laplacian is ~0 (the reference's mis-sliced one is not)."""
    _, tp = problem_pair("plume")
    x = torch.tensor(points(50, 4, t_range=(0.5, 10.0)))
    res = tad.pde_residual(lambda P: tp.analytical_solution(P), x, tp.v,
                           tp.D, tp.source_term(x))
    assert float(res.abs().max()) <= 1e-12


@pytest.mark.parametrize("case", ["scalar", "per_point", "tensor",
                                  "reaction", "tensor_field"])
def test_pde_residual_branches(case):
    params = np_params([3, 8, 8, 1])
    jf, tf = _fields(params)
    x = points(30, 5)
    n = len(x)
    rng = np.random.default_rng(6)
    src = rng.standard_normal(n)
    v, D, kw = (1.0, 0.5), 0.1, {}
    if case == "per_point":
        v = rng.standard_normal((n, 2))
        D = 0.1 + 0.05 * rng.random(n)
        kw = {"D_grad": rng.standard_normal((n, 2))}
    elif case == "tensor":
        D = np.array([[0.2, 0.05], [0.05, 0.1]])
    elif case == "reaction":
        kw = {"reaction": 0.3}
    elif case == "tensor_field":
        D = np.ones((n, 2, 2))
        with pytest.raises(NotImplementedError):
            jad.pde_residual(jf, jnp.asarray(x), jnp.asarray(v), D,
                             jnp.asarray(src))
        with pytest.raises(NotImplementedError):
            tad.pde_residual(tf, torch.tensor(x), v, torch.tensor(D),
                             torch.tensor(src))
        return

    def conv(a, lib):
        if isinstance(a, np.ndarray):
            return jnp.asarray(a) if lib == "j" else torch.tensor(a)
        return a

    want = jad.pde_residual(jf, jnp.asarray(x), conv(np.asarray(v), "j"),
                            conv(D, "j"), jnp.asarray(src),
                            **{k: conv(a, "j") for k, a in kw.items()})
    tv = conv(v, "t") if isinstance(v, np.ndarray) else v
    got = tad.pde_residual(tf, torch.tensor(x), tv, conv(D, "t"),
                           torch.tensor(src),
                           **{k: conv(a, "t") for k, a in kw.items()})
    assert got.shape == want.shape == (n, 1)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("name", ["plume", "emitter", "rotating",
                                  "variable_D", "time_varying_D"])
def test_problem_pde_residual(name):
    """Each problem's residual, the variable-D ones through
    diffusion_grad_at (a per-point t for the time-varying one)."""
    params = np_params([3, 8, 8, 1])
    jf, tf = _fields(params)
    jp, tp = problem_pair(name)
    x = points(30, 7)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    want = jad.problem_pde_residual(jf, jx, jp, jp.source_term(jx))
    got = tad.problem_pde_residual(tf, tx, tp, tp.source_term(tx))
    assert rel(got, want) <= TOL
    if name.endswith("_D"):
        targs = ((jx[:, 2],), (tx[:, 2],)) if name.startswith("time") \
            else ((), ())
        gw = jp.diffusion_grad_at(jx[:, :2], *targs[0])
        gg = tp.diffusion_grad_at(tx[:, :2], *targs[1])
        assert float(np.abs(np.asarray(gw)).max()) > 1e-3
        assert rel(gg, gw) <= TOL
    else:
        assert float(tp.diffusion_grad_at(tx[:, :2]).abs().max()) == 0.0


# Options of composite_loss: (problem, keyword arguments, n_pde).
LOSS_CASES = {
    "plain": ("plume", {}, 64),
    "chunks": ("plume", {}, 4096 + 77),
    "chunks_minibatch": ("plume", {"mini_batch_size": 1000}, 4096 + 77),
    "hard_ic": ("plume", {"hard_ic": True}, 64),
    "causal": ("plume", {"causal_eps": 1.0, "causal_bins": 8}, 70),
    "obstacles_folded": ("obstacles", {"facade": False}, 64),
    "obstacles_split": ("obstacles", {"facade": True}, 64),
    "robin": ("robin", {}, 64),
    "reaction": ("reaction", {"reaction_active": True}, 64),
    "variable_D": ("variable_D", {}, 64),
    "fourier_amp": ("emitter", {"fourier": 6, "amp": 0.4}, 64),
}


def _loss_inputs(name, params_kw=None):
    pname, kw, n_pde = LOSS_CASES[name]
    kw = dict(kw)
    jp, tp = problem_pair(pname)
    params = np_params([3, 8, 8, 1], fourier=kw.pop("fourier", 0),
                       amp=kw.pop("amp", None), seed=11)
    facade = kw.pop("facade", None)
    lam = {"pde": 2.0, "ic": 10.0, "bc": 5.0}
    if facade:
        lam["facade"] = 3.0
    pde = points(n_pde, 12)
    if pname == "obstacles":
        # Some points inside the solids, where the PDE weighs 0.
        pde[:8, 0] = np.linspace(-5.0, -2.0, 8)
        pde[:8, 1] = np.linspace(-3.0, 2.0, 8)
    ic = points(32, 13)
    ic[:, 2] = 0.0
    if pname == "obstacles":
        ic[:4, :2] = [[-5.0, 0.0], [-2.0, 1.0], [5.0, 3.0], [8.0, 4.0]]
    bc = boundary_points(40, 14)
    data = dict(pde=pde, ic=ic, ic_target=np.asarray(
        jp.initial_condition_fn(jnp.asarray(ic[:, :2]))).reshape(-1, 1),
        bc=bc, bc_target=np.asarray(jp.boundary_fn(jnp.asarray(bc))).reshape(
            -1, 1))
    fac = None
    if facade is not None:
        from airpollution_tpu_torch.ops import sampling

        g = torch.Generator().manual_seed(3)
        xyt, nrm = sampling.sample_facade_points(g, 20, tp.obstacles,
                                                 (0.0, 10.0), F64)
        fac = (xyt.numpy(), nrm.numpy())
    return jp, tp, params, lam, data, fac, kw


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_composite_loss_and_gradient(name):
    jp, tp, params, lam, d, fac, kw = _loss_inputs(name)
    mb = kw.pop("mini_batch_size", None)
    jfac = {} if fac is None else dict(xyt_fac=jnp.asarray(fac[0]),
                                      fac_normals=jnp.asarray(fac[1]))
    tfac = {} if fac is None else dict(xyt_fac=torch.tensor(fac[0]),
                                      fac_normals=torch.tensor(fac[1]))

    def jloss(p):
        return jpinn.composite_loss(
            p, jp, jnp.asarray(d["pde"]), jnp.asarray(d["ic"]),
            jnp.asarray(d["ic_target"]), jnp.asarray(d["bc"]),
            jnp.asarray(d["bc_target"]), lam, mb, "adaptive_tanh",
            t_final=10.0, **kw, **jfac)

    (jtotal, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax_params(params))
    mlp = port_mlp(params)
    total, aux = tpinn.composite_loss(
        mlp, tp, torch.tensor(d["pde"]), torch.tensor(d["ic"]),
        torch.tensor(d["ic_target"]), torch.tensor(d["bc"]),
        torch.tensor(d["bc_target"]), lam, mb, t_final=10.0, **kw, **tfac)
    for got, want in zip((total,) + tuple(aux), (jtotal,) + tuple(jaux)):
        got = got.detach()
        if float(want) == 0.0:
            assert float(got) == 0.0
        else:
            assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    (g,) = torch.autograd.grad(total, mlp.flat)
    assert tree_rel(mlp.params_tree(g), jgrad) <= TOL


def test_compute_errors_match_on_ms8():
    jmd, tmd = mesh_pair(8)
    params = np_params([3, 8, 8, 1], "tanh", amp=0.2)
    jp, tp = problem_pair("plume")
    jm = jpinn.PINN([3, 8, 8, 1], jp, japt.Domain(), activation="tanh",
                    dtype=jnp.float64, output_scale=0.2)
    jm.params = jax_params(params)
    tm = tapt.PINN([3, 8, 8, 1], tp, tapt.Domain(), activation="tanh",
                   dtype=F64, output_scale=0.2, device="cpu")
    tm.params = params
    for fn in ("compute_errors", "compute_fem_errors"):
        want = getattr(jm, fn)(jmd, jp.analytical_solution)
        got = getattr(tm, fn)(tmd, tp.analytical_solution)
        np.testing.assert_allclose(got, want, rtol=TOL)
    x = points(20, 9)
    assert rel(tm.compute_pde_residual(x),
               jm.compute_pde_residual(jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("name", ["plume", "emitter"])
def test_output_scale_auto(name):
    """The amplitude from max |IC| on the 64 x 64 grid, None for a zero
    IC."""
    jp, tp = problem_pair(name)
    jm = jpinn.PINN([3, 4, 1], jp, japt.Domain(Lx=20.0, Ly=12.0),
                    dtype=jnp.float64, output_scale="auto")
    tm = tapt.PINN([3, 4, 1], tp, tapt.Domain(Lx=20.0, Ly=12.0), dtype=F64,
                   output_scale="auto", device="cpu")
    if jm.output_scale is None:
        assert tm.output_scale is None and "amp" not in tm.params[-1]
    else:
        assert abs(tm.output_scale - jm.output_scale) <= \
            TOL * jm.output_scale
        assert float(tm.params[-1]["amp"]) == tm.output_scale
