"""The FNO surrogate of the port (``airpollution_tpu_torch/models/fno.py``)
against the JAX package's ``models/fno.py``, float64 on the CPU: the
cell-center grid, the forward pass on carried parameters, AdamW steps
against optax on identical batches, both datasets on identical problem
lists, ``relative_l2``, and ``.npz`` parameter files across packages."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import airpollution_tpu as japt
from airpollution_tpu.io import checkpoint as jckpt
from airpollution_tpu.models import fno as jfno
from airpollution_tpu.problems import ShiftedPlumeProblem as JShifted

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.interop import fno_params_from_numpy
from airpollution_tpu_torch.io import checkpoint as tckpt
from airpollution_tpu_torch.models import fno as tfno

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-10
SMALL = dict(modes=3, width=4, depth=2, proj=8)


def _mesh_pair(ms, nt):
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(), nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=nt,
                        dtype=torch.float64, device="cpu")
    return jmd, tmd


def _params(in_ch=6, seed=0, **kw):
    jp = jfno.init_fno_params(jax.random.PRNGKey(seed), in_ch=in_ch,
                              dtype=jnp.float64, **(SMALL | kw))
    return jp, fno_params_from_numpy([np.asarray(a) for a in jp],
                                     device="cpu")


@pytest.mark.parametrize("ms", [8, 13, 64])
def test_cell_center_grid_equals_jax(ms):
    """The JAX package's grid, from float64 meshes; the port's float32
    mesh gives the same grid (at 64^2 the JAX package's 1e-6 test refuses
    float32 coordinates, whose rounding is ~2e-6 cells there)."""
    jmd, tmd = _mesh_pair(ms, 3)
    want = jfno.cell_center_index_grid(jmd)
    np.testing.assert_array_equal(tfno.cell_center_index_grid(tmd), want)
    np.testing.assert_array_equal(tfno.grid_coordinates(tmd),
                                  jfno.grid_coordinates(jmd))
    md32 = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=3,
                         device="cpu")
    assert md32.dtype == torch.float32
    np.testing.assert_array_equal(tfno.cell_center_index_grid(md32), want)


def test_init_shapes_and_parameter_count():
    """The JAX layout; at the CLI's widths the 2,365,921 parameters of
    results_snapshot/fno_surrogate.json (shapes only, no draws)."""
    jp, _ = _params(in_ch=7)
    gen = torch.Generator().manual_seed(0)
    tp = tfno.init_fno_params(gen, in_ch=7, dtype=torch.float64, **SMALL)
    assert [tuple(t.shape) for t in tp] == [a.shape for a in jp]
    assert all(t.dtype == torch.float64 for t in tp)
    assert float(tp.lift_b.abs().max()) == 0.0
    s = 1.0 / SMALL["width"] ** 2
    assert float(tp.w1_re.abs().max()) <= s
    full = jax.eval_shape(lambda: jfno.init_fno_params(
        jax.random.PRNGKey(0), in_ch=6))
    assert sum(int(np.prod(a.shape)) for a in full) == 2_365_921


@pytest.mark.parametrize("modes", [3, 4], ids=["apart", "overlap"])
def test_forward_matches_jax(modes):
    """fno_apply on carried parameters; with 4 modes on a 7-row grid the
    two mode corners overlap and the second one wins, as in JAX."""
    jp, tp = _params(modes=modes)
    x = np.random.default_rng(0).standard_normal((3, 7, 7, 6))
    want = np.asarray(jax.jit(jfno.fno_apply)(jp, jnp.asarray(x)))
    got = tfno.fno_apply(tp, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    jrel = jfno.relative_l2(jp, jnp.asarray(x), jnp.asarray(x[..., :1]),
                            batch=2)
    assert tfno.relative_l2(tp, torch.tensor(x), torch.tensor(x[..., :1]),
                            batch=2) == pytest.approx(jrel, rel=1e-12)


def test_adamw_steps_match_optax(monkeypatch):
    """Three AdamW steps (decay on) and three more continuing from the
    returned state, against the JAX trainer (optax's adamw): the port's
    batch draws are patched to the rows JAX's keys draw."""
    jp, tp = _params()
    rng = np.random.default_rng(1)
    X, Y = rng.standard_normal((10, 7, 7, 6)), rng.standard_normal(
        (10, 7, 7, 1))
    jX, jY, tX, tY = jnp.asarray(X), jnp.asarray(Y), torch.tensor(X), \
        torch.tensor(Y)
    kw = dict(epochs=3, batch=4, lr=1e-2, weight_decay=1e-3)
    draws = []

    def jax_rows(key):
        keys = jax.random.split(key, kw["epochs"])
        return torch.as_tensor(np.stack([
            np.asarray(jax.random.randint(k, (kw["batch"],), 0, 10))
            for k in keys]))

    monkeypatch.setattr(tfno, "batch_indices",
                        lambda *a: draws.pop(0))
    state_j = state_t = None
    for seed in (5, 6):
        key = jax.random.PRNGKey(seed)
        jp, state_j, lj = jfno.train_fno(jp, jX, jY, key=key,
                                         opt_state=state_j, **kw)
        draws.append(jax_rows(key))
        tp, state_t, lt = tfno.train_fno(tp, tX, tY, opt_state=state_t,
                                         **kw)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-9)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-9)
    assert state_t.count == 6
    for a, b in zip(state_j[0].nu, state_t.nu):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-18)


def _problem_lists(n):
    rng = np.random.default_rng(11)
    Ds = np.exp(rng.uniform(np.log(0.05), np.log(0.5), n))
    vs = rng.uniform(-1.0, 1.0, (n, 2))
    sig = rng.uniform(0.8, 2.0, n)
    ctr = rng.uniform(-8.0, 8.0, (n, 2))

    def make(cls):
        return [cls(v=tuple(map(float, vs[i])), D=float(Ds[i]),
                    sigma=float(sig[i]), center=tuple(map(float, ctr[i])))
                for i in range(n)]

    return make(JShifted), make(tapt.ShiftedPlumeProblem), Ds, vs


def test_final_state_dataset_matches_jax(monkeypatch):
    jmd, tmd = _mesh_pair(9, 7)
    jprobs, tprobs, Ds, vs = _problem_lists(3)
    monkeypatch.setattr(jfno, "_sample_plume_problems",
                        lambda *a: (jprobs, Ds, vs))
    monkeypatch.setattr(tfno, "_sample_plume_problems",
                        lambda *a: (tprobs, Ds, vs))
    jX, jY, _ = jfno.make_plume_dataset(jmd, japt.Domain(),
                                        jax.random.PRNGKey(0), 3)
    tX, tY, got = tfno.make_plume_dataset(tmd, tapt.Domain(),
                                          torch.Generator(), 3)
    assert got is tprobs and tX.shape == (3, 8, 8, 6) and tY.shape == (
        3, 8, 8, 1)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=TOL)
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=0, atol=TOL)
    # A 'trial' mesh shards the solves (one gloo rank: all of them here);
    # what is not a mesh raises.
    from airpollution_tpu_torch.parallel import launch, make_mesh

    with launch.process_group("gloo"):
        mX, mY, _ = tfno.make_plume_dataset(tmd, tapt.Domain(),
                                            torch.Generator(), 3,
                                            mesh=make_mesh({"trial": 1}))
    assert torch.equal(mX, tX) and torch.equal(mY, tY)
    with pytest.raises(TypeError):
        tfno.make_plume_dataset(tmd, tapt.Domain(), torch.Generator(), 3,
                                mesh=object())


@pytest.mark.parametrize("include_t0", [False, True])
def test_time_dataset_matches_jax(monkeypatch, include_t0):
    """Five problems in chunks of 2 (the last one short), 4 snapshots."""
    jmd, tmd = _mesh_pair(9, 9)
    jprobs, tprobs, Ds, vs = _problem_lists(5)
    monkeypatch.setattr(jfno, "_sample_plume_problems",
                        lambda *a: (jprobs, Ds, vs))
    monkeypatch.setattr(tfno, "_sample_plume_problems",
                        lambda *a: (tprobs, Ds, vs))
    kw = dict(n_times=4, chunk=2, include_t0=include_t0)
    jX, jY, _, jt = jfno.make_plume_time_dataset(
        jmd, japt.Domain(), jax.random.PRNGKey(0), 5, **kw)
    tX, tY, _, tt = tfno.make_plume_time_dataset(
        tmd, tapt.Domain(), torch.Generator(), 5, **kw)
    rows = 5 * (5 if include_t0 else 4)
    assert tX.shape == (rows, 8, 8, 7) and tY.shape == (rows, 8, 8, 1)
    np.testing.assert_allclose(tt, jt, rtol=1e-15)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=TOL)
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="must divide"):
        tfno.make_plume_time_dataset(tmd, tapt.Domain(), torch.Generator(),
                                     2, n_times=3)


def test_sampled_problems_follow_the_family():
    gen = torch.Generator().manual_seed(3)
    probs, Ds, vs = tfno._sample_plume_problems(gen, 64, (0.05, 0.5), 1.5,
                                                (0.8, 2.0), 8.0)
    assert len(probs) == 64 and Ds.min() >= 0.05 and Ds.max() <= 0.5
    assert np.hypot(vs[:, 0], vs[:, 1]).max() <= 1.5
    assert all(abs(p.cx) <= 8.0 and 0.8 <= p.sigma <= 2.0 for p in probs)
    again, _, _ = tfno._sample_plume_problems(
        torch.Generator().manual_seed(3), 64, (0.05, 0.5), 1.5, (0.8, 2.0),
        8.0)
    assert [p.D for p in again] == [p.D for p in probs]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_params_load_in_the_other_package(tmp_path, writer):
    jp, tp = _params(seed=3)
    path = str(tmp_path / "fno.npz")
    if writer == "port":
        tckpt.save_pytree(path, tp)
        like = jfno.init_fno_params(jax.random.PRNGKey(9), in_ch=6,
                                    dtype=jnp.float64, **SMALL)
        got = jckpt.load_pytree(path, like)
        assert type(got).__name__ == "FNOParams"
        for a, b in zip(got, tp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        jckpt.save_pytree(path, jp)
        like = tfno.init_fno_params(torch.Generator(), in_ch=6,
                                    dtype=torch.float64, **SMALL)
        got = tckpt.load_pytree(path, like)
        assert isinstance(got, tfno.FNOParams)
        for a, b in zip(jp, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
