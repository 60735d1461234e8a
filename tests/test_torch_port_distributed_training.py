"""The port's multi-process trainers on 4 gloo ranks, float64 on the CPU:
``forward_tp`` and ``parallel_loss_reference`` on {'dp': 2, 'tp': 2}
against the JAX package's on the same mesh shape (identical parameters
and points, 1e-12; the PDE residual's second derivatives go through the
collectives), 5 epochs of ``build_parallel_trainer`` and of
``PINN.train_parallel`` on 4 ranks against the port's one rank (the same
global batches from one seed, 1e-10), ``train_fno_dp`` over {'data': 4}
against ``train_fno`` on the same batches (1e-10), and the command line's
``fno --data_parallel`` on one rank (the JAX CLI's keys).

One ``launch.spawn`` (a module-scoped fixture, deadline 120 s) runs the
rank cases (tests/torch_port_distributed_ranks.training_cases); the
one-rank references run here in a one-rank gloo group."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import airpollution_tpu as japt
from airpollution_tpu.models.pinn import init_mlp_params
from airpollution_tpu.parallel import make_mesh as j_make_mesh
from airpollution_tpu.parallel.pinn_parallel import (
    forward_tp as j_forward_tp, parallel_loss_reference as j_loss_reference,
    tp_param_specs as j_specs)

from airpollution_tpu_torch import cli as t_cli
from airpollution_tpu_torch.models import fno as tfno
from airpollution_tpu_torch.parallel import launch, make_mesh

import torch_port_distributed_ranks as ranks

N_RANKS = 4
LAM = {"pde": 2.0, "ic": 10.0, "bc": 10.0}
# name -> (layers, activation, Fourier features, output amplitude)
FORWARD = {"adaptive_odd": ([3, 8, 8, 8, 1], "adaptive_tanh", 0, False),
           "tanh_even_amp": ([3, 8, 8, 1], "tanh", 0, True),
           "sine_fourier": ([3, 8, 8, 8, 1], "sine", 4, False),
           "swish": ([3, 8, 8, 8, 1], "swish", 0, False)}
TRAINER = ([3, 8, 8, 1], {"pde": 64, "ic": 16, "bc": 16}, LAM, 7)
FNO_KW = dict(epochs=4, batch=8, lr=1e-3, weight_decay=1e-4)


def _numpy_tree(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _forward_params():
    out = {}
    for i, (name, (layers, act, fourier, amp)) in enumerate(FORWARD.items()):
        params = init_mlp_params(
            jax.random.PRNGKey(i), layers, act, jnp.float64,
            fourier_features=fourier, input_scales=(20.0, 20.0, 5.0),
            output_scale=0.37 if amp else 0.0)
        out[name] = (layers, act, _numpy_tree(params), fourier, amp)
    return out


def _points(rng, n, t0=False):
    xy = rng.uniform(-20, 20, (n, 2))
    t = np.zeros((n, 1)) if t0 else rng.uniform(0, 10, (n, 1))
    return np.hstack([xy, t])


def _loss_case():
    rng = np.random.default_rng(0)
    layers = [3, 8, 8, 8, 1]
    params = _numpy_tree(init_mlp_params(jax.random.PRNGKey(9), layers,
                                         "tanh", jnp.float64))
    problem = japt.Problem(v=(1.0, 0.5), D=0.2, sigma=1.5)
    pde, ic, bc = _points(rng, 64), _points(rng, 16, t0=True), _points(rng, 16)
    batches = (pde, ic,
               np.asarray(problem.initial_condition_fn(ic[:, :2])).reshape(
                   -1, 1),
               bc, np.asarray(problem.boundary_fn(bc)).reshape(-1, 1))
    return layers, params, batches, LAM, problem


def _fno_case():
    gen = torch.Generator().manual_seed(1)
    params = tfno.init_fno_params(gen, in_ch=3, modes=2, width=4, depth=2,
                                  dtype=torch.float64)
    rng = np.random.default_rng(2)
    X, Y = rng.normal(size=(12, 8, 8, 3)), rng.normal(size=(12, 8, 8, 1))
    return [t.numpy() for t in params], X, Y, FNO_KW


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = tmp_path_factory.mktemp("training_ranks")
    fwd = _forward_params()
    x = np.random.default_rng(3).uniform(-1, 1, (16, 3))
    layers, params, batches, lam, _ = _loss_case()
    launch.spawn(ranks.training_cases, N_RANKS, backend="gloo",
                 args=(str(out), (fwd, x), (layers, params, batches, lam),
                       TRAINER, _fno_case()), timeout_s=120)
    results = {}
    for f in sorted(out.glob("rank0_*.npy")):
        case = f.name[len("rank0_"):-len(".npy")]
        first = np.load(f)
        for r in range(1, N_RANKS):
            np.testing.assert_array_equal(
                np.load(out / f"rank{r}_{case}.npy"), first)
        results[case] = first
    return dict(results, fwd=fwd, x=x)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_tp_matches_jax(got, name):
    layers, act, params, fourier, amp = got["fwd"][name]
    specs = j_specs(layers, act, fourier, output_scale=amp)
    fn = jax.shard_map(lambda p, xx: j_forward_tp(p, xx, act),
                       mesh=j_make_mesh({"dp": 2, "tp": 2}),
                       in_specs=(specs, P("dp")), out_specs=P("dp"),
                       check_vma=False)
    want = np.asarray(jax.jit(fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(got["x"])))
    assert got[f"forward_{name}"].shape == want.shape == (16, 1)
    assert _rel(got[f"forward_{name}"], want) <= 1e-12


def test_parallel_loss_reference_matches_jax(got):
    layers, params, batches, lam, problem = _loss_case()
    total, aux = j_loss_reference(
        j_make_mesh({"dp": 2, "tp": 2}), layers,
        jax.tree.map(jnp.asarray, params),
        tuple(jnp.asarray(b) for b in batches), problem, lam,
        activation="tanh")
    want = np.concatenate([[float(total)], np.asarray(aux)])
    np.testing.assert_allclose(got["loss"], want, rtol=1e-12, atol=0)


def _one_rank(fn):
    with launch.process_group("gloo"):
        return fn(make_mesh({"dp": 1, "tp": 1}))


def test_trainer_on_four_ranks_equals_one_rank(got):
    losses, state = _one_rank(lambda m: ranks.run_trainer(m, *TRAINER))
    assert got["trainer_losses"].shape == (5, 4)
    assert _rel(got["trainer_losses"], losses.numpy()) <= 1e-10
    assert _rel(got["trainer_params"],
                ranks.flat_params(state.params).numpy()) <= 1e-10
    assert got["trainer_losses"][-1, 0] < got["trainer_losses"][0, 0]


def test_pinn_train_parallel_on_four_ranks_equals_one_rank(got):
    """Two calls (3 + 2 epochs, the Adam moments carried): the history,
    the parameters copied back into the model and the step count."""
    model, history = _one_rank(ranks.run_train_parallel)
    assert history.shape == (5,) and int(model._parallel_state.count) == 5
    assert int(got["pinn_count"]) == 5
    assert _rel(got["pinn_history"], history) <= 1e-10
    assert _rel(got["pinn_params"],
                ranks.flat_params(model.params).numpy()) <= 1e-10


def test_fno_data_parallel_equals_train_fno(got):
    params, X, Y, kw = _fno_case()
    out, state, losses = tfno.train_fno(
        ranks.fno_params(params), torch.as_tensor(X), torch.as_tensor(Y),
        **kw, generator=torch.Generator().manual_seed(3))
    assert state.count == kw["epochs"]
    assert _rel(got["fno_losses"], losses.numpy()) <= 1e-10
    assert _rel(got["fno_params"],
                torch.cat([t.reshape(-1) for t in out]).numpy()) <= 1e-10


def test_fno_data_parallel_checks_the_batch_and_the_mesh(got):
    """A batch of 6 on 4 ranks raises on every rank, as the JAX trainer;
    a mesh that is not a ProcessMesh raises TypeError."""
    from airpollution_tpu_torch.parallel import train_fno_dp

    assert "batch 6 not divisible by data=4" in str(got["fno_batch_error"])
    with pytest.raises(TypeError):
        train_fno_dp(object(), None, None, None)


def test_cli_fno_data_parallel_on_one_rank(tmp_path, monkeypatch, capsys):
    """Outside torchrun (one rank) ``--data_parallel`` trains on the one
    rank and says so in the JAX CLI's keys, as the JAX CLI does on one
    device; the batch stays as given."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("APT_PLATFORM", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    t_cli.main(["fno", "--mesh_size", "9", "--nt", "9", "--n_train", "6",
                "--n_test", "3", "--modes", "2", "--width", "4",
                "--depth", "1", "--epochs", "3", "--batch", "3",
                "--data_parallel"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["data_parallel"] is False and res["n_devices"] == 1
    assert res["batch"] == 3 and np.isfinite(res["loss_last"])
    assert not torch.distributed.is_initialized()
