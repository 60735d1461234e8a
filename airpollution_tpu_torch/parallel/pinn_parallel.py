"""Multi-process PINN training, data-parallel batches x tensor-parallel
MLP, PyTorch counterpart of ``airpollution_tpu/parallel/pinn_parallel.py``.

On a ProcessMesh with axes ``'dp'`` and ``'tp'`` (parallel/device_mesh):

- **dp (data parallel):** the collocation batch is split over 'dp'; the
  composite loss is formed with a ``psum`` over 'dp', so every rank holds
  the global loss, and the parameters, replicated over 'dp', enter through
  ``pvary`` over 'dp', so their gradients come out globally summed.
- **tp (tensor parallel):** hidden layers alternate Megatron-style: even
  hidden layers split their output features (column parallel: W (in,
  out/tp), b and alpha split), odd ones their input features (row
  parallel: W (in/tp, out)) with a ``psum`` over 'tp' re-forming the
  activations; a column-parallel layer's input enters through ``pvary``
  over 'tp'. The PDE residual takes second derivatives through these
  collectives (parallel/collectives.py: each one's transpose is the
  other).
- Parameters and the Adam moments are split like the parameters; the
  fused Adam (explicit moments, the JAX module's ``_adam_update``) keeps
  every rank's update identical.

Every rank draws the global batch from one generator with the same seed
and takes its slice, so N ranks train as one does, up to the order of
the sums. The states and losses going in and out are global (the JAX
functions' global arrays), on every rank.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from airpollution_tpu_torch.models.pinn import ansatz_apply, init_mlp_params
from airpollution_tpu_torch.ops import autodiff, sampling
from airpollution_tpu_torch.parallel.collectives import (all_gather_rows,
                                                         psum, pvary)
from airpollution_tpu_torch.parallel.device_mesh import ProcessMesh

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _num_hidden(layers) -> int:
    return len(layers) - 2


def tp_param_specs(layers, activation="adaptive_tanh", fourier_features=0,
                   output_scale=False):
    """The split of each parameter, in ``init_mlp_params``' structure:
    per dimension the mesh axis it is split over, or None (JAX's
    PartitionSpec as a tuple). Hidden layer h is column parallel when h is
    even, row parallel when odd; the output layer is row parallel iff the
    last hidden layer left the activations split. The frozen Fourier
    ``B`` and the amplitude ``amp`` are replicated."""
    specs = []
    if fourier_features:
        specs.append({"B": (None, None)})
    n_hidden = _num_hidden(layers)
    for h in range(n_hidden):
        if h % 2 == 0:  # column parallel
            spec = {"W": (None, "tp"), "b": ("tp",)}
            if activation == "adaptive_tanh":
                spec["alpha"] = ("tp",)
        else:  # row parallel
            spec = {"W": ("tp", None), "b": (None,)}
            if activation == "adaptive_tanh":
                spec["alpha"] = (None,)
        specs.append(spec)
    if n_hidden % 2 == 1:  # activations are split entering the last layer
        last = {"W": ("tp", None), "b": (None,)}
    else:
        last = {"W": (None, None), "b": (None,)}
    if output_scale:
        last["amp"] = ()
    specs.append(last)
    return specs


def validate_tp_layers(layers, tp_size):
    """Every split dimension must divide by tp_size."""
    for h in range(_num_hidden(layers)):
        if layers[h + 1] % tp_size != 0:
            raise ValueError(
                f"hidden width {layers[h + 1]} not divisible by tp={tp_size}")


def _check_mesh(mesh):
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(
            f"the parallel PINN trainer runs on a ProcessMesh with axes "
            f"'dp' and 'tp' (a process group: parallel/launch.py), got "
            f"{type(mesh).__name__}")
    if set(mesh.shape) != {"dp", "tp"}:
        raise ValueError(f"the mesh needs axes 'dp' and 'tp', has "
                         f"{sorted(mesh.shape)}")


def _split(x, spec, mesh):
    """This rank's part of a global parameter."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            size = x.shape[dim] // mesh.shape[ax]
            x = x.narrow(dim, mesh.index(ax) * size, size)
    return x


def _joined(x, spec, mesh):
    """A global parameter from every rank's part."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = all_gather_rows(x, mesh, ax, dim=dim)
    return x


def _tree_map(fn, tree, specs):
    return [{k: fn(v, spec[k]) for k, v in layer.items()}
            for layer, spec in zip(tree, specs)]


def shard_params(params, specs, mesh):
    """The rank's parts of a global parameter list (:func:`tp_param_specs`
    splits), detached contiguous copies."""
    return _tree_map(
        lambda v, s: _split(torch.as_tensor(v, device=mesh.device), s, mesh)
        .detach().contiguous().clone(), params, specs)


def gather_params(params, specs, mesh):
    """The global parameter list from every rank's parts."""
    return _tree_map(lambda v, s: _joined(v.detach(), s, mesh), params,
                     specs)


def forward_tp(params, x, activation="adaptive_tanh", *, mesh, axis="tp"):
    """Tensor-parallel forward on this rank's parameter parts: ``x`` is
    the rank's batch (the same on every rank of the 'tp' line); returns
    the whole (batch, 1) output on each of them."""
    h = x
    if params and "B" in params[0]:
        # Replicated Fourier embedding (models/pinn.mlp_apply semantics).
        z = h @ params[0]["B"].detach()
        h = torch.cat([torch.sin(z), torch.cos(z)], dim=-1)
        params = params[1:]
    split = False  # whether h holds this rank's part of the features
    for layer in params[:-1]:
        if not split:  # column parallel: out-features split
            z = pvary(h, mesh, axis) @ layer["W"] + layer["b"]
        else:  # row parallel: partial sums over split in-features
            z = psum(h @ layer["W"], mesh, axis) + layer["b"]
        split = not split
        if activation == "adaptive_tanh":
            h = torch.tanh(layer["alpha"] * z)
        elif activation == "tanh":
            h = torch.tanh(z)
        elif activation == "sine":
            h = torch.sin(z)
        elif activation == "swish":
            h = z * torch.sigmoid(z)
        else:
            raise ValueError(f"Activation function {activation} not "
                             f"implemented")
    last = params[-1]
    if split:
        out = psum(h @ last["W"], mesh, axis) + last["b"]
    else:
        out = h @ last["W"] + last["b"]
    if "amp" in last:
        out = last["amp"] * out
    return out


def _apply_tp(params, x, activation, mesh, problem=None, hard_ic=False,
              t_final=1.0):
    """The solution ansatz (models/pinn.ansatz_apply, the one hard-IC
    definition) over the tensor-parallel forward."""
    def net(xx, p):
        return forward_tp(p, xx, activation, mesh=mesh)

    return ansatz_apply(net, x, problem, hard_ic, t_final, params)


def _loss_local(params, xyt_pde, xyt_ic, ic_target, xyt_bc, bc_target,
                problem, lambda_weights, activation, totals, mesh,
                hard_ic=False, t_final=1.0, reaction_active=False):
    """The global composite loss from this rank's points (``psum`` over
    'dp'); ``totals`` are the global batch sizes. Returns ``(total,
    (pde_loss, ic_loss, bc_loss))``, the same on every rank."""
    n_pde_total, n_ic_total, n_bc_total = totals

    def u_fn(p):
        return _apply_tp(params, p, activation, mesh, problem, hard_ic,
                         t_final)[:, 0]

    res = autodiff.problem_pde_residual(
        u_fn, xyt_pde, problem, problem.source_term(xyt_pde),
        reaction=getattr(problem, "reaction", 0.0) if reaction_active
        else 0.0)
    pde_loss = psum(torch.sum(torch.square(res)), mesh, "dp") / n_pde_total
    if hard_ic:
        # The ansatz meets the IC exactly: the term is identically 0.
        ic_loss = pde_loss.new_zeros(())
    else:
        ic_pred = forward_tp(params, xyt_ic, activation, mesh=mesh)
        ic_loss = psum(torch.sum(torch.square(ic_pred - ic_target)), mesh,
                       "dp") / n_ic_total
    bc_pred = _apply_tp(params, xyt_bc, activation, mesh, problem, hard_ic,
                        t_final)
    bc_loss = psum(torch.sum(torch.square(bc_pred - bc_target)), mesh,
                   "dp") / n_bc_total
    lp, li, lb = (lambda_weights["pde"], lambda_weights["ic"],
                  lambda_weights["bc"])
    total = (lp * pde_loss + li * ic_loss + lb * bc_loss) / (lp + li + lb)
    return total, (pde_loss, ic_loss, bc_loss)


def _dp_slice(x, mesh):
    """This rank's contiguous part along 'dp' of a global batch."""
    size = x.shape[0] // mesh.shape["dp"]
    return x[mesh.index("dp") * size:(mesh.index("dp") + 1) * size]


class ParallelTrainState(NamedTuple):
    params: list
    mu: list
    nu: list
    count: torch.Tensor


def init_parallel_state(key, layers, activation="adaptive_tanh",
                        dtype=torch.float32, fourier_features=0,
                        fourier_scale=1.0, input_scales=None,
                        output_scale=0.0, device=None) -> ParallelTrainState:
    """A fresh global state: ``init_mlp_params`` (``key`` a
    torch.Generator or an int seed) and zero moments."""
    return fresh_state(init_mlp_params(
        key, layers, activation, dtype, fourier_features=fourier_features,
        fourier_scale=fourier_scale, input_scales=input_scales,
        output_scale=output_scale, device=device))


def fresh_state(params) -> ParallelTrainState:
    """``params`` with zero moments and a zero step count."""
    def zeros():
        return [{k: torch.zeros_like(v) for k, v in layer.items()}
                for layer in params]

    return ParallelTrainState(params=params, mu=zeros(), nu=zeros(),
                              count=torch.zeros((), dtype=torch.int32))


def _adam_update(params, grads, mu, nu, count, lr):
    """Fused Adam with explicit moments, the JAX module's: the bias
    corrections in float32 from the step count, as there."""
    count = count + 1
    t = count.to(torch.float32)
    bc1 = 1 - torch.tensor(_ADAM_B1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(_ADAM_B2, dtype=torch.float32) ** t
    mu = [_ADAM_B1 * m + (1 - _ADAM_B1) * g for m, g in zip(mu, grads)]
    nu = [_ADAM_B2 * v + (1 - _ADAM_B2) * g * g for v, g in zip(nu, grads)]
    params = [p - lr * (m / bc1.to(m.device)) / (
        torch.sqrt(v / bc2.to(v.device)) + _ADAM_EPS)
        for p, m, v in zip(params, mu, nu)]
    return params, mu, nu, count


def _leaves(tree):
    return [(i, k) for i, layer in enumerate(tree) for k in layer
            if k != "B"]


def build_parallel_trainer(mesh, layers, domain, batch_sizes: dict,
                           lambda_weights: dict, lr: float, *,
                           activation: str = "adaptive_tanh",
                           epochs: int = 1, dtype=torch.float32,
                           fourier_features: int = 0, hard_ic: bool = False,
                           reaction_active: bool = False,
                           output_scale: bool = False):
    """A multi-epoch trainer over a ('dp', 'tp') ProcessMesh.

    Returns ``(train, info)``: ``train(state, xyt_ic, ic_target,
    generator, problem) -> (state, losses)`` takes and gives the global
    :class:`ParallelTrainState` and the global IC batch (sampled once by
    the caller), draws each epoch's boundary and then PDE points from
    ``generator`` (on the mesh's device, seeded alike on every rank) as
    global batches and trains on the rank's 'dp' slice; ``losses`` is
    (epochs, 4): total, pde, ic, bc, all global. ``info`` holds the global
    batch sizes (``n_pde``, ``n_ic``, ``n_bc``: rounded up to whole 'dp'
    slices, the boundary's to 4 sides per slice) and ``state_specs``."""
    _check_mesh(mesh)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    validate_tp_layers(layers, tp)
    xy_ranges = (-domain.Lx, domain.Lx, -domain.Ly, domain.Ly)
    t_range = (0.0, domain.T)

    def ceil_to(n, k):
        return -(-n // k) * k

    n_pde = ceil_to(batch_sizes["pde"], dp)
    n_ic = ceil_to(batch_sizes["ic"], dp)
    n_bc = max(4, ceil_to(batch_sizes["bc"], 4 * dp) // dp) * dp
    totals = (float(n_pde), float(n_ic), float(n_bc))
    specs = tp_param_specs(layers, activation, fourier_features,
                           output_scale=output_scale)
    state_specs = ParallelTrainState(params=specs, mu=specs, nu=specs,
                                     count=())
    loss_fn = partial(_loss_local, lambda_weights=dict(lambda_weights),
                      activation=activation, totals=totals, mesh=mesh,
                      hard_ic=hard_ic, t_final=t_range[1],
                      reaction_active=reaction_active)

    def train(state, xyt_ic, ic_target, generator, problem):
        device = mesh.device
        params = shard_params(state.params, specs, mesh)
        mu = shard_params(state.mu, specs, mesh)
        nu = shard_params(state.nu, specs, mesh)
        count = torch.as_tensor(state.count, dtype=torch.int32)
        leaves = _leaves(params)
        ic_x = _dp_slice(torch.as_tensor(xyt_ic, device=device), mesh)
        ic_y = _dp_slice(torch.as_tensor(ic_target, device=device), mesh)
        losses = torch.empty((epochs, 4), dtype=dtype, device=device)
        for e in range(epochs):
            xyt_bc = sampling.sample_boundary_points(
                generator, n_bc, xy_ranges, t_range, dtype)
            bc_target = problem.boundary_fn(xyt_bc).to(dtype).reshape(-1, 1)
            xyt_pde = sampling.lhs_sampling(generator, n_pde, xy_ranges,
                                            t_range, dtype)
            flat = [params[i][k].requires_grad_(True) for i, k in leaves]
            # Replicated over 'dp': their gradients sum over it.
            used = [dict(layer) for layer in params]
            for (i, k), p in zip(leaves, flat):
                used[i][k] = pvary(p, mesh, "dp")
            total, aux = loss_fn(used, _dp_slice(xyt_pde, mesh), ic_x, ic_y,
                                 _dp_slice(xyt_bc, mesh),
                                 _dp_slice(bc_target, mesh), problem)
            grads = torch.autograd.grad(total, flat)
            with torch.no_grad():
                new, m_new, v_new, count = _adam_update(
                    [p.detach() for p in flat], grads,
                    [mu[i][k] for i, k in leaves],
                    [nu[i][k] for i, k in leaves], count, lr)
                for (i, k), p, m, v in zip(leaves, new, m_new, v_new):
                    params[i][k], mu[i][k], nu[i][k] = p, m, v
                losses[e] = torch.stack([total.detach(),
                                         *(a.detach() for a in aux)])
        out = ParallelTrainState(
            params=gather_params(params, specs, mesh),
            mu=gather_params(mu, specs, mesh),
            nu=gather_params(nu, specs, mesh), count=count)
        return out, losses

    return train, {"n_pde": n_pde, "n_ic": n_ic, "n_bc": n_bc,
                   "state_specs": state_specs}


def parallel_loss_reference(mesh, layers, params_state, batches, problem,
                            lambda_weights, activation="adaptive_tanh",
                            fourier_features=0, reaction_active=False,
                            output_scale=False):
    """The global loss on a mesh from global parameters and global batches
    ``(xyt_pde, xyt_ic, ic_target, xyt_bc, bc_target)``, each split over
    'dp': ``(total, stack(pde, ic, bc))`` on every rank; for equivalence
    tests against the serial loss."""
    _check_mesh(mesh)
    xyt_pde, xyt_ic, ic_target, xyt_bc, bc_target = batches
    totals = (float(xyt_pde.shape[0]), float(xyt_ic.shape[0]),
              float(xyt_bc.shape[0]))
    specs = tp_param_specs(layers, activation, fourier_features,
                           output_scale=output_scale)
    params = shard_params(params_state, specs, mesh)
    total, aux = _loss_local(
        params, *(_dp_slice(b, mesh) for b in batches), problem,
        dict(lambda_weights), activation, totals, mesh,
        reaction_active=reaction_active)
    return total.detach(), torch.stack(aux).detach()
