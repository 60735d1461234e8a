"""Physics-informed neural network solver, PyTorch counterpart of
``airpollution_tpu/models/pinn.py``.

- :class:`MLP` is the network: Xavier-normal weights with std
  ``sqrt(2 / (fan_in + fan_out))`` and zero biases, a per-neuron
  adaptive-tanh ``alpha`` on the hidden layers, an optional frozen random
  Fourier embedding ``B`` (a buffer, divided by the input half-widths) and
  an optional trainable output amplitude ``amp``. Its trainable values
  live in one flat parameter, laid out in the JAX package's leaf order
  (layer by layer, keys sorted: ``W``, ``alpha``, ``amp``, ``b``), so that
  Adam, the masked updates of early stopping and L-BFGS each work on one
  tensor, and :meth:`MLP.params_tree` gives the JAX package's parameter
  list (``interop.pinn_params_from_numpy`` carries one over).
- :func:`composite_loss` is the weighted PINN loss with every option of
  the JAX package: mini-batch chunk means past 4,096 points, hard IC,
  causal weighting, obstacles with the facade block (folded into the
  boundary term or under its own ``"facade"`` weight), Robin sides,
  reaction and variable coefficients. Residual derivatives come from
  ``ops/autodiff`` (two reverse passes, the correct Laplacian).
- :meth:`PINN.train` runs the JAX package's epoch: resampled boundary and
  PDE points (LHS, or RAD), the loss, grad-norm annealing of the weights,
  one ``torch.optim.Adam`` step, the plateau schedule (halve the rate
  after 500 epochs without a 1e-4 relative improvement) and early
  stopping, all on the device: the schedule state is tensors, a stopped
  run's later epochs are masked no-ops, and the host reads the losses and
  the stop flag once per chunk of ``scan_chunk`` epochs (500 by default).
- :meth:`PINN.finetune_lbfgs` polishes with ``ops/lbfgs.LBFGS``, the
  optax L-BFGS with its zoom line search, on one full batch.

Points come from the model's ``torch.Generator`` on its device: a port
run and a JAX run of the same seed draw different points.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.ops import autodiff, sampling
from airpollution_tpu_torch.ops.lbfgs import LBFGS
from airpollution_tpu_torch.problems import SIDE_NORMALS, AdDifProblem

_ACTIVATIONS = ("adaptive_tanh", "tanh", "sine", "swish")

# The plateau schedule (torch ReduceLROnPlateau defaults of the
# reference): patience 500, factor 0.5, relative threshold 1e-4, 'min'.
_PLATEAU_PATIENCE = 500
_PLATEAU_FACTOR = 0.5
_PLATEAU_THRESHOLD = 1e-4

# PDE term as the mean of per-chunk means past this many points.
_MINI_BATCH_THRESHOLD = 4096

# Epochs between host reads of the losses and the stop flag.
_DEFAULT_SCAN_CHUNK = 500

_SIDE_ORDER = ("left", "right", "bottom", "top")


def _check_activation(activation):
    if activation not in _ACTIVATIONS:
        raise ValueError(f"Activation function {activation} not implemented")


class MLP(nn.Module):
    """The PINN's network (module docstring). ``layers`` is [in, hidden...,
    out]; with ``fourier_features=m`` the first dense layer takes the 2m
    features ``[sin(x B), cos(x B)]`` of a frozen ``B ~ N(0,
    fourier_scale^2)`` of shape (in, m), divided row by row by
    ``input_scales``; ``output_scale > 0`` adds the trainable amplitude
    ``amp`` (initial value ``output_scale``) on the output. Weights are
    drawn from ``generator`` (B first, then each W)."""

    def __init__(self, layers, activation="adaptive_tanh", *,
                 fourier_features=0, fourier_scale=1.0, input_scales=None,
                 output_scale=0.0, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        _check_activation(activation)
        device = resolve_device(device)
        self.layers = list(layers)
        self.activation = activation
        widths = list(layers)
        if fourier_features:
            B = torch.empty((layers[0], fourier_features), dtype=dtype,
                            device=device)
            B.normal_(generator=generator).mul_(fourier_scale)
            if input_scales is not None:
                B = B / torch.tensor(input_scales, dtype=dtype,
                                     device=device)[:, None]
            self.register_buffer("B", B)
            widths[0] = 2 * int(fourier_features)
        else:
            self.B = None
        # (layer, key) -> (offset, shape) in the flat parameter, in the
        # JAX package's leaf order.
        self._layout = []
        offset = 0
        n_dense = len(widths) - 1
        for i in range(n_dense):
            fan_in, fan_out = widths[i], widths[i + 1]
            shapes = {"W": (fan_in, fan_out), "b": (fan_out,)}
            if activation == "adaptive_tanh" and i < n_dense - 1:
                shapes["alpha"] = (fan_out,)
            if output_scale and i == n_dense - 1:
                shapes["amp"] = ()
            entry = {}
            for key in sorted(shapes):
                n = int(np.prod(shapes[key]))
                entry[key] = (offset, n, shapes[key])
                offset += n
            self._layout.append(entry)
        self._sizes = [n for entry in self._layout
                       for (_, n, _) in entry.values()]
        self.flat = nn.Parameter(torch.zeros(offset, dtype=dtype,
                                             device=device))
        with torch.no_grad():
            views = self.views()
            for i, layer in enumerate(views):
                fan_in, fan_out = widths[i], widths[i + 1]
                std = float(np.sqrt(2.0 / (fan_in + fan_out)))
                layer["W"].normal_(generator=generator).mul_(std)
                if "alpha" in layer:
                    layer["alpha"].fill_(1.0)
                if "amp" in layer:
                    layer["amp"].fill_(float(output_scale))

    def views(self, flat=None):
        """Each dense layer's dict of views into ``flat`` (default: the
        module's own parameter). One split makes them all, so that the
        gradients of every view return to ``flat`` through one
        concatenation."""
        flat = self.flat if flat is None else flat
        pieces = iter(torch.split(flat, self._sizes))
        return [{k: next(pieces).view(shape)
                 for k, (_, _, shape) in entry.items()}
                for entry in self._layout]

    def params_tree(self, flat=None):
        """The JAX package's parameter list: ``[{"B": B}]`` first when the
        network has a Fourier embedding, then one dict per dense layer."""
        head = [{"B": self.B}] if self.B is not None else []
        return head + self.views(flat)

    def load_params_tree(self, tree):
        """Copy a JAX-layout parameter list (tensors or arrays) in."""
        tree = list(tree)
        if self.B is not None:
            if "B" not in tree[0]:
                raise ValueError("the network has a Fourier embedding B; "
                                 "the parameters carry none")
            b = tree.pop(0)["B"]
            self.B.copy_(torch.as_tensor(np.asarray(b) if not isinstance(
                b, torch.Tensor) else b, dtype=self.B.dtype))
        elif tree and "B" in tree[0]:
            raise ValueError("the parameters carry a Fourier embedding B; "
                             "the network has none")
        views = self.views()
        if len(tree) != len(views):
            raise ValueError(f"{len(tree)} dense layers given, the network "
                             f"has {len(views)}")
        with torch.no_grad():
            for i, (got, want) in enumerate(zip(tree, views)):
                if sorted(got) != sorted(want):
                    raise ValueError(f"layer {i} has keys {sorted(got)}, "
                                     f"the network {sorted(want)}")
                for k, view in want.items():
                    value = got[k]
                    value = (value if isinstance(value, torch.Tensor)
                             else torch.as_tensor(np.asarray(value)))
                    if tuple(value.shape) != tuple(view.shape):
                        raise ValueError(
                            f"layer {i} {k}: shape {tuple(value.shape)}, "
                            f"the network's {tuple(view.shape)}")
                    view.copy_(value.to(view.dtype))

    def forward(self, x, params=None):
        """The network at points ``x`` (..., in) -> (..., out). ``params``
        replaces the module's parameter: a flat tensor of its layout (the
        L-BFGS line search, the detached residual of RAD) or the layer
        views of one (:meth:`views`, made once for several calls)."""
        lead = x.shape[:-1]
        h = x.reshape(-1, x.shape[-1])
        if self.B is not None:
            z = h @ self.B
            h = torch.cat([torch.sin(z), torch.cos(z)], dim=-1)
        layers = params if isinstance(params, list) else self.views(params)
        return _dense_stack(h, layers, self.activation).reshape(
            lead + (layers[-1]["W"].shape[-1],))


def _dense_stack(h, layers, activation):
    """The dense layers on (N, in) features: the activation after each
    but the last, the trainable amplitude ``amp`` on the output."""
    for layer in layers[:-1]:
        z = torch.addmm(layer["b"], h, layer["W"])
        if activation == "adaptive_tanh":
            h = torch.tanh(layer["alpha"] * z)
        elif activation == "tanh":
            h = torch.tanh(z)
        elif activation == "sine":
            h = torch.sin(z)
        else:
            h = z * torch.sigmoid(z)
    last = layers[-1]
    out = torch.addmm(last["b"], h, last["W"])
    if "amp" in last:
        out = last["amp"] * out
    return out


def init_mlp_params(key, layers, activation="adaptive_tanh",
                    dtype=torch.float32, fourier_features=0,
                    fourier_scale=1.0, input_scales=None, output_scale=0.0,
                    device=None):
    """The JAX package's parameter list of a fresh network: Xavier-normal
    weights, zero biases, adaptive-tanh slopes 1, a frozen Fourier
    embedding ``{"B": B}`` first when ``fourier_features`` is set, the
    amplitude ``amp`` on the last layer when ``output_scale`` is. ``key``
    is a ``torch.Generator`` or an int seed; the tensors are :class:`MLP`'s
    draws (the JAX package's PRNG differs), copied out of it."""
    device = resolve_device(device)
    if isinstance(key, torch.Generator):
        generator = key
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(key))
    mlp = MLP(layers, activation, fourier_features=fourier_features,
              fourier_scale=fourier_scale, input_scales=input_scales,
              output_scale=output_scale, dtype=dtype, device=device,
              generator=generator)
    return [{k: v.detach().clone() for k, v in layer.items()}
            for layer in mlp.params_tree()]


def mlp_apply(params, x, activation="adaptive_tanh"):
    """Forward pass of a parameter list (:func:`init_mlp_params`' layout)
    at points ``x`` (..., in) -> (..., out). The Fourier matrix ``B`` is
    frozen: no gradient flows into it."""
    _check_activation(activation)
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    if params and "B" in params[0]:
        z = h @ params[0]["B"].detach()
        h = torch.cat([torch.sin(z), torch.cos(z)], dim=-1)
        params = params[1:]
    out = _dense_stack(h, params, activation)
    return out.reshape(lead + (out.shape[-1],))


def ansatz_apply(mlp, xyt, problem=None, hard_ic=False, t_final=1.0,
                 params=None):
    """The solution ansatz: the network, or with ``hard_ic`` the form
    ``u0(x, y) + (t / T) NN(x, y, t)``, which meets the initial condition
    exactly. ``xyt`` is (..., 3) in (x, y, t) order; ``params`` as in
    :meth:`MLP.forward`."""
    out = mlp(xyt, params)
    if not hard_ic:
        return out
    u0 = problem.initial_condition_fn(xyt[..., :2]).to(out.dtype)
    ramp = (xyt[..., 2] / t_final).to(out.dtype)
    return u0[..., None] + ramp[..., None] * out


def count_parameters(layers):
    """Weight and bias count of a layers list, the formula of the
    experiment tables."""
    return sum(l1 * l2 + l2 for l1, l2 in zip(layers[:-1], layers[1:]))


def count_trainable_parameters(params):
    """Trainable values of an :class:`MLP` or a JAX-layout parameter list:
    every value but the frozen Fourier ``B``, adaptive-tanh alphas and
    the amplitude included."""
    if isinstance(params, MLP):
        return params.flat.numel()
    return sum(int(np.prod(np.shape(v)))
               for layer in params for k, v in layer.items() if k != "B")


def composite_loss(mlp, problem, xyt_pde, xyt_ic, ic_target, xyt_bc,
                   bc_target, lambda_weights, mini_batch_size=None, *,
                   hard_ic=False, t_final=1.0, causal_eps=0.0,
                   causal_bins=32, reaction_active=False, xyt_fac=None,
                   fac_normals=None, flat=None):
    """``(total, (pde_loss, ic_loss, bc_loss))``, the weighted composite
    loss ``(lp Lp + li Li + lb Lb [+ lf Lf]) / (lp + li + lb [+ lf])`` of
    the JAX package, differentiable in the network's parameters (or in
    ``flat``, when given).

    - PDE term: the mean squared residual; with ``causal_eps > 0`` the
      mean over ``causal_bins`` t-sorted bins of ``w_i L_i`` with
      ``w_i = exp(-eps sum_{j<i} L_j)`` (no gradient through w); past
      4,096 points the mean of per-chunk means (``mini_batch_size``,
      default 4,096, ragged last chunk included). Points inside obstacles
      weigh 0 and the term is divided by the live fraction.
    - IC term: the network against ``ic_target`` (0 with ``hard_ic``),
      without the points inside obstacles.
    - BC term: the Dirichlet mismatch, or on Robin sides (blocks of
      ``n // 4`` rows in the order left, right, bottom, top) the flux
      residual ``D dc/dn + alpha c - g``. With ``xyt_fac`` the facade
      residual dc/dn is folded in as a combined mean, or weighed on its
      own when ``lambda_weights`` has ``"facade"``.
    """

    # One split of the parameters serves every network evaluation, and one
    # batch every point set: the PDE points (their Hessian rows too), the
    # boundary points, the IC points (the ansatz is the network there
    # without hard IC) and the facade points.
    params = mlp.views(flat)

    def u(p):
        return ansatz_apply(mlp, p, problem, hard_ic, t_final, params)[:, 0]

    n_pde, n_bc = xyt_pde.shape[0], xyt_bc.shape[0]
    sets = [xyt_pde, xyt_bc] + ([] if hard_ic else [xyt_ic])
    if xyt_fac is not None:
        sets.append(xyt_fac)
    c, grad, hx, hy = autodiff.derivatives(
        u, torch.cat(sets), n_hessian=n_pde)
    v, D, D_grad = autodiff.problem_coefficients(problem, xyt_pde)
    residual = autodiff.residual_from_derivatives(
        c[:n_pde], grad[:n_pde], hx, hy, v, D, problem.source_term(xyt_pde),
        reaction=getattr(problem, "reaction", 0.0) if reaction_active
        else 0.0, D_grad=D_grad)
    c_bc, grad_bc = c[n_pde:n_pde + n_bc], grad[n_pde:n_pde + n_bc]
    rest = n_pde + n_bc
    res2 = torch.square(residual).reshape(-1)
    dtype = res2.dtype
    obstacles = getattr(problem, "obstacles", None)
    if obstacles:
        live = 1.0 - problem.obstacle_fn(xyt_pde[:, :2]).to(dtype)
        live_frac = torch.clamp(torch.mean(live), min=1e-6)
        res2 = res2 * live
    if causal_eps > 0.0:
        order = torch.argsort(xyt_pde[:, 2], stable=True)
        per_bin = n_pde // causal_bins
        binned = res2[order[: per_bin * causal_bins]].reshape(
            causal_bins, per_bin)
        bin_loss = torch.mean(binned, dim=1)
        prior = torch.cat([torch.zeros(1, dtype=dtype, device=res2.device),
                           torch.cumsum(bin_loss, 0)[:-1]])
        w = torch.exp(-causal_eps * prior).detach()
        pde_loss = torch.mean(w * bin_loss)
    elif n_pde > _MINI_BATCH_THRESHOLD:
        chunk = mini_batch_size or _MINI_BATCH_THRESHOLD
        n_chunks = -(-n_pde // chunk)
        pad = n_chunks * chunk - n_pde
        padded = torch.cat([res2, res2.new_zeros(pad)])
        sums = padded.reshape(n_chunks, chunk).sum(dim=1)
        sizes = torch.full((n_chunks,), float(chunk), dtype=dtype,
                           device=res2.device)
        sizes[-1] = chunk - pad
        pde_loss = torch.mean(sums / sizes)
    else:
        pde_loss = torch.mean(res2)
    if obstacles:
        pde_loss = pde_loss / live_frac

    if hard_ic:
        ic_loss = res2.new_zeros(())
    else:
        ic_pred = c[rest:rest + xyt_ic.shape[0]]
        rest += xyt_ic.shape[0]
        ic_res2 = torch.square(ic_pred - ic_target.reshape(-1))
        if obstacles:
            live_ic = 1.0 - problem.obstacle_fn(xyt_ic[:, :2]).to(
                ic_res2.dtype)
            ic_loss = (torch.sum(ic_res2 * live_ic)
                       / torch.clamp(torch.sum(live_ic), min=1.0))
        else:
            ic_loss = torch.mean(ic_res2)

    robin = getattr(problem, "robin_sides", None)
    res = c_bc - bc_target.reshape(-1)
    if not robin:
        bc_loss = torch.mean(torch.square(res))
    else:
        unknown = set(robin) - set(_SIDE_ORDER)
        if unknown:
            raise ValueError(
                f"unknown robin_sides {sorted(unknown)} — expected a "
                f"subset of {sorted(_SIDE_ORDER)}")
        # The Robin sides read their contiguous blocks of the boundary
        # points' gradient.
        n_side = xyt_bc.shape[0] // 4
        blocks = []
        for i, side in enumerate(_SIDE_ORDER):
            lo, hi = i * n_side, (i + 1) * n_side
            if side not in robin:
                blocks.append(res[lo:hi])
                continue
            nx, ny = SIDE_NORMALS[side]
            dcdn = nx * grad_bc[lo:hi, 0] + ny * grad_bc[lo:hi, 1]
            g = problem.robin_g(xyt_bc[lo:hi, :2], xyt_bc[lo:hi, 2], side)
            flux = problem.D * dcdn + robin[side] * c_bc[lo:hi] - g
            blocks.append(flux.to(res.dtype))
        blocks.append(res[4 * n_side:])
        bc_loss = torch.mean(torch.square(torch.cat(blocks)))

    fac_loss = None
    if xyt_fac is not None:
        fgrad = grad[rest:rest + xyt_fac.shape[0]]
        dcdn_fac = torch.sum(fgrad[:, :2] * fac_normals, dim=1)
        fac2 = torch.square(dcdn_fac).to(bc_loss.dtype)
        if "facade" in lambda_weights:
            fac_loss = torch.mean(fac2)
        else:
            n_b, n_f = xyt_bc.shape[0], xyt_fac.shape[0]
            bc_loss = (n_b * bc_loss + torch.sum(fac2)) / (n_b + n_f)

    lp, li, lb = (lambda_weights["pde"], lambda_weights["ic"],
                  lambda_weights["bc"])
    if fac_loss is not None:
        lf = lambda_weights["facade"]
        total = (lp * pde_loss + li * ic_loss + lb * bc_loss
                 + lf * fac_loss) / (lp + li + lb + lf)
    else:
        total = (lp * pde_loss + li * ic_loss + lb * bc_loss) / (
            lp + li + lb)
    return total, (pde_loss, ic_loss, bc_loss)


def rad_select(generator, weights, n):
    """``n`` indices drawn without replacement with probability
    proportional to ``weights`` (Gumbel top-k): residual-based adaptive
    collocation keeps more points where the residual is large, and every
    region keeps some."""
    tiny = torch.finfo(weights.dtype).tiny
    u = torch.rand(weights.shape, generator=generator, dtype=weights.dtype,
                   device=weights.device).clamp_min(tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.topk(torch.log(weights + 1e-12) + gumbel, n).indices


def adam(flat, carry):
    """The trainer's ``torch.optim.Adam`` on the flat parameter: betas
    (0.9, 0.999), eps 1e-8, its learning rate the carry's ``lr`` tensor
    (the plateau schedule changes it in place) and its moments and step
    count the carry's tensors. On the card the update is capturable: no
    host read of the step count or the rate."""
    on_card = flat.device.type == "cuda"
    opt = torch.optim.Adam([flat], lr=carry["lr"], betas=(0.9, 0.999),
                           eps=1e-8, foreach=on_card, capturable=on_card)
    opt.state[flat] = {"step": carry["adam_step"],
                       "exp_avg": carry["exp_avg"],
                       "exp_avg_sq": carry["exp_avg_sq"]}
    return opt


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class EarlyStopping:
    """Host-side early stopping with real snapshots of the parameters (a
    copy, so that restoring gives the best epoch's weights)."""

    def __init__(self, patience=100, min_delta=1e-6,
                 restore_best_weights=True):
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best_weights = restore_best_weights
        self.best_loss = float("inf")
        self.counter = 0
        self.best_weights = None

    def __call__(self, val_loss, params):
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
            if self.restore_best_weights:
                self.best_weights = _clone(params)
        else:
            self.counter += 1
        return self.counter >= self.patience

    def restore_weights(self, params):
        return self.best_weights if self.best_weights is not None else params


# The training carry, in the order the checkpoint stores it: the flat
# parameters, Adam's moments and step count, the schedules, the early
# stopping snapshot, the stop flag, the adaptive weights and the count of
# epochs that ran unfrozen.
CARRY_FIELDS = ("params", "exp_avg", "exp_avg_sq", "adam_step", "lr",
                "plateau_best", "plateau_bad", "es_best", "es_counter",
                "best_params", "stopped", "lam_ic", "lam_bc", "step")


class PINN:
    """PINN solver with the reference's class API. ``device=None`` is the
    CUDA card (and raises without one); ``dtype`` defaults to float32."""

    def __init__(self, layers, problem, domain, activation="adaptive_tanh",
                 seed=1234, dtype=torch.float32, fourier_features=0,
                 fourier_scale=1.0, hard_ic=False, output_scale=None,
                 device=None):
        _check_activation(activation)
        self.device = resolve_device(device)
        self.layers = list(layers)
        self.problem = problem
        self.domain = domain
        self.activation = activation
        self.dtype = dtype
        self.fourier_features = int(fourier_features)
        self.fourier_scale = float(fourier_scale)
        self.hard_ic = bool(hard_ic)
        self.xy_ranges = (-domain.Lx, domain.Lx, -domain.Ly, domain.Ly)
        self.t_range = (0.0, domain.T)
        if output_scale == "auto":
            # max |IC| over a 64 x 64 grid of the box.
            gx = torch.linspace(-domain.Lx, domain.Lx, 64, dtype=dtype,
                                device=self.device)
            gy = torch.linspace(-domain.Ly, domain.Ly, 64, dtype=dtype,
                                device=self.device)
            xx, yy = torch.meshgrid(gx, gy, indexing="xy")
            ic = problem.initial_condition_fn(
                torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1))
            output_scale = float(torch.max(torch.abs(ic)))
            if output_scale <= 0:
                output_scale = None  # zero IC: nothing to derive from
        self.output_scale = output_scale
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.mlp = MLP(
            self.layers, activation, fourier_features=self.fourier_features,
            fourier_scale=self.fourier_scale,
            input_scales=(domain.Lx, domain.Ly, domain.T / 2.0),
            output_scale=output_scale or 0.0, dtype=dtype,
            device=self.device, generator=self.generator)
        self.history = {"total_loss": [], "pde_loss": [], "ic_loss": [],
                        "bc_loss": []}
        self.training_time = 0.0
        self._carry_state = None  # continuation across train() calls
        self._last_lr = None  # base lr of the previous train() call

    @property
    def params(self):
        """The JAX-layout parameter list (views of the network's
        parameters)."""
        return self.mlp.params_tree()

    @params.setter
    def params(self, tree):
        self.mlp.load_params_tree(tree)

    def _points(self, xyt):
        return torch.as_tensor(xyt, dtype=self.dtype, device=self.device)

    # --- forward / residual ---

    def forward(self, xyt):
        with torch.no_grad():
            return ansatz_apply(self.mlp, self._points(xyt), self.problem,
                                self.hard_ic, self.domain.T)

    def _point_fn(self, flat=None):
        def u(p):
            return ansatz_apply(self.mlp, p, self.problem, self.hard_ic,
                                self.domain.T, flat)[:, 0]

        return u

    def compute_pde_residual(self, xyt):
        """dc/dt + v . grad c - D lap c + r c - s at each point, (N, 1)."""
        xyt = self._points(xyt)
        res = autodiff.problem_pde_residual(
            self._point_fn(self.mlp.flat.detach()), xyt, self.problem,
            self.problem.source_term(xyt),
            reaction=getattr(self.problem, "reaction", 0.0),
            create_graph=False)
        return res.detach()

    def _reaction_active(self) -> bool:
        r = getattr(self.problem, "reaction", 0.0)
        return not (isinstance(r, (int, float)) and r == 0.0)

    def _loss_kw(self):
        return dict(hard_ic=self.hard_ic, t_final=self.domain.T,
                    reaction_active=self._reaction_active())

    # --- training ---

    def _ic_points(self, n_ic):
        xy_ic = sampling.lhs_sampling(self.generator, n_ic, self.xy_ranges,
                                      dtype=self.dtype)
        xyt_ic = torch.cat([xy_ic, xy_ic.new_zeros((n_ic, 1))], dim=1)
        ic_target = self.problem.initial_condition_fn(xy_ic).to(
            self.dtype).reshape(-1, 1)
        return xyt_ic, ic_target

    def _boundary_points(self, n_bc):
        xyt_bc = sampling.sample_boundary_points(
            self.generator, n_bc, self.xy_ranges, self.t_range, self.dtype)
        bc_target = self.problem.boundary_fn(xyt_bc).to(
            self.dtype).reshape(-1, 1)
        return xyt_bc, bc_target

    def _facade_kw(self, n_fac):
        if not getattr(self.problem, "obstacles", None):
            return {}
        xyt_fac, fac_n = sampling.sample_facade_points(
            self.generator, n_fac, self.problem.obstacles, self.t_range,
            self.dtype)
        return dict(xyt_fac=xyt_fac, fac_normals=fac_n)

    def _scalar(self, value, dtype=None):
        return torch.tensor(value, dtype=dtype or self.dtype,
                            device=self.device)

    def fresh_carry(self, lr, lambda_weights):
        """The training carry of a run that starts from the current
        parameters (:data:`CARRY_FIELDS`)."""
        flat = self.mlp.flat.detach()
        lp0 = float(lambda_weights.get("pde", 1.0)) or 1.0
        return {
            "params": flat.clone(),
            "exp_avg": torch.zeros_like(flat),
            "exp_avg_sq": torch.zeros_like(flat),
            # Adam's step count: a device tensor for the capturable update
            # on the card, in the parameters' dtype (a float32 count would
            # round Adam's bias corrections of a float64 run).
            "adam_step": torch.zeros(
                (), dtype=self.dtype,
                device=self.device if self.device.type == "cuda" else "cpu"),
            "lr": self._scalar(float(lr)),
            "plateau_best": self._scalar(math.inf),
            "plateau_bad": self._scalar(0, torch.int32),
            "es_best": self._scalar(math.inf),
            "es_counter": self._scalar(0, torch.int32),
            "best_params": flat.clone(),
            "stopped": self._scalar(False, torch.bool),
            # Adaptive-weight carry, seeded from the static weights
            # normalized to lam_pde = 1.
            "lam_ic": self._scalar(float(lambda_weights.get("ic", 1.0))
                                   / lp0),
            "lam_bc": self._scalar(float(lambda_weights.get("bc", 1.0))
                                   / lp0),
            "step": 0,
        }

    def _check_train_options(self, batch_sizes, lambda_weights,
                             adaptive_weights_every, causal_eps,
                             causal_bins):
        obstacles = getattr(self.problem, "obstacles", None) or None
        if (obstacles is None and type(self.problem).obstacle_fn
                is not AdDifProblem.obstacle_fn):
            raise ValueError(
                "PINN obstacle support needs the rectangle spec "
                "(problem.obstacles) — a custom obstacle_fn alone "
                "gives the facade sampler nothing to sample")
        if adaptive_weights_every and "facade" in (lambda_weights or {}):
            raise ValueError(
                "lambda_weights['facade'] is incompatible with "
                "adaptive_weights_every > 0 (the adaptive weights carry "
                "only pde/ic/bc and would silently drop the facade "
                "split) — use static lambdas for a separate facade "
                "weight")
        if causal_eps and batch_sizes["pde"] < int(causal_bins):
            raise ValueError(
                f"causal_eps needs at least causal_bins="
                f"{int(causal_bins)} PDE collocation points per epoch "
                f"(got {batch_sizes['pde']}); lower causal_bins or "
                f"disable causal weighting")

    def train(self, batch_sizes, epochs, lr, lambda_weights,
              early_stopping_patience=0, early_stopping_min_delta=1e-6,
              mini_batch_size=None, restore_best_weights=True,
              warm_start=False, scan_chunk=None, adaptive_oversample=0.0,
              adaptive_weights_every=0, causal_eps=0.0, causal_bins=32):
        """Train with LHS collocation, the JAX package's epoch (module
        docstring), and return the history.

        ``adaptive_oversample=r > 1``: RAD, n_pde points drawn from an
        r-times oversampled LHS pool with probability ~ |residual|/mean + 1
        under the current parameters. ``adaptive_weights_every=k > 0``:
        every k epochs lam_i <- 0.9 lam_i + 0.1 max|grad L_pde| /
        mean|grad L_i| (the mean over every parameter value, the frozen
        ``B`` counted as zeros), seeded from ``lambda_weights``.
        ``causal_eps > 0``: causal weighting over ``causal_bins`` t-bins.
        ``warm_start``: continue the previous call's optimizer and
        schedules (a changed ``lr`` wins over the carried one).
        ``scan_chunk``: epochs between host reads (default
        ``min(epochs, 500)``; 0 = all at once); a run that stopped early
        ends at the next chunk boundary, its epochs after the stop
        masked, and the history keeps the epochs up to the stop.
        """
        epochs = int(epochs)
        self._check_train_options(batch_sizes, lambda_weights,
                                  adaptive_weights_every, causal_eps,
                                  causal_bins)
        if scan_chunk is None:
            chunk = min(epochs, _DEFAULT_SCAN_CHUNK) or epochs
        elif int(scan_chunk) <= 0:
            chunk = epochs
        else:
            chunk = min(int(scan_chunk), epochs)

        start = time.time()
        xyt_ic, ic_target = self._ic_points(batch_sizes["ic"])
        with torch.no_grad():
            if warm_start and self._carry_state is not None:
                st = dict(self._carry_state)
                st["params"] = self.mlp.flat.detach().clone()
                st["stopped"] = self._scalar(False, torch.bool)
                if self._last_lr is not None and lr != self._last_lr:
                    st["lr"] = self._scalar(float(lr))
                else:
                    st["lr"] = st["lr"].clone()
            else:
                st = self.fresh_carry(lr, lambda_weights)
            self.mlp.flat.copy_(st["params"])

        flat = self.mlp.flat
        opt = adam(flat, st)
        cfg = dict(
            n_pde=int(batch_sizes["pde"]), n_bc=int(batch_sizes["bc"]),
            n_fac=int(batch_sizes.get("facade", batch_sizes["bc"])),
            lambdas={k: float(v) for k, v in lambda_weights.items()},
            patience=int(early_stopping_patience),
            min_delta=float(early_stopping_min_delta),
            mini_batch_size=mini_batch_size,
            oversample=float(adaptive_oversample),
            weights_every=int(adaptive_weights_every),
            causal_eps=float(causal_eps), causal_bins=int(causal_bins))

        loss_parts, frozen_parts = [], []
        remaining = epochs
        while remaining > 0:
            length = min(chunk, remaining)
            losses = torch.empty((length, 4), dtype=self.dtype,
                                 device=self.device)
            frozen = torch.empty((length,), dtype=torch.bool,
                                 device=self.device)
            step0 = st["step"]
            for e in range(length):
                self._epoch(st, opt, cfg, xyt_ic, ic_target, losses[e],
                            frozen[e])
            # One host read per chunk: the losses, the frozen flags and
            # with them the stop.
            frozen_h = frozen.cpu().numpy()
            loss_parts.append(losses.cpu().numpy())
            frozen_parts.append(frozen_h)
            st["step"] = step0 + int((~frozen_h).sum())
            remaining -= length
            if remaining > 0 and bool(st["stopped"]):
                break
        if loss_parts:
            losses = np.concatenate(loss_parts, axis=0)
            frozen = np.concatenate(frozen_parts, axis=0)
        else:  # epochs == 0: materialize the carry only
            losses = np.zeros((0, 4), np.float64)
            frozen = np.zeros((0,), bool)

        n_recorded = int((~frozen).sum())
        if n_recorded < epochs:
            print(f"\nEarly stopping triggered at epoch {n_recorded}")
            print(f"Best loss: {float(st['es_best']):.6f}")
        losses = losses[:n_recorded]

        with torch.no_grad():
            if early_stopping_patience and restore_best_weights:
                flat.copy_(st["best_params"])
                print("Restored best model weights")
            st["params"] = flat.detach().clone()
        self._carry_state = st
        self._last_lr = lr
        for i, k in enumerate(("total_loss", "pde_loss", "ic_loss",
                               "bc_loss")):
            self.history[k].extend(losses[:, i].tolist())
        self.training_time = time.time() - start
        return self.history

    def _epoch(self, st, opt, cfg, xyt_ic, ic_target, loss_row,
               frozen_out):
        """One epoch on the device, the carry ``st`` updated in place; no
        host read."""
        flat = self.mlp.flat
        frozen = st["stopped"]
        every = cfg["weights_every"]
        if every:
            weights = {"pde": 1.0, "ic": st["lam_ic"], "bc": st["lam_bc"]}
        else:
            weights = cfg["lambdas"]
        xyt_bc, bc_target = self._boundary_points(cfg["n_bc"])
        reaction = (getattr(self.problem, "reaction", 0.0)
                    if self._reaction_active() else 0.0)
        if cfg["oversample"] > 1.0:
            n_cand = int(round(cfg["oversample"] * cfg["n_pde"]))
            cand = sampling.lhs_sampling(self.generator, n_cand,
                                         self.xy_ranges, self.t_range,
                                         self.dtype)
            res = autodiff.problem_pde_residual(
                self._point_fn(flat.detach()), cand, self.problem,
                self.problem.source_term(cand), reaction=reaction,
                create_graph=False)
            r = torch.abs(res.detach().reshape(-1))
            w = r / (torch.mean(r) + 1e-12) + 1.0
            xyt_pde = cand[rad_select(self.generator, w, cfg["n_pde"])]
        else:
            xyt_pde = sampling.lhs_sampling(self.generator, cfg["n_pde"],
                                            self.xy_ranges, self.t_range,
                                            self.dtype)
        fac_kw = self._facade_kw(cfg["n_fac"])
        total, (lp_, li_, lb_) = composite_loss(
            self.mlp, self.problem, xyt_pde, xyt_ic, ic_target, xyt_bc,
            bc_target, weights, cfg["mini_batch_size"],
            causal_eps=cfg["causal_eps"], causal_bins=cfg["causal_bins"],
            **self._loss_kw(), **fac_kw)

        lam_ic, lam_bc = st["lam_ic"], st["lam_bc"]
        if every and st["step"] % every == 0:
            # Grad-norm annealing on this epoch's batch and the parameters
            # before the update; the frozen B counts as zeros in the mean.
            n_all = flat.numel() + (self.mlp.B.numel()
                                    if self.mlp.B is not None else 0)

            def term_grad(term):
                (g,) = torch.autograd.grad(term, flat, retain_graph=True,
                                           allow_unused=True,
                                           materialize_grads=True)
                return g

            top = torch.max(torch.abs(term_grad(lp_)))
            if self.hard_ic:
                li_hat = lam_ic
            else:
                li_hat = top / (torch.sum(torch.abs(term_grad(li_))) / n_all
                                + 1e-12)
            lb_hat = top / (torch.sum(torch.abs(term_grad(lb_))) / n_all
                            + 1e-12)
            lam_ic = 0.9 * lam_ic + 0.1 * li_hat
            lam_bc = 0.9 * lam_bc + 0.1 * lb_hat
        (grad,) = torch.autograd.grad(total, flat)

        masked = cfg["patience"] > 0
        with torch.no_grad():
            if masked:
                before = [flat.detach().clone(), st["exp_avg"].clone(),
                          st["exp_avg_sq"].clone(), st["adam_step"].clone()]
            flat.grad = grad
            opt.step()
            flat.grad = None
            if masked:
                after = (flat, st["exp_avg"], st["exp_avg_sq"],
                         st["adam_step"])
                for new, old in zip(after, before):
                    new.copy_(torch.where(frozen.to(new.device), old, new))
            total = total.detach()
            lr = st["lr"]
            # The plateau schedule: best moves only on a relative
            # improvement past the threshold.
            improved = total < st["plateau_best"] * (1 - _PLATEAU_THRESHOLD)
            plateau_best = torch.where(improved, total, st["plateau_best"])
            plateau_bad = torch.where(improved, 0, st["plateau_bad"] + 1)
            reduce = plateau_bad > _PLATEAU_PATIENCE
            new_lr = torch.where(reduce, lr * _PLATEAU_FACTOR, lr)
            plateau_bad = torch.where(reduce, 0, plateau_bad)

            def keep(old, new):
                # A stopped run's epochs are no-ops; without early
                # stopping no run stops.
                return torch.where(frozen, old, new) if masked else new

            es_improved = total < st["es_best"] - cfg["min_delta"]
            es_best = torch.where(es_improved, total, st["es_best"])
            es_counter = torch.where(es_improved, 0, st["es_counter"] + 1)
            if masked:
                # The snapshot is of the parameters after this update.
                best = torch.where(es_improved, flat.detach(),
                                   st["best_params"])
                st["best_params"] = keep(st["best_params"], best)
                st["stopped"] = frozen | (es_counter >= cfg["patience"])
            st["es_best"] = keep(st["es_best"], es_best)
            st["es_counter"] = keep(st["es_counter"], es_counter)
            lr.copy_(keep(lr, new_lr))
            st["plateau_best"] = keep(st["plateau_best"], plateau_best)
            st["plateau_bad"] = keep(st["plateau_bad"], plateau_bad)
            st["lam_ic"] = keep(st["lam_ic"], torch.as_tensor(lam_ic).detach())
            st["lam_bc"] = keep(st["lam_bc"], torch.as_tensor(lam_bc).detach())
            loss_row.copy_(torch.stack([total, lp_.detach(), li_.detach(),
                                        lb_.detach()]))
            frozen_out.copy_(frozen)
        st["step"] += 1

    def finetune_lbfgs(self, batch_sizes, steps, lambda_weights,
                       memory_size=20, mini_batch_size=None):
        """Full-batch L-BFGS polish after Adam: one sample of PDE, IC, BC
        (and facade) points, then ``steps`` steps of ``ops/lbfgs.LBFGS``
        (memory ``memory_size``, zoom line search of at most 32 trial
        steps). Appends [total, pde, ic, bc] at each new point to the
        history and adds its time to ``training_time``."""
        start = time.time()
        xyt_pde = sampling.lhs_sampling(self.generator, batch_sizes["pde"],
                                        self.xy_ranges, self.t_range,
                                        self.dtype)
        xyt_ic, ic_target = self._ic_points(batch_sizes["ic"])
        xyt_bc, bc_target = self._boundary_points(batch_sizes["bc"])
        lambdas = {k: float(v) for k, v in lambda_weights.items()}
        fac_kw = self._facade_kw(batch_sizes.get("facade",
                                                 batch_sizes["bc"]))

        def value_and_grad(x):
            x = x.detach().requires_grad_(True)
            total, aux = composite_loss(
                self.mlp, self.problem, xyt_pde, xyt_ic, ic_target, xyt_bc,
                bc_target, lambdas, mini_batch_size, flat=x,
                **self._loss_kw(), **fac_kw)
            (g,) = torch.autograd.grad(total, x)
            return total.detach(), g, torch.stack(aux).detach()

        opt = LBFGS(memory_size)
        x = self.mlp.flat.detach().clone()
        state = opt.init(x)
        values, auxes = [], []
        for _ in range(int(steps)):
            x, state = opt.step(x, state, value_and_grad)
            values.append(float(state.value))
            auxes.append(state.aux)
        with torch.no_grad():
            self.mlp.flat.copy_(x)
        if auxes:
            aux = torch.stack(auxes).cpu().numpy()
            rows = np.concatenate([np.asarray(values)[:, None], aux], axis=1)
            for i, k in enumerate(("total_loss", "pde_loss", "ic_loss",
                                   "bc_loss")):
                self.history[k].extend(rows[:, i].tolist())
        self.training_time += time.time() - start
        return self.history

    def train_parallel(self, mesh, batch_sizes, epochs, lr, lambda_weights):
        """Multi-process training over a ('dp', 'tp') ProcessMesh
        (parallel/pinn_parallel.py): collocation batches split over 'dp',
        the MLP over 'tp', ``epochs`` fused-Adam steps; appends the global
        loss history and copies the trained parameters back into this
        model on every rank. Hidden widths must divide by the 'tp' size.
        The Adam moments carry across calls (``_parallel_state``). The IC
        points and then every epoch's boundary and PDE points come from
        the model's generator, in :meth:`train`'s order, so every rank
        draws the same global batches."""
        from airpollution_tpu_torch.parallel import pinn_parallel
        from airpollution_tpu_torch.parallel.device_mesh import same_device

        if getattr(self.problem, "obstacles", None):
            raise ValueError(
                "interior obstacles (problem.obstacles) are not "
                "supported by the PINN trainers — use the FEM paths")
        if getattr(self.problem, "robin_sides", None):
            raise ValueError(
                "Robin boundaries run on the serial trainer only — the "
                "parallel trainer's boundary loss is Dirichlet-only")
        trainer, info = pinn_parallel.build_parallel_trainer(
            mesh, self.layers, self.domain, dict(batch_sizes),
            dict(lambda_weights), lr, activation=self.activation,
            epochs=int(epochs), dtype=self.dtype,
            fourier_features=self.fourier_features, hard_ic=self.hard_ic,
            reaction_active=self._reaction_active(),
            output_scale="amp" in self.params[-1])
        if not same_device(mesh.device, self.device):
            raise ValueError(f"mesh device {mesh.device} differs from the "
                             f"model's {self.device}")
        params = _clone(self.params)
        state = getattr(self, "_parallel_state", None)
        if state is None:
            state = pinn_parallel.fresh_state(params)
        else:
            state = state._replace(params=params)

        start = time.time()
        xyt_ic, ic_target = self._ic_points(info["n_ic"])
        state, losses = trainer(state, xyt_ic, ic_target, self.generator,
                                self.problem)
        self._parallel_state = state
        self.params = state.params
        losses = losses.cpu().numpy()
        for i, k in enumerate(("total_loss", "pde_loss", "ic_loss",
                               "bc_loss")):
            self.history[k].extend(losses[:, i].tolist())
        self.training_time = time.time() - start
        return self.history

    # --- evaluation ---

    def _at_final_time(self, mesh_data, analytical_sol_fn):
        mid = mesh_data.midpoints.to(device=self.device, dtype=self.dtype)
        t_col = torch.full((mid.shape[0], 1), float(self.domain.T),
                           dtype=self.dtype, device=self.device)
        xyt = torch.cat([mid, t_col], dim=1)
        with torch.no_grad():
            u_exact = analytical_sol_fn(xyt).reshape(-1)
            u_num = self.forward(xyt).reshape(-1)
        return u_num, u_exact

    def compute_errors(self, mesh_data, analytical_sol_fn):
        """(rel_l2, l2, max) at the edge midpoints, t = T."""
        u_num, u_exact = self._at_final_time(mesh_data, analytical_sol_fn)
        err = torch.abs(u_num - u_exact)
        l2 = torch.sqrt(torch.sum(err ** 2))
        rel = l2 / torch.sqrt(torch.sum(u_exact ** 2))
        return float(rel), float(l2), float(torch.max(err))

    def compute_fem_errors(self, mesh_data, analytical_sol_fn):
        """Area-weighted FEM norms at t = T, per-triangle midpoint
        quadrature ``integral f ~ area * sum_midpoints f / 3``:
        (rel_l2, l2, max)."""
        u_num, u_exact = self._at_final_time(mesh_data, analytical_sol_fn)
        t2s = mesh_data.triangle_to_segments.to(self.device)
        areas = mesh_data.triangle_areas.to(device=self.device,
                                            dtype=self.dtype)
        err2 = (u_num - u_exact) ** 2
        tri_err = torch.sum(err2[t2s], dim=1) / 3.0
        tri_ex = torch.sum(u_exact[t2s] ** 2, dim=1) / 3.0
        l2 = torch.sqrt(torch.sum(areas * tri_err))
        norm_ex = torch.sqrt(torch.sum(areas * tri_ex))
        max_error = torch.max(torch.abs(u_num - u_exact))
        return (float(l2 / (norm_ex + 1e-12)), float(l2),
                float(max_error))

    # --- plotting (reporting/plots.py; skipped without matplotlib) ---

    def plot_history(self, save_dir="results", name=""):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_loss_history(self.history, save_dir, name)

    def plot_solution(self, t, mesh_data, analytical_sol_fn=None,
                      save_dir="results"):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_pinn_solution(self, t, mesh_data, analytical_sol_fn,
                                 save_dir)

    def plot_interpolated_solution(self, t, mesh_data, analytical_sol_fn=None,
                                   save_dir="results", name=""):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_pinn_interpolated_solution(
            self, t, mesh_data, analytical_sol_fn, save_dir, name)
