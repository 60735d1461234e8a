"""Fourier Neural Operator surrogate, PyTorch counterpart of
``airpollution_tpu/models/fno.py``.

A neural solution operator in the style of Li et al. 2021 ("Fourier
Neural Operator for Parametric PDEs"): it maps problem inputs (the
initial condition and physical-parameter channels on the cell-center
grid) to the final concentration field in one forward pass, trained once
on solver-manufactured data for a whole problem family.

- The training data comes from the port's member-batched FEM ensemble
  (``diagnostics/ensemble.ensemble_forecast``): every sample's implicit
  solve runs in one batch, its ELL products on kernel B7's stacked mode.
- Fields live on the cell-center grid: the structured CR mesh's
  diagonal-edge DOFs sit at cell centers, so a (c, c) view of a DOF
  vector is one gather (:func:`cell_center_index_grid`).
- The layout is the JAX package's: channels last, (B, H, W, C), and the
  complex spectral weights stored as (real, imag) pairs, so that its
  parameters carry over as a copy (``interop.fno_params_from_numpy``).
  The spectral convolution is ``torch.fft.rfft2`` over (H, W), a complex
  channel mix of the two retained low-mode corners (``einsum``) and
  ``irfft2``; the JAX package computes these outside any Pallas kernel,
  so no kernel of the port's own runs here.
- Training is AdamW with optax's ``adamw`` semantics (decoupled decay,
  eps 1e-8), batches drawn on the device from a ``torch.Generator``, and
  the losses kept on the device until one read at the end.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FNOParams", "AdamWState", "init_fno_params", "fno_apply",
    "cell_center_index_grid", "grid_coordinates",
    "make_plume_dataset", "make_plume_time_dataset",
    "train_fno", "relative_l2",
]


class FNOParams(NamedTuple):
    """FNO parameters, all real tensors, in the JAX package's layout.

    lift/proj: dense channel maps; for each of ``depth`` Fourier blocks,
    spectral weights for the two retained rfft2 mode corners (w1: rows
    [0, modes), w2: rows [-modes, 0); columns [0, modes)) as real/imag
    pairs, and a pointwise skip map.
    """

    lift_w: torch.Tensor   # (in_ch, width)
    lift_b: torch.Tensor   # (width,)
    w1_re: torch.Tensor    # (depth, width, width, modes, modes)
    w1_im: torch.Tensor
    w2_re: torch.Tensor
    w2_im: torch.Tensor
    skip_w: torch.Tensor   # (depth, width, width)
    skip_b: torch.Tensor   # (depth, width)
    proj1_w: torch.Tensor  # (width, proj)
    proj1_b: torch.Tensor  # (proj,)
    proj2_w: torch.Tensor  # (proj, out_ch)
    proj2_b: torch.Tensor  # (out_ch,)


class AdamWState(NamedTuple):
    """AdamW's state: the step count and the two moments per parameter."""

    count: int
    mu: FNOParams
    nu: FNOParams


def init_fno_params(generator, *, in_ch, modes=12, width=32, depth=4,
                    proj=64, out_ch=1, dtype=torch.float32,
                    device="cpu") -> FNOParams:
    """The standard FNO initialisation, drawn from ``generator``:
    U(-s, s) spectral weights with s = 1/(width^2), Xavier-uniform dense
    layers, zero biases. ``generator`` is a ``torch.Generator`` on
    ``device``."""
    def uniform(shape, s):
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        return (2.0 * s) * u - s

    def dense(fan_in, fan_out):
        return uniform((fan_in, fan_out), math.sqrt(6.0 / (fan_in + fan_out)))

    s_spec = 1.0 / (width * width)
    spec_shape = (depth, width, width, modes, modes)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FNOParams(
        lift_w=dense(in_ch, width), lift_b=zeros(width),
        w1_re=uniform(spec_shape, s_spec), w1_im=uniform(spec_shape, s_spec),
        w2_re=uniform(spec_shape, s_spec), w2_im=uniform(spec_shape, s_spec),
        skip_w=torch.stack([dense(width, width) for _ in range(depth)]),
        skip_b=zeros(depth, width),
        proj1_w=dense(width, proj), proj1_b=zeros(proj),
        proj2_w=dense(proj, out_ch), proj2_b=zeros(out_ch),
    )


def _spectral_conv(x, w1_re, w1_im, w2_re, w2_im):
    """(B, H, W, C) -> (B, H, W, C): rfft2 over (H, W), mix the two
    retained low-mode corners over channels, irfft2."""
    _, H, W, _ = x.shape
    m = w1_re.shape[-1]
    xf = torch.fft.rfft2(x, dim=(1, 2))  # (B, H, W//2+1, C) complex
    w1 = torch.complex(w1_re, w1_im)  # (C_in, C_out, m, m)
    w2 = torch.complex(w2_re, w2_im)
    top = torch.einsum("bxyi,ioxy->bxyo", xf[:, :m, :m, :], w1)
    bot = torch.einsum("bxyi,ioxy->bxyo", xf[:, -m:, :m, :], w2)
    out = torch.zeros_like(xf)
    out[:, :m, :m, :] = top
    out[:, -m:, :m, :] = bot  # after top, as the JAX package's .at[].set
    return torch.fft.irfft2(out, s=(H, W), dim=(1, 2))


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation.
    return F.gelu(x, approximate="tanh")


def fno_apply(params: FNOParams, x):
    """Forward pass: ``x`` (B, H, W, in_ch) -> (B, H, W, out_ch)."""
    h = x @ params.lift_w + params.lift_b
    depth = params.skip_w.shape[0]
    for d in range(depth):
        spec = _spectral_conv(h, params.w1_re[d], params.w1_im[d],
                              params.w2_re[d], params.w2_im[d])
        h_new = spec + h @ params.skip_w[d] + params.skip_b[d]
        if d < depth - 1:
            h_new = _gelu(h_new)
        h = h_new
    h = _gelu(h @ params.proj1_w + params.proj1_b)
    return h @ params.proj2_w + params.proj2_b


# --- grid view of CR DOF vectors -------------------------------------


def cell_center_index_grid(mesh_data) -> np.ndarray:
    """(c, c) array of the DOF ids whose midpoints are the cell centers of
    the structured mesh (the diagonal-edge family), computed on the host
    from the coordinates in float64. A cell center lies half a cell from
    every other DOF in grid units, so a DOF is taken within 1e-3 of a
    center: the JAX package's 1e-6 refuses float32 meshes whose spacing
    float32 does not hold exactly (64^2 on the box of 40: a rounding of
    ~2e-6 cells); where it accepts a mesh, both give the same grid."""
    mids = mesh_data.midpoints.detach().cpu().numpy().astype(np.float64)
    n = mesh_data.structured_n
    if n is None:
        raise ValueError("cell-center grid requires a structured mesh")
    c = n - 1
    pts = mesh_data.points.detach().cpu().numpy().astype(np.float64)
    h = (pts[:, 0].max() - pts[:, 0].min()) / c
    xmin, ymin = pts[:, 0].min(), pts[:, 1].min()
    ix = (mids[:, 0] - xmin) / h - 0.5
    iy = (mids[:, 1] - ymin) / h - 0.5
    on = (np.abs(ix - np.round(ix)) < 1e-3) & \
         (np.abs(iy - np.round(iy)) < 1e-3) & \
         (np.round(ix) >= 0) & (np.round(ix) < c) & \
         (np.round(iy) >= 0) & (np.round(iy) < c)
    idx = np.flatnonzero(on)
    grid = np.full((c, c), -1, dtype=np.int64)
    grid[np.round(iy[idx]).astype(int), np.round(ix[idx]).astype(int)] = idx
    if (grid < 0).any():
        raise AssertionError("cell-center grid extraction incomplete")
    return grid


def grid_coordinates(mesh_data):
    """(c, c, 2) physical coordinates of the cell-center grid (numpy)."""
    grid = cell_center_index_grid(mesh_data)
    mids = mesh_data.midpoints.detach().cpu().numpy()
    return mids[grid.reshape(-1)].reshape(grid.shape + (2,))


# --- data from the member-batched FEM engine -------------------------


def _sample_plume_problems(generator, n_samples, d_range, v_max,
                           sigma_range, center_box):
    """A plume-problem family from ``generator`` (a CPU
    ``torch.Generator``): log-uniform D, a uniform wind in the disk of
    radius ``v_max``, uniform release width and center. Returns
    ``(problems, Ds, vs)``, the parameters as numpy arrays."""
    from airpollution_tpu_torch.problems import ShiftedPlumeProblem

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (lo + (hi - lo) * u).numpy()

    Ds = np.exp(uniform((n_samples,), np.log(d_range[0]),
                        np.log(d_range[1])))
    ang = uniform((n_samples,), 0.0, 2 * np.pi)
    rad = v_max * np.sqrt(uniform((n_samples,)))
    vs = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    sig = uniform((n_samples,), sigma_range[0], sigma_range[1])
    ctr = uniform((n_samples, 2), -center_box, center_box)
    problems = [ShiftedPlumeProblem(
        v=(float(vs[i, 0]), float(vs[i, 1])), D=float(Ds[i]),
        sigma=float(sig[i]), center=(float(ctr[i, 0]), float(ctr[i, 1])))
        for i in range(n_samples)]
    return problems, Ds, vs


def _channels(mesh_data, problems, Ds, vs, dtype):
    """(grid index, normalised coordinates (c, c, 2), per-problem IC on
    the grid (n, c, c), constants (n, 3)) on the mesh's device."""
    from airpollution_tpu_torch.diagnostics.ensemble import (
        member_initial_state, stack_problems)

    md = mesh_data
    device = md.midpoints.device
    grid = torch.as_tensor(cell_center_index_grid(md).reshape(-1),
                           device=device)
    coords = torch.as_tensor(grid_coordinates(md), dtype=dtype,
                             device=device)
    c = coords.shape[0]
    batched = stack_problems(problems, dtype=md.midpoints.dtype,
                             device=device)
    u0 = member_initial_state(md, batched, len(problems))
    ic = u0[:, grid].reshape(-1, c, c).to(dtype)
    const = torch.stack([torch.as_tensor(Ds), torch.as_tensor(vs[:, 0]),
                         torch.as_tensor(vs[:, 1])], dim=1).to(
        dtype=dtype, device=device)
    return grid, coords / coords.abs().max(), ic, const


def make_plume_dataset(mesh_data, domain, generator, n_samples, *,
                       d_range=(0.05, 0.5), v_max=1.5,
                       sigma_range=(0.8, 2.0), center_box=8.0,
                       order=1, tol=1e-7, maxiter=200, mesh=None):
    """Solver-manufactured operator-learning dataset.

    Samples ``n_samples`` shifted Gaussian-plume problems from
    ``generator`` (a CPU ``torch.Generator``), integrates all of them to
    t = T as one member batch (``ensemble_forecast``), and returns

    - ``X``: (n, c, c, 6) inputs: the IC at cell centers, the constant
      channels (D, vx, vy) and the coordinate grid (x, y) scaled to
      [-1, 1];
    - ``Y``: (n, c, c, 1) FEM final fields at cell centers;
    - ``problems``: the sampled problems.

    ``mesh`` (a mesh with a 'trial' axis, parallel.make_mesh) shards the
    solves over it (``ensemble_forecast(mesh=)``): each rank draws the
    same problems and solves its share, and every rank gets the whole
    dataset.
    """
    from airpollution_tpu_torch.diagnostics.ensemble import (
        ensemble_forecast)

    problems, Ds, vs = _sample_plume_problems(
        generator, n_samples, d_range, v_max, sigma_range, center_box)
    fc = ensemble_forecast(mesh_data, domain, problems, order=order,
                           tol=tol, maxiter=maxiter, mesh=mesh)
    members = fc["members"]  # (n, n_seg)
    grid, coord_ch, ic, const = _channels(mesh_data, problems, Ds, vs,
                                          members.dtype)
    c = coord_ch.shape[0]
    Y = members[:, grid].reshape(-1, c, c)[..., None]
    X = torch.cat([ic[..., None],
                   const[:, None, None, :].expand(n_samples, c, c, 3),
                   coord_ch[None].expand(n_samples, c, c, 2)], dim=-1)
    return X, Y.to(X.dtype), problems


def make_plume_time_dataset(mesh_data, domain, generator, n_samples, *,
                            n_times=4, include_t0=False, chunk=64,
                            d_range=(0.05, 0.5), v_max=1.5,
                            sigma_range=(0.8, 2.0), center_box=8.0,
                            order=1, tol=1e-7, maxiter=200,
                            stiffness_convention="correct"):
    """Space-time operator-learning dataset: (problem, t) -> c(., t).

    Like :func:`make_plume_dataset`, but each problem gives ``n_times``
    trajectory snapshots (every ``(nt-1)//n_times`` steps) and the inputs
    gain a channel t/T. The trajectories are solved in member batches of
    ``chunk`` problems, and each batch keeps only its strided rows.

    Returns ``X``: (n_samples*n_times, c, c, 7) with channels (ic, D, vx,
    vy, x, y, t/T); ``Y``: the matching FEM fields; ``problems`` (row i
    uses problem ``i // n_times``); ``times``: the (n_times,) snapshot
    times (numpy), shared by every problem.
    """
    from airpollution_tpu_torch.diagnostics.ensemble import (
        member_initial_state, member_operators, stack_problems)
    from airpollution_tpu_torch.models.crbe import run_time_loop

    md = mesh_data
    if (md.nt - 1) % n_times:
        raise ValueError(
            f"n_times={n_times} must divide nt-1={md.nt - 1} "
            f"(strided-snapshot convention)")
    stride = (md.nt - 1) // n_times
    dt = domain.T / (md.nt - 1)
    problems, Ds, vs = _sample_plume_problems(
        generator, n_samples, d_range, v_max, sigma_range, center_box)

    j0 = 0 if include_t0 else 1
    trajs = []
    for i in range(0, n_samples, chunk):
        sub = problems[i:i + chunk]
        batched = stack_problems(sub, dtype=md.midpoints.dtype,
                                 device=md.midpoints.device)
        ops = member_operators(md, sub, dt, order, stiffness_convention)
        sols, _ = run_time_loop(
            ops, member_initial_state(md, batched, len(sub)),
            mesh_data=md, problem=batched, dt=dt, order=order, tol=tol,
            maxiter=maxiter, store_solutions=True)
        # (n_times + 1 - j0, chunk, n_seg) -> (chunk, ..., n_seg)
        trajs.append(sols[::stride][j0:].transpose(0, 1))
    traj = torch.cat(trajs)
    times = np.arange(j0, n_times + 1) * (stride * dt)
    k_t = times.shape[0]

    grid, coord_ch, ic, const = _channels(md, problems, Ds, vs, traj.dtype)
    c = coord_ch.shape[0]
    Y = traj[:, :, grid].reshape(n_samples, k_t, c, c)
    t_ch = torch.as_tensor(times, dtype=ic.dtype, device=ic.device) \
        / domain.T
    X = torch.cat([
        ic[:, None, :, :, None].expand(n_samples, k_t, c, c, 1),
        const[:, None, None, None, :].expand(n_samples, k_t, c, c, 3),
        coord_ch[None, None].expand(n_samples, k_t, c, c, 2),
        t_ch[None, :, None, None, None].expand(n_samples, k_t, c, c, 1),
    ], dim=-1)
    n_rows = n_samples * k_t
    return (X.reshape(n_rows, c, c, 7),
            Y.reshape(n_rows, c, c)[..., None].to(X.dtype),
            problems, times)


# --- training ---------------------------------------------------------


def _rel_l2_rows(params, xb, yb):
    pred = fno_apply(params, xb)
    num = torch.sqrt(((pred - yb) ** 2).sum(dim=(1, 2, 3)))
    den = torch.sqrt((yb ** 2).sum(dim=(1, 2, 3)))
    return num / torch.clamp(den, min=1e-12)


def relative_l2(params, X, Y, batch=32):
    """Mean per-sample relative L2 error of the FNO on (X, Y), in batches
    of ``batch`` rows, with no graph; one host read."""
    with torch.no_grad():
        rows = torch.cat([_rel_l2_rows(params, X[i:i + batch],
                                       Y[i:i + batch])
                          for i in range(0, X.shape[0], batch)])
    return float(rows.mean())


def _loss(params, xb, yb):
    """The relative-L2^2 loss of the standard FNO, averaged over the
    batch."""
    pred = fno_apply(params, xb)
    num = ((pred - yb) ** 2).sum(dim=(1, 2, 3))
    den = torch.clamp((yb ** 2).sum(dim=(1, 2, 3)), min=1e-12)
    return torch.mean(num / den)


def batch_indices(generator, n, batch, epochs, device):
    """The (epochs, batch) row indices of every training step, drawn at
    once on the device."""
    return torch.randint(0, n, (epochs, batch), generator=generator,
                         device=device)


def train_fno(params, X, Y, *, epochs=2000, batch=16, lr=1e-3,
              weight_decay=0.0, generator=None, opt_state=None):
    """AdamW training (optax's ``adamw``: b1 0.9, b2 0.999, eps 1e-8,
    decay ``weight_decay`` added to the update before the learning rate
    scales it) on random batches of ``batch`` rows of (X, Y), drawn from
    ``generator`` (a ``torch.Generator`` on X's device; seed 0 when None).
    Returns ``(params, opt_state, losses)``: ``losses`` the (epochs,)
    per-step losses, read from the device once at the end; pass
    ``opt_state`` back in to continue training."""
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    idx = batch_indices(generator, X.shape[0], batch, epochs, X.device)

    def loss_and_grads(p, step):
        rows = idx[step]
        loss = _loss(FNOParams(*p), X[rows], Y[rows])
        return loss, torch.autograd.grad(loss, p)

    return adamw_steps(params, opt_state, epochs, lr, weight_decay,
                       loss_and_grads, X)


def adamw_steps(params, opt_state, epochs, lr, weight_decay, loss_and_grads,
                like):
    """``epochs`` AdamW steps of :func:`train_fno` from ``params`` and
    ``opt_state`` (None: zero moments); ``loss_and_grads(p, step)`` gives
    step's loss and its gradients in the parameters ``p`` (a list of
    leaf tensors). Returns ``(params, opt_state, losses)``, the losses in
    ``like``'s dtype, read from the device once."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    # The JAX trainer hands optax both rates as float32 scalars.
    lr, weight_decay = float(np.float32(lr)), float(np.float32(weight_decay))
    if opt_state is None:
        opt_state = AdamWState(0, FNOParams(*map(torch.zeros_like, params)),
                               FNOParams(*map(torch.zeros_like, params)))
    p = [t.detach().clone().requires_grad_(True) for t in params]
    mu = [t.clone() for t in opt_state.mu]
    nu = [t.clone() for t in opt_state.nu]
    count = int(opt_state.count)
    losses = torch.empty(epochs, dtype=like.dtype, device=like.device)
    for step in range(epochs):
        loss, grads = loss_and_grads(p, step)
        count += 1
        c1 = 1.0 - b1 ** count
        c2 = 1.0 - b2 ** count
        with torch.no_grad():
            losses[step] = loss
            # One launch per operation over all twelve parameters.
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                                alpha=1.0 - b2)
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
            if weight_decay:
                torch._foreach_add_(upd, p, alpha=weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
    out = FNOParams(*[w.detach() for w in p])
    return out, AdamWState(count, FNOParams(*mu), FNOParams(*nu)), \
        losses.cpu()
