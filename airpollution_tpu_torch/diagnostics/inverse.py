"""Inverse problems: recover physical parameters by differentiating through
the full CRBE solve, PyTorch counterpart of
``airpollution_tpu/diagnostics/inverse.py`` (``solve_final_state``,
``solve_snapshots``, ``fit_parameters``, ``fit_diffusion``, ``fit_source``,
``fit_anisotropic_diffusion`` and ``posterior_covariance``).

The problems keep tensor parameters as tensors (problems.param), assembly
carries their graph, and each implicit step is a
linalg.differentiable_solve / differentiable_chebyshev_solve whose backward
is one transposed solve, so ``torch.autograd`` of an observation misfit
with respect to the physical parameters is exact to solver tolerance (the
exact discrete adjoint on the Chebyshev engines). On structured meshes the
loop runs in family layout with the uniform or per-DOF stencil matvec, and
``engine="auto"`` sends meshes with at least :data:`FUSED_ENGINE_MIN_N`
points per axis to the fused engine: every step's primal and adjoint
Chebyshev sweep is one launch of kernel B4's raw mode
(ops/fused_hbm.chebyshev_apply_canvas_hbm), over the coefficient canvases
and their transpose.

Typical use::

    idx = list(range(16, 128, 16))
    obs = inverse.solve_snapshots(Problem(v=(0.8, 0.6), D=0.25), md,
                                  indices=idx)
    params, losses = inverse.fit_parameters(
        obs, md, make_problem, init, snapshot_indices=idx)

Not ported yet (the JAX package has them): ``robin_alpha`` and
``robin_g_const`` (they raise NotImplementedError), ``fit_wind``,
``fit_deposition``,
``fit_surface_exchange``, ``fit_initial_condition``, ``fit_chemistry``,
``solve_multispecies_snapshots`` and ``receptor_footprint``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from airpollution_tpu_torch.models.crbe import (
    assemble,
    obstacle_masks,
    run_time_loop,
)
from airpollution_tpu_torch.ops import fused_hbm
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.problems import (
    AnisotropicPlumeProblem,
    GaussianSourceProblem,
    Problem,
)

#: Structured-mesh size (points per axis) from which ``engine="auto"`` runs
#: the differentiable loop's solves on kernel B4's raw mode, as the JAX
#: package routes them.
FUSED_ENGINE_MIN_N = 320

#: Adam's constants, those of ``optax.adam`` (eps_root = 0).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _index(mesh_data, indices):
    return torch.as_tensor(np.asarray([int(i) for i in indices],
                                      dtype=np.int64),
                           device=mesh_data.device)


def _mesh_tensor(x, mesh_data):
    """``x`` (a tensor, an array or a number) as a tensor of the mesh's
    dtype and device; a tensor keeps its graph."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float64))
    return x.to(dtype=mesh_data.dtype, device=mesh_data.device)


def _fused_hooks(pattern, ops, perm, chebyshev_iters, dtype, robin_sides):
    """``(cheb_solve_impl, cheb_transpose_solve_impl)``: B4's raw mode over
    the coefficient canvases and over their transpose
    (fused_hbm.raw_solve_pair).

    The input mask is the interior rectangle widened by the Robin walls
    (fused_hbm.robin_rect_bounds), whose DOFs are unknowns. The JAX
    package passes no rectangle here, so its fused engine drops the Robin
    rows of every step's residual (ROADMAP.md C); the port does not
    inherit that."""
    rect = (fused_hbm.robin_rect_bounds(pattern.c, robin_sides)
            if robin_sides else None)
    coeffs = stencil_mod.extract_coefficients(pattern,
                                              ops.system.vals.detach())
    return fused_hbm.raw_solve_pair(pattern, coeffs,
                                    1.0 / ops.system_diag.detach()[perm],
                                    chebyshev_iters, dtype, rect)


def _solve(problem, mesh_data, *, time_scheme_order, stiffness_convention,
           tol, maxiter, store_solutions, robin_alpha=None,
           robin_g_const=None, u0=None, engine="auto", chebyshev_iters=12,
           extrapolate=True):
    """Differentiable solve; (nt, n) when storing, (1, n) otherwise.

    Differentiable in the problem's tensor parameters and in ``u0`` (an
    optional (n_seg,) initial state overriding the problem's initial
    condition). Structured meshes run the loop in family layout: the
    uniform operator's 15 scalars for a constant-coefficient problem
    without Robin walls or obstacles, the per-DOF stencil otherwise.

    ``engine``: ``"scan"`` = BiCGStab to ``tol`` in every step (gradient
    accuracy bounded by ``tol``); ``"fused_hbm"`` = Chebyshev with
    ``chebyshev_iters`` iterations whose primal and adjoint sweeps are one
    launch each of kernel B4's raw mode (the adjoint over the transposed
    coefficients, so the gradient is the exact adjoint of the computed
    primal); ``"auto"`` = fused on structured meshes with
    ``n >= FUSED_ENGINE_MIN_N``, scan otherwise. ``extrapolate``: the
    second-order warm start ``2u - u_prev`` through the delta trick.
    """
    if robin_alpha is not None or robin_g_const is not None:
        raise NotImplementedError(
            "robin_alpha / robin_g_const (traced Robin overrides, the JAX "
            "package's fit_deposition and fit_surface_exchange) are not "
            "ported yet; use the JAX package (airpollution_tpu)")
    if engine not in ("auto", "scan", "fused_hbm"):
        raise ValueError(f"unknown engine {engine!r}")
    md = mesh_data
    dt = float(md.domain.T) / (md.nt - 1)
    ops = assemble(md, problem, dt, time_scheme_order, stiffness_convention)
    if u0 is None:
        u0 = problem.initial_condition_fn(md.midpoints)
    else:
        u0 = _mesh_tensor(u0, md)
    base = dict(problem=problem, dt=dt, order=time_scheme_order, tol=tol,
                maxiter=maxiter, store_solutions=store_solutions,
                differentiable=True, extrapolate_warm_start=extrapolate)

    if md.structured_n is None:
        sols, _ = run_time_loop(ops, u0, mesh_data=md, **base)
        return sols

    pattern = stencil_mod.get_pattern(md)
    _, dead = obstacle_masks(md, problem)
    fam_view = stencil_mod.family_view(md, pattern.perm, dead)
    if (pattern.n >= 3
            and not getattr(problem, "variable_coefficients", False)
            and not getattr(problem, "robin_sides", None)
            and not getattr(problem, "obstacles", None)):
        spec = uniform_mod.build_uniform_spec(pattern)
        ops_fam, matvec, ka_matvec = uniform_mod.uniform_family_operators(
            spec, pattern, ops, time_scheme_order)
    else:
        ops_fam, matvec, ka_matvec = stencil_mod.family_operators(
            pattern, ops, time_scheme_order)
    perm = torch.as_tensor(pattern.perm.astype(np.int64), device=md.device)
    inv = torch.as_tensor(pattern.inv_perm.astype(np.int64),
                          device=md.device)

    if (engine == "fused_hbm"
            or (engine == "auto" and pattern.n >= FUSED_ENGINE_MIN_N)):
        solve_impl, transpose_impl = _fused_hooks(
            pattern, ops, perm, chebyshev_iters, md.dtype,
            getattr(problem, "robin_sides", None))
        base.update(solver="chebyshev", chebyshev_iters=chebyshev_iters,
                    cheb_solve_impl=solve_impl,
                    cheb_transpose_solve_impl=transpose_impl)
    sols_fam, _ = run_time_loop(ops_fam, u0[perm], mesh_data=fam_view,
                                matvec=matvec, ka_matvec=ka_matvec, **base)
    return sols_fam[:, inv]


def solve_final_state(problem, mesh_data, *, time_scheme_order: int = 1,
                      stiffness_convention: str = "correct",
                      tol: float = 1e-9, maxiter: int = 200,
                      robin_alpha=None, robin_g_const=None, u0=None,
                      engine: str = "auto", chebyshev_iters: int = 12,
                      extrapolate: bool = True):
    """Differentiable CRBE solve returning the boundary-lifted final state
    (n_seg,). ``engine``/``chebyshev_iters``/``extrapolate``: see
    :func:`_solve`."""
    return _solve(problem, mesh_data, time_scheme_order=time_scheme_order,
                  stiffness_convention=stiffness_convention, tol=tol,
                  maxiter=maxiter, store_solutions=False,
                  robin_alpha=robin_alpha, robin_g_const=robin_g_const,
                  u0=u0, engine=engine, chebyshev_iters=chebyshev_iters,
                  extrapolate=extrapolate)[0]


def solve_snapshots(problem, mesh_data, *, indices=None,
                    time_scheme_order: int = 1,
                    stiffness_convention: str = "correct",
                    tol: float = 1e-9, maxiter: int = 200,
                    robin_alpha=None, robin_g_const=None, u0=None,
                    engine: str = "auto", chebyshev_iters: int = 12,
                    extrapolate: bool = True):
    """Differentiable solve returning solution snapshots: the time rows
    ``indices`` of the (nt, n_seg) trajectory (default all). Trajectory
    observations make the joint (D, v) estimation well-posed."""
    sols = _solve(problem, mesh_data, time_scheme_order=time_scheme_order,
                  stiffness_convention=stiffness_convention, tol=tol,
                  maxiter=maxiter, store_solutions=True,
                  robin_alpha=robin_alpha, robin_g_const=robin_g_const,
                  u0=u0, engine=engine, chebyshev_iters=chebyshev_iters,
                  extrapolate=extrapolate)
    if indices is None:
        return sols
    return sols[_index(mesh_data, indices)]


def _predictor(mesh_data, make_problem, snapshot_indices, sensor_indices,
               **solve_kw):
    """``params -> predicted observations``: the final state or the
    snapshot rows, then the sensor gather (inside the graph, so its
    transpose rides the same adjoint)."""
    idx = ([int(i) for i in snapshot_indices]
           if snapshot_indices is not None else None)
    sens = (_index(mesh_data, sensor_indices)
            if sensor_indices is not None else None)

    def predict(params):
        p = make_problem(params)
        if idx is None:
            pred = solve_final_state(p, mesh_data, **solve_kw)
        else:
            pred = solve_snapshots(p, mesh_data, indices=idx, **solve_kw)
        if sens is not None:
            pred = pred[..., sens]
        return pred

    return predict


def _leaf_tensors(params, mesh_data):
    """A parameter dict as new tensors of the mesh's dtype and device, in
    the JAX package's pytree order (keys sorted), detached from the
    caller's."""
    return {k: _mesh_tensor(params[k], mesh_data).detach().clone()
            for k in sorted(params)}


def fit_parameters(observed, mesh_data, make_problem, init_params,
                   *, snapshot_indices=None, sensor_indices=None,
                   steps: int = 100,
                   lr: float = 0.1, time_scheme_order: int = 1,
                   tol: float = 1e-9, maxiter: int = 200, cache_key=None,
                   engine: str = "auto", chebyshev_iters: int = 12,
                   extrapolate: bool = True, on_step=None):
    """Gradient-descent fit of physical parameters to observations.

    ``make_problem(params)`` maps the parameter dict (name -> tensor) to a
    problem instance (apply positivity transforms there, e.g. ``D =
    exp(log_d)``). ``observed`` is the final-time field (n,) by default,
    or the ``(len(snapshot_indices), n)`` trajectory; with
    ``sensor_indices`` the misfit is taken on ``predicted[...,
    sensor_indices]`` and ``observed`` carries the sensor axis last.
    Minimizes the mean squared misfit with Adam, ``optax.adam(lr)``'s
    update (b1 = 0.9, b2 = 0.999, eps = 1e-8, bias-corrected). Returns
    ``(params, losses)``: a dict of detached tensors and a list of floats.

    ``cache_key`` is accepted for the JAX signature and ignored: that
    package caches a compiled fit step under it, and an eager solve has no
    compiled program to cache. ``on_step(i, loss)``, when given, is called
    after each Adam step with its loss (a float, so the step has ended on
    the device).
    """
    del cache_key
    md = mesh_data
    observed = _mesh_tensor(observed, md)
    predict = _predictor(md, make_problem, snapshot_indices, sensor_indices,
                         time_scheme_order=time_scheme_order, tol=tol,
                         maxiter=maxiter, engine=engine,
                         chebyshev_iters=chebyshev_iters,
                         extrapolate=extrapolate)
    params = _leaf_tensors(init_params, md)
    keys = list(params)
    leaves = list(params.values())
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses = []
    for step in range(1, steps + 1):
        for t in leaves:
            t.requires_grad_(True)
        loss = torch.mean((predict(params) - observed) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            # optax.scale_by_adam, then scale_by_learning_rate(lr).
            c1 = 1.0 - ADAM_B1 ** step
            c2 = 1.0 - ADAM_B2 ** step
            new = []
            for i, (t, g) in enumerate(zip(leaves, grads)):
                mu[i] = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[i]
                nu[i] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu[i]
                update = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + ADAM_EPS)
                new.append(t.detach() + (-lr) * update)
        leaves = new
        params = dict(zip(keys, leaves))
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(step - 1, losses[-1])
    return params, losses


def posterior_covariance(mesh_data, make_problem, params, *,
                         snapshot_indices=None, sensor_indices=None,
                         obs_std=None, observed=None,
                         time_scheme_order: int = 1,
                         tol: float = 1e-9, maxiter: int = 200):
    """Laplace (Gauss-Newton) posterior covariance of a fitted parameter
    dict: ``Sigma = obs_std^2 (J^T J)^-1``, ``J`` the sensitivity of every
    prediction to every parameter coordinate, computed by forward-mode AD
    through the full differentiable solve (one linearised time loop per
    coordinate, through the solve Function's forward rule, under
    ``torch.no_grad()``). The solve takes the default engine (``"auto"``,
    Chebyshev-12, extrapolated), as the JAX function's does.

    ``obs_std``: the observation noise; if None it is estimated from the
    residuals against ``observed`` (same layout as the fit) as
    ``sqrt(||r||^2 / (N - p))``. Covariances are in the optimisation
    coordinates (e.g. log q).

    Returns a dict: ``cov`` ((p, p) tensor), ``std`` ({label: float}),
    ``corr`` ((p, p) tensor), ``labels`` (coordinate names in the JAX
    package's ``ravel_pytree`` order: the leaf path, plus ``[i]`` for a
    leaf that is not a scalar) and ``obs_std`` (the value used).
    """
    md = mesh_data
    predict = _predictor(md, make_problem, snapshot_indices, sensor_indices,
                         time_scheme_order=time_scheme_order, tol=tol,
                         maxiter=maxiter)
    flat = _leaf_tensors(params, md)
    labels = []
    for name, t in flat.items():
        if t.numel() == 1:
            labels.append(name)
        else:
            labels.extend(f"{name}[{i}]" for i in range(t.numel()))
    theta0 = torch.cat([t.reshape(-1) for t in flat.values()])
    p = theta0.shape[0]

    def unravel(theta):
        out, at = {}, 0
        for name, t in flat.items():
            out[name] = theta[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
        return out

    def predict_vec(theta):
        return predict(unravel(theta)).reshape(-1)

    eye = torch.eye(p, dtype=theta0.dtype, device=theta0.device)
    cols = []
    with torch.no_grad():
        for i in range(p):
            with fwAD.dual_level():
                primal, tangent = fwAD.unpack_dual(
                    predict_vec(fwAD.make_dual(theta0, eye[i])))
                cols.append(torch.zeros_like(primal) if tangent is None
                            else tangent.clone())
        J = torch.stack(cols, dim=1)
        if obs_std is None:
            if observed is None:
                raise ValueError("pass obs_std, or observed to estimate it "
                                 "from the fit residuals")
            obs = _mesh_tensor(observed, md).reshape(-1)
            r = predict_vec(theta0) - obs
            dof = max(int(r.shape[0]) - p, 1)
            obs_std = float(torch.sqrt((r @ r) / dof))
        H = J.T @ J
        cov = float(obs_std) ** 2 * torch.linalg.inv(H)
        std = torch.sqrt(torch.diag(cov))
        corr = cov / torch.outer(std, std)
    return {
        "cov": cov,
        "std": {lab: float(s) for lab, s in zip(labels, std)},
        "corr": corr,
        "labels": labels,
        "obs_std": float(obs_std),
    }


def fit_diffusion(observed_final, mesh_data, *, D0: float = 1.0,
                  v=(1.0, 0.5), sigma: float = 1.0, steps: int = 100,
                  lr: float = 0.1, **kwargs):
    """Recover a positive scalar D (optimised in log space) for the
    Gaussian-plume problem family. Returns ``(D, losses)``."""

    def make_problem(params):
        return Problem(v=v, D=torch.exp(params["log_d"]), sigma=sigma)

    init = {"log_d": torch.log(torch.tensor(D0, dtype=mesh_data.dtype))}
    kwargs.pop("cache_key", None)
    params, losses = fit_parameters(observed_final, mesh_data, make_problem,
                                    init, steps=steps, lr=lr, **kwargs)
    return float(torch.exp(params["log_d"])), losses


def fit_source(observed, mesh_data, *, snapshot_indices=None,
               sensor_indices=None, v=(1.0, 0.5), D: float = 0.1,
               sigma_s: float = 1.0, q0: float = 1.0,
               xy0=(0.0, 0.0), fit_transport: bool = False,
               steps: int = 200, lr: float = 0.1, **kwargs):
    """Emission-source identification: recover the rate ``q`` and location
    ``(xs, ys)`` of a problems.GaussianSourceProblem from concentration
    observations (``sensor_indices`` + ``snapshot_indices`` for a
    monitoring network), transport (``v``, ``D``) known. ``q`` is optimised
    in log space; ``fit_transport=True`` estimates (D, v) as well. The
    parameters follow the mesh's dtype. Returns ``(result, losses)`` with
    keys ``q``, ``xs``, ``ys`` (plus ``D``, ``v`` when ``fit_transport``).
    """
    md = mesh_data
    v = _mesh_tensor(v, md)

    def make_problem(params):
        common = dict(q=torch.exp(params["log_q"]), xs=params["xy"][0],
                      ys=params["xy"][1], sigma_s=sigma_s)
        if fit_transport:
            return GaussianSourceProblem(
                v=params["v"], D=torch.exp(params["log_d"]), **common)
        return GaussianSourceProblem(v=v, D=D, **common)

    init = {"log_q": torch.log(torch.tensor(q0, dtype=md.dtype)),
            "xy": torch.tensor([float(c) for c in xy0], dtype=md.dtype)}
    if fit_transport:
        init["log_d"] = torch.log(torch.tensor(D, dtype=md.dtype))
        init["v"] = v
    kwargs.pop("cache_key", None)
    params, losses = fit_parameters(
        observed, md, make_problem, init,
        snapshot_indices=snapshot_indices, sensor_indices=sensor_indices,
        steps=steps, lr=lr, **kwargs)
    result = {"q": float(torch.exp(params["log_q"])),
              "xs": float(params["xy"][0]), "ys": float(params["xy"][1])}
    if fit_transport:
        result["D"] = float(torch.exp(params["log_d"]))
        result["v"] = tuple(float(x) for x in params["v"])
    return result, losses


def fit_anisotropic_diffusion(observed, mesh_data, *, snapshot_indices=None,
                              sensor_indices=None, Dx0: float = 0.1,
                              Dy0: float = 0.1, v=(1.0, 0.5),
                              sigma: float = 1.0, steps: int = 150,
                              lr: float = 0.05, **kwargs):
    """Recover the eddy-diffusivity tensor diag(Dx, Dy) of a
    problems.AnisotropicPlumeProblem from concentration observations
    (optimised in log space; the tensor enters through the weak-form
    assembly, models/crbe.local_matrices). Returns ``({"Dx": ..., "Dy":
    ...}, losses)``."""
    md = mesh_data
    v = _mesh_tensor(v, md)

    def make_problem(params):
        return AnisotropicPlumeProblem(v=v, Dx=torch.exp(params["log_dx"]),
                                       Dy=torch.exp(params["log_dy"]),
                                       sigma=sigma)

    init = {"log_dx": torch.log(torch.tensor(Dx0, dtype=md.dtype)),
            "log_dy": torch.log(torch.tensor(Dy0, dtype=md.dtype))}
    kwargs.pop("cache_key", None)
    params, losses = fit_parameters(
        observed, md, make_problem, init,
        snapshot_indices=snapshot_indices, sensor_indices=sensor_indices,
        steps=steps, lr=lr, **kwargs)
    return ({"Dx": float(torch.exp(params["log_dx"])),
             "Dy": float(torch.exp(params["log_dy"]))}, losses)
