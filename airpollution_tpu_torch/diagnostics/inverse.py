"""Inverse problems: recover physical parameters by differentiating through
the full CRBE solve, PyTorch counterpart of
``airpollution_tpu/diagnostics/inverse.py``: the differentiable solves
(``solve_final_state``, ``solve_snapshots``, with traced Robin overrides
and an initial-state override; ``solve_multispecies_snapshots``), the fits
(``fit_parameters`` and its wrappers ``fit_diffusion``, ``fit_source``,
``fit_anisotropic_diffusion``, ``fit_wind``; ``fit_deposition``,
``fit_surface_exchange``, ``fit_initial_condition``, ``fit_chemistry``),
``posterior_covariance`` and ``receptor_footprint``.

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
and their transpose. Parameters are nested dicts (or lists, tuples) of
tensors, flattened in the JAX package's ``ravel_pytree`` order.

Typical use::

    idx = list(range(16, 128, 16))
    obs = inverse.solve_snapshots(Problem(v=(0.8, 0.6), D=0.25), md,
                                  indices=idx)
    params, losses = inverse.fit_parameters(
        obs, md, make_problem, init, snapshot_indices=idx)
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
from airpollution_tpu_torch.ops import fused_hbm, linalg, sparse
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.problems import (
    AnisotropicPlumeProblem,
    GaussianSourceProblem,
    MultiSpeciesProblem,
    Problem,
    RotatingPlumeProblem,
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


def _tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf: nested dicts (keys
    sorted, as the JAX package's pytrees order them), lists and tuples;
    None is an empty subtree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree, path=""):
    """``[(label, leaf)]`` in ``ravel_pytree`` order; the label is the
    JAX package's ``keystr`` of the leaf's path, cut as its
    ``posterior_covariance`` cuts it (``"src.log_q"``)."""
    if isinstance(tree, dict):
        items = [(f"{path}[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"{path}[{i}]", t) for i, t in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(path.strip("[']").replace("']['", "."), tree)]
    return [leaf for p, t in items for leaf in _tree_leaves(t, p)]


def _tree_unflatten(tree, leaves):
    """The structure of ``tree`` with ``leaves`` in ``_tree_leaves``
    order."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


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


def _cached_interval(cache, matvec, ops_fam, u0):
    """The Chebyshev interval run_time_loop would estimate for this
    family-layout operator, estimated once and kept in ``cache`` while the
    assembled operator carries no gradient and its values stay bitwise
    the same (a fit whose parameters enter only the load, as
    ``fit_source``'s do); None, to let the loop estimate it, otherwise."""
    vals = ops_fam.system.vals
    if vals.requires_grad:
        return None
    if cache.get("vals") is not None and torch.equal(cache["vals"], vals):
        return cache["bounds"]
    bounds = linalg.power_bounds(
        matvec.detached(), torch.zeros_like(u0).detach(),
        scale=1.0 / torch.sqrt(ops_fam.system_diag.detach()))
    cache["vals"] = vals.detach()
    cache["bounds"] = tuple(b.detach() for b in bounds)
    return cache["bounds"]


def _solve(problem, mesh_data, *, time_scheme_order, stiffness_convention,
           tol, maxiter, store_solutions, robin_alpha=None,
           robin_g_const=None, u0=None, engine="auto", chebyshev_iters=12,
           extrapolate=True, interval_cache=None):
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

    ``robin_alpha`` / ``robin_g_const``: per-side alphas and g values
    (tensors, say) overriding the problem's ``robin_sides`` values in the
    assembled operator and its ``robin_g`` in the load; the gradient
    reaches them through the operator's tensors (on the fused engine the
    canvases B4 reads are detached copies) and through the load. Robin
    problems take the per-DOF stencil on structured meshes, and the fused
    engine keeps their rows (the Robin rectangle, :func:`_fused_hooks`).

    ``interval_cache``: a dict shared by the solves of one fit, in which
    the fused engine keeps its Chebyshev interval while the operator
    stays the same (:func:`_cached_interval`).
    """
    if engine not in ("auto", "scan", "fused_hbm"):
        raise ValueError(f"unknown engine {engine!r}")
    md = mesh_data
    dt = float(md.domain.T) / (md.nt - 1)
    ops = assemble(md, problem, dt, time_scheme_order, stiffness_convention,
                   robin_alpha=robin_alpha)
    if u0 is None:
        u0 = problem.initial_condition_fn(md.midpoints)
    else:
        u0 = _mesh_tensor(u0, md)
    base = dict(problem=problem, dt=dt, order=time_scheme_order, tol=tol,
                maxiter=maxiter, store_solutions=store_solutions,
                differentiable=True, robin_g_const=robin_g_const,
                extrapolate_warm_start=extrapolate)

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
        if interval_cache is not None:
            base["bounds"] = _cached_interval(interval_cache, matvec,
                                              ops_fam, u0)
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
    transpose rides the same adjoint). ``make_problem(params)`` returns a
    problem, or ``(problem, extra solve keywords)``."""
    idx = (_index(mesh_data, snapshot_indices)
           if snapshot_indices is not None else None)
    sens = (_index(mesh_data, sensor_indices)
            if sensor_indices is not None else None)

    def predict(params):
        made = make_problem(params)
        p, extra = made if isinstance(made, tuple) else (made, {})
        pred = _solve(p, mesh_data, store_solutions=idx is not None,
                      **solve_kw, **extra)
        pred = pred[0] if idx is None else pred[idx]
        if sens is not None:
            pred = pred[..., sens]
        return pred

    return predict


def _leaf_tensors(params, mesh_data):
    """A parameter tree (nested dicts, lists, tuples) as new tensors of the
    mesh's dtype and device, detached from the caller's, keys sorted."""
    return _tree_map(
        lambda x: _mesh_tensor(x, mesh_data).detach().clone(), params)


def _adam(loss_of, params, *, steps, lr, on_step=None):
    """``steps`` Adam steps, ``optax.adam(lr)``'s update (b1 = 0.9, b2 =
    0.999, eps = 1e-8, bias-corrected), on the parameter tree ``params``
    (leaves: tensors of their own) minimising ``loss_of(params)``. Returns
    ``(params, losses)``: detached tensors in the same tree, and each
    step's loss at its starting point as a float, as the JAX fits record
    it. ``on_step(i, loss)`` is called after step i."""
    leaves = [t for _, t in _tree_leaves(params)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses = []
    for step in range(1, steps + 1):
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_of(_tree_unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            # optax.scale_by_adam, then scale_by_learning_rate(lr).
            c1 = 1.0 - ADAM_B1 ** step
            c2 = 1.0 - ADAM_B2 ** step
            new = []
            for i, (t, g) in enumerate(zip(leaves, grads)):
                if g is None:
                    g = torch.zeros_like(t)
                mu[i] = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[i]
                nu[i] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu[i]
                update = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + ADAM_EPS)
                new.append(t.detach() + (-lr) * update)
        leaves = new
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(step - 1, losses[-1])
    return _tree_unflatten(params, leaves), losses


def _misfit_fit(observed, mesh_data, predict, init, *, steps, lr,
                on_step=None):
    """Adam on the mean squared misfit of ``predict(params)`` against
    ``observed``; ``(params, losses)`` as :func:`_adam` returns them."""
    observed = _mesh_tensor(observed, mesh_data)
    return _adam(lambda q: torch.mean((predict(q) - observed) ** 2),
                 _leaf_tensors(init, mesh_data), steps=steps, lr=lr,
                 on_step=on_step)


def fit_parameters(observed, mesh_data, make_problem, init_params,
                   *, snapshot_indices=None, sensor_indices=None,
                   steps: int = 100,
                   lr: float = 0.1, time_scheme_order: int = 1,
                   tol: float = 1e-9, maxiter: int = 200, cache_key=None,
                   engine: str = "auto", chebyshev_iters: int = 12,
                   extrapolate: bool = True, on_step=None):
    """Gradient-descent fit of physical parameters to observations.

    ``make_problem(params)`` maps the parameter tree (a dict of tensors,
    or nested dicts, lists and tuples of them) to a problem instance
    (apply positivity transforms there, e.g. ``D = exp(log_d)``).
    ``observed`` is the final-time field (n,) by default, or the
    ``(len(snapshot_indices), n)`` trajectory; with ``sensor_indices`` the
    misfit is taken on ``predicted[..., sensor_indices]`` and ``observed``
    carries the sensor axis last. Minimizes the mean squared misfit with
    Adam, ``optax.adam(lr)``'s update. Returns ``(params, losses)``: the
    tree of detached tensors and a list of floats.

    The fused engine estimates its Chebyshev interval once per fit while
    the assembled operator carries no gradient (the parameters enter only
    the load, as ``fit_source``'s do); the estimate is what each step
    would compute again. ``cache_key`` is accepted for the JAX signature
    and ignored: that package caches a compiled fit step under it, and an
    eager solve has no compiled program to cache. ``on_step(i, loss)``,
    when given, is called after each Adam step with its loss (a float, so
    the step has ended on the device).
    """
    del cache_key
    predict = _predictor(mesh_data, make_problem, snapshot_indices,
                         sensor_indices,
                         time_scheme_order=time_scheme_order,
                         stiffness_convention="correct", tol=tol,
                         maxiter=maxiter, engine=engine,
                         chebyshev_iters=chebyshev_iters,
                         extrapolate=extrapolate, interval_cache={})
    return _misfit_fit(observed, mesh_data, predict, init_params,
                       steps=steps, lr=lr, on_step=on_step)


def posterior_covariance(mesh_data, make_problem, params, *,
                         snapshot_indices=None, sensor_indices=None,
                         obs_std=None, observed=None,
                         time_scheme_order: int = 1,
                         tol: float = 1e-9, maxiter: int = 200):
    """Laplace (Gauss-Newton) posterior covariance of a fitted parameter
    tree: ``Sigma = obs_std^2 (J^T J)^-1``, ``J`` the sensitivity of every
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
    package's ``ravel_pytree`` order: the leaf path, ``"src.log_q"`` for a
    nested one, plus ``[i]`` for a leaf that is not a scalar) and
    ``obs_std`` (the value used).
    """
    md = mesh_data
    predict = _predictor(md, make_problem, snapshot_indices, sensor_indices,
                         time_scheme_order=time_scheme_order,
                         stiffness_convention="correct", tol=tol,
                         maxiter=maxiter, interval_cache={})
    tree = _leaf_tensors(params, md)
    flat = _tree_leaves(tree)
    labels = []
    for name, t in flat:
        if t.numel() == 1:
            labels.append(name)
        else:
            labels.extend(f"{name}[{i}]" for i in range(t.numel()))
    theta0 = torch.cat([t.reshape(-1) for _, t in flat])
    p = theta0.shape[0]

    def unravel(theta):
        out, at = [], 0
        for _, t in flat:
            out.append(theta[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return _tree_unflatten(tree, out)

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


def fit_wind(observed, mesh_data, *, snapshot_indices=None,
             sensor_indices=None, omega0: float = 0.05, D: float = 0.05,
             sigma: float = 1.5, x0: float = 5.0, y0: float = 0.0,
             fit_diffusion: bool = False, steps: int = 200,
             lr: float = 0.02, omega_grid=None, **kwargs):
    """Wind-field estimation: recover the rotation rate ``omega`` of a
    problems.RotatingPlumeProblem (and with ``fit_diffusion`` its ``D``,
    in log space) from concentration observations. The wind enters the
    operator through the centroid-sampled assembly, so the gradient runs
    through the coefficient field into every implicit step (the per-DOF
    stencil; B4's raw mode over its canvases on the fused engine). The
    release (``sigma``, ``x0``, ``y0``) is known.

    The misfit is not convex in ``omega`` (a rotation that misses the puff
    by more than its width leaves the gradient in a wrong basin):
    ``omega_grid``, a sequence of candidate rates, picks the start by one
    forward solve per candidate under ``torch.no_grad()`` (the default
    engine, the caller's order, ``tol`` and ``maxiter``), the first
    argmin. Returns ``(result, losses)`` with key ``omega`` (plus ``D``
    with ``fit_diffusion``, and ``omega0``, the start the grid picked)."""
    md = mesh_data
    order = kwargs.get("time_scheme_order", 1)
    tol = kwargs.get("tol", 1e-9)
    maxiter = kwargs.get("maxiter", 200)

    def make_problem(params):
        d_val = torch.exp(params["log_d"]) if fit_diffusion else D
        return RotatingPlumeProblem(omega=params["omega"], D=d_val,
                                    sigma=sigma, x0=x0, y0=y0)

    grid_pick = None
    if omega_grid is not None:
        observed = _mesh_tensor(observed, md)
        predict = _predictor(
            md, lambda om: RotatingPlumeProblem(omega=om, D=D, sigma=sigma,
                                                x0=x0, y0=y0),
            snapshot_indices, sensor_indices, time_scheme_order=order,
            stiffness_convention="correct", tol=tol, maxiter=maxiter)
        cands = [float(o) for o in omega_grid]
        with torch.no_grad():
            vals = [float(torch.mean((predict(_mesh_tensor(o, md))
                                      - observed) ** 2)) for o in cands]
        grid_pick = omega0 = cands[int(np.argmin(vals))]

    init = {"omega": torch.tensor(float(omega0), dtype=md.dtype)}
    if fit_diffusion:
        init["log_d"] = torch.log(torch.tensor(D, dtype=md.dtype))
    kwargs.pop("cache_key", None)
    params, losses = fit_parameters(
        observed, md, make_problem, init,
        snapshot_indices=snapshot_indices, sensor_indices=sensor_indices,
        steps=steps, lr=lr, **kwargs)
    result = {"omega": float(params["omega"])}
    if fit_diffusion:
        result["D"] = float(torch.exp(params["log_d"]))
    if grid_pick is not None:
        result["omega0"] = grid_pick
    return result, losses


def _robin_sides(problem, what):
    robin = getattr(problem, "robin_sides", None)
    if not robin:
        raise ValueError(f"problem.robin_sides names the {what} sides to "
                         "estimate")
    return sorted(robin)


def fit_deposition(observed, mesh_data, problem, *, alpha0: float = 0.1,
                   snapshot_indices=None, sensor_indices=None,
                   steps: int = 150, lr: float = 0.1,
                   time_scheme_order: int = 1, tol: float = 1e-9,
                   maxiter: int = 200, cache_key=None,
                   engine: str = "auto", chebyshev_iters: int = 12,
                   extrapolate: bool = True, on_step=None):
    """Deposition-velocity estimation: recover the per-side Robin alphas
    (v_d in ``-D dc/dn = v_d c``) of ``problem.robin_sides`` from
    concentration observations, transport known. The alphas are fitted in
    log space as overrides of the static ``robin_sides`` values
    (``robin_alpha``), reaching every implicit step through the assembled
    diagonal. Trajectory snapshots or near-wall sensors identify them.
    ``cache_key`` is ignored (:func:`fit_parameters`). Returns
    ``({side: alpha}, losses)``."""
    del cache_key
    sides = _robin_sides(problem, "deposition")
    md = mesh_data

    def make_problem(q):
        return problem, {"robin_alpha": {
            s: torch.exp(q["log_alpha"][i]) for i, s in enumerate(sides)}}

    predict = _predictor(md, make_problem, snapshot_indices, sensor_indices,
                         time_scheme_order=time_scheme_order,
                         stiffness_convention="correct", tol=tol,
                         maxiter=maxiter, engine=engine,
                         chebyshev_iters=chebyshev_iters,
                         extrapolate=extrapolate)
    init = {"log_alpha": torch.log(torch.full((len(sides),), alpha0,
                                              dtype=md.dtype))}
    params, losses = _misfit_fit(observed, md, predict, init, steps=steps,
                                 lr=lr, on_step=on_step)
    return ({s: float(torch.exp(params["log_alpha"][i]))
             for i, s in enumerate(sides)}, losses)


def fit_surface_exchange(observed, mesh_data, problem, *,
                         alpha0: float = 0.1, c_comp0: float = 0.0,
                         snapshot_indices=None, sensor_indices=None,
                         steps: int = 150, lr: float = 0.1,
                         time_scheme_order: int = 1, tol: float = 1e-9,
                         maxiter: int = 200, cache_key=None,
                         engine: str = "auto", chebyshev_iters: int = 12,
                         extrapolate: bool = True, on_step=None):
    """Joint surface-exchange estimation: per-side deposition velocities
    and compensation points of the bidirectional flux law ``-D dc/dn =
    v_d (c - c_comp)``, i.e. ``alpha = v_d`` (the ``robin_alpha`` override,
    fitted in log space) and ``g = v_d c_comp`` (the ``robin_g_const``
    override of the load; c_comp fitted in linear space). Returns
    ``({side: (v_d, c_comp)}, losses)``."""
    del cache_key
    sides = _robin_sides(problem, "exchange")
    md = mesh_data

    def make_problem(q):
        alphas = {s: torch.exp(q["log_alpha"][i])
                  for i, s in enumerate(sides)}
        g_const = {s: alphas[s] * q["c_comp"][i]
                   for i, s in enumerate(sides)}
        return problem, {"robin_alpha": alphas, "robin_g_const": g_const}

    predict = _predictor(md, make_problem, snapshot_indices, sensor_indices,
                         time_scheme_order=time_scheme_order,
                         stiffness_convention="correct", tol=tol,
                         maxiter=maxiter, engine=engine,
                         chebyshev_iters=chebyshev_iters,
                         extrapolate=extrapolate)
    init = {"log_alpha": torch.log(torch.full((len(sides),), alpha0,
                                              dtype=md.dtype)),
            "c_comp": torch.full((len(sides),), c_comp0, dtype=md.dtype)}
    params, losses = _misfit_fit(observed, md, predict, init, steps=steps,
                                 lr=lr, on_step=on_step)
    return ({s: (float(torch.exp(params["log_alpha"][i])),
                 float(params["c_comp"][i]))
             for i, s in enumerate(sides)}, losses)


def fit_initial_condition(observed, mesh_data, problem, *,
                          snapshot_indices, sensor_indices=None,
                          steps: int = 200, lr: float = 0.05,
                          smoothness: float = 1e-3,
                          nonnegative: bool = False, u0_init=None,
                          time_scheme_order: int = 1, tol: float = 1e-9,
                          maxiter: int = 200, cache_key=None,
                          engine: str = "auto", chebyshev_iters: int = 12,
                          extrapolate: bool = True, on_step=None):
    """4D-Var initial-condition estimation: recover the full (n_seg,)
    initial field from observations of its later evolution, transport
    known, by Adam on

        J(u0) = mean[(H u(t_k; u0) - y_k)^2] + smoothness/n * u0^T K1 u0,

    H the (snapshot, sensor) observation operator and ``u0^T K1 u0`` the
    roughness (the unit-diffusion, zero-wind CR stiffness, assembled once;
    its product is ``sparse.ell_matvec``, kernel B7a on the card, and its
    transpose in the backward). One adjoint sweep of the time loop per
    step. ``snapshot_indices`` must name at least one time; ``observed``
    is ``(len(snapshot_indices), n_seg)`` or ``(..., len(sensor_indices))``.
    ``nonnegative`` fits ``u0 = softplus(z)``; ``u0_init`` seeds the search
    (default zero; ``softplus(-6)`` under ``nonnegative``). The fused
    engine's interval is estimated once (:func:`fit_parameters`).
    ``cache_key`` is ignored. Returns ``(u0_estimate, losses)``."""
    del cache_key
    md = mesh_data
    idx = [int(i) for i in snapshot_indices]
    if not idx:
        raise ValueError("snapshot_indices must name at least one "
                         "observation time")
    n = md.number_of_segments
    dtype = md.dtype
    K1 = assemble(md, Problem(v=(0.0, 0.0), D=1.0), 1.0, 1).stiffness
    if u0_init is None:
        z0 = torch.full((n,), -6.0 if nonnegative else 0.0, dtype=dtype,
                        device=md.device)
    else:
        u0i = _mesh_tensor(u0_init, md)
        z0 = (torch.log(torch.expm1(torch.clamp(u0i, min=1e-6)))
              if nonnegative else u0i)

    def field(z):
        # jax.nn.softplus: log(1 + e^z) with no linear cut-off.
        return torch.logaddexp(z, torch.zeros_like(z)) if nonnegative else z

    predict = _predictor(md, lambda u0: (problem, {"u0": u0}), idx,
                         sensor_indices,
                         time_scheme_order=time_scheme_order,
                         stiffness_convention="correct", tol=tol,
                         maxiter=maxiter, engine=engine,
                         chebyshev_iters=chebyshev_iters,
                         extrapolate=extrapolate, interval_cache={})
    observed = _mesh_tensor(observed, md)

    def loss_of(z):
        u0 = field(z)
        misfit = torch.mean((predict(u0) - observed) ** 2)
        rough = (u0 @ sparse.ell_matvec(K1, u0)) / n
        return misfit + smoothness * rough

    z, losses = _adam(loss_of, z0.detach().clone(), steps=steps, lr=lr,
                      on_step=on_step)
    return field(z).detach(), losses


def solve_multispecies_snapshots(problem, mesh_data, *, R=None,
                                 indices=None, time_scheme_order: int = 1,
                                 stiffness_convention: str = "correct",
                                 tol: float = 1e-9, maxiter: int = 200,
                                 store_solutions: bool = True):
    """Differentiable multi-species solve; (nt, K, n) snapshots (the rows
    ``indices``), or the (1, K, n) final state without
    ``store_solutions``.

    ``problem`` is a problems.MultiSpeciesProblem; ``R`` optionally
    overrides its mechanism with a (K, K) tensor. The chemistry enters
    through the Strang half-step exponential (problems.expm64, torch
    operations that autograd passes through) and every transport solve is
    a linalg.differentiable_solve (BiCGStab), so the gradient in ``R`` is
    the discrete adjoint of the coupled loop. Shared transport on
    structured meshes runs in family layout (the per-DOF stencil); the
    per-species operators of unshared transport are stacked
    (models/multispecies.stack_operators) on the ELL path."""
    from airpollution_tpu_torch.models.multispecies import (
        run_multispecies_loop,
        stack_operators,
    )

    md = mesh_data
    dt = float(md.domain.T) / (md.nt - 1)
    if problem.shared_transport:
        ops = assemble(md, problem.species[0], dt, time_scheme_order,
                       stiffness_convention)
    else:
        ops = stack_operators([
            assemble(md, sp, dt, time_scheme_order, stiffness_convention)
            for sp in problem.species])
    C0 = problem.initial_conditions(md.midpoints)
    base = dict(problem=problem, dt=dt, order=time_scheme_order, tol=tol,
                maxiter=maxiter, store_solutions=store_solutions,
                differentiable=True, R=R)
    if md.structured_n is None or not problem.shared_transport:
        sols, _ = run_multispecies_loop(ops, C0, mesh_data=md, **base)
    else:
        pattern = stencil_mod.get_pattern(md)
        fam_view = stencil_mod.family_view(md, pattern.perm)
        ops_fam, matvec, ka_matvec = stencil_mod.family_operators(
            pattern, ops, time_scheme_order)
        perm = torch.as_tensor(pattern.perm.astype(np.int64),
                               device=md.device)
        inv = torch.as_tensor(pattern.inv_perm.astype(np.int64),
                              device=md.device)
        sols_fam, _ = run_multispecies_loop(
            ops_fam, C0[:, perm], mesh_data=fam_view, matvec=matvec,
            ka_matvec=ka_matvec, **base)
        sols = sols_fam[:, :, inv]
    if indices is None:
        return sols
    return sols[_index(md, indices)]


def fit_chemistry(observed, mesh_data, species, *, make_R=None,
                  init_params=None, R0=None, snapshot_indices=None,
                  sensor_indices=None, steps: int = 150, lr: float = 0.05,
                  time_scheme_order: int = 1, tol: float = 1e-9,
                  maxiter: int = 200, cache_key=None, on_step=None):
    """Chemistry-rate identification: recover the (K, K) linear mechanism
    ``R`` from multi-species observations, transport known (the
    ``species`` problems), by Adam on the discrete adjoint of the Strang
    loop (:func:`solve_multispecies_snapshots`). ``make_R(params) -> (K,
    K)`` with ``init_params`` fits a structured mechanism (e.g. a chain's
    rates in log space); without it a dense ``R`` starts at ``R0`` (zeros
    by default). ``observed`` is ``(len(snapshot_indices), K, n)`` or
    ``(..., n_sensors)``. ``cache_key`` is ignored. Returns ``(R_fit,
    params, losses)``."""
    del cache_key
    md = mesh_data
    K = len(species)
    if make_R is None:
        init_params = {"R": torch.zeros((K, K), dtype=md.dtype)
                       if R0 is None else _mesh_tensor(R0, md)}

        def make_R(params):
            return params["R"]
    elif init_params is None:
        raise ValueError("a custom make_R needs init_params")
    msp = MultiSpeciesProblem(species, np.zeros((K, K)))
    sens = (_index(md, sensor_indices)
            if sensor_indices is not None else None)

    def predict(params):
        pred = solve_multispecies_snapshots(
            msp, md, R=make_R(params), indices=snapshot_indices,
            time_scheme_order=time_scheme_order, tol=tol, maxiter=maxiter)
        if sens is not None:
            pred = pred[..., sens]
        return pred

    params, losses = _misfit_fit(observed, md, predict, init_params,
                                 steps=steps, lr=lr, on_step=on_step)
    with torch.no_grad():
        R_fit = make_R(params)
    return R_fit, params, losses


class _FieldSourceProxy:
    """The transport and boundary semantics of ``problem`` with a per-DOF
    steady emission vector ``s`` as the source and a zero lift (the map is
    linear in s and taken at s = 0; the lift does not depend on s)."""

    zero_source = False

    def __init__(self, problem, s):
        self._problem = problem
        self._s = s
        self.robin_sides = getattr(problem, "robin_sides", None)

    def source_term(self, xyt):
        return self._s

    def robin_g(self, xy, t, side):
        return self._problem.robin_g(xy, t, side)

    @staticmethod
    def boundary_fn(xyt):
        return torch.zeros(xyt.shape[0], dtype=xyt.dtype, device=xyt.device)


def receptor_footprint(mesh_data, domain, problem, receptor_indices, *,
                       time_scheme_order: int = 1,
                       stiffness_convention: str = "correct",
                       tol: float = 1e-9, maxiter: int = 200):
    """Adjoint source-attribution (footprint) maps: for each receptor DOF
    r, ``F[r, j] = d c(x_r, T) / d s_j``, the sensitivity of the
    final-time reading at r to a steady per-DOF emission s entering each
    implicit step as the lumped-mass load ``dt M s``. One forward solve
    on the ELL path (kernel B7a on the card) and one reverse sweep per
    receptor (``torch.autograd.grad`` with a one-hot cotangent). Transport
    (v, D, reaction, Robin walls) comes from ``problem``; its own source
    does not enter. ``domain`` sets the horizon. Returns a
    ``(len(receptor_indices), n_seg)`` tensor."""
    md = mesh_data
    dt = float(domain.T) / (md.nt - 1)
    ops = assemble(md, problem, dt, time_scheme_order, stiffness_convention)
    n = md.number_of_segments
    rec = _index(md, receptor_indices)
    s = torch.zeros(n, dtype=md.dtype, device=md.device, requires_grad=True)
    with torch.enable_grad():
        sols, _ = run_time_loop(
            ops, torch.zeros(n, dtype=md.dtype, device=md.device),
            mesh_data=md, problem=_FieldSourceProxy(problem, s), dt=dt,
            order=time_scheme_order, tol=tol, maxiter=maxiter,
            store_solutions=False, differentiable=True)
        readings = sols[0][rec]
        eye = torch.eye(len(rec), dtype=md.dtype, device=md.device)
        rows = [torch.autograd.grad(readings, s, eye[i],
                                    retain_graph=i + 1 < len(rec))[0]
                for i in range(len(rec))]
    return torch.stack(rows)
