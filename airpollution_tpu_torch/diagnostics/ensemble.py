"""Ensemble forecasting under parameter uncertainty, data assimilation and
sensor placement, PyTorch counterpart of
``airpollution_tpu/diagnostics/ensemble.py``.

Operational air-quality forecasts are ensembles: the wind and the eddy
diffusivity are uncertain, so the model is integrated for a population of
perturbed parameter sets, and the products are the ensemble mean and
spread and the exceedance probabilities P(c(x, T) > threshold) behind
air-quality alerts.

The JAX package integrates every member as one ``vmap`` of its solve.
Here the members are a leading axis of the state: each member's operator
is assembled (``models/crbe.assemble``) and the operators are stacked on
one shared column index (``ops/sparse.stack_ell``), the problem's
parameters become (K, 1) columns (``problems.stack_problems``), and one
time loop (``models/crbe.run_time_loop`` with a (K, n) state) steps all
members together: each ELL product is one launch of kernel B7 over the
whole stack, and the member-batched BiCGStab
(``ops/linalg.bicgstab_members``) reads the host once per iteration for
all members. The statistics reduce over the member axis on the device.

:func:`enkf_update` is the stochastic ensemble Kalman analysis
(perturbed observations) and :func:`place_sensors` the greedy EnSRF
design of a monitoring network; neither forms an (n, n) covariance.
"""

from __future__ import annotations

import torch

from airpollution_tpu_torch.models.crbe import (GlobalOperators, assemble,
                                                reject_robin, run_time_loop)
from airpollution_tpu_torch.ops import sparse
from airpollution_tpu_torch.problems import stack_problems

__all__ = ["stack_problems", "ensemble_forecast", "enkf_update",
           "place_sensors"]


def member_operators(mesh_data, problems, dt, order,
                     stiffness_convention="correct") -> GlobalOperators:
    """Each member's operators, assembled one member at a time and stacked
    along a leading member axis: ``mass_diag`` and ``system_diag`` (K, n),
    ``ka`` and ``system`` on the mesh's one column index. The stiffness
    and advection parts, which the time loop does not read, are not
    kept (None)."""
    mass, ka, system, diag = [], [], [], []
    for p in problems:
        ops = assemble(mesh_data, p, dt, order, stiffness_convention)
        mass.append(ops.mass_diag)
        ka.append(ops.ka)
        system.append(ops.system)
        diag.append(ops.system_diag)
    return GlobalOperators(mass_diag=torch.stack(mass), stiffness=None,
                           advection=None, ka=sparse.stack_ell(ka),
                           system=sparse.stack_ell(system),
                           system_diag=torch.stack(diag))


def member_initial_state(mesh_data, batched, n_members):
    """The (K, n) initial state of a stacked problem, in the mesh's dtype."""
    mids = mesh_data.midpoints
    u0 = torch.as_tensor(batched.initial_condition_fn(mids), dtype=mids.dtype)
    return u0.expand(n_members, mids.shape[0]).contiguous()


def _statistics(members, thresholds):
    K = members.shape[0]
    out = {
        "members": members,
        "mean": members.mean(dim=0),
        "std": members.std(dim=0, correction=1) if K > 1
        else torch.zeros_like(members[0]),
    }
    if len(thresholds):
        taus = torch.as_tensor(list(thresholds), dtype=members.dtype,
                               device=members.device)
        out["exceedance"] = (members[None] > taus[:, None, None]).to(
            members.dtype).mean(dim=1)
    return out


def ensemble_forecast(mesh_data, domain, problems, *, order=1, tol=1e-7,
                      maxiter=200, stiffness_convention="correct",
                      source_quadrature="mass_lumped", thresholds=(),
                      mesh=None, axis: str = "trial", u0_members=None,
                      t0=0.0):
    """Integrate every ensemble member to t = T and return the forecast
    products, tensors on the mesh's device:

    - ``members``: (K, n_seg) final-time fields (boundary-lifted),
    - ``mean``, ``std``: ensemble mean and spread (ddof=1; zeros for K=1),
    - ``exceedance``: (len(thresholds), n_seg) member fractions with
      c(x, T) > threshold (only when ``thresholds`` are given).

    ``problems`` are instances of one class whose parameters differ.
    ``u0_members`` restarts the ensemble from given (K, n_seg) states in
    place of each member's initial condition, and ``t0`` offsets the
    window's source and boundary times, which makes the forecast
    restartable for a cycling forecast-analysis system
    (forecast, :func:`enkf_update`, forecast the next window).

    ``mesh`` (parallel.make_mesh) shards the members over its ``axis``:
    the members are padded to a multiple of the axis size by repeating the
    last one, each rank (or each block of a BlockMesh, one after another)
    runs its contiguous share as one member batch, and the statistics are
    formed from the gathered members, on every rank.
    """
    md = mesh_data
    for p in problems:
        reject_robin(p, "ensemble_forecast (member-batched assembly)")
    dt = domain.T / (md.nt - 1)
    n_members = len(problems)
    dtype, device = md.midpoints.dtype, md.midpoints.device
    batched = stack_problems(problems, dtype=dtype, device=device)
    if u0_members is None:
        u0 = member_initial_state(md, batched, n_members)
    else:
        u0 = torch.as_tensor(u0_members, dtype=dtype, device=device)
        if tuple(u0.shape) != (n_members, md.number_of_segments):
            raise ValueError(
                f"u0_members {tuple(u0.shape)} must be "
                f"({n_members}, {md.number_of_segments})")

    def forecast(members, u0_batch):
        ops = member_operators(md, members, dt, order, stiffness_convention)
        sols, _ = run_time_loop(
            ops, u0_batch, mesh_data=md,
            problem=stack_problems(members, dtype=dtype, device=device),
            dt=dt, order=order, tol=tol, maxiter=maxiter,
            store_solutions=False, source_quadrature=source_quadrature,
            t0=t0)
        return sols[0]

    if mesh is None:
        return _statistics(forecast(list(problems), u0), thresholds)
    from airpollution_tpu_torch.parallel.collectives import RowChain
    from airpollution_tpu_torch.parallel.sweep import padded_shares

    chain = RowChain(mesh, axis)
    share, shares = padded_shares(chain, n_members)
    n_pad = share * chain.n_blocks - n_members
    members = list(problems) + [problems[-1]] * n_pad
    u0 = torch.cat([u0, u0[-1:].expand(n_pad, -1)])
    parts = torch.stack([forecast(members[a:b], u0[a:b])
                         for _, a, b in shares])
    return _statistics(chain.gather(parts, dim=0)[:n_members], thresholds)


def _enkf_update(members, y, sensors, obs_std, eps, inflation):
    """The stochastic EnKF analysis on explicit observation noise ``eps``
    (K, m): the counterpart of the JAX package's ``_enkf_update``."""
    X = members                                   # (K, n) forecast
    K = X.shape[0]
    # Multiplicative prior inflation of the anomalies about the mean
    # (Anderson & Anderson 1999): cycling filters go underdispersive.
    X = X.mean(dim=0) + inflation * (X - X.mean(dim=0))
    S = X[:, sensors]                             # (K, m) at stations
    A = X - X.mean(dim=0)                         # (K, n) anomalies
    As = S - S.mean(dim=0)                        # (K, m)
    C = (As.T @ As) / (K - 1)                     # (m, m) = H P H^T
    C = C + (obs_std ** 2) * torch.eye(C.shape[0], dtype=X.dtype,
                                       device=X.device)
    PHt = (A.T @ As) / (K - 1)                    # (n, m) = P H^T
    innov = (y[None, :] + eps) - S                # (K, m) perturbed obs
    # x_a = x_f + P H^T C^{-1} innov, solved, not inverted.
    return X + innov @ torch.linalg.solve(C, PHt.T)


def enkf_update(members, observations, sensor_indices, obs_std, generator,
                inflation: float = 1.0):
    """Stochastic ensemble-Kalman analysis step (perturbed observations).

    ``members`` is the (K, n_seg) forecast ensemble, ``observations`` the
    (m,) station readings at ``sensor_indices``, ``obs_std`` the
    observation noise (R = obs_std^2 I). Each member is nudged toward its
    own noise-perturbed copy of the observations through the gain built
    from the ensemble's sample covariance; the covariance is never formed
    at (n, n). ``generator`` (a ``torch.Generator`` on the members'
    device) draws the noise, in place of the JAX package's key.
    ``inflation`` scales the forecast anomalies about the mean first
    (~1.05-1.2 in cycling loops). Returns the (K, n_seg) analysis."""
    X = torch.as_tensor(members)
    y = torch.as_tensor(observations, dtype=X.dtype, device=X.device)
    sensors = torch.as_tensor([int(i) for i in sensor_indices],
                              dtype=torch.int64, device=X.device)
    if tuple(y.shape) != (sensors.shape[0],):
        raise ValueError(
            f"observations {tuple(y.shape)} must match sensor_indices "
            f"({sensors.shape[0]},)")
    if X.shape[0] < 2:
        raise ValueError("EnKF needs at least 2 ensemble members")
    eps = obs_std * torch.randn((X.shape[0], sensors.shape[0]),
                                generator=generator, dtype=X.dtype,
                                device=X.device)
    return _enkf_update(X, y, sensors, obs_std, eps, inflation)


def _placement_step(A, mask, obs_var):
    """One greedy EnSRF step on the (K, n) anomalies: the score of each
    candidate (its total analysis-variance reduction ``||P[:, c]||^2 /
    (var_c + obs_var)``, from the (K, K) Gram matrix), the best one, and
    the square-root rank-one update of the anomalies (Whitaker & Hamill
    2002). Returns (A, mask, pick, its score), all on the device."""
    K = A.shape[0]
    G = A @ A.T                                      # (K, K)
    var = (A * A).sum(dim=0) / (K - 1)               # (n,)
    red = (A * (G @ A)).sum(dim=0) / ((K - 1) ** 2)  # ||P[:, c]||^2
    score = torch.where(mask, red / (var + obs_var),
                        torch.full_like(red, -torch.inf))
    s = torch.argmax(score)
    a = A[:, s]                                      # (K,)
    var_s = var[s]
    alpha = 1.0 / (1.0 + torch.sqrt(obs_var / (var_s + obs_var)))
    A = A - (alpha / ((K - 1) * (var_s + obs_var))) * torch.outer(a, a @ A)
    mask = mask.clone()
    mask[s] = False
    return A, mask, s, score[s]


def place_sensors(members, n_sensors, obs_std, candidate_indices=None):
    """Greedy ensemble-based monitoring-network design: each step sites
    the candidate DOF whose observation (noise ``obs_std``) most reduces
    the total analysis variance of the ``members`` (K, n_seg) ensemble,
    then folds it in with the EnSRF rank-one anomaly update, so later
    picks account for what the network already observes.
    ``candidate_indices`` restricts the search. Returns ``(indices,
    reductions)``: the ordered station DOFs and each step's expected
    variance reduction, read from the device once. Never forms an (n, n)
    covariance: each step is (K, K) and (K, n) products."""
    X = torch.as_tensor(members)
    if X.dim() != 2 or X.shape[0] < 2:
        raise ValueError(
            f"members must be (K >= 2, n_seg), got {tuple(X.shape)}")
    n = X.shape[1]
    if not 0 < int(n_sensors) <= n:
        raise ValueError(f"n_sensors={n_sensors} out of range (1..{n})")
    if candidate_indices is None:
        mask = torch.ones(n, dtype=torch.bool, device=X.device)
    else:
        idx = torch.as_tensor([int(i) for i in candidate_indices],
                              dtype=torch.int64, device=X.device)
        if int(n_sensors) > idx.shape[0]:
            raise ValueError(
                f"n_sensors={n_sensors} exceeds the "
                f"{idx.shape[0]} candidate sites")
        mask = torch.zeros(n, dtype=torch.bool, device=X.device)
        mask[idx] = True
    A = X - X.mean(dim=0)
    obs_var = torch.as_tensor(obs_std, dtype=X.dtype, device=X.device) ** 2
    picks, reds = [], []
    for _ in range(int(n_sensors)):
        A, mask, s, r = _placement_step(A, mask, obs_var)
        picks.append(s)
        reds.append(r)
    return (torch.stack(picks).tolist(),
            torch.stack(reds).to(torch.float64).tolist())
