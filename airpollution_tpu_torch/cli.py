"""Command-line interface of the port: ``python -m airpollution_tpu_torch
<cmd>``, the PyTorch counterpart of ``airpollution_tpu/cli.py``: the same
subcommands, arguments, defaults and JSON lines.

- ``solve``: CRBE solve (structured, ``.msh`` or mirrored mesh; Robin
  walls, obstacles, time-varying winds); prints the error triple as JSON
  and optionally saves the field(s) to ``.npz``.
- ``multispecies``: the K-species decay chain on any multispecies route.
- ``pinn``: train a PINN (every accuracy lever); optional checkpoint
  directory (crash-resumable).
- ``invert``: recover the diffusion coefficient from a field saved by
  ``solve --save``.
- ``fit-source``: locate and size an emitter from a saved trajectory.
- ``fit-ic``: 4D-Var, the full initial field from a saved trajectory.
- ``fit-deposition`` / ``fit-exchange``: wall deposition velocities, or
  (v_d, c_comp) pairs, from a trajectory saved by ``solve --robin``.
- ``ensemble``: a K-member forecast under perturbed transport, solved as
  one member batch, with exceedance maps and optional sensor placement.
- ``fno``: train the FNO surrogate on solver-manufactured plume data;
  holdout accuracy and inference rate.

Everything runs on the CUDA card, and raises without one; with
``APT_PLATFORM=cpu`` in the environment it runs on the CPU.

Examples:
    python -m airpollution_tpu_torch solve --mesh_size 64 --nt 128 --order 2
    python -m airpollution_tpu_torch solve --mesh_size 64 --save obs.npz
    python -m airpollution_tpu_torch invert --mesh_size 64 --observed obs.npz
    python -m airpollution_tpu_torch pinn --epochs 2000 --fourier_features 64
    python -m airpollution_tpu_torch ensemble --members 32 --place_sensors 16
    python -m airpollution_tpu_torch fno --mesh_size 64 --nt 128
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _device():
    """``"cpu"`` under ``APT_PLATFORM=cpu``, else None: the CUDA card
    (the entry points raise when there is none)."""
    return "cpu" if os.environ.get("APT_PLATFORM") == "cpu" else None


def _numpy(x):
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _domain_problem(args):
    import airpollution_tpu_torch as apt

    domain = apt.Domain()
    kind = getattr(args, "problem", "gaussian")
    reaction = getattr(args, "reaction", 0.0)
    if kind == "gaussian":
        problem = apt.Problem(v=tuple(args.v), D=args.D, sigma=args.sigma,
                              reaction=reaction)
    elif kind == "square_pulse":
        problem = apt.SquarePulseProblem(v=tuple(args.v), D=args.D,
                                         reaction=reaction)
    elif kind == "gaussian_source":
        problem = apt.GaussianSourceProblem(
            v=tuple(args.v), D=args.D, q=args.q,
            xs=0.0 if args.xs is None else args.xs, ys=args.ys,
            sigma_s=args.sigma_s, reaction=reaction,
        )
    elif kind == "rotating":
        problem = apt.RotatingPlumeProblem(
            omega=args.omega, D=args.D, sigma=args.sigma,
            x0=5.0 if args.xs is None else args.xs, y0=args.ys,
            reaction=reaction,
        )
    elif kind == "anisotropic":
        problem = apt.AnisotropicPlumeProblem(
            v=tuple(args.v), Dx=args.Dx, Dy=args.Dy, sigma=args.sigma,
            reaction=reaction,
        )
    elif kind == "turning":
        problem = apt.TurningWindProblem(
            speed=args.speed, omega_t=args.omega, D=args.D,
            sigma=args.sigma, x0=0.0 if args.xs is None else args.xs,
            y0=args.ys, reaction=reaction,
        )
    else:  # argparse choices guard this
        raise ValueError(f"unknown problem {kind!r}")
    return domain, problem


def _solve_time_varying(args, domain, problem, md, mirror=None):
    """Quasi-static chunked solve of a time-varying problem (--problem
    turning): the operator is reassembled every --reassemble_every steps
    (models/unsteady.solve_time_varying)."""
    import time

    import torch

    from airpollution_tpu_torch.io.checkpoint import save_field
    from airpollution_tpu_torch.models.unsteady import solve_time_varying

    impl = "fused_hbm" if args.matvec_impl == "fused_hbm" else "scan"
    t0 = time.time()
    sols = solve_time_varying(
        problem, md, reassemble_every=args.reassemble_every,
        time_scheme_order=args.order,
        stiffness_convention=args.stiffness_convention,
        extrapolate_warm_start=args.extrapolate,
        solver=args.solver_method, chebyshev_iters=args.chebyshev_iters,
        store_solutions=bool(args.save_all), matvec_impl=impl,
    )
    if sols.device.type == "cuda":
        torch.cuda.synchronize()
    solve_t = time.time() - t0
    rel = l2 = mx = None
    fn = getattr(problem, "analytical_solution", None)
    if fn is not None:
        t_col = torch.full((md.number_of_segments, 1), float(domain.T),
                           dtype=md.midpoints.dtype, device=md.device)
        ex = fn(torch.cat([md.midpoints, t_col], dim=1))
        err = sols[-1] - ex
        l2 = float(torch.linalg.norm(err))
        rel = l2 / float(torch.linalg.norm(ex))
        mx = float(torch.max(torch.abs(err)))
    if args.save:
        if mirror:
            from airpollution_tpu_torch.mesh.mirror import mirror_field

            sols = mirror_field(sols, md, mirror)
        arr = _numpy(sols)
        save_field(args.save, arr if args.save_all else arr[-1],
                   times=_numpy(md.time_discr) if args.save_all else None)
        print(f"saved field to {args.save}", file=sys.stderr)
    print(json.dumps({
        "method": "crbe_quasi_static", **_mesh_json(args),
        "nt": args.nt, "order": args.order,
        "n_dofs": int(md.number_of_segments),
        "reassemble_every": args.reassemble_every,
        "solve_time_s": round(solve_t, 4),
        "rel_l2": rel, "l2": l2, "max_error": mx,
    }))


def _parse_robin(spec: str):
    """'bottom=0.01,top=0' -> {'bottom': 0.01, 'top': 0.0} (side names
    validated by models/crbe.robin_terms)."""
    out = {}
    for part in spec.split(","):
        side, eq, val = part.partition("=")
        if not eq:
            raise SystemExit(
                f"--robin expects side=alpha pairs, got {part!r}"
            )
        out[side.strip()] = float(val)
    return out


def _trajectory_rows(domain, args, observed, times, cmd):
    """Map saved snapshot times onto this run's time grid, dropping t=0
    (the initial row carries no source information). A trajectory saved
    at a finer nt than the fit's --nt fails here, not at the gather."""
    import numpy as np

    dt = domain.T / (args.nt - 1)
    indices = [int(round(float(t) / dt)) for t in np.asarray(times)]
    bad = [i for i in indices if i > args.nt - 1]
    if bad:
        raise SystemExit(
            f"{cmd}: observed snapshot times map to step indices {bad} "
            f"outside this run's grid (--nt {args.nt}); re-run with the "
            f"--nt the trajectory was saved with"
        )
    rows = [k for k, i in enumerate(indices) if i > 0]
    idx = [indices[k] for k in rows]
    return np.asarray(observed)[rows], idx


def _errors_or_none(compute, problem):
    """Error triple against the analytical solution, or Nones when the
    problem has no closed form (square_pulse, gaussian_source)."""
    fn = getattr(problem, "analytical_solution", None)
    if fn is None:
        return None, None, None
    return compute(fn)


def _mesh_data(args, domain, allow_mirror=False):
    import airpollution_tpu_torch as apt

    if getattr(args, "mesh_file", None):
        # A gmsh triangulation (mesh/msh_io.py): regular grids take the
        # structured paths; a grid cut along the other diagonal comes back
        # mirror-tagged and needs the flip-solve-flip of mesh/mirror.py.
        # Subcommands without that wiring solve on the file's own
        # triangulation (the general ELL path) instead of the reflected
        # problem.
        mesh = apt.read_msh(args.mesh_file)
        if getattr(mesh, "mirror", None) and not allow_mirror:
            mesh = apt.read_msh(args.mesh_file, structured=False)
        return apt.MeshData(mesh, domain, nt=args.nt, mirror_ok=True,
                            device=_device())
    return apt.MeshData(apt.create_mesh(args.mesh_size, domain.Lx),
                        domain, nt=args.nt, device=_device())


def _mesh_json(args):
    """Resolution tag of the JSON line: a file-loaded mesh is named by its
    path, with a null mesh_size."""
    if getattr(args, "mesh_file", None):
        return {"mesh_size": None, "mesh_file": args.mesh_file}
    return {"mesh_size": args.mesh_size}


def cmd_solve(args):
    from airpollution_tpu_torch.io.checkpoint import save_field
    from airpollution_tpu_torch.models.crbe import CRBESolver

    domain, problem = _domain_problem(args)
    if args.robin:
        # Deposition and no-flux walls change the true solution: the
        # closed-form error columns are diagnostics only.
        problem.robin_sides = _parse_robin(args.robin)
    if getattr(args, "obstacle", None):
        # Solid blocks change the true solution too.
        problem.obstacles = tuple(tuple(r) for r in args.obstacle)
    md = _mesh_data(args, domain, allow_mirror=True)
    mirror = getattr(md.mesh, "mirror", None)
    if mirror:
        # Mirrored structured grid: solve the pulled-back problem on the
        # canonical mesh and map the output back to the file's frame
        # (error norms are permutation-invariant).
        from airpollution_tpu_torch.mesh.mirror import mirror_problem

        problem = mirror_problem(problem, mirror)
    if getattr(problem, "time_varying", False):
        return _solve_time_varying(args, domain, problem, md,
                                   mirror=mirror)
    solver = CRBESolver(
        domain, problem, md, time_scheme_order=args.order,
        matvec_impl=args.matvec_impl,
        assembly=args.assembly,
        stiffness_convention=args.stiffness_convention,
        extrapolate_warm_start=args.extrapolate,
        solver_method=args.solver_method,
        chebyshev_iters=args.chebyshev_iters,
        snapshot_every=args.snapshot_every,
        device=_device(),
    )
    store = bool(args.save_all)
    solver.solve(store_solutions=store)
    rel, l2, mx = _errors_or_none(solver.compute_errors, problem)
    if args.save:
        sols = solver.solutions
        if mirror:
            from airpollution_tpu_torch.mesh.mirror import mirror_field

            sols = mirror_field(sols, md, mirror)
        sols = _numpy(sols)
        times = _numpy(md.time_discr)
        if store and solver.snapshot_every and sols.shape[0] != times.shape[0]:
            times = times[::solver.snapshot_every]  # strided fused output
        save_field(args.save, sols if store else sols[-1],
                   times=times if store else None)
        print(f"saved field to {args.save}", file=sys.stderr)
    print(json.dumps({
        "method": "crbe", **_mesh_json(args), "nt": args.nt,
        "order": args.order, "n_dofs": int(md.number_of_segments),
        "solve_time_s": round(solver.solve_time, 4),
        "rel_l2": rel, "l2": l2, "max_error": mx,
    }))
    return solver


def cmd_multispecies(args):
    """K-species coupled-chemistry solve (models/multispecies): a decay
    chain built from --rates, an optional steady emitter on species 0, on
    any multispecies route, the canvas step kernel
    (matvec_impl='fused_hbm') included."""
    import numpy as np

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.problems import (
        GaussianSourceProblem,
        MultiSpeciesProblem,
        Problem,
    )

    rates = args.rates
    K = len(rates) + 1
    R = np.zeros((K, K))
    for i, r in enumerate(rates):
        R[i, i] += r
        R[i + 1, i] -= r
    domain = apt.Domain()
    species = []
    for k in range(K):
        if k == 0 and args.source_q > 0:
            # --xs defaults to None (centred for `solve --problem
            # gaussian_source`); the emitter here needs a location.
            xs = -6.0 if args.xs is None else args.xs
            species.append(GaussianSourceProblem(
                q=args.source_q, xs=xs, ys=args.ys,
                sigma_s=args.sigma_s, v=tuple(args.v), D=args.D))
        else:
            species.append(Problem(v=tuple(args.v), D=args.D,
                                   sigma=args.sigma))
    msp = MultiSpeciesProblem(tuple(species), R)
    md = _mesh_data(args, domain)
    solver = apt.MultiSpeciesSolver(
        domain, msp, md, time_scheme_order=args.order,
        matvec_impl=args.matvec_impl, splitting=args.splitting,
        solver_method=args.solver_method,
        chebyshev_iters=args.chebyshev_iters,
        snapshot_every=args.snapshot_every or None,
        device=_device(),
    )
    store = bool(args.snapshot_every)
    sols = solver.solve(store_solutions=store)
    out = {
        "method": "multispecies", **_mesh_json(args),
        "n_species": K, "rates": list(rates), "nt": args.nt,
        "order": args.order, "matvec_impl": args.matvec_impl,
        "splitting": solver.splitting,
        "n_dofs": int(md.number_of_segments),
        "solve_time_s": round(solver.solve_time, 4),
        "steps_per_sec": round((args.nt - 1) / solver.solve_time, 1),
        "rows": int(sols.shape[0]),
    }
    if msp.has_analytical:
        total = solver.compute_errors()
        out["rel_l2_total"] = total["rel_l2_error"]
        out["rel_l2_per_species"] = [
            p["rel_l2_error"] for p in total["per_species"]
        ]
    m = _numpy(solver._require_ops().mass_diag)
    if m.ndim == 2:
        m = m[0]
    out["final_masses"] = [float(x) for x in _numpy(sols[-1]) @ m]
    print(json.dumps(out))
    return solver


def cmd_pinn(args):
    from airpollution_tpu_torch.models.pinn import PINN

    domain, problem = _domain_problem(args)
    md = _mesh_data(args, domain)
    n_col = round(md.number_of_segments / 1.4)  # the reference's coupling
    n_ic = round(0.2 * n_col)
    batch = {"pde": n_col, "ic": n_ic, "bc": n_ic}
    lambdas = {"pde": args.lambda_pde, "ic": args.lambda_ic_bc,
               "bc": args.lambda_ic_bc}
    layers = [3] + [args.neurons] * args.hidden_layers + [1]
    model = PINN(layers, problem, domain, activation=args.activation,
                 fourier_features=args.fourier_features, device=_device())
    train_kwargs = dict(
        early_stopping_patience=args.patience,
        adaptive_oversample=args.adaptive_oversample,
        adaptive_weights_every=args.adaptive_weights_every,
    )
    if args.checkpoint_dir:
        from airpollution_tpu_torch.io.checkpoint import (
            train_with_checkpoints,
        )

        history = train_with_checkpoints(
            model, batch, args.epochs, args.lr, lambdas,
            args.checkpoint_dir, **train_kwargs,
        )
    else:
        history = model.train(batch, args.epochs, args.lr, lambdas,
                              **train_kwargs)
    rel, l2, mx = _errors_or_none(
        lambda fn: model.compute_errors(md, fn), problem
    )
    print(json.dumps({
        "method": "pinn", **_mesh_json(args),
        "epochs_run": len(history["total_loss"]),
        "final_loss": float(history["total_loss"][-1]),
        "train_time_s": round(model.training_time, 2),
        "rel_l2": rel, "l2": l2, "max_error": mx,
    }))
    return model


def cmd_invert(args):
    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.io.checkpoint import load_field

    domain, problem = _domain_problem(args)
    md = _mesh_data(args, domain)
    observed, _ = load_field(args.observed)
    if observed.ndim > 1:
        observed = observed[-1]
    D_est, losses = inverse.fit_diffusion(
        observed, md, D0=args.D0, v=tuple(args.v), sigma=args.sigma,
        steps=args.steps, lr=args.lr,
    )
    print(json.dumps({
        "method": "invert", "D_est": D_est,
        "misfit_first": losses[0], "misfit_last": losses[-1],
        "steps": args.steps,
    }))


def cmd_fit_source(args):
    """Emission-source identification from a saved observation
    trajectory: the command-line face of diagnostics.inverse.fit_source
    (scripts/torch_port_source_inversion.py is the scripted run)."""
    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.io.checkpoint import load_field

    domain, _ = _domain_problem(args)
    md = _mesh_data(args, domain)
    observed, times = load_field(args.observed)
    if observed.ndim != 2:
        raise SystemExit(
            "fit-source needs a trajectory .npz (solve --save --save_all)"
        )
    if times is None:
        raise SystemExit("observed .npz carries no times array")
    obs, idx = _trajectory_rows(domain, args, observed, times,
                                "fit-source")
    sensors, obs = _sensor_rows(args, md, obs)
    result, losses = inverse.fit_source(
        obs, md, snapshot_indices=idx, sensor_indices=sensors,
        v=tuple(args.v), D=args.D, sigma_s=args.sigma_s, q0=args.q0,
        xy0=tuple(args.xy0), fit_transport=args.fit_transport,
        steps=args.steps, lr=args.lr,
    )
    print(json.dumps({
        "method": "fit_source", **result,
        "n_sensors": int(len(sensors)) if sensors is not None
        else int(md.number_of_segments),
        "n_snapshots": len(idx),
        "misfit_first": float(losses[0]), "misfit_last": float(losses[-1]),
        "steps": args.steps,
    }))


def _sensor_rows(args, md, obs):
    """``(sensors, obs)``: ``--sensors`` random stations drawn from the DOF
    midpoints (numpy's generator on ``--sensor_seed``, as the JAX CLI
    draws them) and the observed columns there; all DOFs for 0."""
    import numpy as np

    if args.sensors and args.sensors < md.number_of_segments:
        rng = np.random.default_rng(args.sensor_seed)
        sensors = np.sort(rng.choice(md.number_of_segments, args.sensors,
                                     replace=False))
        return sensors, obs[:, sensors]
    return None, obs


def _robin_trajectory(args, cmd):
    """Domain, the CLI problem with ``--robin``'s walls, mesh data and the
    observed rows of a saved trajectory, for fit-deposition and
    fit-exchange."""
    from airpollution_tpu_torch.io.checkpoint import load_field

    domain, problem = _domain_problem(args)
    if not args.robin:
        raise SystemExit(f"{cmd} needs --robin side=...,side=... naming "
                         "the walls to estimate")
    problem.robin_sides = _parse_robin(args.robin)
    md = _mesh_data(args, domain)
    observed, times = load_field(args.observed)
    if observed.ndim != 2 or times is None:
        raise SystemExit(
            f"{cmd} needs a trajectory .npz with times "
            "(solve --robin ... --save --save_all)"
        )
    obs, idx = _trajectory_rows(domain, args, observed, times, cmd)
    return problem, md, obs, idx


def cmd_fit_ic(args):
    """4D-Var initial-condition estimation from a saved observation
    trajectory: the command-line face of
    diagnostics.inverse.fit_initial_condition (transport from the problem
    flags; the control is the full initial field)."""
    import torch

    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.io.checkpoint import load_field, save_field

    domain, problem = _domain_problem(args)
    md = _mesh_data(args, domain)
    observed, times = load_field(args.observed)
    if observed.ndim != 2 or times is None:
        raise SystemExit(
            "fit-ic needs a trajectory .npz with times "
            "(solve --save --save_all)"
        )
    # _trajectory_rows drops the t=0 row: observing u0 directly would
    # make the fit a copy instead of a deconvolution.
    obs, idx = _trajectory_rows(domain, args, observed, times, "fit-ic")
    sensors, obs = _sensor_rows(args, md, obs)
    u0_est, losses = inverse.fit_initial_condition(
        obs, md, problem, snapshot_indices=idx, sensor_indices=sensors,
        steps=args.steps, lr=args.lr, smoothness=args.smoothness,
        nonnegative=args.nonnegative,
    )
    out = {
        "method": "fit_ic", "n_dofs": int(md.number_of_segments),
        "n_sensors": int(len(sensors)) if sensors is not None
        else int(md.number_of_segments),
        "n_snapshots": len(idx), "smoothness": args.smoothness,
        "misfit_first": float(losses[0]), "misfit_last": float(losses[-1]),
        "steps": args.steps,
    }
    u0_true = problem.initial_condition_fn(md.midpoints)
    out["rel_l2_vs_problem_ic"] = float(
        torch.linalg.norm(u0_est - u0_true) / torch.linalg.norm(u0_true))
    if args.save:
        save_field(args.save, u0_est)
        print(f"saved recovered initial field to {args.save}",
              file=sys.stderr)
    print(json.dumps(out))


def cmd_fit_deposition(args):
    """Deposition-velocity estimation from a saved trajectory: the
    command-line face of diagnostics.inverse.fit_deposition."""
    from airpollution_tpu_torch.diagnostics import inverse

    problem, md, obs, idx = _robin_trajectory(args, "fit-deposition")
    alphas, losses = inverse.fit_deposition(
        obs, md, problem, alpha0=args.alpha0, snapshot_indices=idx,
        steps=args.steps, lr=args.lr,
    )
    print(json.dumps({
        "method": "fit_deposition", "alphas": alphas,
        "n_snapshots": len(idx),
        "misfit_first": float(losses[0]), "misfit_last": float(losses[-1]),
        "steps": args.steps,
    }))


def cmd_fit_exchange(args):
    """Joint (v_d, c_comp) surface-exchange estimation from a saved
    trajectory: the command-line face of
    diagnostics.inverse.fit_surface_exchange."""
    from airpollution_tpu_torch.diagnostics import inverse

    problem, md, obs, idx = _robin_trajectory(args, "fit-exchange")
    out, losses = inverse.fit_surface_exchange(
        obs, md, problem, alpha0=args.alpha0, c_comp0=args.c_comp0,
        snapshot_indices=idx, steps=args.steps, lr=args.lr,
    )
    print(json.dumps({
        "method": "fit_surface_exchange",
        "exchange": {s: {"v_d": v, "c_comp": c}
                     for s, (v, c) in out.items()},
        "n_snapshots": len(idx),
        "misfit_first": float(losses[0]), "misfit_last": float(losses[-1]),
        "steps": args.steps,
    }))


def cmd_ensemble(args):
    """Ensemble forecast under perturbed transport: K members with
    lognormal D and Gaussian v drawn around the CLI values (numpy, as the
    JAX package draws them), integrated as one member batch
    (diagnostics.ensemble.ensemble_forecast)."""
    import numpy as np

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.device import synchronize
    from airpollution_tpu_torch.diagnostics import ensemble_forecast

    domain, _ = _domain_problem(args)
    md = _mesh_data(args, domain)
    rng = np.random.default_rng(args.seed)
    Ds = np.exp(rng.normal(np.log(args.D), args.d_spread, args.members))
    Vs = rng.normal(args.v, args.v_spread, (args.members, 2))
    if args.problem == "gaussian":
        problems = [apt.Problem(v=tuple(v), D=float(d), sigma=args.sigma)
                    for v, d in zip(Vs, Ds)]
    elif args.problem == "square_pulse":
        problems = [apt.SquarePulseProblem(v=tuple(v), D=float(d))
                    for v, d in zip(Vs, Ds)]
    else:
        raise SystemExit(
            "ensemble supports --problem gaussian or square_pulse"
        )
    taus = tuple(args.thresholds)
    synchronize(md.device)
    t0 = time.time()
    out = ensemble_forecast(md, domain, problems, order=args.order,
                            thresholds=taus)
    synchronize(md.device)
    wall = time.time() - t0
    stations, reductions = None, None
    if args.place_sensors:
        from airpollution_tpu_torch.diagnostics import place_sensors

        stations, reductions = place_sensors(
            out["members"], args.place_sensors, obs_std=args.obs_std)
    if args.save:
        extra = {}
        if stations is not None:
            extra = dict(stations=np.asarray(stations),
                         station_var_reduction=np.asarray(reductions))
        exceedance = out.get("exceedance")
        np.savez(args.save, mean=_numpy(out["mean"]),
                 std=_numpy(out["std"]),
                 exceedance=np.asarray([]) if exceedance is None
                 else _numpy(exceedance),
                 thresholds=np.asarray(taus),
                 midpoints=_numpy(md.midpoints), **extra)
        print(f"saved ensemble products to {args.save}", file=sys.stderr)
    exc = out.get("exceedance")
    payload = {
        "method": "ensemble", "members": args.members,
        **_mesh_json(args), "nt": args.nt, "order": args.order,
        "mean_field_max": float(out["mean"].max()),
        "spread_max": float(out["std"].max()),
        "exceedance_mean": {str(t): float(exc[i].mean())
                            for i, t in enumerate(taus)} if exc is not None
        else {},
        "wall_s": round(wall, 3),
    }
    if stations is not None:
        payload["stations"] = stations
        payload["station_var_reduction_first_last"] = [
            round(reductions[0], 6), round(reductions[-1], 6)]
    print(json.dumps(payload))
    return out


def cmd_fno(args):
    """Train the FNO operator surrogate on solver-manufactured plume data
    (models/fno.py) and report holdout accuracy and inference throughput.
    The data, the initial parameters and the batches come from
    ``torch.Generator``s seeded with --seed, --seed + 1 and --seed + 2
    (other numbers than the JAX package's keys give). Returns
    ``(params, losses)``. With --data_parallel under ``torchrun
    --nproc_per_node N`` (N > 1) the minibatch is split over the N ranks
    (parallel/fno_parallel.py) and rank 0 reports."""
    if args.n_times and (args.nt - 1) % args.n_times:
        # The time-conditioned dataset snapshots every (nt-1)/n_times
        # steps, so n_times must divide nt-1: bump nt to the next valid
        # value instead of failing on the defaults.
        nt_fix = args.n_times * math.ceil((args.nt - 1) / args.n_times) + 1
        print(f"note: --nt {args.nt} -> {nt_fix} (the time-conditioned "
              f"dataset needs n_times | nt-1)", file=sys.stderr)
        args.nt = nt_fix
    # --data_parallel under torchrun with N > 1 ranks: the group from its
    # environment (nccl on the cards, gloo under APT_PLATFORM=cpu), the
    # minibatch split over the ranks; every rank builds the same data.
    n_dev = int(os.environ.get("WORLD_SIZE", "1"))
    use_dp = args.data_parallel and n_dev > 1
    if use_dp:
        from airpollution_tpu_torch.parallel import launch

        launch.init_from_env("gloo" if _device() == "cpu" else "nccl")
    try:
        return _fno(args, use_dp, n_dev)
    finally:
        if use_dp:
            import torch.distributed as dist

            dist.destroy_process_group()


def _fno(args, use_dp, n_dev):
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.device import synchronize
    from airpollution_tpu_torch.models import fno

    domain = apt.Domain()
    md = _mesh_data(args, domain)
    device = md.device
    lead = not use_dp or int(os.environ["RANK"]) == 0
    n_all = args.n_train + args.n_test
    data_gen = torch.Generator().manual_seed(args.seed)
    t0 = time.time()
    if args.n_times:
        X, Y, _, _ = fno.make_plume_time_dataset(
            md, domain, data_gen, n_all, n_times=args.n_times)
        rows_per = args.n_times
    else:
        X, Y, _ = fno.make_plume_dataset(md, domain, data_gen, n_all)
        rows_per = 1
    synchronize(device)
    t_data = time.time() - t0
    n_tr = args.n_train * rows_per
    Xtr, Ytr, Xte, Yte = X[:n_tr], Y[:n_tr], X[n_tr:], Y[n_tr:]

    params = fno.init_fno_params(
        torch.Generator(device=device).manual_seed(args.seed + 1),
        in_ch=X.shape[-1], modes=args.modes, width=args.width,
        depth=args.depth, dtype=X.dtype, device=device)
    batch = args.batch
    batches = torch.Generator(device=device).manual_seed(args.seed + 2)
    t0 = time.time()
    if use_dp:
        from airpollution_tpu_torch.parallel import make_mesh, train_fno_dp

        batch = -(-batch // n_dev) * n_dev
        params, _, losses = train_fno_dp(
            make_mesh({"data": n_dev}), params, Xtr, Ytr,
            epochs=args.epochs, batch=batch, lr=args.lr, generator=batches)
    else:
        params, _, losses = fno.train_fno(
            params, Xtr, Ytr, epochs=args.epochs, batch=batch, lr=args.lr,
            generator=batches)
    t_train = time.time() - t0  # the trainers end in one read of the losses

    rel_te = fno.relative_l2(params, Xte, Yte)
    bs = min(64, Xte.shape[0])
    with torch.no_grad():
        fno.fno_apply(params, Xte[:bs])
        synchronize(device)
        t0 = time.time()
        for _ in range(10):
            fno.fno_apply(params, Xte[:bs])
        synchronize(device)
    fields_per_s = bs / ((time.time() - t0) / 10)

    if args.save and lead:
        from airpollution_tpu_torch.io.checkpoint import save_pytree

        save_pytree(args.save, params)
        print(f"saved FNO params to {args.save}", file=sys.stderr)
    if not lead:
        return params, losses
    print(json.dumps({
        "method": "fno", **_mesh_json(args), "nt": args.nt,
        "n_train": args.n_train, "n_test": args.n_test,
        "n_times": args.n_times, "epochs": args.epochs, "batch": batch,
        "data_parallel": bool(use_dp), "n_devices": n_dev if use_dp else 1,
        "dataset_gen_s": round(t_data, 2), "train_s": round(t_train, 2),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "rel_l2_holdout_vs_fem": rel_te,
        "inference_fields_per_sec": round(fields_per_s, 1),
    }))
    return params, losses


def build_parser():
    p = argparse.ArgumentParser(prog="airpollution_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--mesh_size", type=int, default=64)
        sp.add_argument("--mesh_file", default="",
                        help="load a gmsh ASCII .msh triangulation "
                             "instead of generating one (overrides "
                             "--mesh_size)")
        sp.add_argument("--nt", type=int, default=128)
        sp.add_argument("--v", type=float, nargs=2, default=[1.0, 0.5])
        sp.add_argument("--D", type=float, default=0.1)
        sp.add_argument("--sigma", type=float, default=1.0)
        sp.add_argument("--problem", default="gaussian",
                        choices=("gaussian", "square_pulse",
                                 "gaussian_source", "rotating",
                                 "anisotropic", "turning"),
                        help="gaussian_source: steady emitter (--q --xs "
                             "--ys --sigma_s); no analytical errors. "
                             "rotating: puff in a solid-body-rotation "
                             "wind (--omega; puff center --xs --ys, "
                             "default (5, 0)); exact solution. "
                             "anisotropic: plume with D=diag(Dx, Dy) "
                             "eddy-diffusivity tensor (--Dx --Dy); "
                             "exact solution")
        sp.add_argument("--reaction", type=float, default=0.0,
                        help="first-order decay/deposition rate r "
                             "(adds + r c to the PDE; the gaussian "
                             "problem stays its own exact oracle: its "
                             "solution is the plume times exp(-r t))")
        sp.add_argument("--q", type=float, default=1.0,
                        help="emission rate (gaussian_source)")
        sp.add_argument("--xs", type=float, default=None,
                        help="source / puff center x (default 0; "
                             "rotating: 5)")
        sp.add_argument("--ys", type=float, default=0.0)
        sp.add_argument("--sigma_s", type=float, default=1.0)
        sp.add_argument("--omega", type=float, default=0.1,
                        help="rotation rate of the wind field (rotating)")
        sp.add_argument("--Dx", type=float, default=0.1,
                        help="x diffusivity (anisotropic)")
        sp.add_argument("--Dy", type=float, default=0.01,
                        help="y diffusivity (anisotropic)")
        sp.add_argument("--speed", type=float, default=1.0,
                        help="wind speed (turning: v turns at rate "
                             "--omega; quasi-static chunked solve, "
                             "--reassemble_every)")
        sp.add_argument("--reassemble_every", type=int, default=4,
                        help="steps per operator reassembly for "
                             "time-varying problems (must divide nt-1)")

    sp = sub.add_parser("solve", help="CRBE FEM solve")
    common(sp)
    sp.add_argument("--robin", default="",
                    help="Robin/deposition walls as side=alpha pairs, "
                         "e.g. --robin bottom=0.01,top=0 (alpha=0: "
                         "no-flux wall; alpha=v_d: dry deposition; "
                         "unnamed sides stay Dirichlet; forces the ELL "
                         "path)")
    sp.add_argument("--obstacle", type=float, nargs=4, action="append",
                    metavar=("XMIN", "XMAX", "YMIN", "YMAX"),
                    default=None,
                    help="solid rectangular obstacle (repeatable): "
                         "masked assembly with a no-diffusive-flux "
                         "staircase wall (problems.AdDifProblem."
                         "obstacles; per-DOF solve paths)")
    sp.add_argument("--order", type=int, default=1, choices=(1, 2))
    sp.add_argument("--matvec_impl", default="auto",
                    choices=("auto", "ell", "stencil", "uniform", "pallas",
                             "fused", "fused_hbm"))
    sp.add_argument("--assembly", default="auto",
                    choices=("auto", "full", "patch"),
                    help="patch: O(1) uniform-operator scalars from a "
                         "congruent patch mesh (no global assembly)")
    sp.add_argument("--solver_method", default="bicgstab",
                    choices=("bicgstab", "chebyshev"))
    sp.add_argument("--chebyshev_iters", type=int, default=8)
    sp.add_argument("--stiffness_convention", default="correct",
                    choices=("correct", "reference"))
    sp.add_argument("--extrapolate", action="store_true")
    sp.add_argument("--snapshot_every", type=int, default=None,
                    help="strided snapshots for the fused paths "
                         "(with --save_all)")
    sp.add_argument("--save", default="", help="Save final field to .npz")
    sp.add_argument("--save_all", action="store_true",
                    help="Save every snapshot (with --save)")
    sp.set_defaults(fn=cmd_solve)

    sp = sub.add_parser(
        "multispecies",
        help="K-species coupled-chemistry solve (decay chain)",
    )
    common(sp)
    sp.add_argument("--order", type=int, default=2, choices=(1, 2))
    sp.add_argument("--rates", type=float, nargs="+", default=[0.4, 0.2],
                    help="chain rates A->B->... (K = len+1 species)")
    sp.add_argument("--source_q", type=float, default=0.0,
                    help="steady Gaussian emitter on species 0 at "
                         "(--xs, --ys) width --sigma_s (0 = plume ICs "
                         "only, keeps the expm oracle)")
    sp.add_argument("--matvec_impl", default="auto",
                    choices=("auto", "ell", "stencil", "uniform",
                             "fused_hbm"))
    sp.add_argument("--splitting", default="auto",
                    choices=("auto", "strang", "commute"))
    sp.add_argument("--solver_method", default="bicgstab",
                    choices=("bicgstab", "chebyshev"))
    sp.add_argument("--chebyshev_iters", type=int, default=8)
    sp.add_argument("--snapshot_every", type=int, default=0,
                    help="store every k-th state (0 = final only)")
    sp.set_defaults(fn=cmd_multispecies)

    sp = sub.add_parser("pinn", help="Train a PINN")
    common(sp)
    sp.add_argument("--neurons", type=int, default=32)
    sp.add_argument("--hidden_layers", type=int, default=4)
    sp.add_argument("--activation", default="tanh")
    sp.add_argument("--epochs", type=int, default=4000)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--lambda_pde", type=float, default=180.0)
    sp.add_argument("--lambda_ic_bc", type=float, default=80.0)
    sp.add_argument("--patience", type=int, default=0)
    sp.add_argument("--fourier_features", type=int, default=0)
    sp.add_argument("--adaptive_oversample", type=float, default=0.0)
    sp.add_argument("--adaptive_weights_every", type=int, default=0)
    sp.add_argument("--checkpoint_dir", default="",
                    help="Checkpointed training with crash resume")
    sp.set_defaults(fn=cmd_pinn)

    sp = sub.add_parser(
        "fno", help="Train the FNO operator surrogate on "
        "solver-manufactured plume data")
    sp.add_argument("--mesh_size", type=int, default=33)
    sp.add_argument("--nt", type=int, default=64)
    sp.add_argument("--n_train", type=int, default=128)
    sp.add_argument("--n_test", type=int, default=32)
    sp.add_argument("--n_times", type=int, default=0,
                    help="snapshots per problem for a TIME-CONDITIONED "
                         "surrogate (0 = final-state operator)")
    sp.add_argument("--modes", type=int, default=12)
    sp.add_argument("--width", type=int, default=32)
    sp.add_argument("--depth", type=int, default=4)
    sp.add_argument("--epochs", type=int, default=2000)
    sp.add_argument("--batch", type=int, default=16)
    sp.add_argument("--lr", type=float, default=1.5e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--data_parallel", action="store_true",
                    help="shard the minibatch over all devices "
                         "(parallel/fno_parallel.py)")
    sp.add_argument("--save", default="",
                    help="save trained params to this .npz")
    sp.set_defaults(fn=cmd_fno)

    sp = sub.add_parser("invert", help="Recover D from an observed field")
    common(sp)
    sp.add_argument("--observed", required=True, help=".npz from solve --save")
    sp.add_argument("--D0", type=float, default=1.0)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=0.1)
    sp.set_defaults(fn=cmd_invert)

    sp = sub.add_parser(
        "fit-source",
        help="Localize/quantify an emitter from sensor observations",
    )
    common(sp)
    sp.add_argument("--observed", required=True,
                    help=".npz trajectory from solve --problem "
                         "gaussian_source --save --save_all "
                         "--snapshot_every k (times included)")
    sp.add_argument("--sensors", type=int, default=64,
                    help="random monitoring stations drawn from the DOF "
                         "midpoints (0 = all DOFs)")
    sp.add_argument("--sensor_seed", type=int, default=0)
    sp.add_argument("--q0", type=float, default=1.0)
    sp.add_argument("--xy0", type=float, nargs=2, default=[0.0, 0.0])
    sp.add_argument("--fit_transport", action="store_true",
                    help="jointly estimate D and v as well")
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--lr", type=float, default=0.1)
    sp.set_defaults(fn=cmd_fit_source)

    sp = sub.add_parser(
        "ensemble",
        help="Ensemble forecast under perturbed transport parameters",
    )
    common(sp)
    sp.add_argument("--order", type=int, default=2, choices=(1, 2))
    sp.add_argument("--members", type=int, default=32)
    sp.add_argument("--d_spread", type=float, default=0.3,
                    help="lognormal sigma of the D perturbation")
    sp.add_argument("--v_spread", type=float, default=0.15,
                    help="Gaussian sigma per wind component")
    sp.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.01, 0.03],
                    help="exceedance thresholds for P(c > tau) maps")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--place_sensors", type=int, default=0,
                    help="greedily site this many monitoring stations on "
                         "the forecast ensemble (EnSRF variance-reduction "
                         "placement, diagnostics.place_sensors)")
    sp.add_argument("--obs_std", type=float, default=0.01,
                    help="station noise assumed by --place_sensors")
    sp.add_argument("--save", default="",
                    help="save mean/std/exceedance products to .npz")
    sp.set_defaults(fn=cmd_ensemble)

    sp = sub.add_parser(
        "fit-ic",
        help="4D-Var: recover the full initial field from a trajectory",
    )
    common(sp)
    sp.add_argument("--observed", required=True,
                    help=".npz trajectory from solve --save --save_all "
                         "(times included); row 0 is dropped — the fit "
                         "deconvolves the later evolution")
    sp.add_argument("--sensors", type=int, default=0,
                    help="random monitoring stations drawn from the DOF "
                         "midpoints (0 = all DOFs)")
    sp.add_argument("--sensor_seed", type=int, default=0)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--lr", type=float, default=0.05,
                    help="keep below the field amplitude (Adam steps "
                         "are O(lr) per DOF)")
    sp.add_argument("--smoothness", type=float, default=1e-3,
                    help="H1-seminorm Tikhonov weight (THE accuracy "
                         "lever under sparse/noisy sensors)")
    sp.add_argument("--nonnegative", action="store_true",
                    help="softplus reparameterization of the field")
    sp.add_argument("--save", default="",
                    help="save the recovered initial field to .npz")
    sp.set_defaults(fn=cmd_fit_ic)

    sp = sub.add_parser(
        "fit-deposition",
        help="Estimate wall deposition velocities from observations",
    )
    common(sp)
    sp.add_argument("--robin", required=True,
                    help="side=alpha pairs naming the walls to estimate "
                         "(values are static defaults; the fit optimizes "
                         "traced overrides)")
    sp.add_argument("--observed", required=True,
                    help=".npz trajectory from solve --robin ... "
                         "--save --save_all (times included)")
    sp.add_argument("--alpha0", type=float, default=0.1)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--lr", type=float, default=0.05)
    sp.set_defaults(fn=cmd_fit_deposition)

    sp = sub.add_parser(
        "fit-exchange",
        help="Estimate wall (v_d, c_comp) surface exchange jointly",
    )
    common(sp)
    sp.add_argument("--robin", required=True,
                    help="side=alpha pairs naming the walls to estimate "
                         "(values are static defaults; the fit optimizes "
                         "traced overrides)")
    sp.add_argument("--observed", required=True,
                    help=".npz trajectory from solve --robin ... "
                         "--save --save_all (times included)")
    sp.add_argument("--alpha0", type=float, default=0.1)
    sp.add_argument("--c_comp0", type=float, default=0.0)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--lr", type=float, default=0.05)
    sp.set_defaults(fn=cmd_fit_exchange)
    return p


def main(argv=None):
    """Parse ``argv`` (default: the command line) and run the subcommand;
    returns what the subcommand's function returns (the solver or model of
    ``solve``, ``multispecies`` and ``pinn``, the forecast products of
    ``ensemble``, the parameters and losses of ``fno``)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
