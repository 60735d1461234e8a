"""What the ranks of the port's multi-process tests run
(tests/test_torch_port_distributed_*.py, tests/test_torch_port_ensemble.py):
module-level functions that ``parallel.launch.spawn`` starts on each gloo
rank. Each writes its results as numpy arrays to ``out_dir``
(``rank<r>_<case>.npy``), where the pytest process holds them against the
JAX package's sharded functions and against each other. This module
imports no JAX: the JAX references run in the pytest process."""

import os

import numpy as np
import torch

import airpollution_tpu_torch as tapt


def _save(out_dir, case, value):
    import torch.distributed as dist

    arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    np.save(os.path.join(out_dir, f"rank{dist.get_rank()}_{case}.npy"), arr)


def _md(ms, nt, T=None):
    dom = tapt.Domain() if T is None else tapt.Domain(T=T)
    return tapt.MeshData(tapt.create_mesh(ms, 20.0), dom, nt=nt,
                         dtype=torch.float64, device="cpu")


class SourcedProblem(tapt.Problem):
    """The Gaussian problem plus tests/test_parallel.py's smooth synthetic
    source."""

    zero_source = False

    def source_term(self, xyt):
        x, y, t = xyt[..., 0], xyt[..., 1], xyt[..., 2]
        return 0.05 * torch.exp(-(x ** 2 + y ** 2) / 8.0) * torch.cos(0.3 * t)


# --- the launcher and the collectives ---------------------------------


def collective_cases(out_dir):
    """On 4 ranks as a {'dp': 2, 'tp': 2} mesh: the layout, psum and its
    first and second derivatives, all_gather_rows and halo_exchange."""
    from airpollution_tpu_torch.parallel import make_mesh
    from airpollution_tpu_torch.parallel.collectives import (
        all_gather_rows, halo_exchange, psum, pvary)

    mesh = make_mesh({"dp": 2, "tp": 2})
    _save(out_dir, "coords", [mesh.index("dp"), mesh.index("tp"),
                              *mesh.ranks("dp"), *mesh.ranks("tp")])
    r = mesh.rank
    x = torch.tensor([1.0 + r], dtype=torch.float64, requires_grad=True)
    y = psum(x ** 3, mesh, "tp")
    (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), x)
    # A replicated value into a rank-dependent product: its cotangent sums
    # over the axis.
    w = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    z = psum(pvary(w, mesh, "dp") * (1.0 + r), mesh, "dp")
    (gw,) = torch.autograd.grad(z.sum(), w)
    _save(out_dir, "psum", [float(y), float(g), float(h), float(gw)])
    rows = torch.full((2, 3), float(r), dtype=torch.float64)
    _save(out_dir, "gather0", all_gather_rows(rows, mesh, "tp"))
    _save(out_dir, "gather1", all_gather_rows(rows, mesh, "dp", dim=1))
    below, above = halo_exchange(torch.full((1, 3), 10.0 + r),
                                 torch.full((2, 3), 20.0 + r), mesh, "dp")
    _save(out_dir, "halo_below", below)
    _save(out_dir, "halo_above", above)
    return mesh.shape


def raise_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise KeyError("rank one fails")
    dist.barrier()


def hang():
    import time

    time.sleep(600)


# --- the solvers --------------------------------------------------------


def _halo_case(problem, order, iters, nt, **kw):
    from airpollution_tpu_torch.parallel import build_halo_solver, make_mesh

    md = _md(12, nt)
    method = kw.get("solver_method", "chebyshev")
    serial = tapt.CRBESolver(
        tapt.Domain(), problem, md, matvec_impl="uniform",
        time_scheme_order=order, solver_method=method,
        chebyshev_iters=iters, device="cpu")
    solve = build_halo_solver(make_mesh({"mp": 3}), md, problem, serial.dt,
                              order=order, iters=iters, **kw)
    return solve(serial._require_ops(), serial.set_initial_condition())


def solver_cases(out_dir):
    """On 3 ranks: build_halo_solver (BE and CN Chebyshev, the psum
    BiCGStab, the sourced strided trajectory), pad_operators and
    build_sharded_solver, crbe_diffusion_sweep, and
    ensemble_forecast / make_plume_dataset sharded over 'trial'."""
    from airpollution_tpu_torch.diagnostics.ensemble import ensemble_forecast
    from airpollution_tpu_torch.models import fno as tfno
    from airpollution_tpu_torch.parallel import (
        build_sharded_solver, crbe_diffusion_sweep, make_mesh, pad_operators)

    for order in (1, 2):
        _save(out_dir, f"halo_cheb_{order}",
              _halo_case(tapt.Problem(), order, 14, 16))
    _save(out_dir, "halo_bicgstab",
          _halo_case(SourcedProblem(), 2, 8, 9, solver_method="bicgstab",
                     tol=1e-10, maxiter=300))
    _save(out_dir, "halo_strided",
          _halo_case(SourcedProblem(), 1, 14, 16, snapshot_every=5))

    md = _md(8, 16)
    s = tapt.CRBESolver(tapt.Domain(), tapt.Problem(), md, solver_tol=1e-11,
                        device="cpu")
    ops = s._require_ops()
    padded, n_pad = pad_operators(ops, md.number_of_segments, 3)
    _save(out_dir, "pad", [n_pad, padded.system.vals.shape[0]])
    _save(out_dir, "pad_system", padded.system.vals)
    sharded = build_sharded_solver(make_mesh({"mp": 3}), md, tapt.Problem(),
                                   s.dt, tol=1e-11)
    _save(out_dir, "fem", sharded(padded, s.set_initial_condition()))

    D = [0.01, 0.1, 1.0]
    sweep = crbe_diffusion_sweep(md, tapt.Domain(), D, tol=1e-11,
                                 mesh=make_mesh({"trial": 3}))
    _save(out_dir, "sweep", torch.stack([sweep[k] for k in (
        "rel_l2_error", "l2_error", "max_error")]))

    emd = _md(8, 9, T=1.0)
    members = [tapt.ShiftedPlumeProblem(v=(0.5 + 0.1 * k, -0.2 * k),
                                        D=0.1 + 0.05 * k, center=(k, -k))
               for k in range(4)]
    out = ensemble_forecast(emd, emd.domain, members, order=2,
                            thresholds=(0.01, 0.05), tol=1e-11,
                            mesh=make_mesh({"trial": 3}))
    for k in ("members", "mean", "std", "exceedance"):
        _save(out_dir, f"ensemble_{k}", out[k])

    pmd = _md(9, 9, T=1.0)
    Ds, vs = np.array([0.1, 0.2, 0.3]), np.array([[0.5, 0.2], [-0.3, 0.4],
                                                   [0.1, -0.6]])
    probs = [tapt.ShiftedPlumeProblem(v=tuple(vs[i]), D=float(Ds[i]),
                                      sigma=1.0 + 0.2 * i, center=(i, -i))
             for i in range(3)]
    tfno._sample_plume_problems = lambda *a: (probs, Ds, vs)
    X, Y, _ = tfno.make_plume_dataset(pmd, pmd.domain, torch.Generator(), 3,
                                      tol=1e-11,
                                      mesh=make_mesh({"trial": 3}))
    _save(out_dir, "plume_X", X)
    _save(out_dir, "plume_Y", Y)


def gaussian_source_members(out_dir, params):
    """On 2 ranks: ensemble_forecast of GaussianSourceProblem members
    (their (K, 1) source columns) sharded over 'trial'."""
    from airpollution_tpu_torch.diagnostics.ensemble import ensemble_forecast
    from airpollution_tpu_torch.parallel import make_mesh

    md = _md(8, 9, T=1.0)
    members = [tapt.GaussianSourceProblem(**p) for p in params]
    out = ensemble_forecast(md, md.domain, members, order=2, tol=1e-11,
                            mesh=make_mesh({"trial": 2}))
    _save(out_dir, "members", out["members"])


# --- the block-sharded solvers (kernels B8-B10, plain versions) --------


def hbm_cases(out_dir):
    """On 2 ranks: each block builder with one block per rank, and the
    same solve on a one-process 2-block BlockMesh (rank 0), which
    tests/test_torch_port_hbm_shard_*.py hold against JAX."""
    import torch.distributed as dist

    from airpollution_tpu_torch.models.crbe import assemble
    from airpollution_tpu_torch.models.unsteady import solve_time_varying
    from airpollution_tpu_torch.parallel import (
        build_canvas_hbm_halo_solver, build_hbm_halo_solver,
        build_multispecies_hbm_halo_solver, make_mesh)
    from airpollution_tpu_torch.parallel.device_mesh import BlockMesh

    ranks = make_mesh({"mp": 2})
    blocks = BlockMesh({"mp": 2}, torch.device("cpu"))

    def both(case, run):
        _save(out_dir, case, run(ranks))
        if dist.get_rank() == 0:
            np.save(os.path.join(out_dir, f"block_{case}.npy"),
                    run(blocks).numpy())

    md = _md(24, 9)
    src = tapt.GaussianSourceProblem(q=5.0, xs=-2.0, ys=1.0, sigma_s=3.0)
    s = tapt.CRBESolver(tapt.Domain(), src, md, device="cpu")
    args = (s._require_ops(), s.set_initial_condition())
    both("b8", lambda m: build_hbm_halo_solver(
        m, md, src, s.dt, order=2, iters=6, extrapolate=True,
        snapshot_every=4)(*args))

    plume = tapt.RotatingPlumeProblem(omega=0.05, D=0.3)
    plume.robin_sides = {"bottom": 0.05}
    plume.obstacles = ((-4.0, 4.0, -4.0, 4.0),)
    sc = tapt.CRBESolver(tapt.Domain(), plume, md, device="cpu")
    cargs = (sc._require_ops(), sc.set_initial_condition())
    both("b9", lambda m: build_canvas_hbm_halo_solver(
        m, md, plume, sc.dt, order=1, iters=8, snapshot_every=4)(*cargs))

    chain = tapt.MultiSpeciesProblem(
        (tapt.GaussianSourceProblem(q=2.0, xs=-6.0, ys=2.0, sigma_s=2.0,
                                    v=(0.4, -0.1), D=0.6),
         tapt.Problem(v=(0.4, -0.1), D=0.6, sigma=1.5)),
        [[0.3, 0.0], [-0.3, 0.1]])
    margs = (assemble(md, chain.species[0], s.dt, 2, "correct"),
             chain.initial_conditions(md.midpoints))
    both("b10", lambda m: build_multispecies_hbm_halo_solver(
        m, md, chain, s.dt, order=2, iters=6, snapshot_every=4)(*margs))

    wmd = tapt.MeshData(tapt.create_mesh(24, 20.0), tapt.Domain(T=1.0),
                        nt=9, dtype=torch.float64, device="cpu")
    wind = tapt.TurningWindProblem()
    both("unsteady", lambda m: solve_time_varying(
        wind, wmd, reassemble_every=4, time_scheme_order=2,
        chebyshev_iters=8, extrapolate_warm_start=True,
        store_solutions=False, matvec_impl="fused_hbm", mesh=m))


# --- the trainers -------------------------------------------------------


def _problem():
    return tapt.Problem(v=(1.0, 0.5), D=0.2, sigma=1.5)


def forward_cases(out_dir, cases, x):
    """forward_tp on {'dp': 2, 'tp': 2}: each case's output on this rank's
    dp slice of ``x``, gathered over 'dp'."""
    from airpollution_tpu_torch.parallel import forward_tp, make_mesh
    from airpollution_tpu_torch.parallel.collectives import all_gather_rows
    from airpollution_tpu_torch.parallel.pinn_parallel import (
        _dp_slice, shard_params, tp_param_specs)

    mesh = make_mesh({"dp": 2, "tp": 2})
    xt = _dp_slice(torch.as_tensor(x), mesh)
    for name, (layers, act, params, fourier, amp) in cases.items():
        specs = tp_param_specs(layers, act, fourier, output_scale=amp)
        local = shard_params(params, specs, mesh)
        out = forward_tp(local, xt, act, mesh=mesh)
        _save(out_dir, f"forward_{name}", all_gather_rows(out, mesh, "dp"))
    return mesh


def training_cases(out_dir, fwd, loss, trainer, fno_case):
    """On 4 ranks: forward_tp and parallel_loss_reference on {'dp': 2,
    'tp': 2} from given parameters and points, 5 epochs of
    build_parallel_trainer and of PINN.train_parallel, and train_fno_dp
    over {'data': 4} (and its batch check)."""
    from airpollution_tpu_torch.parallel import (build_fno_dp_trainer,
                                                 make_mesh, train_fno_dp)
    from airpollution_tpu_torch.parallel.pinn_parallel import (
        parallel_loss_reference)

    mesh = forward_cases(out_dir, *fwd)
    layers, params, batches, lam = loss
    total, aux = parallel_loss_reference(
        mesh, layers, params, [torch.as_tensor(b) for b in batches],
        _problem(), lam, activation="tanh")
    _save(out_dir, "loss", torch.cat([total[None], aux]))

    losses, state = run_trainer(mesh, *trainer)
    _save(out_dir, "trainer_losses", losses)
    _save(out_dir, "trainer_params", flat_params(state.params))

    model, history = run_train_parallel(mesh)
    _save(out_dir, "pinn_history", history)
    _save(out_dir, "pinn_params", flat_params(model.params))
    _save(out_dir, "pinn_count", int(model._parallel_state.count))

    params, X, Y, kw = fno_case
    data = make_mesh({"data": 4})
    out, _, fl = train_fno_dp(data, fno_params(params), torch.as_tensor(X),
                              torch.as_tensor(Y), **kw,
                              generator=torch.Generator().manual_seed(3))
    _save(out_dir, "fno_losses", fl)
    _save(out_dir, "fno_params", torch.cat([t.reshape(-1) for t in out]))
    try:
        build_fno_dp_trainer(data, epochs=1, batch=6)
    except ValueError as exc:
        _save(out_dir, "fno_batch_error", str(exc))


def fno_params(arrays):
    from airpollution_tpu_torch.models.fno import FNOParams

    return FNOParams(*[torch.as_tensor(a) for a in arrays])


def flat_params(params):
    return torch.cat([torch.as_tensor(v).detach().reshape(-1)
                      for layer in params for _, v in sorted(layer.items())])


def run_trainer(mesh, layers, batch_sizes, lam, seed):
    """5 epochs of build_parallel_trainer from init_parallel_state(seed),
    the IC points drawn first from the generator of that seed."""
    from airpollution_tpu_torch.ops import sampling
    from airpollution_tpu_torch.parallel import (build_parallel_trainer,
                                                 init_parallel_state)

    dom = tapt.Domain()
    train, info = build_parallel_trainer(
        mesh, layers, dom, batch_sizes, lam, 2e-3, activation="tanh",
        epochs=5, dtype=torch.float64)
    state = init_parallel_state(seed, layers, "tanh", torch.float64,
                                device="cpu")
    gen = torch.Generator().manual_seed(seed)
    xy = sampling.lhs_sampling(gen, info["n_ic"], (-dom.Lx, dom.Lx, -dom.Ly,
                                                   dom.Ly), dtype=torch.float64)
    xyt = torch.cat([xy, torch.zeros((xy.shape[0], 1), dtype=xy.dtype)], 1)
    target = _problem().initial_condition_fn(xy).reshape(-1, 1)
    state, losses = train(state, xyt, target, gen, _problem())
    return losses, state


def run_train_parallel(mesh):
    """PINN.train_parallel twice (3 epochs, then 2 more continuing the
    Adam moments): its history and the model."""
    model = tapt.PINN([3, 8, 8, 1], _problem(), tapt.Domain(),
                      activation="adaptive_tanh", seed=5,
                      dtype=torch.float64, device="cpu", output_scale="auto")
    args = ({"pde": 64, "ic": 16, "bc": 16}, 3, 2e-3,
            {"pde": 2.0, "ic": 10.0, "bc": 10.0})
    model.train_parallel(mesh, *args)
    model.train_parallel(mesh, args[0], 2, *args[2:])
    return model, np.asarray(model.history["total_loss"])
