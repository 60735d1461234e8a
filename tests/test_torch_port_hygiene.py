"""Guards on the port's boundaries: it imports no JAX, its entry points
never fall back to the CPU on their own, a CPU tensor takes a kernel's
plain version without needing the CUDA toolchain, every option it does
not have yet raises NotImplementedError (and an invalid one ValueError,
as in the JAX package), and each option a slice ported solves through the
plain version of its kernel, with no CUDA launch."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch import _build
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.ops import fused_hbm, fused_solver, fused_stencil

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "airpollution_tpu_torch",
    "airpollution_tpu_torch._build",
    "airpollution_tpu_torch.cli",
    "airpollution_tpu_torch.device",
    "airpollution_tpu_torch.diagnostics",
    "airpollution_tpu_torch.diagnostics.analysis",
    "airpollution_tpu_torch.diagnostics.ensemble",
    "airpollution_tpu_torch.diagnostics.inverse",
    "airpollution_tpu_torch.experiments",
    "airpollution_tpu_torch.experiments.__main__",
    "airpollution_tpu_torch.experiments.common",
    "airpollution_tpu_torch.experiments.crbe_experiments",
    "airpollution_tpu_torch.experiments.fixed_runtime_experiments",
    "airpollution_tpu_torch.experiments.optimal_hyperparams_search",
    "airpollution_tpu_torch.experiments.pinn_experiments",
    "airpollution_tpu_torch.experiments.sensitivity_analysis",
    "airpollution_tpu_torch.hpo",
    "airpollution_tpu_torch.hpo.search",
    "airpollution_tpu_torch.interop",
    "airpollution_tpu_torch.io",
    "airpollution_tpu_torch.io.checkpoint",
    "airpollution_tpu_torch.problems",
    "airpollution_tpu_torch.mesh.data",
    "airpollution_tpu_torch.mesh.mirror",
    "airpollution_tpu_torch.mesh.msh_io",
    "airpollution_tpu_torch.mesh.native",
    "airpollution_tpu_torch.mesh.structured",
    "airpollution_tpu_torch.mesh.topology",
    "airpollution_tpu_torch.models.crbe",
    "airpollution_tpu_torch.models.fno",
    "airpollution_tpu_torch.models.multispecies",
    "airpollution_tpu_torch.models.pinn",
    "airpollution_tpu_torch.models.unsteady",
    "airpollution_tpu_torch.ops.fused_hbm",
    "airpollution_tpu_torch.ops.fused_solver",
    "airpollution_tpu_torch.ops.fused_stencil",
    "airpollution_tpu_torch.ops.autodiff",
    "airpollution_tpu_torch.ops.gather",
    "airpollution_tpu_torch.ops.lbfgs",
    "airpollution_tpu_torch.ops.lifting",
    "airpollution_tpu_torch.ops.linalg",
    "airpollution_tpu_torch.ops.loads",
    "airpollution_tpu_torch.ops.sampling",
    "airpollution_tpu_torch.ops.sparse",
    "airpollution_tpu_torch.ops.spectral",
    "airpollution_tpu_torch.ops.stencil",
    "airpollution_tpu_torch.ops.uniform",
    "airpollution_tpu_torch.parallel",
    "airpollution_tpu_torch.parallel.collectives",
    "airpollution_tpu_torch.parallel.device_mesh",
    "airpollution_tpu_torch.parallel.fem_shard",
    "airpollution_tpu_torch.parallel.fno_parallel",
    "airpollution_tpu_torch.parallel.hbm_shard",
    "airpollution_tpu_torch.parallel.launch",
    "airpollution_tpu_torch.parallel.pinn_parallel",
    "airpollution_tpu_torch.parallel.stencil_shard",
    "airpollution_tpu_torch.parallel.sweep",
    "airpollution_tpu_torch.reporting",
    "airpollution_tpu_torch.reporting.data_visualization",
    "airpollution_tpu_torch.reporting.frames",
    "airpollution_tpu_torch.reporting.plots",
    "airpollution_tpu_torch.reporting.table_generator",
    "airpollution_tpu_torch.utils",
    "airpollution_tpu_torch.utils.profiling",
]


# The port's scripts that import the package at module level (the JAX
# package's demo and experiment scripts, ported).
PORT_SCRIPTS = [
    "torch_port_source_inversion",
    "torch_port_unsteady_scale",
    "torch_port_unsteady_wind",
    "torch_port_unsteady_checks",
    "torch_port_large_mesh_policy",
    "torch_port_wind_fit_stability",
    "torch_port_dispatch_count",
    "torch_port_ensemble_demo",
    "torch_port_fno_surrogate",
    "torch_port_problem3",
    "torch_port_problem3_comprehensive_analysis",
    "torch_port_problem3_comprehensive_analysis2",
    "torch_port_problem3_comparative_analysis",
    "torch_port_assimilation_demo",
    "torch_port_da_cycling_demo",
    "torch_port_network_design_demo",
    "torch_port_wind_inversion_demo",
    "torch_port_extrapolate_ab",
    "torch_port_obstacle_canyon_demo",
    "torch_port_multispecies_fused_demo",
    "torch_port_multispecies_demo",
    "torch_port_rotating_convergence",
    "torch_port_pinn_rotating_demo",
    "torch_port_pinn_accuracy_levers",
    "torch_port_canyon_pinn_fem",
]


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_no_jax():
    out = _run(f"""
        import importlib, sys
        for m in {PORT_MODULES!r}:
            importlib.import_module(m)
        import chip_smoke
        for name in {PORT_SCRIPTS!r}:
            importlib.import_module("scripts." + name)
        bad = [m for m in sys.modules
               if m in ("jax", "optax", "airpollution_tpu", "experiments",
                        "pandas")
               or m.startswith(("jax.", "optax.", "airpollution_tpu.",
                                "experiments.", "pandas."))]
        print("BAD", bad)
        assert not bad, bad
    """)
    assert out.returncode == 0, out.stderr + out.stdout


def test_port_sources_name_no_jax():
    files = list((REPO / "airpollution_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.append(REPO / "scripts" / "torch_port_production_scenario.py")
    files += [REPO / "scripts" / f"{name}.py" for name in PORT_SCRIPTS]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "optax" not in s \
                    and "pandas" not in s \
                    and not s.startswith(("import experiments",
                                          "from experiments")) \
                    and "airpollution_tpu." not in \
                    s.replace("airpollution_tpu_torch", ""), (f, s)


def test_port_scripts_default_outside_results_snapshot():
    """No default of a port script (an argparse flag's or a function
    argument's) names a path under results_snapshot/: those files were
    committed before the port began."""
    import ast

    for name in PORT_SCRIPTS:
        tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
        defaults = [kw.value for node in ast.walk(tree)
                    if isinstance(node, ast.Call)
                    for kw in node.keywords if kw.arg == "default"]
        defaults += [d for node in ast.walk(tree)
                     if isinstance(node, ast.FunctionDef)
                     for d in node.args.defaults + node.args.kw_defaults
                     if d is not None]
        defaults += [node.value for node in tree.body
                     if isinstance(node, ast.Assign)]
        for d in defaults:
            for leaf in ast.walk(d):
                if isinstance(leaf, ast.Constant) and isinstance(
                        leaf.value, str):
                    assert "results_snapshot" not in leaf.value, (name,
                                                                  leaf.value)


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent")
    out = _run("""
        from airpollution_tpu_torch.ops import fused_hbm, fused_solver
        from airpollution_tpu_torch.ops import fused_stencil
        assert fused_solver.KERNEL.launches == 0
        kernels = (fused_solver.KERNEL, fused_solver.LOAD_KERNEL,
                   fused_solver.BICGSTAB_KERNEL, fused_solver.CANVAS_KERNEL,
                   fused_hbm.KERNEL, fused_hbm.LOAD_KERNEL,
                   fused_hbm.CANVAS_KERNEL, fused_hbm.CANVAS_RAW_KERNEL,
                   fused_hbm.MULTISPECIES_KERNEL, fused_stencil.KERNEL,
                   fused_hbm.BLOCK_KERNEL, fused_hbm.BLOCK_LOAD_KERNEL,
                   fused_hbm.CANVAS_BLOCK_KERNEL,
                   fused_hbm.MULTISPECIES_BLOCK_KERNEL)
        assert all(k._lib is None for k in kernels)
    """, env=env)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = tapt.create_mesh(5, 20.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapt.MeshData(mesh, tapt.Domain(), nt=4)
    md = tapt.MeshData(mesh, tapt.Domain(), nt=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CRBESolver(tapt.Domain(), tapt.Problem(), md)
    with pytest.raises(ValueError, match="differs"):
        CRBESolver(tapt.Domain(), tapt.Problem(), md, device="meta")
    chem = tapt.MultiSpeciesProblem((tapt.Problem(), tapt.Problem()),
                                    [[0.1, 0.0], [-0.1, 0.0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapt.MultiSpeciesSolver(tapt.Domain(), chem, md)
    with pytest.raises(ValueError, match="differs"):
        tapt.MultiSpeciesSolver(tapt.Domain(), chem, md, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapt.PINN([3, 4, 1], tapt.Problem(), tapt.Domain())


def test_command_line_raises_without_cuda(tmp_path):
    """``python -m airpollution_tpu_torch`` takes the card unless
    APT_PLATFORM=cpu is set, and with no card raises instead of falling
    back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "APT_PLATFORM"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "airpollution_tpu_torch", "solve",
           "--mesh_size", "5", "--nt", "3"]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not out.stdout.strip()
    out = subprocess.run(cmd, cwd=tmp_path, env=dict(env, APT_PLATFORM="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"method": "crbe"' in out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cmd", [
    ["fit-ic"], ["fit-deposition", "--robin", "right=0.5"],
    ["fit-exchange", "--robin", "right=0.5"]])
def test_fit_subcommands_take_the_card(monkeypatch, cmd):
    """The inverse subcommands ported in slice 14 take the card unless
    APT_PLATFORM=cpu, and with no card raise before reading anything."""
    from airpollution_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("APT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*cmd, "--mesh_size", "5", "--nt", "3", "--observed",
                  "missing.npz"])


def test_inverse_fits_on_cpu_tensors_build_nothing(monkeypatch):
    """The fits, the differentiable multispecies solve and the footprint
    run where their mesh data lives: on a CPU mesh they take the plain
    versions of B4's raw mode and B7 (fused engine included), and never
    build or launch a kernel."""
    from airpollution_tpu_torch.diagnostics import inverse
    from airpollution_tpu_torch.ops import gather

    def no_build(*_a, **_k):
        raise AssertionError("a CPU fit must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_build)
    kernels = (fused_hbm.CANVAS_RAW_KERNEL, gather.KERNEL)
    before = [k.launches for k in kernels]
    md = tapt.MeshData(tapt.create_mesh(6, 20.0), tapt.Domain(), nt=4,
                       dtype=torch.float64, device="cpu")
    walled = tapt.SquarePulseProblem(v=(0.0, 0.0), D=1.0)
    walled.robin_sides = {"right": 0.5}
    obs = torch.zeros((2, md.number_of_segments), dtype=torch.float64)
    fused = dict(engine="fused_hbm", chebyshev_iters=4, steps=1)
    inverse.fit_surface_exchange(obs, md, walled, snapshot_indices=[1, 3],
                                 **fused)
    inverse.fit_initial_condition(obs, md, tapt.Problem(),
                                  snapshot_indices=[1, 3], **fused)
    inverse.fit_wind(obs, md, snapshot_indices=[1, 3], omega_grid=[0.1],
                     **fused)
    F = inverse.receptor_footprint(md, md.domain, tapt.Problem(), [3])
    chem = tapt.MultiSpeciesProblem((tapt.Problem(), tapt.Problem()),
                                    [[0.1, 0.0], [-0.1, 0.0]])
    C = inverse.solve_multispecies_snapshots(chem, md)
    assert F.device.type == C.device.type == "cpu"
    assert [k.launches for k in kernels] == before


def test_pinn_unported_methods_raise(tmp_path):
    """The methods that once raised NotImplementedError now run:
    multi-process training (parallel/pinn_parallel.py) on a one-rank gloo
    ('dp', 'tp') mesh, twice with the Adam moments carried, and what is
    not a mesh raises TypeError; the plots (reporting/plots.py) each write
    the JAX package's file names."""
    from airpollution_tpu_torch.parallel import launch, make_mesh

    m = tapt.PINN([3, 4, 1], tapt.Problem(), tapt.Domain(), device="cpu")
    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                       device="cpu")
    args = ({"pde": 8, "ic": 4, "bc": 4}, 2, 1e-3,
            {"pde": 1.0, "ic": 1.0, "bc": 1.0})
    with launch.process_group("gloo"):
        mesh = make_mesh({"dp": 1, "tp": 1})
        m.train_parallel(mesh, *args)
        m.train_parallel(mesh, *args)
    assert len(m.history["total_loss"]) == 4
    assert int(m._parallel_state.count) == 4
    assert np.isfinite(m.history["total_loss"]).all()
    for bad in (None, object()):
        with pytest.raises(TypeError):
            m.train_parallel(bad, *args)
    m.history = {k: [1.0, 0.5] for k in ("total_loss", "pde_loss",
                                         "ic_loss", "bc_loss")}
    m.plot_history(save_dir=str(tmp_path), name="p")
    m.plot_solution(1.0, md, save_dir=str(tmp_path))
    m.plot_interpolated_solution(1.0, md, save_dir=str(tmp_path), name="p")
    assert {p.name for p in tmp_path.iterdir()} == {
        "loss_history_p.pdf", "loss_history_p.png", "solution_1.0.pdf",
        "solution_1.0.png", "solution_1.0_interpolated_solution_p.pdf",
        "solution_1.0_interpolated_solution_p.png"}


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU solve must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_build)
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=21,
                       dtype=torch.float64, device="cpu")
    before = (fused_solver.KERNEL.launches, fused_hbm.KERNEL.launches)
    for impl in ("fused", "fused_hbm"):
        s = CRBESolver(tapt.Domain(), tapt.Problem(), md, matvec_impl=impl,
                       solver_method="chebyshev", chebyshev_iters=4,
                       device="cpu")
        out = s.solve(store_solutions=False)
        assert out.device.type == "cpu" and bool(torch.isfinite(out).all())
    assert (fused_solver.KERNEL.launches, fused_hbm.KERNEL.launches) == before
    u = torch.zeros((3, 9, 9), dtype=torch.float64)
    scal = torch.ones(22 + 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_solver.kernel_solve(scal, u, n_steps=1, n_iters=1,
                                  use_ka=False, extrapolate=False)


def _unported(**kw):
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=21,
                       dtype=torch.float64, device="cpu")
    problem = kw.pop("problem", tapt.Problem())
    return CRBESolver(tapt.Domain(), problem, md, device="cpu", **kw)


class _Robin(tapt.Problem):
    robin_sides = {"left": 0.1}


class _Obstacle(tapt.Problem):
    obstacles = ((-1.0, 1.0, -1.0, 1.0),)


class _Variable(tapt.Problem):
    variable_coefficients = True


class _Sourced(tapt.Problem):
    zero_source = False


class _RobinFlux(_Robin):
    def robin_g_xy(self, x, y, t, side):
        return 0.0 * x + 1.0


class _TimeVarying(tapt.Problem):
    time_varying = True


FUSED_CHEB = dict(matvec_impl="fused", solver_method="chebyshev")


@pytest.mark.parametrize("kw,exc", [
    (dict(matvec_impl="fused_hbm", solver_method="bicgstab"), ValueError),
    (dict(problem=_Sourced(), matvec_impl="fused", fused_operator="canvas",
          solver_method="bicgstab"), ValueError),
    (dict(problem=_RobinFlux(), matvec_impl="fused",
          solver_method="bicgstab"), ValueError),
    (dict(problem=_Variable(), fused_operator="uniform", **FUSED_CHEB),
     ValueError),
    (dict(problem=_TimeVarying()), ValueError),
    (dict(assembly="patch", matvec_impl="stencil"), ValueError),
], ids=["fused_hbm-bicgstab", "canvas-bicgstab-sourced",
        "robin_g_xy-bicgstab", "variable-uniform-operator", "time-varying",
        "patch"])
def test_out_of_scope_options_raise(kw, exc):
    with pytest.raises(exc):
        _unported(**kw)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a kernel's plain version)."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _emitter():
    return tapt.GaussianSourceProblem(q=5.0, xs=-2.0, ys=1.0, sigma_s=4.0)


@pytest.mark.parametrize("kw,kernel", [
    (dict(fused_operator="canvas", **FUSED_CHEB), "B4"),
    (dict(problem=_Robin(), matvec_impl="fused_hbm",
          solver_method="chebyshev"), "B4"),
    (dict(problem=_Obstacle(), matvec_impl="fused",
          solver_method="bicgstab"), "B5"),
    (dict(problem=_Variable(), matvec_impl="fused_hbm",
          solver_method="chebyshev"), "B4"),
    (dict(matvec_impl="pallas"), "B3"),
    (dict(problem=_Robin(), assemble_only=True), None),
    (dict(matvec_impl="fused", solver_method="bicgstab"), "B1-BiCGStab"),
    (dict(problem=_emitter(), **FUSED_CHEB), "B1"),
    (dict(problem=_emitter(), matvec_impl="fused_hbm",
          solver_method="chebyshev"), "B2"),
    (dict(problem=_RobinFlux(), matvec_impl="fused_hbm",
          solver_method="chebyshev"), "B4"),
    (dict(snapshot_every=4, store=True, **FUSED_CHEB), "B1"),
    (dict(assembly="patch", **FUSED_CHEB), "B1"),
    (dict(assembly="patch", matvec_impl="fused_hbm",
          solver_method="chebyshev"), "B2"),
    (dict(preconditioner="spectral", matvec_impl="stencil"), None),
    (dict(matvec_impl="uniform"), None),
], ids=["canvas", "robin", "obstacles", "variable-coefficients", "pallas",
        "assemble-robin", "fused-bicgstab", "fused-sourced",
        "fused_hbm-sourced", "robin_g_xy-fused", "snapshot_every",
        "patch-fused", "patch-fused_hbm", "spectral", "uniform"])
def test_ported_options_solve_on_the_plain_kernels(monkeypatch, kw, kernel):
    from airpollution_tpu_torch.models import crbe

    plain = {
        "B1": _spy(monkeypatch, fused_solver, "plain_solve"),
        "B1-BiCGStab": _spy(monkeypatch, fused_solver,
                            "plain_uniform_bicgstab_solve"),
        "B2": _spy(monkeypatch, fused_solver, "plain_step"),
        "B3": _spy(monkeypatch, fused_stencil.stencil, "stencil_matvec"),
        "B4": _spy(monkeypatch, fused_hbm, "plain_canvas_step"),
        "B5": _spy(monkeypatch, fused_solver, "plain_bicgstab_solve"),
    }
    if kw.pop("assemble_only", False):
        md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                           dtype=torch.float64, device="cpu")
        ops = crbe.assemble(md, kw["problem"], 0.1, 1)
        assert bool(torch.isfinite(ops.system.vals).all())
        return
    store = kw.pop("store", False)
    s = _unported(**kw)
    out = s.solve(store_solutions=store)
    n_rows = (s.mesh_data.nt - 1) // s.snapshot_every + 1 if store else 1
    assert out.shape == (n_rows, s.mesh_data.number_of_segments)
    assert bool(torch.isfinite(out).all())
    if kernel is None:
        # Plain array code on its route: no fused plan, no kernel B1-B5.
        assert not hasattr(s, "fused_kernel")
        assert not any(plain[k] for k in ("B1", "B1-BiCGStab", "B2", "B4",
                                          "B5"))
    else:
        assert getattr(s, "fused_kernel", "B3") == kernel
        assert plain[kernel], f"the plain version of {kernel} was not used"
    assert all(k.launches == 0 for k in (
        fused_stencil.KERNEL, fused_solver.KERNEL, fused_solver.LOAD_KERNEL,
        fused_solver.BICGSTAB_KERNEL, fused_solver.CANVAS_KERNEL,
        fused_hbm.KERNEL, fused_hbm.LOAD_KERNEL, fused_hbm.CANVAS_KERNEL))


def test_other_entry_points_raise_on_unported_input():
    from airpollution_tpu_torch.models import crbe

    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                       device="cpu")
    with pytest.raises(ValueError, match="coeff_time"):
        crbe.assemble(md, _TimeVarying(), 0.1, 1)
    with pytest.raises(ValueError, match="patch"):
        CRBESolver(tapt.Domain(), tapt.Problem(), md, assembly="patch",
                   device="cpu")


def _chemistry(sourced=True):
    first = (tapt.GaussianSourceProblem(q=2.0, xs=-2.0) if sourced
             else tapt.Problem())
    return tapt.MultiSpeciesProblem((first, tapt.Problem(sigma=2.0)),
                                    [[0.3, -0.1], [-0.2, 0.4]])


def _multispecies(problem=None, nt=9, **kw):
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(T=1.0), nt=nt,
                       dtype=torch.float64, device="cpu")
    return tapt.MultiSpeciesSolver(tapt.Domain(T=1.0),
                                   problem or _chemistry(), md,
                                   device="cpu", **kw)


@pytest.mark.parametrize("fuse,plain", [
    (True, "plain_multispecies_step"), (False, "plain_canvas_step")])
def test_multispecies_cpu_tensors_take_the_plain_kernels(monkeypatch, fuse,
                                                         plain):
    """The fused Strang route on CPU tensors: B6's plain version (B4's
    with fuse_chemistry=False) once per step, no build, no launch."""
    def no_build(*_a, **_k):
        raise AssertionError("a CPU solve must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_build)
    calls = _spy(monkeypatch, fused_hbm, plain)
    s = _multispecies(time_scheme_order=2, matvec_impl="fused_hbm",
                      splitting="strang", solver_method="chebyshev",
                      chebyshev_iters=6, fuse_chemistry=fuse)
    out = s.solve(store_solutions=False)
    assert out.shape == (1, 2, s.mesh_data.number_of_segments)
    assert bool(torch.isfinite(out).all())
    assert len(calls) == (8 if fuse else 16)
    assert fused_hbm.MULTISPECIES_KERNEL.launches == 0
    assert fused_hbm.CANVAS_KERNEL.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        fused_hbm.multispecies_kernel_step(
            torch.zeros((21, 9, 9)), torch.zeros(1), 1,
            torch.zeros((2, 3, 9, 9)), torch.zeros((2, 3, 9, 9)), False,
            (1, 8, 1, 8), None, 8)


def test_multispecies_unported_options_raise():
    from airpollution_tpu_torch.models import multispecies

    # matvec_impl="uniform" is ported: the Strang loop on the 15-scalar
    # operator gives the stencil loop's answer.
    got = _multispecies(matvec_impl="uniform", splitting="strang",
                        solver_tol=1e-12).solve(store_solutions=False)
    want = _multispecies(matvec_impl="stencil", splitting="strang",
                         solver_tol=1e-12).solve(store_solutions=False)
    assert float((got - want).abs().max()) <= 1e-10 * float(
        want.abs().max())
    # The commute route rides the port's CRBESolver and its snapshot_every.
    s = _multispecies(_chemistry(sourced=False), snapshot_every=4)
    assert s.splitting == "commute"
    assert s.solve().shape == (3, 2, s.mesh_data.number_of_segments)
    s = _multispecies(splitting="strang", solver_method="chebyshev")
    ops = s.build_global_matrices()
    C0 = s.set_initial_condition()
    base = dict(mesh_data=s.mesh_data, problem=s.problem, dt=s.dt, order=1,
                tol=1e-8, maxiter=10)
    # The differentiable loop and the R override are ported
    # (tests/test_torch_port_multispecies_adjoint.py); the differentiable
    # loop is BiCGStab-only, as in the JAX package.
    with pytest.raises(ValueError, match="bicgstab"):
        multispecies.run_multispecies_loop(ops, C0, **base,
                                           differentiable=True,
                                           solver="chebyshev")
    same = [multispecies.run_multispecies_loop(ops, C0, **base, **extra)[0]
            for extra in ({}, dict(R=s.problem.R),
                          dict(differentiable=True))]
    assert torch.equal(same[0], same[1]) and torch.equal(same[0], same[2])


def test_gather_and_native_modules_import_without_a_toolchain():
    """Importing kernel B7's module or the native bridge builds nothing:
    no nvcc, no C++ compiler, no library loaded."""
    env = dict(os.environ, PATH="/nonexistent")
    out = _run("""
        from airpollution_tpu_torch.mesh import native
        from airpollution_tpu_torch.ops import gather, sparse
        assert gather.KERNEL._lib is None and gather.KERNEL.launches == 0
        assert native._STATE == {"tried": False, "lib": None,
                                 "error": None}
    """, env=env)
    assert out.returncode == 0, out.stderr


def _general_solver(**kw):
    md = tapt.MeshData(tapt.create_unstructured_mesh(9, 20.0, seed=1),
                       tapt.Domain(), nt=33, dtype=torch.float64,
                       device="cpu")
    return CRBESolver(tapt.Domain(), tapt.Problem(), md, device="cpu", **kw)


@pytest.mark.parametrize("method", ["bicgstab", "chebyshev"])
def test_general_mesh_cpu_solve_takes_plain_b7(monkeypatch, method):
    """An unstructured CPU solve (and, for Chebyshev, the transposed
    products of its spectral estimate) runs B7's plain version: no
    build, no launch."""
    from airpollution_tpu_torch.ops import gather

    def no_build(*_a, **_k):
        raise AssertionError("a CPU solve must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_build)
    calls = _spy(monkeypatch, gather, "plain_matvec")
    s = _general_solver(solver_method=method, chebyshev_iters=12)
    out = s.solve(store_solutions=False)
    assert bool(torch.isfinite(out).all()) and not s._use_stencil()
    assert s.solver_method == method
    assert calls and gather.KERNEL.launches == 0


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_b7_failure_raises_instead_of_falling_back(monkeypatch):
    """A CUDA-typed product whose kernel launch fails raises; the plain
    version is never taken in its place."""
    from airpollution_tpu_torch.ops import gather, sparse

    def failed(*_a, **_k):
        raise RuntimeError("ell_gather launch failed: injected (1)")

    monkeypatch.setattr(gather.KERNEL, "launch", failed)
    monkeypatch.setattr(_build, "current_stream", lambda: None)
    calls = _spy(monkeypatch, gather, "plain_matvec")
    A = sparse.EllMatrix(torch.ones(4, 1),
                         *sparse.ell_index([[0], [1], [2], [3]], "cpu"))
    x = torch.Tensor._make_subclass(_CudaTyped, torch.ones(4))
    with pytest.raises(RuntimeError, match="injected"):
        sparse.ell_matvec(A, x)
    with pytest.raises(RuntimeError, match="injected"):
        gather.ell_matvec_vmem_roll(A, x)
    with pytest.raises(ValueError, match="int32 columns"):
        gather.matvec(A.vals, A.cols, None, x)
    assert not calls


JAX_SUBPACKAGES = ["", "models", "mesh", "ops", "io", "diagnostics", "utils",
                   "hpo", "parallel"]
# XLA's persistent compilation cache has no counterpart on the card.
NOT_PORTED = {"utils": {"enable_compilation_cache"}}


def _jax_all(sub):
    """The names in the ``__all__`` of a JAX (sub)package, read from its
    source (importing it would import JAX)."""
    import ast

    init = REPO / "airpollution_tpu" / sub / "__init__.py"
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"{init} has no __all__")


def test_parallel_import_starts_nothing():
    """Importing the parallel package (every module of it) initializes no
    process group, builds and loads no kernel and imports no JAX, with no
    toolchain on the PATH."""
    env = dict(os.environ, PATH="/nonexistent")
    out = _run("""
        import gc, sys
        import airpollution_tpu_torch.parallel as par
        from airpollution_tpu_torch.parallel import (collectives, fem_shard,
            fno_parallel, launch, pinn_parallel, stencil_shard, sweep)
        import torch.distributed as dist
        from airpollution_tpu_torch import _build
        assert not dist.is_initialized()
        kernels = [o for o in gc.get_objects()
                   if isinstance(o, _build.Kernel)]
        assert kernels and all(k._lib is None and k.launches == 0
                               for k in kernels)
        assert not any(m == "jax" or m.startswith(("jax.", "airpollution_tpu."))
                       for m in sys.modules)
    """, env=env)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_public_surface_matches_the_jax_subpackages(order):
    """Every name of each JAX subpackage's ``__all__`` imports from the
    port's counterpart (and stands in its ``__all__``), in either import
    order (no import cycle), with no toolchain on the PATH and no kernel
    built or loaded."""
    wanted = {sub: sorted(_jax_all(sub) - NOT_PORTED.get(sub, set()))
              for sub in JAX_SUBPACKAGES}
    subs = JAX_SUBPACKAGES if order == "forward" else JAX_SUBPACKAGES[::-1]
    env = dict(os.environ, PATH="/nonexistent")
    out = _run(f"""
        import gc, importlib
        wanted = {wanted!r}
        for sub in {subs!r}:
            name = "airpollution_tpu_torch" + ("." + sub if sub else "")
            mod = importlib.import_module(name)
            missing = [n for n in wanted[sub] if not hasattr(mod, n)]
            assert not missing, (name, missing)
            unlisted = set(wanted[sub]) - set(mod.__all__)
            assert not unlisted, (name, unlisted)
        from airpollution_tpu_torch import _build
        kernels = [o for o in gc.get_objects()
                   if isinstance(o, _build.Kernel)]
        assert kernels and all(k._lib is None for k in kernels)
    """, env=env)
    assert out.returncode == 0, out.stderr


def test_register_problem_pytree_admits_a_user_subclass():
    """A user subclass of a problem names its member parameters through
    ``register_problem_pytree``; ``stack_problems`` then takes it."""
    from airpollution_tpu_torch import problems

    class Tilted(tapt.Problem):
        pass

    members = [Tilted(D=0.1), Tilted(D=0.2)]
    with pytest.raises(TypeError, match="register_problem_pytree"):
        problems.stack_problems(members)
    try:
        assert problems.register_problem_pytree(
            Tilted, ("v", "D", "sigma", "reaction")) is Tilted
        stacked = problems.stack_problems(members)
        assert stacked.D.tolist() == [[0.1], [0.2]]
    finally:
        problems.MEMBER_FIELDS.pop(Tilted, None)


@pytest.mark.parametrize("module,argv", [
    ("crbe_experiments", ["--mesh_sizes", "4"]),
    ("pinn_experiments", ["--mesh_sizes", "4", "--epochs", "1"]),
    ("sensitivity_analysis", ["--epochs", "1"]),
    ("fixed_runtime_experiments", ["--run_for_testing", "True"]),
    ("optimal_hyperparams_search", ["--n_trials", "1", "--epochs", "1"]),
])
def test_drivers_raise_without_cuda(monkeypatch, tmp_path, module, argv):
    """The experiment drivers take the card unless APT_PLATFORM=cpu or
    ``device="cpu"``; with no card they raise before writing anything."""
    import importlib

    driver = importlib.import_module(
        f"airpollution_tpu_torch.experiments.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("APT_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv)
    assert not any(tmp_path.iterdir())
