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
    "airpollution_tpu_torch.device",
    "airpollution_tpu_torch.diagnostics",
    "airpollution_tpu_torch.diagnostics.inverse",
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
    "airpollution_tpu_torch.models.multispecies",
    "airpollution_tpu_torch.models.pinn",
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
    "airpollution_tpu_torch.ops.stencil",
    "airpollution_tpu_torch.ops.uniform",
    "airpollution_tpu_torch.parallel",
    "airpollution_tpu_torch.parallel.device_mesh",
    "airpollution_tpu_torch.parallel.hbm_shard",
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
        import scripts.torch_port_source_inversion
        import scripts.torch_port_pinn_experiments
        bad = [m for m in sys.modules
               if m in ("jax", "optax", "airpollution_tpu")
               or m.startswith(("jax.", "optax.", "airpollution_tpu."))]
        print("BAD", bad)
        assert not bad, bad
    """)
    assert out.returncode == 0, out.stderr + out.stdout


def test_port_sources_name_no_jax():
    files = list((REPO / "airpollution_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.append(REPO / "scripts" / "torch_port_production_scenario.py")
    files.append(REPO / "scripts" / "torch_port_source_inversion.py")
    files.append(REPO / "scripts" / "torch_port_pinn_experiments.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "optax" not in s \
                    and "airpollution_tpu." not in \
                    s.replace("airpollution_tpu_torch", ""), (f, s)


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


def test_pinn_unported_methods_raise():
    """Multi-device training (ROADMAP item 19) and the plots (A3) are not
    ported: each raises NotImplementedError, on the CPU model too."""
    m = tapt.PINN([3, 4, 1], tapt.Problem(), tapt.Domain(), device="cpu")
    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                       device="cpu")
    with pytest.raises(NotImplementedError):
        m.train_parallel(None, {"pde": 8, "ic": 4, "bc": 4}, 1, 1e-3,
                         {"pde": 1.0, "ic": 1.0, "bc": 1.0})
    with pytest.raises(NotImplementedError):
        m.plot_history()
    with pytest.raises(NotImplementedError):
        m.plot_solution(1.0, md)
    with pytest.raises(NotImplementedError):
        m.plot_interpolated_solution(1.0, md)


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
    (dict(preconditioner="spectral", matvec_impl="stencil"),
     NotImplementedError),
    (dict(matvec_impl="uniform"), NotImplementedError),
], ids=["fused_hbm-bicgstab", "canvas-bicgstab-sourced",
        "robin_g_xy-bicgstab", "variable-uniform-operator", "time-varying",
        "patch", "spectral", "uniform"])
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
], ids=["canvas", "robin", "obstacles", "variable-coefficients", "pallas",
        "assemble-robin", "fused-bicgstab", "fused-sourced",
        "fused_hbm-sourced", "robin_g_xy-fused", "snapshot_every",
        "patch-fused", "patch-fused_hbm"])
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
    with pytest.raises(NotImplementedError):
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

    with pytest.raises(NotImplementedError):
        _multispecies(matvec_impl="uniform")
    # The commute route rides the port's CRBESolver and its snapshot_every.
    s = _multispecies(_chemistry(sourced=False), snapshot_every=4)
    assert s.splitting == "commute"
    assert s.solve().shape == (3, 2, s.mesh_data.number_of_segments)
    s = _multispecies(splitting="strang", solver_method="chebyshev")
    ops = s.build_global_matrices()
    C0 = s.set_initial_condition()
    base = dict(mesh_data=s.mesh_data, problem=s.problem, dt=s.dt, order=1,
                tol=1e-8, maxiter=10)
    for extra in (dict(differentiable=True), dict(R=s.problem.R)):
        with pytest.raises(NotImplementedError):
            multispecies.run_multispecies_loop(ops, C0, **base, **extra)


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
