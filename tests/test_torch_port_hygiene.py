"""Guards on the port's boundaries: it imports no JAX, its entry points
never fall back to the CPU on their own, a CPU tensor takes a kernel's
plain version without needing the CUDA toolchain, and every option it
does not have yet raises NotImplementedError."""

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
from airpollution_tpu_torch.ops import fused_hbm, fused_solver

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "airpollution_tpu_torch",
    "airpollution_tpu_torch._build",
    "airpollution_tpu_torch.device",
    "airpollution_tpu_torch.interop",
    "airpollution_tpu_torch.problems",
    "airpollution_tpu_torch.mesh.data",
    "airpollution_tpu_torch.mesh.structured",
    "airpollution_tpu_torch.mesh.topology",
    "airpollution_tpu_torch.models.crbe",
    "airpollution_tpu_torch.ops.fused_hbm",
    "airpollution_tpu_torch.ops.fused_solver",
    "airpollution_tpu_torch.ops.lifting",
    "airpollution_tpu_torch.ops.linalg",
    "airpollution_tpu_torch.ops.sparse",
    "airpollution_tpu_torch.ops.stencil",
    "airpollution_tpu_torch.ops.uniform",
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
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "airpollution_tpu" or m.startswith("airpollution_tpu.")]
        print("BAD", bad)
        assert not bad, bad
    """)
    assert out.returncode == 0, out.stderr + out.stdout


def test_port_sources_name_no_jax():
    files = list((REPO / "airpollution_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s and "airpollution_tpu." not in \
                    s.replace("airpollution_tpu_torch", ""), (f, s)


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent")
    out = _run("""
        from airpollution_tpu_torch.ops import fused_hbm, fused_solver
        assert fused_solver.KERNEL.launches == 0
        assert fused_hbm.KERNEL._lib is None
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


FUSED_CHEB = dict(matvec_impl="fused", solver_method="chebyshev")


@pytest.mark.parametrize("kw", [
    dict(matvec_impl="fused", solver_method="bicgstab"),
    dict(matvec_impl="fused_hbm", solver_method="bicgstab"),
    dict(problem=_Sourced(), **FUSED_CHEB),
    dict(snapshot_every=2),
    dict(assembly="patch", **FUSED_CHEB),
    dict(fused_operator="canvas", **FUSED_CHEB),
    dict(problem=_Robin()),
    dict(problem=_Obstacle()),
    dict(problem=_Variable()),
    dict(preconditioner="spectral", matvec_impl="stencil"),
    dict(matvec_impl="uniform"),
    dict(matvec_impl="pallas"),
], ids=["fused-bicgstab", "fused_hbm-bicgstab", "fused-sourced",
        "snapshot_every", "patch", "canvas", "robin", "obstacles",
        "variable-coefficients", "spectral", "uniform", "pallas"])
def test_out_of_scope_options_raise(kw):
    with pytest.raises(NotImplementedError):
        _unported(**kw)


def test_other_entry_points_raise_on_unported_input():
    from airpollution_tpu_torch.models import crbe

    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                       device="cpu")
    with pytest.raises(NotImplementedError):
        crbe.assemble(md, _Robin(), 0.1, 1)
    with pytest.raises(NotImplementedError):
        fused_solver.fused_solve_uniform(
            None, None, None, None, torch.zeros(3), n_steps=1, n_iters=1,
            method="bicgstab")
