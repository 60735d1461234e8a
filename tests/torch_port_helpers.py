"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py):
one structured mesh in both packages, the JAX package's assembled
operator carried across as numpy arrays, and a stand-in for the JAX raw_b
kernel."""

from functools import partial

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import airpollution_tpu as japt
from airpollution_tpu.ops import linalg as jlinalg
from airpollution_tpu.ops import stencil as jstencil
import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.interop import operators_from_numpy


def mesh_pair(ms, nt=8):
    """(JAX MeshData, port MeshData) of one ms x ms mesh, float64, CPU."""
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(), nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=nt,
                        dtype=torch.float64, device="cpu")
    return jmd, tmd


def port_operators(jops):
    """The JAX GlobalOperators as the port's, through numpy."""

    def ell(m):
        return np.asarray(m.vals), np.asarray(m.cols)

    return operators_from_numpy(
        mass_diag=np.asarray(jops.mass_diag),
        stiffness=ell(jops.stiffness), advection=ell(jops.advection),
        ka=ell(jops.ka), system=ell(jops.system),
        system_diag=np.asarray(jops.system_diag), device="cpu",
    )


def jax_plain_raw(pattern, coeffs, inv_diag_fam, b_fam, *, n_iters, bounds,
                  interpret=False, **_):
    """The JAX raw_b kernel's polynomial p(A) mask(b) through
    linalg.chebyshev (interior-rectangle mask: H rows 0 and n-1, V columns
    0 and n-1), what that kernel is tested against in
    tests/test_fused_adjoint.py: a test patches it over
    ``pallas_hbm.chebyshev_apply_canvas_hbm`` to skip interpret mode."""
    n, c = pattern.n, pattern.c
    mH = jnp.ones((n, c)).at[0].set(0.0).at[n - 1].set(0.0)
    mV = jnp.ones((c, n)).at[:, 0].set(0.0).at[:, n - 1].set(0.0)
    mask = jnp.concatenate([mH.ravel(), mV.ravel(), jnp.ones(c * c)])
    return jlinalg.chebyshev(
        partial(jstencil.stencil_matvec, pattern, coeffs), mask * b_fam,
        bounds=bounds, iters=n_iters, precond=lambda r: inv_diag_fam * r).x


def rel_diff(a, b):
    """max|a - b| / max|b| of a torch tensor against an array."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the tests of a module that imports
    this fixture: their loops run many small ops, and several test workers
    on the CPU would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
