"""Shared set-up of the port's parity tests (tests/test_torch_port_*.py):
one structured mesh in both packages, and the JAX package's assembled
operator carried across as numpy arrays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import airpollution_tpu as japt
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
