"""Two checks behind the multispecies port's findings, on the CPU in f64.

1. Emission loads on obstacle dead DOFs under the reference quadrature:
   the JAX package's fused Strang path (kernel B6 in interpret mode), its
   ELL scan, and the port's fused path (B6's plain version) on one problem
   (a Gaussian emitter and a plume behind a block with 3 dead DOFs, ms=12,
   nt=5, Domain(T=1), Chebyshev-12), BE and CN, under both source
   quadratures. Prints max |u| on the dead DOFs of each and the largest
   live-DOF difference from the JAX scan.
2. The chemistry half-step exponential expm(-dt/2 R) of the same problem:
   torch.linalg.matrix_exp, the JAX package's expm and the port's
   problems.expm64 against scipy's expm.

Run from the repository root:
    JAX_PLATFORMS=cpu python scripts/torch_port_multispecies_checks.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.scipy.linalg

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import scipy.linalg
import torch

import airpollution_tpu as japt
from airpollution_tpu import problems as jp
from airpollution_tpu.models.crbe import obstacle_masks
from airpollution_tpu.models.multispecies import MultiSpeciesSolver as JSolver

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.problems import expm64

BLOCK = ((-5.0, 1.0, -3.0, 3.0),)
R = np.array([[0.3, -0.1], [-0.2, 0.4]])


def species(mod):
    src = mod.GaussianSourceProblem(q=2.0, xs=-2.0, ys=0.0, sigma_s=4.0)
    plume = mod.Problem(sigma=2.0)
    for sp in (src, plume):
        sp.obstacles = BLOCK
    return src, plume


def dead_dofs(order, quadrature, ms=12, nt=5):
    kw = dict(time_scheme_order=order, source_quadrature=quadrature,
              splitting="strang", solver_method="chebyshev",
              chebyshev_iters=12)
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(T=1.0),
                        nt=nt, dtype=jax.numpy.float64)
    jms = jp.MultiSpeciesProblem(species(jp), R)
    dead = np.asarray(obstacle_masks(jmd, jms.species[0])[1])
    fused = JSolver(japt.Domain(T=1.0), jms, jmd, matvec_impl="fused_hbm",
                    **kw)
    u_fused = np.asarray(fused.solve(store_solutions=False))[0]
    ell = JSolver(japt.Domain(T=1.0), jms, jmd, matvec_impl="ell", **kw)
    u_ell = np.asarray(ell.solve(store_solutions=False))[0]

    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(T=1.0),
                        nt=nt, dtype=torch.float64, device="cpu")
    tms = tapt.MultiSpeciesProblem(species(tapt), R)
    port = tapt.MultiSpeciesSolver(tapt.Domain(T=1.0), tms, tmd,
                                   matvec_impl="fused_hbm", device="cpu",
                                   cheb_bounds=fused._fused_bounds_cache[1],
                                   **kw)
    u_port = port.solve(store_solutions=False)[0].numpy()
    live = ~dead
    return {
        "order": order, "quadrature": quadrature,
        "dead_dofs": int(dead.sum()),
        "jax_b6_dead_max": float(np.abs(u_fused[:, dead]).max()),
        "jax_ell_dead_max": float(np.abs(u_ell[:, dead]).max()),
        "port_b6_dead_max": float(np.abs(u_port[:, dead]).max()),
        "jax_b6_vs_ell_live": float(np.abs(u_fused[:, live]
                                           - u_ell[:, live]).max()),
        "port_b6_vs_jax_ell_live": float(np.abs(u_port[:, live]
                                                - u_ell[:, live]).max()),
    }


def half_step_exponential(dt=1.0 / 4):
    A = -(0.5 * dt) * R
    ref = scipy.linalg.expm(A)
    return {
        "dt": dt,
        "torch_matrix_exp_err": float(np.abs(
            torch.linalg.matrix_exp(torch.tensor(A)).numpy() - ref).max()),
        "jax_expm_err": float(np.abs(np.asarray(
            jax.scipy.linalg.expm(jax.numpy.asarray(A))) - ref).max()),
        "expm64_err": float(np.abs(expm64(A).numpy() - ref).max()),
        "torch": torch.__version__,
    }


if __name__ == "__main__":
    for order in (1, 2):
        for quadrature in ("reference", "mass_lumped"):
            print(json.dumps(dead_dofs(order, quadrature)), flush=True)
    for dt in (1.0 / 4, 2.0 / 16):
        print(json.dumps(half_step_exponential(dt)), flush=True)
