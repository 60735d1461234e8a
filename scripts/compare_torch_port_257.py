"""Final-state accuracy of the JAX package and the PyTorch port on the CPU,
float32, on the 257^2 main-path mesh (nt=1001, 'reference' convention,
BiCGStab scan path with tol 1e-6, as bench.py's check solver).

Run from the repository root (about 40 s):

    JAX_PLATFORMS=cpu python scripts/compare_torch_port_257.py

Prints one JSON line: both rel_l2 values and max|jax - port|.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu.models.crbe import CRBESolver as JaxSolver  # noqa: E402

MS, NT = 257, 1001
KW = dict(solver_tol=1e-6, solver_maxiter=100,
          stiffness_convention="reference", matvec_impl="stencil")

jmd = japt.MeshData(japt.create_mesh(MS, 20.0), japt.Domain(), nt=NT)
js = JaxSolver(japt.Domain(), japt.Problem(sigma=1.0), jmd, **KW)
js.solve(store_solutions=False)
tmd = tapt.MeshData(tapt.create_mesh(MS, 20.0), tapt.Domain(), nt=NT,
                    device="cpu")
ts = tapt.CRBESolver(tapt.Domain(), tapt.Problem(sigma=1.0), tmd,
                     device="cpu", **KW)
ts.solve(store_solutions=False)
print(json.dumps({
    "jax_cpu_rel_l2": js.compute_errors(japt.Problem().analytical_solution)[0],
    "port_cpu_rel_l2": ts.compute_errors(tapt.Problem().analytical_solution)[0],
    "max_abs_diff": float(np.abs(np.asarray(js.solutions[-1])
                                 - ts.solutions[-1].numpy()).max()),
}))
