"""Final-state accuracy of the JAX package and the PyTorch port on the CPU,
float32, for the rotating-wind canvas configuration C1 at 257^2:
RotatingPlumeProblem(omega=0.05, D=0.3), nt=1001, the scan path
(matvec_impl="stencil") with Chebyshev-6 and the extrapolated warm start,
BE. The accuracy reference for the card's C1 (1025^2, kernel B4) and C2
(257^2, kernel B5).

Run from the repository root (a minute or two):

    JAX_PLATFORMS=cpu python scripts/compare_torch_port_canvas.py

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
from airpollution_tpu.problems import RotatingPlumeProblem  # noqa: E402

MS, NT = 257, 1001
KW = dict(matvec_impl="stencil", solver_method="chebyshev",
          chebyshev_iters=6, extrapolate_warm_start=True)

jp = RotatingPlumeProblem(omega=0.05, D=0.3)
jmd = japt.MeshData(japt.create_mesh(MS, 20.0), japt.Domain(), nt=NT)
js = JaxSolver(japt.Domain(), jp, jmd, **KW)
js.solve(store_solutions=False)
tp = tapt.RotatingPlumeProblem(omega=0.05, D=0.3)
tmd = tapt.MeshData(tapt.create_mesh(MS, 20.0), tapt.Domain(), nt=NT,
                    device="cpu")
ts = tapt.CRBESolver(tapt.Domain(), tp, tmd, device="cpu", **KW)
ts.solve(store_solutions=False)
print(json.dumps({
    "jax_cpu_rel_l2": js.compute_errors(jp.analytical_solution)[0],
    "port_cpu_rel_l2": ts.compute_errors(tp.analytical_solution)[0],
    "max_abs_diff": float(np.abs(np.asarray(js.solutions[-1])
                                 - ts.solutions[-1].numpy()).max()),
}))
