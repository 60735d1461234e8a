"""Where a main-path solve of the PyTorch port spends its time on the GPU.

Profiles one warm ``CRBESolver.solve(store_solutions=False)`` of each
main-path configuration with ``torch.profiler`` (CPU and CUDA activity):
257^2, nt=1001, ``matvec_impl="fused"`` (kernel B1), Chebyshev-4
extrapolated, BE; and 1025^2, nt=1001, ``matvec_impl="fused_hbm"`` (kernel
B2), Chebyshev-8 extrapolated, BE; float32, 'reference' convention. From
the Chrome trace it takes the device's busy time (the union of kernel and
memory-operation intervals), the wall time of the solve, their ratio and
the device time of the top kernels by name; beside them, the host time to
build the MeshData and of the first (cold) solve, which assembles the
operator and estimates the Chebyshev interval. Prints one JSON line per
configuration and the card's name and power limit; writes the Chrome
traces to ``--out`` (default ``build/profiles``). Needs one CUDA card; run
from the repository root:

    python3 scripts/torch_port_profile.py [--out DIR]
"""

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
import chip_smoke as cs  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_and_top(trace_path, top=6):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"][:80]] += e["dur"]
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-3, [(n, us * 1e-3) for n, us in by_name.most_common(top)]


def profile(out, name, ms_mesh, problem, domain, **kw):
    t0 = time.perf_counter()
    md = apt.MeshData(apt.create_mesh(ms_mesh, 20.0), domain, nt=1001)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    s = apt.CRBESolver(domain, problem, md, stiffness_convention="reference",
                       solver_method="chebyshev", extrapolate_warm_start=True,
                       **kw)
    t0 = time.perf_counter()
    s.solve(store_solutions=False)  # assembly, interval, pattern, kernel
    first_solve_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        s.solve(store_solutions=False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out, f"profile_{name}.json")
    prof.export_chrome_trace(path)
    busy_ms, top = busy_and_top(path)
    print(json.dumps({"config": name, "mesh_setup_s": mesh_s,
                      "first_solve_s": first_solve_s, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms,
                      "top_device_ms": top}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join("build", "profiles"),
                        help="directory for the Chrome traces")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    domain, problem = apt.Domain(), apt.Problem(sigma=1.0)
    from airpollution_tpu_torch import _build

    _build.build(["uniform_solver.cu", "uniform_step.cu"])
    profile(args.out, "fused_257_be", 257, problem, domain,
            matvec_impl="fused", chebyshev_iters=4)
    profile(args.out, "fused_hbm_1025_be", 1025, problem, domain,
            matvec_impl="fused_hbm", chebyshev_iters=8)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
