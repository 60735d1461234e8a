"""The readings that a cell's limit is set from, on the card, in one process.

    python3 portbench/limits.py --workload <name> --seeds 11,12,13 \\
        [--requests 3] [--witness 1] [--fewer 1]

For each seed: the cell's set-up and ``--requests`` forecasts through the
timed path at the cell's own size, then the program's widest gap from the
plain reference (the lower reading), and the gap of the control: the
reference itself, its time loop run in bfloat16, the precision below the
configuration's float32 (the upper reading); with
``--witness 1`` two witnesses: the gap of the reference's time loop run
in float32, the configuration's own precision, and the gap of the program
itself run in float64 (the same path with no float32 rounding); with
``--fewer 1`` the gap of a looser solve, the fault the configurations'
fixed iteration counts rule out: the program with one solver iteration a
step fewer than the cell's. One JSON line per seed on standard output. The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell: str, seed: int, requests: int, witness: bool = False,
             fewer: bool = False, device="cuda:0", bench=None,
             base=None) -> dict:
    import torch

    from portbench import harness, registry

    bench = bench or registry.benchmark()
    _, mix, config = registry.resolve(bench, cell, base)
    traffic = registry.load_module("traffic", mix["kind"], base)
    system = traffic.setup(config, mix, seed, device,
                           harness.Spans(annotate=False))
    fields = [system.request() for _ in range(requests)]
    system.release_state()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    expect = system.reference()
    out = {"cell": cell, "seed": seed, "requests": requests,
           "program_gap": traffic.widest_gap(fields, expect),
           "reference_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    lower = system.reference(loop_dtype=torch.bfloat16)
    out["control_gap"] = traffic.widest_gap([lower], expect)
    out["control_s"] = time.perf_counter() - t0
    if witness:
        same = system.reference(loop_dtype=torch.float32)
        out["float32_reference_gap"] = traffic.widest_gap([same], expect)
        wide = traffic.setup(dict(config, precision="float64"), mix, seed,
                             device, harness.Spans(annotate=False))
        out["float64_program_gap"] = traffic.widest_gap([wide.request()],
                                                        expect)
        wide.release_state()
    if fewer:
        solver = dict(mix["solver"])
        key = ("chebyshev_iters" if solver["solver_method"] == "chebyshev"
               else "fused_iters")
        solver[key] -= 1
        loose = traffic.setup(config, dict(mix, solver=solver), seed, device,
                              harness.Spans(annotate=False))
        out["one_fewer_iteration_gap"] = traffic.widest_gap(
            [loose.request()], expect)
        loose.release_state()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--witness", type=int, choices=(0, 1), default=0)
    p.add_argument("--fewer", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.requests,
                                  bool(args.witness), bool(args.fewer))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
