"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``airpollution_tpu_torch``). Prints the numbers compared,
each beside its limit, as the last lines on standard error, and the result
as one JSON object on the last line of standard output. Exits with a code
other than 0, and prints no result, when there is no CUDA card or fewer
than the cell asks for, when the port is missing, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Every kernel cache at a fixed path inside the checkout, so that only the
# first run in a checkout builds. The port builds its CUDA libraries under
# build/kernels/ and its mesh library under build/native/ by itself.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness, registry

    bench = registry.benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        sys.stderr.write(f"no workload {args.workload!r} in BENCHMARK.json\n")
        return 2
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: the benchmark runs on the card\n")
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        sys.stderr.write(f"{args.workload} needs {chips[args.workload]} "
                         f"cards, {torch.cuda.device_count()} present\n")
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda:0", t_start=T_START,
                         bench=bench)
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"forbidden modules loaded: {', '.join(found)}\n")
        return 3
    sys.stderr.write("\n".join(harness.check_lines(result["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
