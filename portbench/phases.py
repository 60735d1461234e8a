"""A cell's requests by the port's own phases, and what the port's tracing
costs, on the card (apart from the benchmark's runs):

    python3 portbench/phases.py --workload <cell> --seed <n> --seconds <s> \\
        [--pairs 2] [--out <dir>]

One process, one cell of ``BENCHMARK.json``, set up as ``run.py`` does:

1. the port's tracing (``airpollution_tpu_torch.utils.profiling``) is on
   from before set-up, and a snapshot is taken after it;
2. the cell's ``traced_requests`` run under ``torch.profiler`` with the
   harness's spans and the port's, reduced by :mod:`portbench.program`,
   with a snapshot over them;
3. the per-layer metrics read from the port's spans and counters
   (``metrics/<name>.py`` in :data:`METRICS`) from that context;
4. ``--pairs`` pairs of windows of ``--seconds`` with the port's tracing
   off and on (no profiler), in the order off, on, on, off, ...: each
   window's steps per second, and whether the last answers of the two
   kinds of window are equal bit for bit.

Prints one JSON object as the last line of standard output; with
``--out`` also writes it to ``<out>/phases_<cell>_<seed>.json``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

#: Per-layer metrics read from the port's spans and counters.
METRICS = ("request_prep_ms", "launch_host_us", "assembly_setup_s",
           "interval_setup_s")
#: Counters that must read 0 over the traced requests.
SETUP_ONLY = ("kernel_builds", "kernel_loads", "solve_fn_builds")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def traced_requests(system, n, spans, device):
    """``n`` requests under the profiler; returns the program's summary of
    them (:func:`portbench.program.summarize`)."""
    import torch

    from portbench import harness, program

    prof = harness._profiler()
    prof.start()
    for _ in range(n):
        with spans("request"):
            system.request()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    return program.summarize(program.raw_events(
        prof.profiler.kineto_results.events()))


def window(system, seconds, seed, traced_port):
    """One window with the port's tracing ``traced_port``; returns its
    steps per second, request count and last answer."""
    from airpollution_tpu_torch.utils import profiling
    from portbench import harness

    with profiling.tracing(traced_port):
        record = harness.measure(system, seconds, harness.Spans(False), 0,
                                 seed)
    profiling.reset()
    rate = (record["completed"] * system.steps_per_request
            / record["window_s"])
    return rate, record["attempted"], record["fields"][-1]


def run(cell, seed, seconds, pairs, device, *, bench=None, base=None):
    """The result object of one cell (``bench`` and ``base`` as in
    :func:`portbench.harness.run`)."""
    import torch

    from airpollution_tpu_torch.utils import profiling
    from portbench import harness, registry

    bench = bench or registry.benchmark()
    _, mix, config = registry.resolve(bench, cell, base)
    traffic = registry.load_module("traffic", mix["kind"], base)
    device = torch.device(device)
    spans = harness.Spans(annotate=True)
    profiling.reset()
    with profiling.tracing():
        with spans("context"):
            if device.type == "cuda":
                torch.cuda.set_device(device)
            torch.zeros(1, device=device).add_(1)
        system = traffic.setup(config, mix, seed, device, spans)
        with harness._profiler():
            torch.zeros(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        setup = profiling.snapshot()
        profiling.reset()
        summary = traced_requests(system, mix["traced_requests"], spans,
                                  device)
        win = profiling.snapshot()
    profiling.reset()
    ctx = {"cell": cell, "trace": summary,
           "program": {"setup": setup, "window": win},
           "steps_per_request": system.steps_per_request}
    metrics = {m: registry.load_module("metrics", m, base).read(ctx)
               for m in METRICS}
    rates = {"off": [], "on": []}
    last = {}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            rate, n, field = window(system, seconds, seed, on)
            key = "on" if on else "off"
            rates[key].append(rate)
            last[key] = field
            sys.stderr.write(f"{cell}: window with the port's tracing {key}:"
                             f" {n} requests, {rate!r} steps/s\n")
    same = (bool(torch.equal(last["on"], last["off"]))
            if len(last) == 2 else None)
    return {"cell": cell, "seed": seed, "card": harness.power_limit(),
            "setup_s": setup_s, "harness_spans": dict(spans.seconds),
            "metrics": metrics,
            "window_counters": {k: win["counters"].get(k, 0)
                                for k in SETUP_ONLY + ("guard_chunks",)},
            "window_kernels": win["kernels"], "setup_snapshot": setup,
            "window_spans": win["spans"], "trace": summary,
            "steps_per_s": rates, "on_equals_off": same}


def main(argv=None) -> int:
    args = parse(argv)
    result = run(args.workload, args.seed, args.seconds, args.pairs,
                 args.device)
    line = json.dumps(result)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"phases_{args.workload}_{args.seed}.json").write_text(line)
    t = result["trace"] or {}
    sys.stderr.write(
        f"{args.workload}: metrics {result['metrics']}; window counters "
        f"{result['window_counters']}; kernels {result['window_kernels']};"
        f" idle {t.get('idle_gaps')}; program {t.get('program')}; "
        f"joined {t.get('joined')}\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
