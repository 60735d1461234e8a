#!/usr/bin/env python3
"""Kernels B3 (stencil matvec) and B7 (ELL gather) of the parent tree
against this tree's, on one card, each tree in its own process, in turns
(parent, change, change, parent). The parent's package is unpacked from
a checkout, by default into build/parent_100e2c2:

    git archive 100e2c2 airpollution_tpu_torch | tar -x -C build/parent_100e2c2
    python3 scripts/torch_port_b3_b7_ab.py [--parent DIR] [--out FILE]

First this tree alone: its two sources compiled with ``-Xptxas -v``
(registers, spills), and B3 and B7 held against their plain versions at
65^2 and 257^2 in f64 and f32. Then, per tree, in f32 through the entry points both trees have
(``fused_stencil.stencil_matvec_fused``, ``gather.ell_matvec_vmem``,
``sparse.ell_matvec``, ``CRBESolver``): per product at 257^2 (B3 on C3's
operator, B7 on U1's unstructured system) and B7 at 1025^2, the time per
launch back to back (CUDA events), the host's enqueue time and the device
time alone (a CUDA graph of 200 launches, replayed), and cuSPARSE's CSR
product of the same matrix in the same process (back to back and
enqueue); C3b's steps/s (257^2, nt=65, BiCGStab, matvec_impl "pallas" and
"stencil") and U1's BE steps/s (257^2 unstructured, nt=1001). This tree
alone adds B3 through its bound operator (what its solves call per
product: the parent's solves call ``stencil_matvec_fused``, which this
tree binds anew on each call) and the cost of reading the current stream
two ways. Needs
one CUDA card and nvcc; prints the card's name and power limit first, one
JSON line per run, a summary last, and writes everything to ``--out``
(default build/ab/torch_port_b3_b7_ab.json).
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "AB_RESULT "


def _chip_smoke():
    """This tree's chip_smoke.py, for its helpers; it imports the port
    lazily, so it measures whichever tree is first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ptxas_report():
    """Registers, shared memory and spills of this tree's B3 and B7."""
    from airpollution_tpu_torch import _build

    out = {}
    for src in ("stencil_matvec.cu", "ell_gather.cu"):
        lib = ROOT / "build" / "ab" / f"ptxas_{src}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        run = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                              "-Xptxas", "-v", "-o", str(lib),
                              str(_build.CSRC / src)],
                             capture_output=True, text=True, check=True)
        out[src] = [line.strip() for line in run.stderr.splitlines()
                    if "registers" in line or "spill" in line]
    return out


def check_change(cs):
    """This tree's B3 and B7 against their plain versions (f64 1e-12, f32
    1e-5 of max|y|)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.ops import fused_stencil, gather, stencil

    out = {"ptxas": _ptxas_report(), "cases": []}
    problems = {"C1": apt.RotatingPlumeProblem(omega=0.05, D=0.3),
                "C3": cs.robin_obstacle_problem()}
    for ms in (65, 257):
        mesh = apt.create_mesh(ms, 20.0)
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            md = apt.MeshData(mesh, apt.Domain(), nt=33, dtype=dtype)
            x = torch.tensor(np.random.default_rng(0).standard_normal(
                md.number_of_segments), dtype=dtype, device=md.device)
            for pname, problem in problems.items():
                inp = cs.canvas_inputs(md, problem, 1, dtype, {})
                ref = stencil.stencil_matvec(inp["pattern"], inp["coeffs"],
                                             x)
                op = fused_stencil.StencilOperator(inp["pattern"],
                                                   inp["coeffs"])
                rel = cs.rel_err(op(x), ref)[1]
                out["cases"].append({"kernel": "B3", "ms": ms,
                                     "dtype": name, "problem": pname,
                                     "rel_err": rel})
                cs.check(rel <= cs.TOL[name],
                         f"B3 {ms}^2 {pname} {name}: {rel:.3e}")
            A = cs.ell_system(cs.unstructured_md(ms, 33, name))
            xa = torch.tensor(np.random.default_rng(1).standard_normal(
                A.n_rows), dtype=dtype, device=md.device)
            rel = cs.rel_err(gather.ell_matvec_vmem(A, xa),
                             gather.plain_matvec(A.vals, A.cols, xa))[1]
            out["cases"].append({"kernel": "B7a", "ms": ms, "dtype": name,
                                 "rel_err": rel})
            cs.check(rel <= cs.B7_TOL[name], f"B7 {ms}^2 {name}: {rel:.3e}")
    torch.cuda.synchronize()
    return out


def _times(cs, fn, reps=200, device=True):
    """Per call back to back, host enqueue and (with ``device``) the
    device alone, in ms."""
    out = {"ms": statistics.median(cs.cuda_ms(fn, reps) for _ in range(3)),
           "enqueue_ms": cs.enqueue_ms(fn, reps)}
    if device:
        out["device_ms"], out["device_timed_by"] = cs.graph_ms(fn, reps)
    return out


def _csr(A, dtype):
    import torch

    n, w = A.vals.shape
    return torch.sparse_csr_tensor(
        torch.arange(0, n * w + 1, w, device=A.vals.device),
        A.cols.reshape(-1), A.vals.reshape(-1).to(dtype), size=(n, n))


def _stream_costs(reps=20000):
    """Host µs per read of the current stream, two ways."""
    import torch

    ways = {"current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream}
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        ways["_cuda_getCurrentRawStream(current_device())"] = (
            lambda: raw(torch.cuda.current_device()))
    out = {}
    for name, fn in ways.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def measure(cs):
    """One tree's numbers (f32)."""
    import numpy as np
    import torch

    import airpollution_tpu_torch as apt
    from airpollution_tpu_torch.models.crbe import CRBESolver
    from airpollution_tpu_torch.ops import fused_stencil, gather, sparse
    from airpollution_tpu_torch.ops import stencil

    f32 = torch.float32
    change = hasattr(fused_stencil, "StencilOperator")
    out = {"tree": "change" if change else "parent"}
    domain = apt.Domain()

    # B3 at 257^2 on C3's operator.
    md = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=1001)
    inp = cs.canvas_inputs(md, cs.robin_obstacle_problem(), 1, f32, {})
    pattern, coeffs = inp["pattern"], inp["coeffs"]
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        md.number_of_segments), dtype=f32, device=md.device)
    ref = stencil.stencil_matvec(pattern, coeffs, x)
    out["b3_rel_err"] = cs.rel_err(
        fused_stencil.stencil_matvec_fused(pattern, coeffs, x), ref)[1]
    out["b3"] = _times(cs, lambda: fused_stencil.stencil_matvec_fused(
        pattern, coeffs, x))
    csr = _csr(inp["ops"].system, f32)
    xg = x[torch.as_tensor(pattern.inv_perm.astype("int64"),
                           device=md.device)]
    out["b3_csr"] = _times(cs, lambda: csr @ xg, device=False)
    if change:
        op = fused_stencil.StencilOperator(pattern, coeffs)
        out["b3_bound"] = _times(cs, lambda: op(x))
        out["stream_read_us"] = _stream_costs()
    del inp, csr

    # B7 at 257^2 and 1025^2 on U1's operator.
    md_u = {}
    for ms in (257, 1025):
        md_u[ms] = cs.unstructured_md(ms, 1001, "float32")
        A = cs.ell_system(md_u[ms])
        n, w = A.vals.shape
        xa = torch.tensor(np.random.default_rng(1).standard_normal(n),
                          dtype=f32, device=md.device)
        out[f"b7_{ms}_rel_err"] = cs.rel_err(
            gather.ell_matvec_vmem(A, xa),
            gather.plain_matvec(A.vals, A.cols, xa))[1]
        out[f"b7_{ms}"] = _times(cs, lambda: gather.ell_matvec_vmem(A, xa))
        out[f"b7_{ms}_ell_matvec"] = _times(
            cs, lambda: sparse.ell_matvec(A, xa))
        csr = _csr(A, f32)
        out[f"b7_{ms}_csr"] = _times(cs, lambda: csr @ xa, device=False)
        out[f"b7_{ms}_bound_ms"] = cs.bound(cs.b7_bytes(n, w, 4), 2 * n * w)[0]
        del A, csr
    del md_u[1025]

    # C3b: the scan path through B3, and through the plain stencil.
    md65 = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=65)
    for impl in ("pallas", "stencil"):
        s = CRBESolver(domain, cs.robin_obstacle_problem(), md65,
                       solver_tol=1e-6, solver_maxiter=100, matvec_impl=impl)
        times = cs.timed_solves(s, 5)
        out[f"c3b_{impl}_steps_per_s"] = (md65.nt - 1) / min(times)
        out[f"c3b_{impl}_steps_per_s_median"] = (
            (md65.nt - 1) / statistics.median(times))
        out[f"c3b_{impl}_final"] = s.solutions[-1].clone()
    out["c3b_max_pallas_minus_stencil"] = float(
        (out.pop("c3b_pallas_final") - out.pop("c3b_stencil_final"))
        .abs().max())

    # U1, BE: the unstructured 257^2 solve on B7.
    s = CRBESolver(domain, apt.Problem(sigma=1.0), md_u[257],
                   matvec_impl="auto", time_scheme_order=1)
    times = cs.timed_solves(s, 3, warm_up=False)
    out["u1_be_steps_per_s"] = (md_u[257].nt - 1) / min(times)
    out["u1_be_steps_per_s_median"] = ((md_u[257].nt - 1)
                                       / statistics.median(times))
    out["u1_be_rel_l2"] = s.compute_errors(
        apt.Problem(sigma=1.0).analytical_solution)[0]
    return out


def worker(tree, check):
    sys.path.insert(0, str(Path(tree).resolve()))
    cs = _chip_smoke()
    result = check_change(cs) if check else measure(cs)
    print(TAG + json.dumps(result), flush=True)
    return 0


def run(tree, check=False):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(tree)] + (["--check"] if check else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(tree)))
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith(TAG))
    result = json.loads(line[len(TAG):])
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)
    return result


SUMMARY = ["b3.ms", "b3.enqueue_ms", "b3.device_ms", "b3_bound.ms",
           "b3_bound.enqueue_ms", "b3_bound.device_ms", "b3_csr.ms", "b3_csr.enqueue_ms",
           "b7_257.ms", "b7_257.enqueue_ms", "b7_257.device_ms",
           "b7_257_ell_matvec.ms", "b7_257_ell_matvec.enqueue_ms",
           "b7_257_csr.ms", "b7_257_bound_ms",
           "b7_1025.ms", "b7_1025.enqueue_ms", "b7_1025.device_ms",
           "b7_1025_csr.ms", "b7_1025_bound_ms",
           "c3b_pallas_steps_per_s", "c3b_stencil_steps_per_s",
           "u1_be_steps_per_s"]


def _get(result, key):
    head, _, tail = key.partition(".")
    value = result.get(head)
    return value.get(tail) if tail and isinstance(value, dict) else value


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=str(ROOT / "build" /
                                            "parent_100e2c2"))
    ap.add_argument("--out", default=str(ROOT / "build" / "ab" /
                                         "torch_port_b3_b7_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.check)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_b3_b7_ab: no CUDA device", file=sys.stderr)
        return 1
    parent = Path(args.parent)
    if not (parent / "airpollution_tpu_torch").is_dir():
        print(f"no parent tree at {parent}: unpack one with git archive",
              file=sys.stderr)
        return 1
    card = _chip_smoke().card_line()
    print(card, flush=True)
    results = {"card": card, "check": run(ROOT, check=True), "runs": []}
    for tree in (parent, ROOT, ROOT, parent):
        results["runs"].append(run(tree))
    summary = {}
    for key in SUMMARY:
        row = {}
        for tag in ("parent", "change"):
            vals = [_get(r, key) for r in results["runs"]
                    if r["tree"] == tag and _get(r, key) is not None]
            row[tag] = vals
        summary[key] = row
    results["summary"] = summary
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(card, flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
