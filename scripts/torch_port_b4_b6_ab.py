#!/usr/bin/env python3
"""Kernels B4 (with its load, raw and block modes) and B6 (with its block
mode) of another tree against this tree's, in one process on one card.

    python3 scripts/torch_port_b4_b6_ab.py PARENT_DIR [--out FILE]
    python3 scripts/torch_port_b4_b6_ab.py --sweep [--out FILE]

PARENT_DIR holds the other tree's airpollution_tpu_torch/csrc (a `git
archive <commit> airpollution_tpu_torch | tar -x -C build/parent_<commit>`;
build/ is git-ignored). Both trees' canvas_step.cu and multispecies_step.cu
are compiled with nvcc (each in its own C++ namespace, ``-Xptxas -v``),
then each main path's step is timed in turns (parent, change, change,
parent) with CUDA events (ms per launch, back to back) and as a CUDA graph
of 200 launches (device time alone): B4 at C1's shape (1025^2, k=14, BE,
extrapolated), B4 with a load at P1's (1025^2, k=8, CN, extrapolated) and
P2's (513^2), B4's raw mode at I1's (513^2, k=12), B6 at M1's (1025^2,
K=3, k=8, CN, one load), and one interior block of 4 of B9 (C1) and B10
(M1). Each line says whether the two outputs are bit-equal, else the
largest |difference| over max|u|.

--sweep builds this tree's kernels at other launch shapes (threads per
block x window cells per thread, ``-D CANVAS_THREADS_F32=...``), prints
each build's registers and spills, and times every (tile, depth) plan that
fits each shape at each main-path shape, beside the plan
ops/fused_hbm.canvas_plan picks.

Needs one CUDA card and nvcc; prints JSON lines, the card's name and power
limit first.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402

VP, I = ctypes.c_void_p, ctypes.c_int
IP = ctypes.POINTER(ctypes.c_int)
# Entry points and argument types: the parent's (a halo and a block size)
# and this tree's (a depth and a work buffer).
PARENT_ARGS = {
    "crbe_canvas_step_f32": [VP] * 8 + [I] * 10 + [VP],
    "crbe_canvas_step_raw_f32": [VP] * 4 + [I] * 9 + [VP],
    "crbe_canvas_block_step_f32": [VP] * 8 + [I] * 13 + [VP],
    "crbe_multispecies_step_f32": [VP] * 6 + [IP] + [I] * 11 + [VP],
    "crbe_multispecies_block_step_f32": [VP] * 6 + [IP] + [I] * 14 + [VP],
}
CHANGE_ARGS = {
    "crbe_canvas_step_f32": [VP] * 9 + [I] * 9 + [VP],
    "crbe_canvas_step_raw_f32": [VP] * 5 + [I] * 8 + [VP],
    "crbe_canvas_block_step_f32": [VP] * 9 + [I] * 13 + [VP],
    "crbe_multispecies_step_f32": [VP] * 7 + [IP] + [I] * 10 + [VP],
    "crbe_multispecies_block_step_f32": [VP] * 7 + [IP] + [I] * 14 + [VP],
}
SHAPES = ((512, 4), (384, 6), (384, 5), (256, 8), (256, 6), (128, 8))
F32 = torch.float32


def build(tag, csrc, defines=()):
    """Compile csrc's canvas_step.cu and multispecies_step.cu into
    build/ab/<tag>/; returns {source: (library, [(kernel, registers,
    spill bytes, stack bytes)])}."""
    out_dir = ROOT / "build" / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(src):
        lib = out_dir / f"lib{Path(src).stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               f"-Dcrbe=crbe_{tag}", *defines, "-o", str(lib),
               str(Path(csrc) / src)]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc {tag} {src}:\n{run.stderr[-4000:]}")
        return src, (lib, ptxas_summary(run.stderr))

    with ThreadPoolExecutor(2) as pool:
        return dict(pool.map(one, ("canvas_step.cu", "multispecies_step.cu")))


def ptxas_summary(log):
    """(kernel, registers, spill store bytes, stack frame bytes) per
    kernel of ptxas's -v report."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((demangle(name), int(m.group(1)), spill, stack))
            name = None
    return rows


def demangle(sym):
    out = subprocess.run(["c++filt", sym], capture_output=True, text=True)
    text = out.stdout.strip() or sym
    return text.split("(")[0].replace("crbe_", "")


def bind(libs, args):
    fns = {}
    for src, (lib, _) in libs.items():
        handle = ctypes.CDLL(str(lib))
        for sym, types in args.items():
            if hasattr(handle, sym):
                fn = getattr(handle, sym)
                fn.argtypes = types
                fn.restype = ctypes.c_int
                fns[sym] = fn
    return fns


def call(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__}: launch error {err}")


def main_cases():
    """The main paths' inputs: B4 (C1), B4 with a load (P1, P2), B4's raw
    mode (I1), B6 (M1), one interior block of 4 of B9 and B10."""
    cache = {}
    dom = apt.Domain()
    md = {1025: apt.MeshData(apt.create_mesh(1025, 20.0), dom, nt=1001),
          513: apt.MeshData(apt.create_mesh(513, 20.0), dom, nt=1001)}
    md_i1 = apt.MeshData(apt.create_mesh(513, 20.0), dom,
                         nt=cs.I1["nt"])
    cases = {}
    inp = cs.canvas_inputs(md[1025], apt.RotatingPlumeProblem(
        omega=0.05, D=0.3), 1, F32, cache)
    C, cheb, u, _ = cs.canvas_step_inputs(inp, cs.C1_ITERS, F32)
    cases["B4 C1"] = dict(kind="step", C=C, cheb=cheb, u=u, up=u * 0.9,
                          k=cs.C1_ITERS, use_ka=False, rect=inp["rect"],
                          load=None)
    blocks = cs.block_rows(u.shape[-1], 4, cs.C1_ITERS, False)
    cases["B9 C1"] = dict(kind="block", C=blocks.split(C)[1], cheb=cheb,
                          u=blocks.split(u)[1], up=blocks.split(u * 0.9)[1],
                          k=cs.C1_ITERS, use_ka=False, rect=inp["rect"],
                          load=None, block=blocks.blocks[1])
    problem = cs.scenario_problem()
    for name, ms in (("P1", 1025), ("P2", 513)):
        inp = cs.canvas_inputs(md[ms], problem, 2, F32, cache)
        C, cheb, u, masks = cs.canvas_step_inputs(inp, 8, F32)
        (load,), _ = cs.step_loads(inp, md[ms], problem, 1, True, C, masks,
                                   True, F32)
        cases[f"B4-load {name}"] = dict(
            kind="step", C=C, cheb=cheb, u=u + 0.01 * masks,
            up=u, k=8, use_ka=True, rect=inp["rect"], load=load)
    inp, C = cs.raw_inputs(md_i1, cs.i1_problem(), F32, cache, False)
    k = cs.I1["chebyshev_iters"]
    n = md_i1.structured_n
    b = torch.tensor(np.random.default_rng(1).standard_normal((3, n, n)),
                     dtype=F32, device=C.device)
    cheb = fused_solver.cheb_scalars(inp["bounds"], k, F32, C.device)
    cases["B4-raw I1"] = dict(kind="raw", C=C, cheb=cheb, u=b, k=k,
                              rect=inp["rect"])
    K, k = 3, cs.DEMO_ITERS[1025]
    inp = cs.canvas_inputs(md[1025], apt.Problem(v=(1.0, 0.2), D=0.3,
                                                 sigma=1.0), 2, F32, cache)
    case = cs.b6_case(inp, md[1025], K, k, 2, F32, cs.demo_species(1)[0],
                      True)
    cases["B6 M1"] = dict(kind="ms", C=case["C"], scal=case["scal"],
                          u=case["U"], k=k, use_ka=True, rect=inp["rect"],
                          loads=case["loads"], index=case["index"])
    nn = md[1025].structured_n
    blocks = cs.block_rows(nn, 4, k, True)
    cases["B10 M1"] = dict(
        kind="msblock", C=blocks.split(case["C"])[1], scal=case["scal"],
        u=blocks.split(case["U"].reshape(3 * K, nn, nn))[1].reshape(
            K, 3, blocks.rows, nn).contiguous(),
        k=k, use_ka=True, rect=inp["rect"],
        loads=blocks.split(case["loads"])[1].contiguous(),
        index=case["index"], block=blocks.blocks[1])
    return cases


def launcher(fns, case, plan=None):
    """A closure launching ``case`` once through the parent's entry points
    (plan None) or this tree's with ``plan``, holding the buffers whose
    pointers it passes; and its output tensor."""
    P = _build.pointer
    s = _build.current_stream
    c = case
    out = torch.empty_like(c["u"])
    k, rect = c["k"], c["rect"]
    n = c["u"].shape[-1]
    parent = plan is None
    if c["kind"] in ("step", "block"):
        up_out = torch.empty_like(c["u"])
        halt = torch.tensor(-1, dtype=torch.int32, device=out.device)
        halo = k + int(c["use_ka"])
        work = None if parent else fused_hbm.work_buffer(plan, c["u"])
        keep = (up_out, halt, work)  # alive as long as the launcher
        head = [P(c["C"]), P(c["cheb"]), P(c["u"]), P(c["up"]), P(out),
                P(up_out), P(halt), P(c["load"])]
        if c["kind"] == "step":
            fn = fns["crbe_canvas_step_f32"]
            if parent:
                args = head + [n, 32, halo, k, int(c["use_ka"]), *rect, 512]
            else:
                args = head + [P(work), n, plan.tile, plan.depth, k,
                               int(c["use_ka"]), *rect]
        else:
            fn = fns["crbe_canvas_block_step_f32"]
            blk = c["block"].kernel_args()
            if parent:
                args = head + [*blk, 32, halo, k, int(c["use_ka"]), *rect]
            else:
                args = head + [P(work), *blk, plan.tile, plan.depth, k,
                               int(c["use_ka"]), *rect]
        return (lambda keep=keep: call(fn, *args, s())), out
    if c["kind"] == "raw":
        fn = fns["crbe_canvas_step_raw_f32"]
        if parent:
            args = [P(c["C"]), P(c["cheb"]), P(c["u"]), P(out), n, 32, k - 1,
                    k, *rect, 512]
        else:
            work = fused_hbm.work_buffer(plan, c["u"])
            args = [P(c["C"]), P(c["cheb"]), P(c["u"]), P(out), P(work), n,
                    plan.tile, plan.depth, k, *rect]
        keep = None if parent else work
        return (lambda keep=keep: call(fn, *args, s())), out
    K = c["u"].shape[0]
    index = (ctypes.c_int * K)(*c["index"])
    halo = k + int(c["use_ka"])
    head = [P(c["C"]), P(c["scal"]), P(c["u"]), P(c["loads"]), P(out), None]
    keep = None if parent else fused_hbm.work_buffer(plan, c["u"], K)
    if not parent:
        head.append(P(keep))
    if c["kind"] == "ms":
        fn = fns["crbe_multispecies_step_f32"]
        if parent:
            args = head + [index, K, n, 32, halo, k, 1, *rect, 512]
        else:
            args = head + [index, K, n, plan.tile, plan.depth, k, 1, *rect]
    else:
        fn = fns["crbe_multispecies_block_step_f32"]
        blk = c["block"].kernel_args()
        if parent:
            args = head + [index, K, *blk, 32, halo, k, 1, *rect]
        else:
            args = head + [index, K, *blk, plan.tile, plan.depth, k, 1,
                           *rect]
    return (lambda keep=keep: call(fn, *args, s())), out


def plan_of(case):
    if case["kind"] == "raw":
        return fused_hbm.raw_plan(case["k"], F32)
    if case["kind"] in ("ms", "msblock"):
        return fused_hbm.multispecies_plan(case["u"].shape[0], case["k"],
                                           case["use_ka"], F32)
    return fused_hbm.canvas_plan(case["k"], case["use_ka"], F32)


def compare(a, b, case):
    """None when a and b are bit-equal (on the written rows), else
    max|a - b| / max|b|."""
    if case["kind"] in ("block", "msblock"):
        blk = case["block"]
        sl = slice(blk.halo, blk.halo + blk.local)
        a, b = a[..., sl, :], b[..., sl, :]
    if torch.equal(a, b):
        return None
    return float((a - b).abs().max() / b.abs().max())


def ab(parent_dir, out):
    parent = bind(build("old", Path(parent_dir) /
                        "airpollution_tpu_torch" / "csrc"), PARENT_ARGS)
    libs = build("new", _build.CSRC)
    emit({"ptxas_change": {s: r for s, (_, r) in libs.items()}}, out)
    change = bind(libs, CHANGE_ARGS)
    for name, case in main_cases().items():
        plan = plan_of(case)
        runs = {"parent": launcher(parent, case),
                "change": launcher(change, case, plan)}
        for fn, _ in runs.values():
            fn()
        torch.cuda.synchronize()
        row = {"case": name, "plan": plan,
               "diff_over_max": compare(runs["change"][1],
                                        runs["parent"][1], case)}
        row["bit_equal"] = row["diff_over_max"] is None
        ms = {"parent": [], "change": []}
        dev = {"parent": [], "change": []}
        for tag in ("parent", "change", "change", "parent"):
            ms[tag].append(cs.cuda_ms(runs[tag][0], 50))
            dev[tag].append(cs.graph_ms(runs[tag][0])[0])
        row.update(ms=ms, device_ms=dev)
        emit(row, out)


def sweep(out):
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        builds = list(pool.map(
            lambda sh: build(f"t{sh[0]}c{sh[1]}", _build.CSRC,
                             (f"-DCANVAS_THREADS_F32={sh[0]}",
                              f"-DCANVAS_CELLS_F32={sh[1]}")), SHAPES))
    cases = main_cases()
    for (threads, cells), libs in zip(SHAPES, builds):
        emit({"shape": [threads, cells],
              "ptxas": {s: r for s, (_, r) in libs.items()}}, out)
        fns = bind(libs, CHANGE_ARGS)
        for name, case in cases.items():
            raw = case["kind"] == "raw"
            K = case["u"].shape[0] if case["kind"] in ("ms", "msblock") \
                else None
            use_ka = case.get("use_ka", False)
            rows = []
            for depth in range(1, fused_hbm.MAX_DEPTH + 1):
                for tile in fused_hbm.PLAN_TILES:
                    plan = fused_hbm.CanvasPlan(tile, depth)
                    if not fused_hbm.plan_fits(plan, case["k"], use_ka, F32,
                                               raw=raw, n_species=K,
                                               shape=(threads, cells)):
                        continue
                    run, _ = launcher(fns, case, plan)
                    rows.append((tile, depth, cs.cuda_ms(run, 30)))
            best = min(rows, key=lambda r: r[2]) if rows else None
            emit({"shape": [threads, cells], "case": name,
                  "planner": plan_of(case), "best": best,
                  "plans_ms": rows}, out)


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available() or (a.parent is None) != a.sweep:
        print(__doc__, file=sys.stderr)
        return 1
    emit({"card": cs.card_line()}, a.out)
    if a.sweep:
        sweep(a.out)
    else:
        ab(a.parent, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
