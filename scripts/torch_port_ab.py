#!/usr/bin/env python3
"""The uniform step (B1, B2, B8, with their loads) and the BiCGStab whole
loop (B5, B1's BiCGStab variant) of another tree against this tree's, in
one process on one card.

    python3 scripts/torch_port_ab.py PARENT_DIR [--out FILE]
    python3 scripts/torch_port_ab.py --sweep [--threads 512,640] [--out FILE]

PARENT_DIR holds the other tree's airpollution_tpu_torch/csrc (a `git
archive <commit> airpollution_tpu_torch | tar -x -C build/parent_<commit>`;
build/ is git-ignored). Both trees' uniform_solver.cu, uniform_step.cu,
canvas_solver.cu and uniform_bicgstab.cu are compiled with nvcc (each in
its own C++ namespace, ``-Xptxas -v``), checked for bit-equal output,
and timed in turns (parent, change, change, parent) at
the main paths' shapes, f32: B1, one 257^2 solve of 1000 steps
(Chebyshev-4, BE, extrapolated) and with S1's steady load plane; B2, one
1025^2 step (Chebyshev-8, BE, extrapolated) and S2's 513^2 step with its
load (Chebyshev-4); B8, one interior block of 4 at 2049^2 (Chebyshev-10,
BE, extrapolated), with and without S1's load, and the 4 blocks' launches
of one step beside one whole-canvas B2 launch; B5, one C2 solve (257^2,
1000 steps, BiCGStab-5, BE, extrapolated, the rotating wind) and B1's
BiCGStab variant at S3's (the plume). Steps are timed back to back (ms per
launch) and as a CUDA graph of 200 launches (device time alone); the whole
loops back to back. Each line says whether the two outputs are bit-equal,
else the largest |difference| over max|u| (a block's interior rows: its
halo rows are not written).

--sweep builds this tree's uniform step at each block size of --threads
(default 384-1,024; ``-DUNIFORM_THREADS_F32=...``), prints each build's
registers and spills, and times every plan ops/fused_solver.uniform_plan
chooses from (tiles of UNIFORM_EDGES rows and columns, balanced over the
live cells) that fits each build at each step's main-path shape, each with
its uniform_cost; at 512 threads it then times the planner's pick and the
fastest plan again in turns (back to back and device alone). Then the
empty-barrier floor of the BiCGStab loop (16 and 27 barriers per step of
a 1000-step solve on its 130-block grid, its hand-built barrier and
cooperative groups' grid sync, from scripts/torch_port_barrier_floor.cu),
each BiCGStab kernel at every cells-per-thread mode its register capacity
allows and in global mode at 257^2, B1's BiCGStab variant at 321^2 (2
cells per thread) against global mode, and both loops at 513^2 at their
planned mode.

Needs one CUDA card and nvcc; prints JSON lines, the card's name and power
limit first.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402
from scripts.torch_port_b4_b6_ab import ptxas_summary  # noqa: E402

VP, I = ctypes.c_void_p, ctypes.c_int
IP = ctypes.POINTER(ctypes.c_int)
UP = ctypes.POINTER(ctypes.c_uint)
FLOOR_SOURCE = ROOT / "scripts" / "torch_port_barrier_floor.cu"
F32 = torch.float32
SOURCES = ("uniform_solver.cu", "uniform_step.cu", "canvas_solver.cu",
           "uniform_bicgstab.cu")
# Entry points and argument types: the parent's (a square tile, a halo and
# a block size) and this tree's (a plan's tile rows, columns and depth, a
# work buffer, cells per thread for the BiCGStab loops).
PARENT_ARGS = {
    "crbe_uniform_solve_f32": [VP] * 5 + [I] * 7 + [VP, IP],
    "crbe_uniform_solve_load_f32": [VP] * 6 + [I] * 8 + [VP, IP],
    "crbe_uniform_step_f32": [VP] * 6 + [I] * 6 + [VP],
    "crbe_uniform_step_load_f32": [VP] * 7 + [I] * 6 + [VP],
    "crbe_uniform_block_step_f32": [VP] * 6 + [I] * 9 + [VP],
    "crbe_uniform_block_step_load_f32": [VP] * 7 + [I] * 9 + [VP],
    "crbe_canvas_solve_f32": [VP] * 5 + [I] * 5 + [VP, IP],
    "crbe_uniform_bicgstab_f32": [VP] * 6 + [I] * 6 + [VP, IP],
}
CHANGE_ARGS = {
    "crbe_uniform_solve_f32": [VP] * 6 + [I] * 7 + [VP, IP],
    "crbe_uniform_solve_load_f32": [VP] * 7 + [I] * 8 + [VP, IP],
    "crbe_uniform_step_f32": [VP] * 7 + [I] * 6 + [VP],
    "crbe_uniform_step_load_f32": [VP] * 8 + [I] * 6 + [VP],
    "crbe_uniform_block_step_f32": [VP] * 7 + [I] * 10 + [VP],
    "crbe_uniform_block_step_load_f32": [VP] * 8 + [I] * 10 + [VP],
    "crbe_canvas_solve_f32": [VP] * 5 + [I] * 5 + [VP, IP],
    "crbe_uniform_bicgstab_f32": [VP] * 6 + [I] * 6 + [VP, IP],
    "crbe_barrier_floor": [UP, I, I, I, VP],
}


def build(tag, csrc, sources=SOURCES, defines=()):
    """Compile ``sources`` (names in csrc, or paths) into build/ab/<tag>/,
    with csrc on the include path; returns {source: (library, [(kernel,
    registers, spill bytes, stack bytes)])}."""
    out_dir = ROOT / "build" / "ab" / tag
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(src):
        lib = out_dir / f"lib{Path(src).stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               f"-Dcrbe=crbe_{tag}", *defines, "-I", str(csrc), "-o",
               str(lib), str(Path(csrc) / src)]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc {tag} {src}:\n{run.stderr[-4000:]}")
        return src, (lib, ptxas_summary(run.stderr))

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


def bind(libs, args):
    fns = {}
    for _, (lib, _) in libs.items():
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


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def compare(a, b):
    """None when a and b are bit-equal, else max|a - b| / max|b|."""
    if torch.equal(a, b):
        return None
    return float((a - b).abs().max() / b.abs().max())


def main_cases(loops_only=False):
    """The main paths' inputs (f32), keyed by case name (``loops_only``:
    the BiCGStab loops' alone)."""
    dom = apt.Domain()
    problem = apt.Problem(sigma=1.0)
    sizes = (257,) if loops_only else (257, 513, 1025, 2049)
    md = {ms: apt.MeshData(apt.create_mesh(ms, 20.0), dom, nt=1001)
          for ms in sizes}
    cases = {}
    n_steps = 1000
    if loops_only:
        return _loop_cases(md[257], n_steps, cases)
    scal, u3 = cs.uniform_inputs(md[257], problem, 1, 4, F32)
    cases["B1"] = dict(kind="solve", scal=scal, u=u3, k=4, steps=n_steps,
                       load=None)
    scal, u3 = cs.uniform_inputs(md[257], cs.plume(), 1, cs.S_ITERS, F32)
    cases["B1-load S1"] = dict(
        kind="solve", scal=scal, u=u3, k=cs.S_ITERS, steps=n_steps,
        load=cs.uniform_load(md[257], scal, 1, cs.s_source(), n_steps, F32))
    scal, u = cs.uniform_inputs(md[1025], problem, 1, 8, F32)
    cases["B2"] = dict(kind="step", scal=scal, u=u, up=u * 0.9, k=8,
                       load=None)
    scal, u = cs.uniform_inputs(md[513], cs.plume(), 1, cs.S_ITERS, F32)
    cases["B2-load S2"] = dict(
        kind="step", scal=scal, u=u, up=u * 0.9, k=cs.S_ITERS,
        load=cs.uniform_load(md[513], scal, 1, cs.s_source(), 1, F32))
    k = cs.B8_ITERS
    scal, u = cs.patch_inputs(md[2049], k, F32)
    blocks = cs.block_rows(u.shape[-1], 4, k, False)
    U, UP_ = blocks.split(u), blocks.split(u * 0.9)
    plane = blocks.split(cs.uniform_load(md[2049], scal, 1, cs.s_source(), 1,
                                         F32))
    for name, load in (("B8", None), ("B8-load", plane)):
        cases[name] = dict(kind="block", scal=scal, u=U[1].contiguous(),
                           up=UP_[1].contiguous(), k=k,
                           load=None if load is None else
                           load[1].contiguous(), block=blocks.blocks[1])
    cases["B8 x4 blocks"] = dict(kind="blocks", scal=scal, u=U, up=UP_, k=k,
                                 blocks=blocks)
    cases["B2 2049"] = dict(kind="step", scal=scal, u=u, up=u * 0.9, k=k,
                            load=None)
    return _loop_cases(md[257], n_steps, cases)


def _loop_cases(md, n_steps, cases):
    inp = cs.canvas_inputs(md, apt.RotatingPlumeProblem(
        omega=0.05, D=0.3), 1, F32, {})
    C, u3 = cs.bicgstab_inputs(inp, F32)
    cases["B5 C2"] = dict(kind="canvas_bicgstab", C=C, u=u3, k=5,
                          steps=n_steps)
    scal, u3 = cs.uniform_inputs(md, cs.plume(), 1, cs.S_ITERS, F32)
    cases["B1-BiCGStab S3"] = dict(kind="uniform_bicgstab",
                                   scal=scal[:21].contiguous(), u=u3, k=5,
                                   steps=n_steps)
    return cases


def launcher(fns, case, parent, plan=None):
    """A closure launching ``case`` once through the parent's entry points
    or this tree's (with ``plan``: a UniformPlan, or the cells per thread
    for the loops; default the tree's own), holding every buffer whose
    pointer it passes; and a function returning its output."""
    P = _build.pointer
    s = _build.current_stream
    c = case
    kind, k = c["kind"], c["k"]
    keep = []
    if kind == "solve":
        n = c["u"].shape[-1]
        bufs = [torch.empty_like(c["u"]) for _ in range(4)]
        grid = ctypes.c_int(0)
        plan = plan or fused_solver.uniform_plan(k, False, F32, n)
        work = None if parent else fused_solver.uniform_work(plan, c["u"])
        keep += [bufs, grid, work]
        load = c["load"]
        stride = 0 if load is None or load.dim() == 3 else load[0].numel()

        def run():
            ua, ub, upa, upb = bufs
            ua.copy_(c["u"])
            upa.copy_(c["u"])
            head = [P(c["scal"]), P(ua), P(ub), P(upa), P(upb)]
            if load is not None:
                head.append(P(load))
            if parent:
                tail = [n, 24, k, k, 0, c["steps"]]
                if load is not None:
                    tail.append(stride)
                tail += [512, s(), ctypes.byref(grid)]
            else:
                tail = [P(work), n, plan.th, plan.tw, plan.depth, k, 0,
                        c["steps"]]
                if load is not None:
                    tail.append(stride)
                tail += [s(), ctypes.byref(grid)]
            name = "crbe_uniform_solve_load_f32" if load is not None \
                else "crbe_uniform_solve_f32"
            call(fns[name], *head, *tail)

        res = bufs[0] if c["steps"] % 2 == 0 else bufs[1]
        return run, lambda: res
    if kind in ("step", "block"):
        u = c["u"]
        n = u.shape[-1]
        out, up_out = torch.empty_like(u), torch.empty_like(u)
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
        if plan is None and not parent:
            plan = (fused_hbm.block_plan(k, False, F32, c["block"])
                    if kind == "block" else
                    fused_solver.uniform_plan(k, False, F32, n))
        work = None if parent else fused_solver.uniform_work(plan, u)
        load = c["load"]
        head = [P(c["scal"]), P(u), P(c["up"]), P(out), P(up_out), P(halt)]
        if load is not None:
            head.append(P(load))
        if not parent:
            head.append(P(work))
        geo = [n] if kind == "step" else list(c["block"].kernel_args())
        if parent:
            tail = geo + [32, k, k, 0] + ([512] if kind == "step" else [])
        else:
            tail = geo + [plan.th, plan.tw, plan.depth, k, 0]
        name = {"step": "crbe_uniform_step", "block": "crbe_uniform_block_step"
                }[kind] + ("_load" if load is not None else "") + "_f32"
        fn = fns[name]
        keep += [out, up_out, halt, work]
        return (lambda keep=keep: call(fn, *head, *tail, s())), lambda: out
    if kind == "blocks":
        blocks = c["blocks"]
        runs = []
        outs = []
        for d, b in enumerate(blocks.blocks):
            sub = dict(kind="block", scal=c["scal"], u=c["u"][d].contiguous(),
                       up=c["up"][d].contiguous(), k=k, load=None, block=b)
            run, o = launcher(fns, sub, parent)
            runs.append(run)
            outs.append(o)
        sl = slice(blocks.halo, blocks.halo + blocks.local)

        def run_all(runs=runs):
            for r in runs:
                r()

        return run_all, lambda: torch.stack([o()[..., sl, :]
                                             for o in outs])
    # The BiCGStab loops.
    u = torch.empty_like(c["u"])
    up = torch.empty_like(c["u"])
    n = u.shape[-1]
    op = "canvas" if kind == "canvas_bicgstab" else "uniform"
    if plan is None and not parent:
        plan = fused_solver.bicgstab_cells(n, op, F32)
    work = torch.empty((12,) + tuple(u.shape), dtype=F32, device=u.device)
    partials = torch.zeros(4 * fused_solver.CANVAS_MAX_GRID + 1,
                           dtype=torch.float64, device=u.device)
    grid = ctypes.c_int(0)
    mode = 512 if parent else plan
    keep += [up, work, partials, grid]

    def run(keep=keep):
        u.copy_(c["u"])
        up.copy_(c["u"])
        if kind == "canvas_bicgstab":
            call(fns["crbe_canvas_solve_f32"], P(c["C"]), P(u), P(up),
                 P(work), P(partials), n, c["steps"], k, 0, mode, s(),
                 ctypes.byref(grid))
        else:
            call(fns["crbe_uniform_bicgstab_f32"], P(c["scal"]), P(u), P(up),
                 P(work), P(partials), None, n, c["steps"], k, 0, 0, mode,
                 s(), ctypes.byref(grid))

    return run, lambda: u


def timed(run, kind):
    """(back-to-back ms, device-alone ms or None) of one launch."""
    if kind in ("solve", "canvas_bicgstab", "uniform_bicgstab"):
        return cs.cuda_ms(run, 3), None
    return cs.cuda_ms(run, 50), cs.graph_ms(run)[0]


def ab(parent_dir, out):
    csrc = Path(parent_dir) / "airpollution_tpu_torch" / "csrc"
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(build, "old", csrc),
                pool.submit(build, "new", _build.CSRC)]
        old, new = (j.result() for j in jobs)
    emit({"ptxas_change": {s: r for s, (_, r) in new.items()}}, out)
    emit({"ptxas_parent": {s: r for s, (_, r) in old.items()}}, out)
    fns = {"parent": bind(old, PARENT_ARGS), "change": bind(new, CHANGE_ARGS)}
    for name, case in main_cases().items():
        runs = {"parent": launcher(fns["parent"], case, True),
                "change": launcher(fns["change"], case, False)}
        for fn, _ in runs.values():
            fn()
            torch.cuda.synchronize()
        # Each run's output, taken right after it (the solves share none).
        got = {}
        for tag, (fn, o) in runs.items():
            fn()
            torch.cuda.synchronize()
            got[tag] = o().clone()
        if case["kind"] == "block":  # the halo rows are not written
            b = case["block"]
            got = {t: g[..., b.halo:b.halo + b.local, :]
                   for t, g in got.items()}
        row = {"case": name,
               "diff_over_max": compare(got["change"], got["parent"])}
        row["bit_equal"] = row["diff_over_max"] is None
        ms = {t: [] for t in runs}
        dev = {t: [] for t in runs}
        for tag in ("parent", "change", "change", "parent"):
            b2b, alone = timed(runs[tag][0], case["kind"])
            ms[tag].append(b2b)
            if alone is not None:
                dev[tag].append(alone)
        row.update(ms=ms, device_ms=dev)
        emit(row, out)


def sweep(out, threads):
    """The uniform step's plans at each block size, then the loops."""
    sweep_steps(out, threads)
    sweep_loops(out)


def sweep_steps(out, threads_list):
    with ThreadPoolExecutor(len(threads_list)) as pool:
        libs = list(pool.map(
            lambda t: build(f"u{t}", _build.CSRC,
                            ("uniform_solver.cu", "uniform_step.cu"),
                            (f"-DUNIFORM_THREADS_F32={t}",)),
            threads_list))
    cases = main_cases()
    steps = {k: v for k, v in cases.items()
             if v["kind"] in ("solve", "step", "block")
             and k not in ("B1-load S1", "B8-load")}
    for threads, built in zip(threads_list, libs):
        emit({"threads": threads,
              "ptxas": {s: r for s, (_, r) in built.items()}}, out)
        fns = bind(built, CHANGE_ARGS)
        for name, case in steps.items():
            k = case["k"]
            n = case["u"].shape[-1]
            solve = case["kind"] == "solve"
            live = case["block"].live_rows if case["kind"] == "block" \
                else None
            plans = fused_solver.uniform_candidates(
                k, False, F32, n, 1, live,
                shape=(threads, fused_solver.UNIFORM_SHAPE[F32][1]))
            rows = []
            for plan in plans:
                run, _ = launcher(fns, case, False, plan)
                ms = cs.cuda_ms(run, 3 if solve else 30)
                rows.append((plan.th, plan.tw,
                             fused_solver.uniform_tiles(plan, n, live),
                             fused_solver.uniform_cost(plan, k, False, F32,
                                                       n, live), ms))
            best = min(rows, key=lambda r: r[-1]) if rows else None
            row = {"threads": threads, "case": name, "best": best,
                   "plans_ms": rows}
            if threads == fused_solver.UNIFORM_SHAPE[F32][0]:
                pick = fused_solver.uniform_plan(k, False, F32, n,
                                                 live_rows=live)
                row["planner"] = pick
                fastest = fused_solver.UniformPlan(best[0], best[1], 1)
                turns = {"planner": [], "fastest": []}
                alone = {"planner": [], "fastest": []}
                runs = {"planner": launcher(fns, case, False, pick)[0],
                        "fastest": launcher(fns, case, False, fastest)[0]}
                for tag in ("planner", "fastest", "fastest", "planner"):
                    b2b, dev = timed(runs[tag], case["kind"])
                    turns[tag].append(b2b)
                    if dev is not None:
                        alone[tag].append(dev)
                row.update(in_turns_ms=turns, in_turns_device_ms=alone)
            emit(row, out)


def sweep_loops(out):
    """The BiCGStab loops: the empty-barrier floor, then each mode."""
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(build, "loops", _build.CSRC,
                            ("canvas_solver.cu", "uniform_bicgstab.cu")),
                pool.submit(build, "floor", _build.CSRC, (FLOOR_SOURCE,))]
        loops, floor = (j.result() for j in jobs)
    fns = bind(loops, CHANGE_ARGS)
    floor_fn = bind(floor, CHANGE_ARGS)["crbe_barrier_floor"]
    cases = main_cases(loops_only=True)
    emit({"ptxas_loops": {s: r for s, (_, r) in loops.items()}}, out)
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    ptr = ctypes.cast(counter.data_ptr(), UP)
    for tag, cg in (("hand", 0), ("cg", 1)):
        for per_step in (16, 27):
            n_syncs = per_step * 1000
            ms = cs.cuda_ms(lambda: call(floor_fn, ptr, 130, n_syncs, cg,
                                         _build.current_stream()), 3)
            emit({"barrier": tag, "grid": 130, "per_step": per_step,
                  "ms_per_1000_steps": ms, "us_per_barrier":
                  ms * 1e3 / n_syncs}, out)
    for name in ("B5 C2", "B1-BiCGStab S3"):
        case = cases[name]
        op = "canvas" if case["kind"] == "canvas_bicgstab" else "uniform"
        modes = list(range(1, fused_solver.BICGSTAB_CELLS[(op, F32)] + 1))
        rows = []
        for m in modes + [0]:
            run, _ = launcher(fns, case, False, m)
            rows.append((m, cs.cuda_ms(run, 2)))
        emit({"case": name, "cells_ms": rows,
              "planner": fused_solver.bicgstab_cells(257, op, F32)}, out)
    # 321^2, 200 steps: B1's BiCGStab variant at 2 cells per thread (its
    # plan) against global mode, in turns; then both loops at 513^2.
    dom = apt.Domain()
    for ms_, modes in ((321, (2, 0, 0, 2)), (513, None)):
        md = apt.MeshData(apt.create_mesh(ms_, 20.0), dom, nt=201)
        scal, u3 = cs.uniform_inputs(md, cs.plume(), 1, 5, F32)
        loops_at = [("B1-BiCGStab", dict(
            kind="uniform_bicgstab", scal=scal[:21].contiguous(), u=u3, k=5,
            steps=200), "uniform")]
        if ms_ == 513:
            inp = cs.canvas_inputs(md, apt.RotatingPlumeProblem(
                omega=0.05, D=0.3), 1, F32, {})
            C, c3 = cs.bicgstab_inputs(inp, F32)
            loops_at.append(("B5", dict(kind="canvas_bicgstab", C=C, u=c3,
                                        k=5, steps=200), "canvas"))
        for name, case, op in loops_at:
            cells = fused_solver.bicgstab_cells(ms_, op, F32)
            timings = []
            for m in modes or (cells,):
                run, _ = launcher(fns, case, False, m)
                timings.append((m, cs.cuda_ms(run, 2)))
            emit({"case": f"{name} {ms_}", "planner": cells,
                  "cells_ms": timings}, out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--threads", default="384,512,640,768,1024")
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available() or (a.parent is None) != a.sweep:
        print(__doc__, file=sys.stderr)
        return 1
    emit({"card": cs.card_line()}, a.out)
    if a.sweep:
        sweep(a.out, [int(t) for t in a.threads.split(",")])
    else:
        ab(a.parent, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
