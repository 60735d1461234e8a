#!/usr/bin/env python3
"""Kernels B1, B2 and B5 of another tree against this tree's, in one
process on one card: both trees' uniform_solver.cu, uniform_step.cu and
canvas_solver.cu are compiled with nvcc (each in its own C++ namespace),
checked for bit-equal output, and timed in turns (old, new, new, old, old,
new) with CUDA events at the main paths' shapes: B1, one whole 257^2 solve
of 1000 steps (Chebyshev-4, BE, extrapolated); B2, one 1025^2 step
(Chebyshev-8, BE, extrapolated); B5, one whole 257^2 solve of 1000 steps on
C2's rotating wind (BiCGStab-5, BE, extrapolated). This tree's load entry
points of B1 and B2 are timed beside them with a steady source's load
plane.

    python3 scripts/torch_port_ab.py OLD_CSRC_DIR

OLD_CSRC_DIR holds the other tree's airpollution_tpu_torch/csrc (e.g. a
`git archive` of the parent commit unpacked under build/). Needs one CUDA
card and nvcc; prints JSON lines, the card's name and power limit first.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402

VOID, INT = ctypes.c_void_p, ctypes.c_int


def load(tag, csrc, source):
    """The library of ``csrc``/``source`` built under namespace crbe_tag."""
    out = ROOT / "build" / "ab" / f"lib{Path(source).stem}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-Dcrbe=crbe_{tag}", "-o", str(out),
                    str(Path(csrc) / source)], check=True)
    return ctypes.CDLL(str(out))


def entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def checked(err, what):
    if err:
        raise RuntimeError(f"{what}: launch error {err}")


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    trees = {"old": sys.argv[1], "new": _build.CSRC}
    domain, problem = apt.Domain(), apt.Problem(sigma=1.0)
    P = _build.pointer
    stream = _build.current_stream

    # B1: the whole 257^2 solve.
    md = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=1001)
    k, n_steps, n = 4, md.nt - 1, md.structured_n
    scal, u3 = cs.uniform_inputs(md, problem, 1, k, torch.float32)
    plane = cs.uniform_load(md, scal, 1, cs.s_source(), n_steps,
                            torch.float32)
    halo = fused_solver.halo_of(k, False)
    tile = fused_solver.choose_tile(halo, torch.float32, fused_solver.TILE)
    libs = {tag: load(tag, csrc, "uniform_solver.cu")
            for tag, csrc in trees.items()}
    b1 = {tag: entry(lib, "crbe_uniform_solve_f32",
                     [VOID] * 5 + [INT] * 7 + [VOID, ctypes.POINTER(INT)])
          for tag, lib in libs.items()}
    b1_load = entry(libs["new"], "crbe_uniform_solve_load_f32",
                    [VOID] * 6 + [INT] * 8 + [VOID, ctypes.POINTER(INT)])
    bufs = [torch.empty_like(u3) for _ in range(4)]
    grid = ctypes.c_int(0)

    def run_b1(tag):
        ua, ub, upa, upb = bufs
        ua.copy_(u3)
        upa.copy_(u3)
        head = (P(scal), P(ua), P(ub), P(upa), P(upb))
        if tag == "new_with_load":
            checked(b1_load(*head, P(plane), n, tile, halo, k, 0, n_steps,
                            0, 512, stream(), ctypes.byref(grid)), tag)
        else:
            checked(b1[tag](*head, n, tile, halo, k, 0, n_steps, 512,
                            stream(), ctypes.byref(grid)), tag)
        return ua if n_steps % 2 == 0 else ub

    outs = {tag: run_b1(tag).clone() for tag in ("old", "new")}
    times = {"old": [], "new": [], "new_with_load": []}
    for tag in ("old", "new", "new", "old", "old", "new"):
        times[tag].append(cs.cuda_ms(lambda: run_b1(tag), 5))
    for _ in range(2):
        times["new_with_load"].append(
            cs.cuda_ms(lambda: run_b1("new_with_load"), 5))
    print(json.dumps({"kernel": "B1", "ms": 257, "steps": n_steps, "k": k,
                      "tile": tile,
                      "bit_equal": bool(torch.equal(outs["old"],
                                                    outs["new"])),
                      "ms_per_launch": times}), flush=True)

    # B2: one 1025^2 step.
    md = apt.MeshData(apt.create_mesh(1025, 20.0), domain, nt=1001)
    k, n = 8, md.structured_n
    scal, u = cs.uniform_inputs(md, problem, 1, k, torch.float32)
    plane = cs.uniform_load(md, scal, 1, cs.s_source(), 1, torch.float32)
    up = u.clone()
    halo = fused_solver.halo_of(k, False)
    tile = fused_solver.choose_tile(halo, torch.float32, fused_hbm.TILE)
    libs = {tag: load(tag, csrc, "uniform_step.cu")
            for tag, csrc in trees.items()}
    b2 = {tag: entry(lib, "crbe_uniform_step_f32",
                     [VOID] * 6 + [INT] * 6 + [VOID])
          for tag, lib in libs.items()}
    b2_load = entry(libs["new"], "crbe_uniform_step_load_f32",
                    [VOID] * 7 + [INT] * 6 + [VOID])
    out, up_out = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)

    def run_b2(tag):
        head = (P(scal), P(u), P(up), P(out), P(up_out), P(halt))
        tail = (n, tile, halo, k, 0, 512, stream())
        if tag == "new_with_load":
            checked(b2_load(*head, P(plane), *tail), tag)
        else:
            checked(b2[tag](*head, *tail), tag)
        return out

    outs = {tag: run_b2(tag).clone() for tag in ("old", "new")}
    times = {"old": [], "new": [], "new_with_load": []}
    for tag in ("old", "new", "new", "old", "old", "new"):
        times[tag].append(cs.cuda_ms(lambda: run_b2(tag), 100))
    for _ in range(2):
        times["new_with_load"].append(
            cs.cuda_ms(lambda: run_b2("new_with_load"), 100))
    print(json.dumps({"kernel": "B2", "ms": 1025, "k": k, "tile": tile,
                      "bit_equal": bool(torch.equal(outs["old"],
                                                    outs["new"])),
                      "ms_per_launch": times}), flush=True)

    # B5: the whole C2 solve.
    md = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=1001)
    inp = cs.canvas_inputs(md, apt.RotatingPlumeProblem(omega=0.05, D=0.3),
                           1, torch.float32, {})
    C, u3 = cs.bicgstab_inputs(inp, torch.float32)
    libs = {tag: load(tag, csrc, "canvas_solver.cu")
            for tag, csrc in trees.items()}
    b5 = {tag: entry(lib, "crbe_canvas_solve_f32",
                     [VOID] * 5 + [INT] * 5 + [VOID, ctypes.POINTER(INT)])
          for tag, lib in libs.items()}
    u, up = torch.empty_like(u3), torch.empty_like(u3)
    work = torch.empty((6,) + tuple(u3.shape), dtype=u3.dtype,
                       device=u3.device)
    partials = torch.empty((4, fused_solver.CANVAS_MAX_GRID),
                           dtype=torch.float64, device=u3.device)

    def run_b5(tag):
        u.copy_(u3)
        up.copy_(u3)
        checked(b5[tag](P(C), P(u), P(up), P(work), P(partials),
                        md.structured_n, md.nt - 1, 5, 0, 512, stream(),
                        ctypes.byref(grid)), tag)
        return u

    outs = {tag: run_b5(tag).clone() for tag in ("old", "new")}
    times = {"old": [], "new": []}
    for tag in ("old", "new", "new", "old", "old", "new"):
        times[tag].append(cs.cuda_ms(lambda: run_b5(tag), 2))
    print(json.dumps({"kernel": "B5", "ms": 257, "steps": md.nt - 1,
                      "k": 5,
                      "bit_equal": bool(torch.equal(outs["old"],
                                                    outs["new"])),
                      "ms_per_launch": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
