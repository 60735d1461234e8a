#!/usr/bin/env python3
"""Kernel B4 of another tree against this tree's, in one process on one
card: both canvas_step.cu sources are compiled with nvcc (each in its own
C++ namespace), checked for bit-equal output, and timed in turns (old,
new, new, old, ...) with CUDA events at 1025^2 on two operators: C1's
rotating wind (k=14, BE, extrapolated) and the multispecies demo's
transport (k=8, CN). This tree's B4 is also timed with an emission load.

    python3 scripts/torch_port_b4_ab.py OLD_CSRC_DIR

OLD_CSRC_DIR holds the other tree's airpollution_tpu_torch/csrc (e.g. a
`git archive` of the parent commit unpacked under build/). Needs one CUDA
card and nvcc; prints JSON lines, the card's name and power limit first.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import airpollution_tpu_torch as apt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.ops import fused_solver  # noqa: E402


def load_b4(tag, csrc):
    """The f32 entry point of ``csrc``/canvas_step.cu and whether it takes
    a load pointer."""
    src = Path(csrc) / "canvas_step.cu"
    out = ROOT / "build" / "ab" / f"libcanvas_step_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-Dcrbe=crbe_{tag}", "-o", str(out), str(src)],
                   check=True)
    with_load = "float* load" in src.read_text()
    lib = ctypes.CDLL(str(out))
    fn = lib.crbe_canvas_step_f32
    fn.argtypes = ([ctypes.c_void_p] * (8 if with_load else 7)
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, with_load


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    kernels = {"old": load_b4("old", sys.argv[1]),
               "new": load_b4("new", _build.CSRC)}
    md = apt.MeshData(apt.create_mesh(1025, 20.0), apt.Domain(), nt=1001)
    cache = {}
    P = _build.pointer
    cells = (("C1", apt.RotatingPlumeProblem(omega=0.05, D=0.3), 14, 1,
              True),
             ("demo", apt.Problem(v=(1.0, 0.2), D=0.3), 8, 2, False))
    for name, problem, k, order, ext in cells:
        inp = cs.canvas_inputs(md, problem, order, torch.float32, cache)
        C, cheb, u, _ = cs.canvas_step_inputs(inp, k, torch.float32)
        up = u.clone() if ext else None
        out = torch.empty_like(u)
        up_out = torch.empty_like(u) if ext else None
        load = 1e-3 * u.abs()
        halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
        halo = fused_solver.halo_of(k, order == 2)
        tile = fused_solver.choose_tile(halo, torch.float32, 32)

        def call(tag, with_load=False):
            fn, takes_load = kernels[tag]
            ptrs = [P(C), P(cheb), P(u), P(up), P(out), P(up_out), P(halt)]
            if takes_load:
                ptrs.append(P(load if with_load else None))
            err = fn(*ptrs, md.structured_n, tile, halo, k, int(order == 2),
                     *inp["rect"], 512, _build.current_stream())
            if err:
                raise RuntimeError(f"{tag}: launch error {err}")

        results = {}
        for tag in kernels:
            call(tag)
            torch.cuda.synchronize()
            results[tag] = out.clone()
        times = {"old": [], "new": [], "new_with_load": []}
        for tag in ("old", "new", "new", "old", "old", "new"):
            times[tag].append(cs.cuda_ms(lambda: call(tag), 50))
        for _ in range(2):
            times["new_with_load"].append(
                cs.cuda_ms(lambda: call("new", True), 50))
        print(json.dumps({"cell": name, "k": k, "order": order,
                          "extrapolate": ext, "tile": tile,
                          "bit_equal": bool(torch.equal(results["old"],
                                                        results["new"])),
                          "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
