"""Tile and block-size sweep of the PyTorch port's CUDA kernels.

Times, in float32, each at every launch shape it takes, and checks each
launch against the kernel's plain PyTorch version:

- B1 (``csrc/uniform_solver.cu``: the whole 257^2, nt=1001 solve,
  Chebyshev-4, extrapolated warm start, BE and CN) at every output tile
  that fits shared memory and both block sizes; then B1's time per step
  split into its fixed part and its part per Chebyshev iteration, beside
  B2 launched once per step on the same mesh;
- B2 (``csrc/uniform_step.cu``: one 1025^2 step, Chebyshev-8,
  extrapolated, BE) at every tile and both block sizes;
- B3 (``csrc/stencil_matvec.cu``: one 257^2 matvec at its one block
  size, through the bound operator) and B5
  (``csrc/canvas_solver.cu``: the whole 257^2, nt=1001 BiCGStab-5 solve)
  at each block size.

Prints one JSON line per configuration, then the card's name and power
limit. Needs one CUDA card; run from the repository root, optionally
naming the kernels to sweep:

    python3 scripts/torch_port_tile_sweep.py [B1 B2 B3 B5]

The canvas step kernels B4 and B6 take their launch plans from
scripts/torch_port_b4_b6_ab.py --sweep.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import airpollution_tpu_torch as apt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402


def tiles(halo):
    return [t for t in sorted(fused_solver.TILE_CANDIDATES)
            if fused_solver.tile_fits(t, halo, torch.float32)]


def sweep_b1(md, problem):
    k, n_steps = 4, md.nt - 1
    for order in (1, 2):
        use_ka = order == 2
        scal, u3 = cs.uniform_inputs(md, problem, order, k, torch.float32)
        kw = dict(n_steps=n_steps, n_iters=k, use_ka=use_ka, extrapolate=True)
        ref = fused_solver.plain_solve(scal, u3, **kw)
        for tile in tiles(fused_solver.halo_of(k, use_ka)):
            for threads in fused_solver.BLOCK_THREADS:
                def run():
                    return fused_solver.kernel_solve(
                        scal, u3, tile=tile, threads=threads, **kw)
                err = float((run() - ref).abs().max())
                ms = cs.cuda_ms(run, 3)
                print(json.dumps({"kernel": "B1", "ms_mesh": 257, "order": order,
                                  "k": k, "tile": tile, "threads": threads,
                                  "ms": ms, "max_abs_err": err}), flush=True)


def sweep_b2(md, problem):
    k = 8
    scal, u = cs.uniform_inputs(md, problem, 1, k, torch.float32)
    up = u.clone()
    masks = fused_solver.rect_masks(u.shape[-1], torch.float32, u.device)
    ref, _ = fused_solver.plain_step(scal, k, u, up, False, masks)
    out, out_up = torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    for tile in tiles(fused_solver.halo_of(k, False)):
        for threads in fused_solver.BLOCK_THREADS:
            def run():
                fused_hbm.kernel_step(scal, k, u, up, out, out_up, False, halt,
                                      tile, threads)
            run()
            err = float((out - ref).abs().max())
            ms = cs.cuda_ms(run, 50)
            print(json.dumps({"kernel": "B2", "ms_mesh": 1025, "order": 1,
                              "k": k, "tile": tile, "threads": threads,
                              "ms": ms, "max_abs_err": err}), flush=True)


def split_b1(md, problem):
    """B1 at its launch shape against k (BE, extrapolated): the intercept
    is the per-step cost outside the iterations (state load and store, grid
    barrier), the slope one iteration's. B2 launched once per step on the
    same mesh at k=4 for comparison."""
    n_steps = md.nt - 1
    for k in (1, 2, 4, 8):
        scal, u3 = cs.uniform_inputs(md, problem, 1, k, torch.float32)
        kw = dict(n_steps=n_steps, n_iters=k, use_ka=False, extrapolate=True)
        ms = cs.cuda_ms(lambda: fused_solver.kernel_solve(scal, u3, **kw), 3)
        print(json.dumps({"kernel": "B1", "ms_mesh": 257, "k": k,
                          "tile": fused_solver.TILE,
                          "threads": fused_solver.THREADS,
                          "us_per_step": ms * 1e3 / n_steps}), flush=True)
    k = 4
    scal, u = cs.uniform_inputs(md, problem, 1, k, torch.float32)
    up, out, out_up = u.clone(), torch.empty_like(u), torch.empty_like(u)
    halt = torch.tensor(-1, dtype=torch.int32, device=u.device)
    for tile in (16, 24, 32):
        ms = cs.cuda_ms(lambda: fused_hbm.kernel_step(
            scal, k, u, up, out, out_up, False, halt, tile), 200)
        print(json.dumps({"kernel": "B2", "ms_mesh": 257, "k": k,
                          "tile": tile, "threads": fused_solver.THREADS,
                          "us_per_step": ms * 1e3}), flush=True)


def sweep_b3_b5(md, problem):
    import numpy as np

    from airpollution_tpu_torch.ops import fused_stencil, stencil

    inp = cs.canvas_inputs(md, problem, 1, torch.float32, {})
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        md.number_of_segments), dtype=torch.float32, device=md.device)
    ref = stencil.stencil_matvec(inp["pattern"], inp["coeffs"], x)
    op = fused_stencil.StencilOperator(inp["pattern"], inp["coeffs"])
    err = float((op(x) - ref).abs().max())
    print(json.dumps({"kernel": "B3", "ms_mesh": 257,
                      "ms": cs.cuda_ms(lambda: op(x), 200),
                      "max_abs_err": err}), flush=True)
    C, u3 = cs.bicgstab_inputs(inp, torch.float32)
    kw = dict(n_steps=md.nt - 1, n_iters=5, use_ka=False, extrapolate=True)
    for threads in fused_solver.BLOCK_THREADS:
        def run():
            return fused_solver.kernel_bicgstab_solve(C, u3, threads=threads,
                                                      **kw)
        ms = cs.cuda_ms(run, 3)
        print(json.dumps({"kernel": "B5", "ms_mesh": 257, "k": 5,
                          "threads": threads, "ms": ms,
                          "us_per_step": ms * 1e3 / kw["n_steps"]}),
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    which = set(sys.argv[1:]) or {"B1", "B2", "B3", "B5"}
    domain, problem = apt.Domain(), apt.Problem(sigma=1.0)
    md = apt.MeshData(apt.create_mesh(257, 20.0), domain, nt=1001)
    if "B1" in which:
        sweep_b1(md, problem)
        split_b1(md, problem)
    if which & {"B3", "B5"}:
        sweep_b3_b5(md, apt.RotatingPlumeProblem(omega=0.05, D=0.3))
    if "B2" in which:
        md = apt.MeshData(apt.create_mesh(1025, 20.0), domain, nt=1001)
        sweep_b2(md, problem)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
