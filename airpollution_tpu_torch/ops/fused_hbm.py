"""Fused CRBE solve with one kernel launch per time step (kernel B2),
PyTorch counterpart of ``airpollution_tpu/ops/pallas_hbm.py``'s
``fused_solve_uniform_hbm``, ``guard_stride`` and ``_guarded_scan``.

Serves meshes past the whole-loop kernel's routing limit (the state no
longer fits the budget models/crbe keeps from the JAX package). Each step
is one launch of ``csrc/uniform_step.cu``: one block per 2-D output tile
runs the whole step (RHS, warm start, k Chebyshev iterations) in shared
memory on a window with a halo in both directions, reading the state once
and writing it once. The host loops over steps in chunks of
``guard_every``; after each chunk a divergence flag is updated on the
device, never read there, and read once by the caller. Once the flag is
set, later launches return at once.

On a CPU tensor each step is ``fused_solver.plain_step``: the same step on
the full canvas.
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import fused_solver, linalg

KERNEL = _build.Kernel(
    "uniform_step", "uniform_step.cu",
    {torch.float32: "crbe_uniform_step_f32",
     torch.float64: "crbe_uniform_step_f64"},
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

#: Output tile edge, measured on an H100 (scripts/torch_port_tile_sweep.py):
#: fastest at 1025^2 with Chebyshev-8, 1,089 blocks of 512 threads.
TILE = 32


def guard_stride(n_steps: int, target: int = 64) -> int:
    """Largest divisor of ``n_steps`` that is <= ``target``: the length of
    a divergence-guard chunk."""
    for d in range(min(target, n_steps), 0, -1):
        if n_steps % d == 0:
            return d
    return 1


def kernel_step(scal, n_iters, u, up, u_out, up_out, use_ka, halt, tile,
                threads=fused_solver.THREADS):
    """One launch of B2: (u, up) -> (u_out, up_out); CUDA tensors only."""
    n = u.shape[-1]
    halo = fused_solver.halo_of(n_iters, use_ka)
    P = _build.pointer
    KERNEL.launch(u.dtype, P(scal), P(u), P(up), P(u_out), P(up_out),
                  P(halt), n, tile, halo, n_iters, int(use_ka), threads,
                  _build.current_stream())


def fused_solve_uniform_hbm(spec, consts, mass_consts, inv_diag_consts,
                            u0_fam, *, n_steps: int, n_iters: int, bounds,
                            use_ka: bool = False, extrapolate: bool = False,
                            guard_every: int | None = None):
    """Whole time loop, one B2 launch per step (Chebyshev only).

    Same contract as fused_solver.fused_solve_uniform. With
    ``guard_every`` it returns ``(state, bad)``: ``bad`` is a 0-d int32
    tensor on the state's device holding the 1-based step that ends the
    first diverged guard chunk (non-finite or exploded state, see
    linalg.diverged_state), or -1 for a clean run.
    """
    dtype, device = u0_fam.dtype, u0_fam.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if n_steps == 0:
        bad = torch.tensor(-1, dtype=torch.int32, device=device)
        return (u0_fam, bad) if guard_every is not None else u0_fam
    scal = fused_solver.step_scalars(
        consts, mass_consts, inv_diag_consts, bounds, n_iters, dtype
    )
    u = fused_solver.to_canvases(spec, u0_fam)
    up = u.clone() if extrapolate else None
    ref_norm = torch.linalg.norm(u)
    bad = torch.tensor(-1, dtype=torch.int32, device=device)

    if u.is_cuda:
        tile = fused_solver.choose_tile(
            fused_solver.halo_of(n_iters, use_ka), dtype, TILE)
        u_nxt = torch.empty_like(u)
        up_nxt = torch.empty_like(u) if extrapolate else None

        def step(u, up):
            nonlocal u_nxt, up_nxt
            kernel_step(scal, n_iters, u, up, u_nxt, up_nxt, use_ka, bad,
                        tile)
            u_nxt, u = u, u_nxt
            if extrapolate:
                up_nxt, up = up, up_nxt
            return u, up
    else:
        masks = fused_solver.rect_masks(u.shape[-1], dtype, device)

        def step(u, up):
            if int(bad) >= 0:  # a free read on the CPU
                return u, up
            return fused_solver.plain_step(scal, n_iters, u, up, use_ka,
                                           masks)

    chunk = n_steps if guard_every is None else guard_every
    if n_steps % chunk:
        raise ValueError("guard_every must divide n_steps")
    for i in range(n_steps // chunk):
        for _ in range(chunk):
            u, up = step(u, up)
        tripped = (bad < 0) & linalg.diverged_state(u, ref_norm)
        bad.copy_(torch.where(tripped, (i + 1) * chunk, bad))

    out = fused_solver.from_canvases(spec, u)
    return (out, bad) if guard_every is not None else out
