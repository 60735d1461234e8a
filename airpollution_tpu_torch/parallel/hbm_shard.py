"""Block-sharded fused solvers, PyTorch counterpart of
``airpollution_tpu/parallel/hbm_shard.py``.

The JAX module spreads the per-step fused kernels (B2, B4, B6) over a
device mesh. The canvas rows are cut into blocks, block d owning rows
``[d local, (d + 1) local)``, and each block is carried EXTENDED: its
interior plus ``halo = roundup8(k + 2 (+1 CN))`` rows of each neighbour's
state, the per-step domain of dependence of the step (one row per
application of A). A step is a pair of ppermutes that refresh the halos
(zeros at the chain ends) and one launch per block of the kernel in
sharded-block mode, which masks on global rows and writes the interior
rows only.

Here the mesh (parallel/device_mesh.py) is one of two kinds:

- a ProcessMesh: the rank at index d along the axis holds block d, as in
  JAX; a step's exchange is one ``halo_exchange`` of the halo slabs with
  both neighbours (parallel/collectives.py), and the interiors come back
  to every rank with one ``all_gather_rows`` at the end and with each
  strided snapshot;
- a BlockMesh: the blocks of an axis lie side by side on one device in
  one ``(n_blocks, ..., rows, n)`` tensor, and :func:`exchange` is two
  slice copies (block d's first ``halo`` rows from block d-1's last
  interior rows, its last ``halo`` rows from block d+1's first) and the
  two chain-end zero fills: the ppermute pair's semantics
  (``stencil_shard._halo_from_below`` / ``_halo_from_above``).

Then each block takes one launch of the block kernel (ops/fused_hbm.py):
B8 (B2's block mode), B9 (B4's) or B10 (B6's); on a CPU tensor its plain
version. The blocks compute the same values either way, so a solve on
ranks is bitwise the solve on one process's blocks.

So a step costs a launch per block and the exchange where the
whole-canvas solve takes one launch. With the extrapolated warm
start both carried states are exchanged (the warm start reads u_prev in
the halo). Arrays that do not change during a solve (the coefficient
stack, the obstacle carve) are cut into extended blocks once per solve,
neighbours' rows included and zeros past the chain ends: what one exchange
of them gives. Loads are built per block on its own rows, halo rows
included, at global coordinates (ops/loads.py), so neighbouring blocks
compute identical values where they overlap and no block reads another's
plane.

Chebyshev only, final state or strided snapshots, as the JAX solvers.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from airpollution_tpu_torch.mesh.data import structured_grid
from airpollution_tpu_torch.models.crbe import (
    assemble_canvas,
    obstacle_masks,
    robin_terms,
)
from airpollution_tpu_torch.models.multispecies import (
    half_step_exponential,
    make_species_lift,
)
from airpollution_tpu_torch.ops import fused_hbm, fused_solver, lifting
from airpollution_tpu_torch.ops import linalg, sparse
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.ops.loads import EmissionLoads, RobinFluxLoads
from airpollution_tpu_torch.parallel.collectives import RowChain
from airpollution_tpu_torch.parallel.device_mesh import (check_mesh,
                                                         same_device)
from airpollution_tpu_torch.problems import (
    robin_g_customized,
    robin_g_xy_provided,
)


def halo_rows(iters: int, use_ka: bool) -> int:
    """A block's halo, ``roundup8(k + 2 (+1 CN))`` rows as in the JAX
    solvers: at least the block kernels' window halo."""
    depth = iters + 1 + (1 if use_ka else 0)
    halo = -(-(depth + 1) // 8) * 8
    assert halo >= fused_solver.halo_of(iters, use_ka)
    return halo


def _block_layout(n: int, n_blocks: int, halo: int) -> int:
    """Interior rows per block of an n-row canvas: the blocks cover the
    canvas, and each interior is a multiple of 8 and at least ``halo`` rows
    (an exchange reads a neighbour's first and last ``halo`` interior
    rows).

    The JAX layout also sizes the TPU's VMEM row stripes inside a block
    (pallas_hbm.choose_tile, _choose_stripe_rows_planes) and rounds the
    interior up to whole stripes: a TPU memory choice. The block kernels
    tile a block with 2-D tiles of their own, so only the interior is
    sized here."""
    return -(-max(-(-n // n_blocks), halo) // 8) * 8


class RowBlocks:
    """The row blocks of an n x n canvas: ``n_blocks`` interiors of
    ``local`` rows, each carried as ``rows = local + 2 halo`` rows
    (:class:`fused_hbm.BlockRows` each). ``blocks`` are the ones this
    process holds: all of them, or with ``chain`` (a
    collectives.RowChain) the chain's."""

    def __init__(self, n: int, n_blocks: int, halo: int, chain=None):
        self.n, self.n_blocks, self.halo = n, n_blocks, halo
        self.chain = chain
        self.local = _block_layout(n, n_blocks, halo)
        self.rows = self.local + 2 * halo
        ids = range(n_blocks) if chain is None else chain.ids
        self.blocks = [fused_hbm.BlockRows(n, d * self.local - halo, halo,
                                           self.local)
                       for d in ids]

    @property
    def on_ranks(self) -> bool:
        return self.chain is not None and not self.chain.local

    def split(self, canvas):
        """(..., n, n) canvases -> (held blocks, ..., rows, n) extended
        blocks: each interior with its neighbours' rows, zero past the
        canvas and past the chain ends."""
        pad = self.local * self.n_blocks - self.n + self.halo
        full = F.pad(canvas, (0, 0, self.halo, pad))
        return torch.stack([full[..., b.row0 + self.halo:
                                 b.row0 + self.halo + self.rows, :]
                            for b in self.blocks])

    def join(self, ext):
        """(held blocks, ..., rows, n) extended blocks -> (..., n, n): the
        interiors of every block in canvas order (on ranks, gathered from
        all of them)."""
        inner = ext[..., self.halo:self.halo + self.local, :]
        if self.on_ranks:
            return self.chain.gather(inner, dim=-2)[..., :self.n, :]
        return torch.cat(list(inner.unbind(0)), dim=-2)[..., :self.n, :]


def exchange(ext, local: int, halo: int):
    """Refresh the halo rows of the extended blocks ``ext`` (n_blocks, ...,
    rows, n) in place: block d's first ``halo`` rows take block d-1's last
    ``halo`` interior rows, its last ``halo`` rows block d+1's first ones,
    and the chain ends take zeros."""
    ext[1:, ..., :halo, :] = ext[:-1, ..., local:local + halo, :]
    ext[0, ..., :halo, :] = 0
    ext[:-1, ..., halo + local:, :] = ext[1:, ..., halo:2 * halo, :]
    ext[-1, ..., halo + local:, :] = 0


def exchange_ranks(ext, local: int, halo: int, chain):
    """:func:`exchange` of this rank's extended block ``ext`` (1, ...,
    rows, n) with the neighbouring ranks of ``chain``: one halo_exchange
    of the two (..., halo, n) slabs."""
    below, above = chain.neighbours(ext[:, ..., halo:2 * halo, :],
                                    ext[:, ..., local:local + halo, :])
    ext[:, ..., :halo, :] = below
    ext[:, ..., halo + local:, :] = above


def _run(state, blocks: RowBlocks, n_steps: int, snapshot_every,
         block_step, load_of):
    """``n_steps`` steps of the extended blocks ``state`` (held blocks,
    ...): each an exchange, then ``block_step(i, state[i], out[i],
    load_of(i))`` for every held block i, which writes its next state
    (its interior at least) into ``out[i]``. Returns the final state and,
    with ``snapshot_every=k``, the joined state after every k steps."""
    other = torch.empty_like(state)
    snaps = []
    for i in range(n_steps):
        if blocks.on_ranks:
            exchange_ranks(state, blocks.local, blocks.halo, blocks.chain)
        else:
            exchange(state, blocks.local, blocks.halo)
        for d in range(len(blocks.blocks)):
            block_step(d, state[d], other[d], load_of(d))
        state, other = other, state
        if snapshot_every is not None and (i + 1) % snapshot_every == 0:
            snaps.append(blocks.join(state))
    return state, snaps


def _blocks_of(mesh, axis, mesh_data, n, halo):
    """The RowBlocks of ``mesh``'s ``axis`` that this process holds (a
    BlockMesh's all, a ProcessMesh rank's own) on the mesh's device, which
    must be the mesh data's."""
    check_mesh(mesh, axis)
    if not same_device(mesh.device, mesh_data.device):
        raise ValueError(f"mesh device {mesh.device} differs from the mesh "
                         f"data's {mesh_data.device}")
    if mesh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mesh.device}")
    return RowBlocks(n, mesh.shape[axis], halo, RowChain(mesh, axis))


def _check_common(mesh_data, snapshot_every, n_steps, source_quadrature,
                  what):
    if getattr(mesh_data, "structured_n", None) is None:
        raise ValueError(f"{what} requires a structured mesh")
    if source_quadrature not in ("mass_lumped", "reference"):
        raise ValueError(f"unknown source_quadrature {source_quadrature!r}")
    if snapshot_every is not None and (
            snapshot_every < 1 or n_steps % snapshot_every):
        raise ValueError("snapshot_every must be a positive divisor of nt-1")


def _perm_tensors(mesh_data):
    perm, inv = stencil_mod.get_family_perm(mesh_data)
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                 device=mesh_data.device) for a in (perm, inv))


def build_hbm_halo_solver(mesh, mesh_data, problem, dt, *, order=1, iters=8,
                          axis="mp", extrapolate=False, snapshot_every=None,
                          assembly="auto", stiffness_convention="correct",
                          source_quadrature="mass_lumped"):
    """Block-sharded uniform-operator solve on kernel B8 over a structured
    mesh: ``solve(ops, u0)`` gives the ``(1, n_seg)`` final state,
    boundary-lifted, or with ``snapshot_every=k`` the strided
    ``((nt-1)/k + 1, n_seg)`` trajectory of the serial ``solutions[::k]``
    (the extrapolated warm start carries across snapshots, as in the JAX
    solver). ``order=2`` is Crank-Nicolson, ``extrapolate`` the
    second-order warm start, ``iters`` the Chebyshev iterations per step.
    A source (``problem.source_xy``) is loaded per block on global
    coordinates, with ``source_quadrature`` as in models/crbe.run_time_loop.

    ``assembly``: ``"full"`` takes the 21 operator scalars from assembled
    ``GlobalOperators``; ``"patch"`` from a congruent patch mesh
    (ops/uniform.patch_constants: no global operator, ``solve(None, u0)``);
    ``"auto"`` takes patch past 6M DOFs, as CRBESolver does. The Chebyshev
    interval is the one CRBESolver's fused uniform routes estimate, so the
    block solve and the whole-canvas solve take the same scalars.
    """
    for attr, what in (("robin_sides", "Robin boundaries"),
                       ("obstacles", "interior obstacles")):
        if getattr(problem, attr, None):
            raise ValueError(
                f"{what} (problem.{attr}) break translation invariance: the "
                f"uniform block solver does not take them — use "
                f"build_canvas_hbm_halo_solver (the per-DOF canvas operator)")
    md = mesh_data
    n_steps = md.nt - 1
    _check_common(md, snapshot_every, n_steps, source_quadrature,
                  "hbm halo solver")
    if getattr(problem, "variable_coefficients", False):
        raise ValueError(
            "this builder runs on the translation-invariant uniform "
            "operator; spatially varying coefficients are served by "
            "build_canvas_hbm_halo_solver (the block-sharded canvas kernel)")
    if assembly not in ("auto", "full", "patch"):
        raise ValueError(f"unknown assembly {assembly!r}")
    use_patch = assembly == "patch" or (
        assembly == "auto" and md.number_of_segments > 6_000_000)
    if use_patch:
        spec = uniform_mod.make_spec_lite(md.structured_n)
    else:
        spec = uniform_mod.build_uniform_spec(stencil_mod.get_pattern(md))
    perm, inv = _perm_tensors(md)
    use_ka = order == 2
    blocks = _blocks_of(mesh, axis, md, spec.n, halo_rows(iters, use_ka))
    device = md.device
    sourced = not getattr(problem, "zero_source", False)
    src = {}
    if sourced:
        src = dict(source_fn=problem.source_xy,
                   source_steady=bool(getattr(problem, "steady_source",
                                              False)),
                   grid=structured_grid(md), dt=dt, t0=0.0, use_ka=use_ka,
                   lumped=source_quadrature == "mass_lumped")
    lift_at = lifting.make_lift(problem, md.midpoints, md.boundary_mask)
    n_states = 2 if extrapolate else 1

    def solve_with(pieces, u0):
        consts, mass_c, inv_diag_c, bounds = pieces
        dtype = u0.dtype
        scal = fused_solver.step_scalars(consts, mass_c, inv_diag_c, bounds,
                                         iters, dtype)
        U = blocks.split(fused_solver.to_canvases(spec, u0[perm]))
        state = torch.stack([U] * n_states, dim=1)  # (blocks, states, 3, ..)
        masks = [fused_hbm.block_masks(b, dtype, device)
                 for b in blocks.blocks]
        loads = [fused_solver.uniform_loads(
            src["source_fn"], src["source_steady"], mass_c, m,
            grid=src["grid"], dt=dt, t0=0.0, use_ka=use_ka,
            lumped=src["lumped"], row0=b.row0)
            for b, (m, _) in zip(blocks.blocks, masks)] if sourced else None

        def load_of(d):
            return None if loads is None else loads[d].advance()[0]

        if device.type == "cuda":
            plans = [fused_hbm.block_plan(iters, use_ka, dtype, b)
                     for b in blocks.blocks]
            works = [fused_solver.uniform_work(p, U[0]) for p in plans]

            def block_step(d, src_, dst, load):
                fused_hbm.block_kernel_step(
                    scal, iters, src_[0], src_[1] if extrapolate else None,
                    dst[0], dst[1] if extrapolate else None, use_ka, None,
                    plans[d], blocks.blocks[d], load=load, work=works[d])
        else:
            def block_step(d, src_, dst, load):
                x, up = fused_hbm.plain_block_step(
                    scal, iters, src_[0], src_[1] if extrapolate else None,
                    use_ka, *masks[d], load)
                dst[0].copy_(x)
                if extrapolate:
                    dst[1].copy_(up)

        state, snaps = _run(state, blocks, n_steps, snapshot_every,
                            block_step, load_of)
        if snapshot_every is None:
            u_fam = fused_solver.from_canvases(spec, blocks.join(state)[0])
            return lifting.lifted_final_state(lift_at, u_fam[inv], dt,
                                              n_steps)
        u_fams = torch.stack([fused_solver.from_canvases(spec, s[0])
                              for s in snaps])
        return lifting.strided_trajectory(lift_at, u0, u_fams[:, inv], dt,
                                          snapshot_every, n_steps)

    def interval(matvec, diag_fam):
        lo, hi = linalg.power_bounds(matvec, torch.zeros_like(diag_fam),
                                     scale=1.0 / torch.sqrt(diag_fam))
        return float(lo), float(hi)

    if use_patch:
        xs = md.points[:, 0]
        half_width = float(xs.max() - xs.min()) / 2.0
        sys_c, _, mass_c, diag_c = uniform_mod.patch_constants(
            spec.n, half_width, problem, dt, order, stiffness_convention,
            dtype=md.midpoints.dtype, device=device)
        diag_fam = uniform_mod.family_diag_vector(spec, diag_c,
                                                  md.boundary_mask[perm])
        patch_pieces = (sys_c, mass_c, 1.0 / diag_c, interval(
            partial(uniform_mod.uniform_matvec, spec, sys_c), diag_fam))

        def solve(ops, u0):
            """``ops`` is not read on the patch route (pass None)."""
            return solve_with(patch_pieces, u0)

        return solve

    @_keep_last
    def pieces(ops):
        consts = uniform_mod.extract_constants(spec, ops.system.vals)
        return (consts, uniform_mod.family_constants(spec, ops.mass_diag),
                1.0 / uniform_mod.family_constants(spec, ops.system_diag),
                interval(partial(uniform_mod.uniform_matvec, spec, consts),
                         ops.system_diag[perm]))

    def solve(ops, u0):
        if ops is None:
            raise ValueError("the full-assembly route needs the assembled "
                             "GlobalOperators (assembly='patch' takes None)")
        return solve_with(pieces(ops), u0)

    return solve


def _keep_last(prepare):
    """``prepare(ops, *key)`` kept for the last operator set and key: a
    solver is called again and again with one ``ops``."""
    last = {"ops": None, "key": None, "value": None}

    def prepared(ops, *key):
        if last["ops"] is not ops or last["key"] != key:
            last["value"] = prepare(ops, *key)
            last["ops"], last["key"] = ops, key
        return last["value"]

    return prepared


def _prepare_canvas_operator(md, perm, dmask, blocks, ops, dtype):
    """``(C blocks, interval)``: the (n_blocks, 21, rows, n) extended
    blocks of the canvas operator of ``ops`` (masked mass on the reduced
    Dirichlet set ``dmask``) and the Chebyshev interval of the ELL system,
    the estimate of the serial canvas routes (CRBESolver,
    MultiSpeciesSolver)."""
    pattern = stencil_mod.get_pattern(md)
    coeffs = stencil_mod.extract_coefficients(pattern, ops.system.vals)
    mass_fam = torch.where(dmask[perm],
                           torch.zeros_like(ops.mass_diag[perm]),
                           ops.mass_diag[perm])
    C = fused_hbm.canvas_operator(pattern, coeffs, mass_fam,
                                  1.0 / ops.system_diag[perm], dtype)
    lo, hi = linalg.power_bounds(
        partial(sparse.ell_matvec, ops.system),
        torch.zeros_like(ops.system_diag),
        scale=1.0 / torch.sqrt(ops.system_diag))
    return blocks.split(C), (float(lo), float(hi))


def _canvas_setup(md, problem):
    """(reduced Dirichlet mask with the dead DOFs, dead mask or None)."""
    dmask = robin_terms(md, problem)[0]
    _, dead = obstacle_masks(md, problem)
    if dead is not None:
        dmask = dmask | dead
    return dmask, dead


def _prepare_canvas_at(md, problem, dt, order, stiffness_convention,
                       pattern, perm, dmask, blocks, coeff_time, dtype):
    """``(C blocks, interval)`` of the operator at ``coeff_time``, from
    models/crbe.assemble_canvas (no ELL operator), with the interval of the
    serial time-varying chunks (fused_hbm.canvas_interval), so that block
    and whole-canvas chunks take the same one."""
    coeffs, mass_raw_fam, diag_fam = assemble_canvas(
        md, problem, dt, order, stiffness_convention, coeff_time=coeff_time)
    mass_fam = torch.where(dmask[perm], torch.zeros_like(mass_raw_fam),
                           mass_raw_fam)
    C = fused_hbm.canvas_operator(pattern, coeffs, mass_fam, 1.0 / diag_fam,
                                  dtype)
    return blocks.split(C), fused_hbm.canvas_interval(pattern, coeffs,
                                                       diag_fam)


def build_canvas_hbm_halo_solver(mesh, mesh_data, problem, dt, *, order=1,
                                 iters=8, axis="mp", extrapolate=False,
                                 snapshot_every=None,
                                 source_quadrature="mass_lumped",
                                 n_steps=None,
                                 stiffness_convention="correct"):
    """Block-sharded canvas-operator solve on kernel B9: spatially varying
    coefficients, Robin walls and obstacles, over the assembled operator.

    The same blocks as :func:`build_hbm_halo_solver`, with the (21, n, n)
    canvas stack (15 coefficients of the masked system, masked mass,
    inverse diagonal; ops/fused_hbm.canvas_operator) cut into extended
    blocks once per operator set. Robin walls widen the rectangles by
    their wall lines on GLOBAL bounds (fused_hbm.robin_rect_bounds);
    inhomogeneous flux data comes from the elementwise
    ``problem.robin_g_xy`` on each block's part of the wall lines (a
    problem that overrides ``robin_g`` alone raises). Obstacles ride the
    masked coefficients: the initial state is carved, dead DOFs stay
    exactly 0 and get no lift. Sources as in :func:`build_hbm_halo_solver`.
    The Chebyshev interval is the serial canvas routes' ELL estimate.

    ``solve(ops, u0, t0=0.0, coeff_time=None)``: ``n_steps`` steps (default
    nt - 1) from time ``t0``. With ``coeff_time`` (a number) the operator
    is not ``ops`` (pass None) but models/crbe.assemble_canvas of the
    problem at that time, with the interval of the serial time-varying
    chunks (fused_hbm.canvas_interval): one chunk of
    models/unsteady.solve_time_varying(mesh=...). The stack of the last
    ``coeff_time`` is kept.
    """
    robin = getattr(problem, "robin_sides", None) or None
    g_on = False
    if robin and robin_g_customized(problem):
        if not robin_g_xy_provided(problem):
            raise ValueError(
                "this problem overrides robin_g without an elementwise "
                "robin_g_xy — the block-sharded canvas solver builds the "
                "flux load on each block's wall lines from robin_g_xy; "
                "override robin_g_xy or use the serial scan paths")
        g_on = True
    md = mesh_data
    if n_steps is None:
        n_steps = md.nt - 1
    _check_common(md, snapshot_every, n_steps, source_quadrature,
                  "canvas halo solver")
    pattern = stencil_mod.family_pattern(md)
    perm, inv = _perm_tensors(md)
    c = pattern.c
    use_ka = order == 2
    blocks = _blocks_of(mesh, axis, md, pattern.n, halo_rows(iters, use_ka))
    device = md.device
    sourced = not getattr(problem, "zero_source", False)
    grid = structured_grid(md) if sourced or g_on else None
    rect = fused_hbm.robin_rect_bounds(c, robin) if robin else (1, c, 1, c)
    dmask, dead = _canvas_setup(md, problem)
    lift_at = lifting.make_lift(problem, md.midpoints, dmask, zero_mask=dead)
    n_states = 2 if extrapolate else 1
    prepared = _keep_last(partial(_prepare_canvas_operator, md, perm, dmask,
                                  blocks))
    prepared_at = _keep_last(
        lambda _ops, coeff_time, dtype: _prepare_canvas_at(
            md, problem, dt, order, stiffness_convention, pattern, perm,
            dmask, blocks, coeff_time, dtype))

    def solve(ops, u0, t0=0.0, coeff_time=None):
        dtype = u0.dtype
        if coeff_time is not None:
            Cb, bounds = prepared_at(None, float(coeff_time), dtype)
        elif ops is None:
            raise ValueError("the canvas block solver needs assembled "
                             "GlobalOperators (or a coeff_time= for the "
                             "direct canvas assembly)")
        else:
            Cb, bounds = prepared(ops, dtype)
        if dead is not None:
            u0 = torch.where(dead, torch.zeros_like(u0), u0)
        cheb = fused_solver.cheb_scalars(bounds, iters, dtype, device)
        U = blocks.split(fused_solver.to_canvases(pattern, u0[perm]))
        state = torch.stack([U] * n_states, dim=1)
        masks = [fused_hbm.block_masks(b, dtype, device, rect)
                 for b in blocks.blocks]
        live = None
        if dead is not None:
            live = blocks.split(fused_hbm.canvas_live(pattern, dead[perm],
                                                      dtype))
        loads = []
        for d, b in enumerate(blocks.blocks):
            live_d = None if live is None else live[d]
            sources = EmissionLoads(
                (problem.source_xy,),
                (bool(getattr(problem, "steady_source", False)),),
                grid=grid, dt=dt, t0=t0, use_ka=use_ka,
                lumped=source_quadrature == "mass_lumped",
                mass3=Cb[d, 15:18], masks=masks[d][0], live=live_d,
                row0=b.row0) if sourced else None
            walls = RobinFluxLoads(
                problem.robin_g_xy, tuple(sorted(robin)), grid=grid, dt=dt,
                use_ka=use_ka, masks=masks[d][0], live=live_d,
                row0=b.row0) if g_on else None
            loads.append(fused_hbm.load_planes(sources, walls, t0, dt,
                                               U[d]))

        def load_of(d):
            return loads[d]()

        if device.type == "cuda":
            plan = fused_hbm.canvas_plan(iters, use_ka, dtype)
            work = fused_hbm.work_buffer(plan, U[0])

            def block_step(d, src, dst, load):
                fused_hbm.canvas_block_kernel_step(
                    Cb[d], cheb, iters, src[0],
                    src[1] if extrapolate else None, dst[0],
                    dst[1] if extrapolate else None, use_ka, rect, None,
                    plan, blocks.blocks[d], load=load, work=work)
        else:
            def block_step(d, src, dst, load):
                x, up = fused_hbm.plain_canvas_block_step(
                    Cb[d], cheb, iters, src[0],
                    src[1] if extrapolate else None, use_ka, *masks[d], load)
                dst[0].copy_(x)
                if extrapolate:
                    dst[1].copy_(up)

        state, snaps = _run(state, blocks, n_steps, snapshot_every,
                            block_step, load_of)
        if snapshot_every is None:
            u_fam = fused_solver.from_canvases(pattern, blocks.join(state)[0])
            return (u_fam[inv] + lift_at(t0 + dt * n_steps))[None, :]
        u_fams = torch.stack([fused_solver.from_canvases(pattern, s[0])
                              for s in snaps])
        return lifting.strided_trajectory(lift_at, u0, u_fams[:, inv], dt,
                                          snapshot_every, n_steps)

    return solve


def build_multispecies_hbm_halo_solver(mesh, mesh_data, problem, dt, *,
                                       order=1, iters=8, axis="mp",
                                       snapshot_every=None,
                                       source_quadrature="mass_lumped"):
    """Block-sharded Strang multispecies solve on kernel B10: K species on
    the shared canvas operator, both chemistry half-mixes (``E_half =
    expm(-dt/2 R)``, problems.expm64) inside the kernel.

    The blocks of :func:`build_canvas_hbm_halo_solver`: one exchange per
    step refreshes the halo rows of all K species (chemistry couples no
    two places, so the halo is the single-species one), then one launch
    per block runs the mixes and the K Chebyshev solves on its extended
    coefficient block; mixing the refreshed halo rows gives what the
    neighbouring block computes there. ``problem`` is a
    MultiSpeciesProblem with shared transport; Robin alpha walls ride the
    coefficients and the widened rectangles, obstacles the masked
    coefficients (dead state stays exactly 0), per-species emissions
    (``species[k].source_xy``) are loaded per block on global coordinates.

    ``solve(ops, C0)`` (``ops`` the shared assembled GlobalOperators) gives
    the ``(1, K, N)`` final state, or with ``snapshot_every=k`` the
    ``(n_snaps + 1, K, N)`` strided rows, boundary-lifted, row 0 the
    carved initial state.
    """
    p = problem
    if not p.shared_transport:
        raise ValueError(
            "the block-sharded multispecies solver needs shared (v, D) "
            "across species (one coefficient stack serves all)")
    md = mesh_data
    n_steps = md.nt - 1
    _check_common(md, snapshot_every, n_steps, source_quadrature,
                  "canvas halo solver")
    sp0 = p.species[0]
    robin = getattr(sp0, "robin_sides", None) or None
    K = p.n_species
    pattern = stencil_mod.get_pattern(md)
    perm, inv = _perm_tensors(md)
    n, c = pattern.n, pattern.c
    use_ka = order == 2
    blocks = _blocks_of(mesh, axis, md, n, halo_rows(iters, use_ka))
    device = md.device
    source_fns = tuple(
        None if getattr(sp, "zero_source", False) else sp.source_xy
        for sp in p.species) if not p.zero_source else (None,) * K
    steady = tuple(bool(getattr(sp, "steady_source", False))
                   for sp in p.species)
    needs_t = any(f is not None for f in source_fns)
    grid = structured_grid(md) if needs_t else None
    rect = fused_hbm.robin_rect_bounds(c, robin) if robin else (1, c, 1, c)
    dmask, dead = _canvas_setup(md, sp0)
    lift = make_species_lift(p, md.midpoints, dmask, dead)
    E_half = half_step_exponential(p.R, dt)
    prepared = _keep_last(partial(_prepare_canvas_operator, md, perm, dmask,
                                  blocks))

    def solve(ops, C0):
        if ops is None:
            raise ValueError("the block-sharded multispecies solver needs "
                             "the shared assembled GlobalOperators")
        dtype = C0.dtype
        Cb, bounds = prepared(ops, dtype)
        if dead is not None:
            C0 = torch.where(dead[None, :], torch.zeros_like(C0), C0)
        state = blocks.split(torch.cat([
            fused_solver.to_canvases(pattern, C0[k][perm])
            for k in range(K)]))  # (blocks, 3 K, rows, n)
        masks = [fused_hbm.block_masks(b, dtype, device, rect)
                 for b in blocks.blocks]
        live = None
        if dead is not None:
            live = blocks.split(fused_hbm.canvas_live(pattern, dead[perm],
                                                      dtype))
        loads = [EmissionLoads(
            source_fns, steady, grid=grid, dt=dt, t0=0.0, use_ka=use_ka,
            lumped=source_quadrature == "mass_lumped", mass3=Cb[d, 15:18],
            masks=masks[d][0], live=None if live is None else live[d],
            row0=b.row0) for d, b in enumerate(blocks.blocks)
        ] if needs_t else None
        index = loads[0].index if needs_t else [-1] * K

        def load_of(d):
            return None if loads is None else loads[d].advance()

        def species(x):
            return x.view(K, 3, blocks.rows, n)

        if device.type == "cuda":
            plan = fused_hbm.multispecies_plan(K, iters, use_ka, dtype)
            work = fused_hbm.work_buffer(plan, Cb[0], K)
            scal = fused_hbm.multispecies_scalars(bounds, iters, E_half,
                                                  dtype, device)

            def block_step(d, src, dst, planes):
                fused_hbm.multispecies_block_kernel_step(
                    Cb[d], scal, iters, species(src), species(dst), use_ka,
                    rect, None, plan, blocks.blocks[d], planes, index, work)
        else:
            cheb = fused_solver.cheb_scalars(bounds, iters, dtype, device)
            E = E_half.to(dtype=dtype, device=device)

            def block_step(d, src, dst, planes):
                species(dst).copy_(fused_hbm.plain_multispecies_block_step(
                    Cb[d], cheb, E, iters, species(src), use_ka, *masks[d],
                    planes, index))

        state, snaps = _run(state, blocks, n_steps, snapshot_every,
                            block_step, load_of)

        def to_fam(U_can):
            U_can = U_can.view(K, 3, n, n)
            return torch.stack([fused_solver.from_canvases(pattern, U_can[k])
                                for k in range(K)])[:, inv]

        if snapshot_every is None:
            return (to_fam(blocks.join(state)) + lift(dt * n_steps))[None]
        rows = [to_fam(s) + lift(dt * snapshot_every * (j + 1))
                for j, s in enumerate(snaps)]
        return torch.cat([C0[None], torch.stack(rows)])

    return solve
