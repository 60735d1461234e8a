"""The launch plans of the uniform step (B1, B2, B8) and of the BiCGStab
whole loop (B5, B1's BiCGStab variant) on the CPU, where no kernel runs.

ops/fused_solver.uniform_plan picks a step's output tile (rows x columns)
and the number of launches (spans) it is split over, so that every span's
window fits the compiled launch shape's registers and its two d planes
shared memory, for every k the kernels take; among the tiles that fit, by
one rule (uniform_cost) at every shape. The tiles cover the live cells
(global rows and columns below c = n - 1); their written cells partition
the whole canvas, or a block's interior rows, and in block mode the tile
height is balanced over the block's live rows.
ops/fused_solver.bicgstab_cells keeps 1 or 2 cells per thread in registers
while one 512-thread block per SM covers the canvas and the operator's
registers allow, and runs in global mode beyond. The wrappers hand each
launch its plan."""

import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402
from airpollution_tpu_torch.parallel import hbm_shard  # noqa: E402

F32, F64 = torch.float32, torch.float64
fs = fused_solver


def _window(plan, k, use_ka):
    h = fs.step_spans(k, use_ka, False, plan.depth)[0].halo
    return (plan.th + 2 * h) * (plan.tw + 2 * h)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("use_ka", [False, True])
@pytest.mark.parametrize("region", ["canvas", "block"])
def test_every_uniform_plan_fits_its_budget(dtype, use_ka, region):
    """For every k up to MAX_ITERS the plan's first (widest) span fits the
    registers (window cells <= threads x the most cells per thread) and
    shared memory (6 planes), at the least depth that fits."""
    threads, cells = fs.UNIFORM_SHAPE[dtype]
    elem = torch.tensor([], dtype=dtype).element_size()
    for n in (17, 129, 1025):
        for k in range(1, fs.MAX_ITERS + 1):
            plan = fs.uniform_plan(k, use_ka, dtype, n,
                                   live_rows=(n - 1) // 2
                                   if region == "block" else None)
            assert 1 <= plan.depth <= fs.MAX_DEPTH
            assert fs.uniform_plan_fits(plan, k, use_ka, dtype)
            w = _window(plan, k, use_ka)
            assert w <= threads * max(cells)
            assert 6 * w * elem <= fs.SMEM_BUDGET
            assert plan.th <= n - 1 and plan.tw <= n - 1
            if plan.depth > 1:  # a shallower split would not fit
                for d in range(1, plan.depth):
                    if fs.depth_fits(k, use_ka, False, d):
                        assert not fs.uniform_plan_fits(
                            fs.UniformPlan(8, 8, d), k, use_ka, dtype)


def test_main_path_plans():
    """B1 keeps its 24^2 tiles at 257^2 (121 blocks, one wave); B2's tiles
    divide the live cells at 1025^2; the deep f64 steps split."""
    assert fs.uniform_plan(4, False, F32, 257) == fs.UniformPlan(24, 24, 1)
    plan = fs.uniform_plan(8, False, F32, 1025)
    rows, cols = fs.uniform_tiles(plan, 1025)
    assert rows * plan.th >= 1024 and cols * plan.tw >= 1024
    assert (rows - 1) * plan.th < 1024 and (cols - 1) * plan.tw < 1024
    assert fs.uniform_plan(64, True, F64, 257).depth == 4


@pytest.mark.parametrize("k,use_ka,dtype,n,live", [
    (4, False, F32, 257, None), (8, False, F32, 1025, None),
    (4, False, F32, 513, None), (10, False, F32, 2049, None),
    (10, False, F32, 2049, 513), (8, True, F64, 1025, None)])
def test_uniform_plan_is_the_least_cost_candidate(k, use_ka, dtype, n, live):
    """One rule at every shape: the plan is a candidate of least
    uniform_cost, and among those the squarer, then the wider."""
    plan = fs.uniform_plan(k, use_ka, dtype, n, live_rows=live)
    plans = fs.uniform_candidates(k, use_ka, dtype, n, plan.depth, live)
    assert plan in plans

    def cost(p):
        return fs.uniform_cost(p, k, use_ka, dtype, n, live)

    least = [p for p in plans if cost(p) == cost(plan)]
    assert all(cost(p) >= cost(plan) for p in plans)
    assert max((min(p.th, p.tw), p.tw) for p in least) == \
        (min(plan.th, plan.tw), plan.tw)


def test_uniform_cost_counts_waves_and_row_steps():
    """uniform_cost: the waves of tiles on 132 SMs times the sum over the
    phases of ceil(rows x window width / threads)."""
    # 257^2, k=4, 24^2 tiles: 11 x 11 = 121 tiles, one wave; a 32^2 window
    # whose phases keep 32, 30, 28, 26, 24 rows of 32 cells, 2 steps each.
    assert fs.uniform_cost(fs.UniformPlan(24, 24, 1), 4, False, F32,
                           257) == 10
    # 20^2 tiles: 13 x 13 = 169 tiles, two waves of 28-wide rows.
    assert fs.uniform_cost(fs.UniformPlan(20, 20, 1), 4, False, F32,
                           257) == 2 * 10
    # f64 runs 256 threads.
    assert fs.uniform_cost(fs.UniformPlan(24, 24, 1), 4, False, F64,
                           257) == 4 + 4 + 4 + 4 + 3


def _written(plan, n, lo, hi, row0):
    """The cells each tile of a uniform step writes and computes, as
    csrc/tile_step.cuh deals them: {(tile row, tile col): (written rows,
    written cols, computed rows, computed cols)} as ranges."""
    c = n - 1
    live_hi = min(max(c - row0, lo), hi)
    R, C = fs.uniform_tiles(plan, n, live_hi - lo)
    out = {}
    for tr in range(R):
        for tc in range(C):
            rs = lo + tr * plan.th
            re = hi if tr == R - 1 else rs + plan.th
            cs = tc * plan.tw
            ce = n if tc == C - 1 else cs + plan.tw
            out[(tr, tc)] = (range(rs, re), range(cs, ce),
                             range(rs, min(rs + plan.th, re)),
                             range(cs, min(cs + plan.tw, ce)))
    return out, live_hi


@pytest.mark.parametrize("n,n_blocks,k,use_ka", [
    (17, 2, 4, False), (65, 4, 8, True), (257, 4, 8, False),
    (513, 2, 14, True), (2049, 4, 10, False), (2049, 4, 14, True)])
def test_block_tiles_cover_each_interior_once(n, n_blocks, k, use_ka):
    """Every interior cell of every block is written by exactly one tile,
    every live cell (global row and column below c) is computed, and the
    tile height is balanced over the block's live rows: the last tile row
    overruns them by less than one row per tile row."""
    blocks = hbm_shard.RowBlocks(n, n_blocks, hbm_shard.halo_rows(k, use_ka))
    for b in blocks.blocks:
        plan = fused_hbm.block_plan(k, use_ka, F32, b)
        assert fs.uniform_plan_fits(plan, k, use_ka, F32)
        _, _, row0, lo, hi = b.kernel_args()
        tiles, live_hi = _written(plan, n, lo, hi, row0)
        assert live_hi - lo == b.live_rows
        count = torch.zeros((hi - lo, n), dtype=torch.int32)
        computed = torch.zeros((hi - lo, n), dtype=torch.bool)
        for wr, wc, cr, cc in tiles.values():
            count[wr.start - lo:wr.stop - lo, wc.start:wc.stop] += 1
            computed[cr.start - lo:cr.stop - lo, cc.start:cc.stop] = True
        assert bool((count == 1).all())
        assert bool(computed[:b.live_rows, :n - 1].all())
        R = fs.uniform_tiles(plan, n, b.live_rows)[0]
        if b.live_rows:
            assert R * plan.th - b.live_rows < R


@pytest.mark.parametrize("n", [17, 129, 257, 1025])
def test_whole_canvas_tiles_partition_the_canvas(n):
    for k, use_ka in ((4, False), (8, True)):
        for dtype in (F32, F64):
            plan = fs.uniform_plan(k, use_ka, dtype, n)
            tiles, live_hi = _written(plan, n, 0, n, 0)
            assert live_hi == n - 1
            count = torch.zeros((n, n), dtype=torch.int32)
            for wr, wc, cr, cc in tiles.values():
                count[wr.start:wr.stop, wc.start:wc.stop] += 1
            assert bool((count == 1).all())


@pytest.mark.parametrize("operator", ["uniform", "canvas"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_bicgstab_cells_and_mode(operator, dtype):
    """From n = 17 to 1025: the fewest cells per thread (1, 2) that cover
    the canvas with at most one 512-thread block per SM, within the
    operator's register capacity; global mode (0) only where none does."""
    most = fs.BICGSTAB_CELLS[(operator, dtype)]
    for n in list(range(17, 1026, 16)) + [257, 363, 513, 1025]:
        cells = fs.bicgstab_cells(n, operator, dtype)
        total = n * n
        fitting = [c for c in (1, 2) if c <= most
                   and -(-total // (512 * c)) <= fs.H100_SMS]
        assert cells == (fitting[0] if fitting else 0)
    # The main paths' 257^2 keeps one cell per thread; on a card of fewer
    # SMs it needs more.
    assert fs.bicgstab_cells(257, operator, dtype) == 1
    assert fs.bicgstab_cells(257, operator, dtype, sms=100) == \
        (2 if most >= 2 else 0)
    assert fs.bicgstab_cells(1025, operator, dtype) == 0


def test_bicgstab_cells_beyond_the_registers():
    """321^2 and 363^2 keep 2 cells per thread for the uniform operator in
    f32 and run the canvas operator in global mode; 513^2 (4 cells per
    thread) runs both in global mode."""
    for n in (321, 363):
        assert fs.bicgstab_cells(n, "uniform", F32) == 2
        assert fs.bicgstab_cells(n, "canvas", F32) == 0
    for op in ("uniform", "canvas"):
        for dtype in (F32, F64):
            assert fs.bicgstab_cells(513, op, dtype) == 0


class _CudaTyped(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _cuda(t):
    return torch.Tensor._make_subclass(_CudaTyped, t)


def _record(monkeypatch, *kernels):
    calls = []
    for kern in kernels:
        monkeypatch.setattr(kern, "launch",
                            lambda dtype, *a, kern=kern: calls.append(
                                (kern.name, a)))
    monkeypatch.setattr(_build, "current_stream", lambda: 7)
    # A pointer stands for its tensor's size.
    monkeypatch.setattr(_build, "pointer",
                        lambda t: None if t is None else t.numel())
    return calls


@pytest.mark.parametrize("depth,sets", [(1, 0), (2, 1), (3, 2)])
def test_uniform_wrappers_hand_the_plan(monkeypatch, depth, sets):
    """B1, B2 and B8 pass the plan's tile rows, columns and depth, and a
    work buffer of 9 planes per set (none at depth 1)."""
    calls = _record(monkeypatch, fs.KERNEL, fs.LOAD_KERNEL, fused_hbm.KERNEL,
                    fused_hbm.LOAD_KERNEL, fused_hbm.BLOCK_KERNEL)
    n, k = 17, 8
    plan = fs.UniformPlan(8, 16, depth)
    scal = _cuda(torch.zeros(22 + 2 * k))
    u = _cuda(torch.zeros((3, n, n)))
    fused_hbm.kernel_step(scal, k, u, u, u, u, False, None, plan)
    fused_hbm.kernel_step(scal, k, u, u, u, u, False, None, plan, load=u)
    block = fused_hbm.BlockRows(n, -16, 16, 8)
    ub = _cuda(torch.zeros((3, block.rows, n)))
    fused_hbm.block_kernel_step(scal, k, ub, None, ub, None, True, None, plan,
                                block)
    fs.kernel_solve(scal, u, n_steps=3, n_iters=k, use_ka=False,
                    extrapolate=True, plan=plan)
    fs.kernel_solve(scal, u, n_steps=3, n_iters=k, use_ka=True,
                    extrapolate=False, plan=plan, load=u)
    (b2, a2), (b2l, a2l), (b8, a8), (b1, a1), (b1l, a1l) = calls
    assert (b2, b2l, b8, b1, b1l) == ("uniform_step", "uniform_step_load",
                                      "uniform_block_step", "uniform_solver",
                                      "uniform_solver_load")
    assert a2[7:13] == (n, 8, 16, depth, k, 0)
    assert a2l[8:14] == (n, 8, 16, depth, k, 0)
    assert a8[7:17] == (*block.kernel_args(), 8, 16, depth, k, 1)
    assert a1[6:13] == (n, 8, 16, depth, k, 0, 3)
    assert a1l[7:15] == (n, 8, 16, depth, k, 1, 3, 0)
    work = {"b2": a2[6], "b2l": a2l[7], "b8": a8[6], "b1": a1[5],
            "b1l": a1l[6]}
    if depth == 1:
        assert set(work.values()) == {None}
    else:
        assert work["b2"] == work["b2l"] == work["b1"] == sets * 9 * n * n
        assert work["b8"] == sets * 9 * block.rows * n
    assert a2[-1] == a2l[-1] == a8[-1] == a1[-2] == a1l[-2] == 7


@pytest.mark.parametrize("cells,planes", [(1, 6), (2, 6), (0, 12)])
def test_bicgstab_wrappers_hand_the_cells(monkeypatch, cells, planes):
    """B5 and B1's BiCGStab variant pass the plan's cells per thread, and
    a work buffer of 6 canvases in register mode, 12 in global mode, and
    the four partial sums with the barrier's counter."""
    calls = _record(monkeypatch, fs.CANVAS_KERNEL, fs.BICGSTAB_KERNEL)
    n = 9
    u = _cuda(torch.zeros((3, n, n)))
    C = _cuda(torch.zeros((24, n, n)))
    fs.kernel_bicgstab_solve(C, u, n_steps=2, n_iters=5, use_ka=False,
                             extrapolate=True, cells=cells)
    scal = _cuda(torch.zeros(21))
    fs.kernel_uniform_bicgstab_solve(scal, u, n_steps=2, n_iters=5,
                                     use_ka=True, extrapolate=False,
                                     cells=cells)
    (b5, a5), (b1, a1) = calls
    assert (b5, b1) == ("canvas_solver", "uniform_bicgstab")
    assert a5[5:10] == (n, 2, 5, 0, cells)
    assert a1[6:12] == (n, 2, 5, 1, 0, cells)
    assert a5[3] == a1[3] == planes * 3 * n * n
    assert a5[4] == a1[4] == 4 * fs.CANVAS_MAX_GRID + 1


def test_spans_are_shared_with_the_canvas_kernels():
    """The canvas kernels' spans are the uniform step's (one make_span in
    csrc/tile_step.cuh)."""
    for k, use_ka, raw in ((14, False, False), (8, True, False),
                           (24, False, True)):
        for depth in range(1, fs.MAX_DEPTH + 1):
            if fs.depth_fits(k, use_ka, raw, depth):
                assert fused_hbm.canvas_spans(k, use_ka, raw, depth) == \
                    fs.step_spans(k, use_ka, raw, depth)
