"""The launch plan of the canvas kernels (B4, its raw and block modes, B6)
on the CPU, where no kernel runs.

ops/fused_hbm.canvas_plan picks each step's output tile and the number of
launches (spans) its phases are split over, so that every span's window
fits the compiled launch shape's registers and its planes shared memory;
past that envelope it raises the messages the kernels always raised. A
split step runs the same per-cell arithmetic in the same order, so the
plain versions split at the kernels' spans equal the whole step bitwise.
The wrappers hand a launch the plan's tile and depth and a work buffer of
9 planes per species (two sets from depth 3 on)."""

import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.models import crbe  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, fused_solver  # noqa: E402
from airpollution_tpu_torch.ops import stencil  # noqa: E402
from airpollution_tpu_torch.problems import expm64  # noqa: E402

F32, F64 = torch.float32, torch.float64
MODES = [("step", None), ("raw", None)] + [("multispecies", K)
                                           for K in (1, 3, 8)]


def _plan(mode, K, k, use_ka, dtype):
    if mode == "raw":
        return fused_hbm.raw_plan(k, dtype)
    if mode == "multispecies":
        return fused_hbm.multispecies_plan(K, k, use_ka, dtype)
    return fused_hbm.canvas_plan(k, use_ka, dtype)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("mode,K", MODES)
def test_every_plan_fits_its_budget(mode, K, dtype):
    """For k <= 24, BE and CN: every span's window holds at most threads x
    cells cells, its planes fit shared memory, the depth is at most 4, and
    the spans cover the step's phases."""
    threads, cells = fused_hbm.CANVAS_SHAPE[dtype]
    elem = torch.tensor([], dtype=dtype).element_size()
    planes = 6 if mode != "multispecies" else 3 * K + 6
    raw = mode == "raw"
    for k in range(1, 25):
        for use_ka in ((False,) if raw else (False, True)):
            plan = _plan(mode, K, k, use_ka, dtype)
            assert plan.tile in fused_hbm.PLAN_TILES
            assert 1 <= plan.depth <= fused_hbm.MAX_DEPTH
            spans = fused_hbm.canvas_spans(k, use_ka, raw, plan.depth)
            assert sum(s.halo for s in spans) == \
                fused_hbm.step_halo(k, use_ka, raw)
            for s in spans:
                w = plan.tile + 2 * s.halo
                assert w * w <= threads * cells
                assert planes * w * w * elem <= fused_solver.SMEM_BUDGET


def test_spans_deal_the_phases_as_the_kernels_do():
    """The halos go to the earlier spans first; each span's iterations
    follow the last one's; ``ext`` is the later spans' halo."""
    spans = fused_hbm.canvas_spans(14, False, False, 2)
    assert [(s.halo, s.it0, s.it1, s.ext) for s in spans] == \
        [(7, 0, 6, 7), (7, 6, 13, 0)]
    spans = fused_hbm.canvas_spans(8, True, False, 3)  # H = 9: 3, 3, 3
    assert [(s.halo, s.it0, s.it1, s.ext) for s in spans] == \
        [(3, 0, 1, 6), (3, 1, 4, 3), (3, 4, 7, 0)]
    spans = fused_hbm.canvas_spans(24, False, True, 4)  # H = 23
    assert [(s.halo, s.it0, s.it1) for s in spans] == \
        [(6, 0, 6), (6, 6, 12), (6, 12, 18), (5, 18, 23)]
    assert [(s.first, s.last) for s in spans] == \
        [(True, False), (False, False), (False, False), (False, True)]
    # A later span runs at least one iteration; the first holds the
    # right-hand side and the initial residual.
    assert not fused_hbm.depth_fits(1, True, False, 2)
    assert not fused_hbm.depth_fits(2, False, True, 2)
    assert not fused_hbm.depth_fits(30, False, False, 5)
    with pytest.raises(ValueError, match="depth 2"):
        fused_hbm.canvas_spans(1, False, False, 2)


def test_past_the_envelope_the_old_messages_raise():
    with pytest.raises(ValueError, match="halo 61 too deep"):
        fused_hbm.canvas_plan(60, True, F64)
    with pytest.raises(ValueError, match="chebyshev_iters=60 too deep for "
                                         "the raw mode"):
        fused_hbm.raw_plan(60, F64)
    with pytest.raises(ValueError, match="K=8.*chebyshev_iters=60"):
        fused_hbm.multispecies_plan(8, 60, True, F64)
    with pytest.raises(ValueError, match="1 to 8 species"):
        fused_hbm.multispecies_plan(9, 4, False, F32)


def _canvas(ms=17, problem=None, order=2):
    """A 17^2 canvas operator in f64 (C3's Robin walls and building by
    default), its masks, rect, dead DOFs and a state."""
    class RobinObstacle(tapt.Problem):
        robin_sides = {"bottom": 0.05, "top": 0.0}
        obstacles = ((-4.0, 4.0, -4.0, 4.0),)

    problem = problem or RobinObstacle(sigma=3.0)
    md = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=41,
                       dtype=F64, device="cpu")
    ops = crbe.assemble(md, problem, md.domain.T / (md.nt - 1), order)
    pattern = stencil.get_pattern(md)
    perm = torch.as_tensor(pattern.perm.astype("int64"))
    dmask = crbe.robin_terms(md, problem)[0]
    _, dead = crbe.obstacle_masks(md, problem)
    if dead is not None:
        dmask = dmask | dead
    bm = dmask[perm]
    rect = fused_hbm.robin_rect_bounds(pattern.c, problem.robin_sides) \
        if getattr(problem, "robin_sides", None) else (1, pattern.c, 1,
                                                       pattern.c)
    C = fused_hbm.canvas_operator(
        pattern, stencil.extract_coefficients(pattern, ops.system.vals),
        torch.where(bm, torch.zeros_like(ops.mass_diag[perm]),
                    ops.mass_diag[perm]),
        1.0 / ops.system_diag[perm], F64)
    masks = fused_solver.rect_masks(pattern.n, F64, "cpu", rect)
    u = problem.initial_condition_fn(md.midpoints)
    if dead is not None:
        u = torch.where(dead, torch.zeros_like(u), u)
    u = fused_solver.to_canvases(pattern, u[perm])
    dead3 = None if dead is None else \
        fused_solver.to_canvases(pattern, dead[perm].to(F64)).bool()
    return C, masks, u, dead3


@pytest.mark.parametrize("use_ka", [False, True])
def test_split_plain_steps_equal_the_whole_step_bitwise(use_ka):
    """B4 (with extrapolation and a load), B4's raw mode and B6 at every
    depth that splits k = 14: the plain versions through the kernels'
    spans equal the whole step bitwise at 17^2 in f64, on a Robin
    rectangle with a building whose dead DOFs stay exactly 0."""
    C, masks, u, dead3 = _canvas(order=2 if use_ka else 1)
    k = 14
    cheb = fused_solver.cheb_scalars((0.05, 1.9), k, F64, "cpu")
    up = 0.9 * u
    load = 1e-3 * masks * (1.0 - dead3.to(F64))
    whole, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, up, use_ka, masks,
                                           load)
    raw = fused_hbm.plain_canvas_raw(C, cheb, k, u, masks)
    E = expm64(-0.05 * torch.tensor([[0.4, 0.0], [-0.4, 0.2]]))
    U = torch.stack([u, 0.5 * u])
    ms = fused_hbm.plain_multispecies_step(C, cheb, E, k, U, use_ka, masks,
                                           load[None], [0, -1])
    for depth in range(2, fused_hbm.MAX_DEPTH + 1):
        got, _ = fused_hbm.plain_canvas_step(C, cheb, k, u, up, use_ka, masks,
                                             load, depth)
        assert torch.equal(got, whole)
        assert torch.equal(
            fused_hbm.plain_canvas_raw(C, cheb, k, u, masks, depth), raw)
        got = fused_hbm.plain_multispecies_step(C, cheb, E, k, U, use_ka,
                                                masks, load[None], [0, -1],
                                                depth)
        assert torch.equal(got, ms)
    assert float(whole[dead3].abs().max()) == 0.0
    assert float(ms[:, dead3].abs().max()) == 0.0
    # The split step is the step: its x after the last span's x += d is
    # that of k plain Chebyshev iterations.
    S, m, idg = C[:15], C[15:18], C[18:21]
    x = masks * (2.0 * u - up)
    r = (2.0 * m * u + (1.0 - masks) * u - fused_solver.stencil_terms(S, u)
         if use_ka else m * u) + load - fused_solver.stencil_terms(S, x)
    d = cheb[0] * (idg * r)
    for it in range(k):
        x = x + d
        r = r - fused_solver.stencil_terms(S, d)
        d = cheb[1 + it] * d + cheb[1 + k + it] * (idg * r)
    assert torch.equal(x, whole)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _cuda(t):
    return torch.Tensor._make_subclass(_CudaTyped, t)


@pytest.mark.parametrize("depth,sets", [(1, 0), (2, 1), (3, 2)])
def test_wrappers_hand_the_plan_and_a_work_buffer(monkeypatch, depth, sets):
    """B4, its raw mode and B6 pass the plan's tile and depth, and a work
    buffer of 9 planes per species and set (none at depth 1)."""
    from airpollution_tpu_torch import _build

    n, K = 9, 2
    calls = []
    for kern in (fused_hbm.CANVAS_KERNEL, fused_hbm.CANVAS_RAW_KERNEL,
                 fused_hbm.MULTISPECIES_KERNEL):
        monkeypatch.setattr(kern, "launch",
                            lambda dtype, *a, kern=kern: calls.append(
                                (kern.name, a)))
    monkeypatch.setattr(_build, "current_stream", lambda: 7)
    # A pointer stands for its tensor's size.
    monkeypatch.setattr(_build, "pointer",
                        lambda t: None if t is None else t.numel())
    plan = fused_hbm.CanvasPlan(8, depth)
    C = _cuda(torch.zeros((21, n, n)))
    cheb = _cuda(torch.zeros(1 + 2 * 6))
    u = _cuda(torch.zeros((3, n, n)))
    fused_hbm.canvas_kernel_step(C, cheb, 6, u, None, u, None, False,
                                 (1, 8, 1, 8), None, plan)
    fused_hbm.canvas_raw_kernel(C, cheb, 6, u, u, (1, 8, 1, 8), plan)
    U = _cuda(torch.zeros((K, 3, n, n)))
    scal = _cuda(torch.zeros(1 + 2 * 6 + K * K))
    fused_hbm.multispecies_kernel_step(C, scal, 6, U, U, True, (1, 8, 1, 8),
                                       None, plan)
    (b4, a4), (raw, ar), (b6, a6) = calls
    assert (b4, raw, b6) == ("canvas_step", "canvas_step_raw",
                             "multispecies_step")
    assert a4[9:12] == (n, 8, depth) and ar[5:8] == (n, 8, depth)
    assert a6[9:12] == (n, 8, depth)
    work = {"b4": a4[8], "raw": ar[4], "b6": a6[6]}
    if depth == 1:
        assert set(work.values()) == {None}
    else:
        assert work["b4"] == work["raw"] == sets * 9 * n * n
        assert work["b6"] == sets * 9 * K * n * n
    assert all(a[-1] == 7 for _, a in calls)
