"""The launch paths of kernels B3 and B7 on the CPU, where no kernel runs.

B3's bound operator (ops/fused_stencil.StencilOperator) checks the
coefficient grids once, x on every call, and hands the launch the grids'
and x's pointers and n; B7's int32 columns are checked once, when the
index is built (ops/gather.KernelIndex), and a product passes their
pointer, the values' and x's, and the expected ints. A CUDA-typed CPU tensor stands in for a card tensor, with
``Kernel.launch`` patched to record what a launch would receive. A failed
launch raises and never falls back to the plain version, the stream is
read on every call, and ``_build.Kernel`` resolves each dtype's C symbol
once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.ops import fused_stencil, gather  # noqa: E402
from airpollution_tpu_torch.ops import sparse, stencil  # noqa: E402

F32, F64 = torch.float32, torch.float64


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _cuda_typed(t):
    return torch.Tensor._make_subclass(_CudaTyped, t)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _recorder(monkeypatch, kernel):
    """Patch ``kernel.launch`` to record (dtype, args) and launch
    nothing."""
    calls = []
    monkeypatch.setattr(kernel, "launch",
                        lambda dtype, *args: calls.append((dtype, args)))
    return calls


def _streams(monkeypatch, *values):
    it = iter(values)
    monkeypatch.setattr(_build, "current_stream", lambda: next(it))


def _pattern(ms=5):
    md = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=4,
                       dtype=F64, device="cpu")
    return stencil.get_pattern(md)


def _grids(pattern, dtype=F32, seed=0, wrap=_cuda_typed):
    n, c = pattern.n, pattern.c
    rng = np.random.default_rng(seed)
    shapes = [(n, c)] * 5 + [(c, n)] * 5 + [(c, c)] * 5
    return tuple(wrap(torch.tensor(rng.standard_normal(s), dtype=dtype))
                 for s in shapes)


def test_b3_operator_refuses_what_the_kernel_does_not_take():
    pattern = _pattern()
    good = _grids(pattern)
    with pytest.raises(ValueError, match="15 coefficient grids"):
        fused_stencil.StencilOperator(pattern, good[:14])
    with pytest.raises(ValueError, match="entries"):
        fused_stencil.StencilOperator(pattern, good[:14] + (good[0],))
    with pytest.raises(ValueError, match="one dtype"):
        fused_stencil.StencilOperator(pattern,
                                      good[:14] + (good[14].double(),))
    with pytest.raises(ValueError, match="float32 or float64"):
        fused_stencil.StencilOperator(
            pattern, tuple(g.to(torch.float16) for g in good))
    op = fused_stencil.StencilOperator(pattern, good)
    for x in (torch.ones(op.size - 1), torch.ones(op.size, dtype=F64),
              torch.ones(2, op.size)):
        with pytest.raises(ValueError, match="kernel B3 takes x"):
            op(_cuda_typed(x))


@pytest.mark.parametrize("ms", [3, 5])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_b3_launch_passes_the_bound_pointers_and_n(monkeypatch, dtype, ms):
    pattern = _pattern(ms)
    coeffs = _grids(pattern, dtype)
    calls = _recorder(monkeypatch, fused_stencil.KERNEL)
    _streams(monkeypatch, 111, 222)
    op = fused_stencil.StencilOperator(pattern, coeffs)
    x = _cuda_typed(torch.ones(op.size, dtype=dtype))
    y1, y2 = op(x), op(x)
    assert [d for d, _ in calls] == [dtype, dtype]
    (_, (desc, xp, yp, s1)), (_, (desc2, _, yp2, s2)) = calls
    assert (s1, s2) == (111, 222)  # the stream is read on every call
    assert desc is desc2 and xp == x.data_ptr()
    assert (yp, yp2) == (y1.data_ptr(), y2.data_ptr())
    got = desc.contents
    assert list(got.coefs) == [g.data_ptr() for g in coeffs]
    assert got.n == pattern.n


def test_b3_failure_raises_instead_of_falling_back(monkeypatch):
    """A CUDA-typed product whose B3 launch fails raises, through the bound
    operator, its BoundMatvec form and stencil_matvec_fused; the plain
    version is never taken in its place."""
    def failed(*_a, **_k):
        raise RuntimeError("stencil_matvec launch failed: injected (1)")

    monkeypatch.setattr(fused_stencil.KERNEL, "launch", failed)
    monkeypatch.setattr(_build, "current_stream", lambda: None)
    calls = _spy(monkeypatch, stencil, "stencil_matvec")
    pattern = _pattern()
    coeffs = _grids(pattern)
    op = fused_stencil.StencilOperator(pattern, coeffs)
    x = _cuda_typed(torch.ones(op.size))
    for call in (lambda: op(x), lambda: op.matvec(x, *coeffs),
                 lambda: fused_stencil.stencil_matvec_fused(pattern, coeffs,
                                                            x)):
        with pytest.raises(RuntimeError, match="injected"):
            call()
    assert not calls


@pytest.mark.parametrize("order", [1, 2])
def test_pallas_solve_binds_b3_once_per_operator(monkeypatch, order):
    """The scan path with matvec_impl="pallas" binds the system operator
    (and K+A in CN) once per solve; the CPU solve runs the plain version
    and equals the "stencil" solve."""
    built = _spy(monkeypatch, fused_stencil, "StencilOperator")
    md = tapt.MeshData(tapt.create_mesh(9, 20.0), tapt.Domain(), nt=6,
                       dtype=F64, device="cpu")
    out = {}
    for impl in ("pallas", "stencil"):
        s = CRBESolver(tapt.Domain(), tapt.Problem(), md, device="cpu",
                       time_scheme_order=order, matvec_impl=impl,
                       solver_tol=1e-12)
        out[impl] = s.solve(store_solutions=False)
    assert len(built) == order
    assert fused_stencil.KERNEL.launches == 0
    torch.testing.assert_close(out["pallas"], out["stencil"], rtol=0,
                               atol=1e-14)


def test_bound_matvec_keeps_the_binding_when_detached():
    from airpollution_tpu_torch.models import crbe

    md = tapt.MeshData(tapt.create_mesh(5, 20.0), tapt.Domain(), nt=4,
                       dtype=F64, device="cpu")
    pattern = stencil.get_pattern(md)
    ops = crbe.assemble(md, tapt.Problem(), 0.1, 1)
    _, matvec, _ = stencil.family_operators(pattern, ops, 1, kernel=True)
    det = matvec.detached()
    assert det.fn is matvec.fn
    assert isinstance(matvec.fn.__self__, fused_stencil.StencilOperator)
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        md.number_of_segments))
    torch.testing.assert_close(
        det(x), stencil.stencil_matvec(pattern, matvec.params, x),
        rtol=0, atol=0)


def _ell(n=6, seed=0):
    """A structurally symmetric ELL operator: row r couples r-1, r, r+1
    (cyclic)."""
    rng = np.random.default_rng(seed)
    cols = np.stack([(np.arange(n) + k) % n for k in (-1, 0, 1)], 1)
    width = cols.shape[1]
    idx = sparse.ell_index(cols, "cpu")
    vals = torch.tensor(rng.standard_normal((n, width)), dtype=F32)
    return sparse.EllMatrix(vals, *idx)


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stack"])
def test_b7_launch_passes_pointers_and_ints(monkeypatch, stacked):
    A = _ell()
    n, w = A.vals.shape
    B = 3
    calls = _recorder(monkeypatch, gather.KERNEL)
    _streams(monkeypatch, 111, 222)
    if stacked:
        A = sparse.stack_ell([A._replace(vals=A.vals * (1 + k))
                              for k in range(B)])
        x = _cuda_typed(torch.ones(B, n))
        ys = [sparse.ell_matvec_stacked(A, x) for _ in range(2)]
    else:
        x = _cuda_typed(torch.ones(n))
        ys = [sparse.ell_matvec(A, x), gather.ell_matvec_vmem(A, x)]
    assert len(calls) == 2
    for (dtype, args), stream, y in zip(calls, (111, 222), ys):
        assert dtype == F32 and y.shape == x.shape
        index, *rest = args
        assert index is A.b7.struct
        assert rest == [A.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
                        B if stacked else 1, stream]
        got = index.contents
        # A stack's values advance by n * w; its columns are one shared
        # (n, w) index.
        assert (got.cols, got.n, got.width, got.op_stride) == (
            A.cols32.data_ptr(), n, w, n * w if stacked else 0)
        assert A.cols32.shape == (n, w)


def test_b7_checks_columns_once_and_x_and_vals_per_product(monkeypatch):
    A = _ell()
    n, w = A.vals.shape
    index = A.b7
    assert index.cols32 is A.cols32
    assert (index.shape, index.device) == (A.vals.shape, -1)
    assert (index.struct.contents.cols, index.struct.contents.op_stride) == (
        A.cols32.data_ptr(), 0)
    with pytest.raises(ValueError, match="int32"):
        gather.KernelIndex(A.cols)
    with pytest.raises(ValueError, match="contiguous"):
        gather.KernelIndex(A.cols32.t())
    _recorder(monkeypatch, gather.KERNEL)
    monkeypatch.setattr(_build, "current_stream", lambda: 0)
    x = _cuda_typed(torch.ones(n))
    with pytest.raises(ValueError, match="differ"):
        gather.kernel_matvec(A.vals[:, :2].contiguous(), index, x)
    with pytest.raises(ValueError, match="dtype"):
        gather.kernel_matvec(A.vals.double(), index, x)
    with pytest.raises(ValueError, match="rows"):
        gather.kernel_matvec(A.vals, index, _cuda_typed(torch.ones(n + 1)))


def test_b7_index_is_carried_by_the_operator_and_rebound_on_copy():
    """The launch index is a field of the operator, built once per index,
    stack and unstacked operator (never attached to a tensor); a deep copy
    binds the copied columns."""
    import copy

    A = _ell()
    assert not vars(A.cols32)  # nothing attached to the columns
    S = sparse.stack_ell([A, A._replace(vals=2 * A.vals)])
    assert S.b7.shape == S.vals.shape and S.b7.cols32 is S.cols32
    assert S.cols32 is A.cols32 and S.cols is A.cols  # one shared index
    one = sparse.unstack_ell(S, 1)
    assert one.b7.struct.contents.cols == S.cols32.data_ptr()
    assert one.b7.struct.contents.op_stride == 0
    assert one.b7 is not S.b7 and one.b7.shape == A.vals.shape
    B = copy.deepcopy(A)
    assert B.b7.cols32 is B.cols32 and B.cols32 is not A.cols32
    assert B.b7.struct.contents.cols == B.cols32.data_ptr()
    torch.testing.assert_close(sparse.ell_matvec(B, torch.ones(A.n_rows)),
                               sparse.ell_matvec(A, torch.ones(A.n_rows)))


class _FakeFn:
    def __init__(self, ret):
        self.ret = ret
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return self.ret


class _FakeLib:
    """Counts symbol look-ups; crbe_error_string is an attribute."""

    def __init__(self, ret=0):
        self.looked_up = []
        self.ret = ret
        self.crbe_error_string = lambda err: b"injected"

    def __getattr__(self, name):
        self.looked_up.append(name)
        return _FakeFn(self.ret)


def test_kernel_resolves_each_dtype_symbol_once():
    k = _build.Kernel("fake", "fake.cu", {F32: "f32_sym", F64: "f64_sym"},
                      [])
    k._lib = _FakeLib()
    for dtype in (F32, F32, F64, F32, F64):
        k.launch(dtype, 1, 2)
    assert k._lib.looked_up == ["f32_sym", "f64_sym"]
    assert k.launches == 5
    with pytest.raises(TypeError, match="no kernel"):
        k.launch(torch.float16)
    bad = _build.Kernel("fake", "fake.cu", {F32: "f32_sym"}, [])
    bad._lib = _FakeLib(ret=7)
    with pytest.raises(RuntimeError, match="injected"):
        bad.launch(F32)
    assert bad.launches == 0
