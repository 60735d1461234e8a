"""Kernel B7, the ELL gather SpMV (airpollution_tpu_torch/ops/gather.py),
and its autograd Function (ops/sparse.EllMatvec), on the CPU.

The plain version, which a CPU tensor takes, against the JAX package's
Pallas kernels in interpret mode at 17^2 unstructured in float32 (atol
2e-6, the JAX test's own); the Function's gradients in float64 by
gradcheck and gradgradcheck for a shared operator, a batch over one
operator and a stack of operators; and the transposition map against a
dense transpose, built from the triangles and from the columns alone."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.models.crbe import assemble as jassemble  # noqa: E402
from airpollution_tpu.ops import pallas_gather as jgather  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.ops import gather, sparse  # noqa: E402

from torch_port_helpers import port_operators  # noqa: E402

F64 = torch.float64


def _jax_system(ms=17, seed=1):
    md = japt.MeshData(japt.create_unstructured_mesh(ms, 20.0, seed=seed),
                       japt.Domain(), nt=4)
    return jassemble(md, japt.Problem(), 0.05, 1).system


@pytest.mark.parametrize("entry,kw", [
    ("ell_matvec_vmem", dict(block_rows=128)),
    ("ell_matvec_vmem", dict(block_rows=512)),
    ("ell_matvec_vmem_roll", {}),
])
def test_plain_b7_matches_jax_interpret_kernels(entry, kw):
    jA = _jax_system()
    rng = np.random.default_rng(0)
    x = rng.normal(size=jA.vals.shape[0]).astype(np.float32)
    y_jax = getattr(jgather, entry)(jA, jnp.asarray(x), interpret=True, **kw)
    tA = sparse.EllMatrix(torch.tensor(np.asarray(jA.vals)),
                          *sparse.ell_index(np.asarray(jA.cols), "cpu"))
    before = gather.KERNEL.launches
    y = getattr(gather, entry)(tA, torch.tensor(x), **kw)
    assert y.dtype == torch.float32 and gather.KERNEL.launches == before
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), atol=2e-6)


def test_entry_points_keep_the_jax_contract():
    A = sparse.EllMatrix(torch.ones(4, 1),
                         *sparse.ell_index(np.arange(4)[:, None], "cpu"))
    with pytest.raises(ValueError, match="multiple of 128"):
        gather.ell_matvec_vmem(A, torch.ones(4), block_rows=100)
    for n in (197_120, 40_000_000, 3_000_000):
        assert gather.fits_vmem(n) == jgather.fits_vmem(n)


def _operator(ms=6, seed=2):
    md = tapt.MeshData(tapt.create_unstructured_mesh(ms, 20.0, seed=seed),
                       tapt.Domain(), nt=3, dtype=F64, device="cpu")
    idx = md.ell_index()
    real = (idx.tslot < idx.tslot.numel()).reshape(idx.cols.shape)
    return md, idx, real


def _dense(vals, cols):
    n = cols.shape[0]
    out = torch.zeros(n, n, dtype=vals.dtype)
    rows = torch.arange(n)[:, None].expand_as(cols)
    return out.index_put_((rows, cols), vals, accumulate=True)


def test_transpose_slots_give_the_dense_transpose():
    """Both transposition maps (from the triangles, from the columns) are
    equal and give A^T on the same columns; padding slots read zero, and
    a real column-0 entry is told from padding."""
    md, idx, real = _operator()
    host = md._ensure_ell()
    np.testing.assert_array_equal(sparse.transpose_slots(host.cols),
                                  host.tslot)
    assert bool((idx.cols[~real] == 0).all())
    assert bool((idx.cols[real] == 0).any())  # the rows coupled to DOF 0
    rng = np.random.default_rng(3)
    vals = torch.tensor(rng.standard_normal(idx.cols.shape)) * real
    vt = sparse._transposed_vals(vals, idx.tslot)
    assert torch.equal(_dense(vt, idx.cols), _dense(vals, idx.cols).T)
    assert bool((vt[~real] == 0).all())


def test_transpose_slots_refuse_an_unsymmetric_pattern():
    cols = np.array([[0, 1], [1, 0], [2, 0]])  # row 0 -> 1, row 1 -/-> 0
    cols[1] = [1, 2]
    with pytest.raises(ValueError, match="symmetric"):
        sparse.transpose_slots(cols)


@pytest.mark.parametrize("layout", ["shared", "batched", "stacked"])
def test_ell_matvec_gradcheck_and_gradgradcheck(layout):
    """gradcheck and gradgradcheck of EllMatvec in float64: one operator
    on x (n,), one operator on a batch X (3, n), a stack of 3 operators on
    X (3, n)."""
    _, idx, real = _operator()
    n, w = idx.cols.shape
    rng = np.random.default_rng(5)
    if layout == "stacked":
        vals = torch.tensor(rng.standard_normal((3, n, w))) * real
        A = sparse.stack_ell([sparse.EllMatrix(torch.zeros(n, w), *idx)] * 3)

        def f(v, x):
            return sparse.ell_matvec_stacked(A._replace(vals=v), x)
    else:
        vals = torch.tensor(rng.standard_normal((n, w))) * real
        A = sparse.EllMatrix(vals, *idx)

        def f(v, x):
            return sparse.ell_matvec(A._replace(vals=v), x)
    x = torch.tensor(rng.standard_normal(n if layout == "shared"
                                         else (3, n)))
    inputs = (vals.requires_grad_(True), x.requires_grad_(True))
    assert torch.autograd.gradcheck(f, inputs)
    assert torch.autograd.gradgradcheck(f, inputs)


def test_ell_matvec_forward_mode_matches_the_product_rule():
    import torch.autograd.forward_ad as fwAD

    _, idx, real = _operator()
    rng = np.random.default_rng(6)
    vals, vdot = (torch.tensor(rng.standard_normal(idx.cols.shape)) * real
                  for _ in range(2))
    x, xdot = (torch.tensor(rng.standard_normal(idx.cols.shape[0]))
               for _ in range(2))
    with fwAD.dual_level():
        y = sparse.ell_matvec(
            sparse.EllMatrix(fwAD.make_dual(vals, vdot), *idx),
            fwAD.make_dual(x, xdot))
        tangent = fwAD.unpack_dual(y).tangent
    expect = _dense(vdot, idx.cols) @ x + _dense(vals, idx.cols) @ xdot
    torch.testing.assert_close(tangent, expect, rtol=1e-13, atol=1e-13)


def test_operators_keep_their_index():
    """Assembly, Dirichlet masking, the interop path and species stacking
    carry the int32 columns and the transposition map of the pattern."""
    from airpollution_tpu_torch.models import crbe
    from airpollution_tpu_torch.models.multispecies import stack_operators

    md, idx, _ = _operator()
    ops = crbe.assemble(md, tapt.Problem(), 0.1, 2)
    for A in (ops.stiffness, ops.advection, ops.ka, ops.system):
        assert A.cols32 is idx.cols32 and A.tslot is idx.tslot
    assert ops.system.cols32.dtype == torch.int32
    jmd = japt.MeshData(japt.create_unstructured_mesh(6, 20.0, seed=2),
                        japt.Domain(), nt=3, dtype=jnp.float64)
    carried = port_operators(jassemble(jmd, japt.Problem(), 0.1, 2))
    assert carried.system.tslot is carried.ka.tslot
    assert torch.equal(carried.system.tslot, idx.tslot)
    stacked = stack_operators([ops, ops])
    assert stacked.system.cols32 is idx.cols32  # one shared index
    assert stacked.system.vals.shape == (2,) + idx.cols.shape
    assert stacked.system.tslot is idx.tslot
