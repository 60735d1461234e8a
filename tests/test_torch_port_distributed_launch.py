"""The port's launcher and collectives (parallel/launch.py,
parallel/collectives.py, device_mesh.ProcessMesh) on gloo ranks on the
CPU: the row-major rank layout of JAX's device mesh, psum with its first
and second derivatives (its transpose is pvary's), all_gather_rows,
halo_exchange with zeros at the chain ends; a rank that raises fails the
spawn with that rank's error, and a rank that hangs ends in TimeoutError
within the deadline. One spawn of 4 ranks runs the collective cases."""

import time

import numpy as np
import pytest
import torch

from airpollution_tpu_torch.parallel import launch, make_mesh
from airpollution_tpu_torch.parallel.device_mesh import BlockMesh, ProcessMesh

import torch_port_distributed_ranks as ranks


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    d = tmp_path_factory.mktemp("collective_ranks")
    shape = launch.spawn(ranks.collective_cases, 4, backend="gloo",
                         args=(str(d),), timeout_s=120)
    assert shape == {"dp": 2, "tp": 2}  # rank 0's result comes back
    return lambda r, case: np.load(d / f"rank{r}_{case}.npy")


def test_ranks_lie_row_major_over_the_axes(out):
    """rank = dp_index * 2 + tp_index, as JAX's device array for
    {'dp': 2, 'tp': 2}; each axis line holds the ranks sharing the other
    index."""
    for r in range(4):
        dp, tp = divmod(r, 2)
        assert out(r, "coords").tolist() == [dp, tp, tp, 2 + tp, 2 * dp,
                                             2 * dp + 1]


def test_psum_and_its_derivatives(out):
    """y = psum(x^3) over 'tp': each rank's dy/dx is its own 3 x^2 (the
    replicated y's cotangent goes back unsummed) and d2y/dx2 6 x; pvary's
    cotangent sums over 'dp'."""
    for r in range(4):
        tp_line = [r - r % 2, r - r % 2 + 1]
        y = sum((1.0 + q) ** 3 for q in tp_line)
        gw = sum(1.0 + q for q in (r % 2, r % 2 + 2))
        np.testing.assert_allclose(
            out(r, "psum"), [y, 3 * (1.0 + r) ** 2, 6 * (1.0 + r), gw],
            rtol=1e-15)


def test_all_gather_rows(out):
    for r in range(4):
        tp_line = [r - r % 2, r - r % 2 + 1]
        np.testing.assert_array_equal(
            out(r, "gather0"), np.repeat(np.array(tp_line, float), 2)[:, None]
            * np.ones((1, 3)))
        dp_line = [r % 2, r % 2 + 2]
        np.testing.assert_array_equal(
            out(r, "gather1"), np.repeat(np.array(dp_line, float), 3)[None]
            * np.ones((2, 1)))


def test_halo_exchange_fills_the_chain_ends_with_zeros(out):
    """Along 'dp' (ranks r and r + 2): the lower rank gets zeros from
    below and the upper rank's first rows from above; the upper rank the
    lower's last rows from below and zeros from above."""
    for lo in (0, 1):
        hi = lo + 2
        np.testing.assert_array_equal(out(lo, "halo_below"), np.zeros((2, 3)))
        np.testing.assert_array_equal(out(lo, "halo_above"),
                                      np.full((1, 3), 10.0 + hi))
        np.testing.assert_array_equal(out(hi, "halo_below"),
                                      np.full((2, 3), 20.0 + lo))
        np.testing.assert_array_equal(out(hi, "halo_above"), np.zeros((1, 3)))


def test_a_rank_that_raises_fails_the_spawn():
    with pytest.raises(KeyError, match="rank one fails") as err:
        launch.spawn(ranks.raise_on_rank_one, 2, backend="gloo",
                     timeout_s=60)
    assert "raised on rank 1 of 2" in "".join(err.value.__notes__)


def test_a_rank_that_hangs_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.spawn(ranks.hang, 2, backend="gloo", timeout_s=5)
    assert time.monotonic() - t0 < 15


def test_make_mesh_without_and_with_a_group():
    """No group: a BlockMesh on the asked device; a one-rank gloo group: a
    ProcessMesh on the CPU, whose axes must multiply to the world size;
    the backend must be named."""
    assert isinstance(make_mesh({"mp": 4}, device="cpu"), BlockMesh)
    with launch.process_group("gloo"):
        mesh = make_mesh({"dp": 1, "tp": 1})
        assert isinstance(mesh, ProcessMesh)
        assert mesh.device == torch.device("cpu") and mesh.coords == {
            "dp": 0, "tp": 0}
        with pytest.raises(ValueError, match="process group 1"):
            make_mesh({"mp": 2})
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        launch.spawn(ranks.hang, 1, backend="mpi", timeout_s=5)
