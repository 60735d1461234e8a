"""The port's block-sharded fused solvers with one block per rank
(parallel/hbm_shard.py on a ProcessMesh: kernels B8, B9 and B10 through
their plain versions on the CPU, the halo slabs swapped between 2 gloo
ranks) and ``solve_time_varying(mesh=)`` on them, each bitwise equal to
the same solve on a one-process 2-block BlockMesh, which
tests/test_torch_port_hbm_shard_*.py and tests/test_torch_port_unsteady.py
hold against JAX.

One ``launch.spawn`` of 2 ranks (a module-scoped fixture, deadline 120 s)
runs every case (tests/torch_port_distributed_ranks.hbm_cases); rank 0
also runs the BlockMesh solves, in its own process, so both sides take
the same torch threading."""

import numpy as np
import pytest

from airpollution_tpu_torch.parallel import launch

import torch_port_distributed_ranks as ranks

CASES = {"b8": "build_hbm_halo_solver: a Gaussian emitter, CN, "
               "extrapolated, strided rows",
         "b9": "build_canvas_hbm_halo_solver: a rotating wind, a Robin "
               "floor, a building, strided rows",
         "b10": "build_multispecies_hbm_halo_solver: a sourced chain, CN, "
                "strided rows",
         "unsteady": "solve_time_varying(mesh=): the turning wind on B9's "
                     "chunks"}


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    d = tmp_path_factory.mktemp("hbm_ranks")
    launch.spawn(ranks.hbm_cases, 2, backend="gloo", args=(str(d),),
                 timeout_s=120)
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_block_per_rank_equals_the_block_mesh(out, case):
    want = np.load(out / f"block_{case}.npy")
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    for r in range(2):
        np.testing.assert_array_equal(np.load(out / f"rank{r}_{case}.npy"),
                                      want)
