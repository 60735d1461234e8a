"""Block meshes and the block-sharded fused solvers (kernels B8-B10), the
PyTorch counterpart of the parts of ``airpollution_tpu/parallel`` that run
a Pallas kernel. The blocks of a mesh live on one device."""

from airpollution_tpu_torch.parallel.device_mesh import dp_tp_split, make_mesh
from airpollution_tpu_torch.parallel.hbm_shard import (
    build_canvas_hbm_halo_solver,
    build_hbm_halo_solver,
    build_multispecies_hbm_halo_solver,
)

__all__ = [
    "dp_tp_split", "make_mesh",
    "build_hbm_halo_solver", "build_canvas_hbm_halo_solver",
    "build_multispecies_hbm_halo_solver",
]
