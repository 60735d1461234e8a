"""Multi-process parallelism on ``torch.distributed``, PyTorch counterpart
of ``airpollution_tpu/parallel``: meshes over ranks (or blocks on one
device), DP x TP PINN training, data-parallel FNO training, the
row-sharded FEM solve, the halo-exchange stencil solve, the block-sharded
fused solvers (kernels B8-B10) and device-parallel sweeps.
``parallel/launch.py`` starts the ranks; ``parallel/collectives.py`` holds
the collectives. Importing the package initializes no process group."""

from airpollution_tpu_torch.parallel.device_mesh import (
    BlockMesh,
    ProcessMesh,
    dp_tp_split,
    make_mesh,
)
from airpollution_tpu_torch.parallel.pinn_parallel import (
    ParallelTrainState,
    build_parallel_trainer,
    forward_tp,
    init_parallel_state,
    tp_param_specs,
)
from airpollution_tpu_torch.parallel.fem_shard import (
    build_sharded_solver,
    pad_operators,
    sharded_matvec,
)
from airpollution_tpu_torch.parallel.fno_parallel import (
    build_fno_dp_trainer,
    train_fno_dp,
)
from airpollution_tpu_torch.parallel.sweep import crbe_diffusion_sweep
from airpollution_tpu_torch.parallel.stencil_shard import build_halo_solver
from airpollution_tpu_torch.parallel.hbm_shard import (
    build_canvas_hbm_halo_solver,
    build_hbm_halo_solver,
    build_multispecies_hbm_halo_solver,
)

__all__ = [
    "dp_tp_split", "make_mesh",
    "ParallelTrainState", "build_parallel_trainer", "forward_tp",
    "init_parallel_state", "tp_param_specs",
    "build_sharded_solver", "pad_operators", "sharded_matvec",
    "build_fno_dp_trainer", "train_fno_dp",
    "crbe_diffusion_sweep",
    "build_halo_solver", "build_hbm_halo_solver",
    "build_canvas_hbm_halo_solver",
    "build_multispecies_hbm_halo_solver",
    "BlockMesh", "ProcessMesh",
]
