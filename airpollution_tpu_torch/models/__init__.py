"""Solver models of the port: the CRBE finite-element path, the
multi-species solver, the PINN, and the FNO surrogate (the names the JAX
package's ``airpollution_tpu.models`` exports, and the FNO's)."""

from airpollution_tpu_torch.models.crbe import (
    BESCRFEM,
    CRBESolver,
    ElementCR,
    assemble,
    local_matrices,
    run_time_loop,
)
from airpollution_tpu_torch.models.fno import (
    FNOParams,
    cell_center_index_grid,
    fno_apply,
    grid_coordinates,
    init_fno_params,
    make_plume_dataset,
    make_plume_time_dataset,
    relative_l2,
    train_fno,
)
from airpollution_tpu_torch.models.multispecies import (
    MultiSpeciesSolver,
    run_multispecies_loop,
)
from airpollution_tpu_torch.models.pinn import (
    PINN,
    EarlyStopping,
    count_parameters,
    init_mlp_params,
    mlp_apply,
)

__all__ = [
    "BESCRFEM", "CRBESolver", "ElementCR", "assemble", "local_matrices",
    "run_time_loop",
    "MultiSpeciesSolver", "run_multispecies_loop",
    "PINN", "EarlyStopping", "count_parameters", "init_mlp_params",
    "mlp_apply",
    "FNOParams", "cell_center_index_grid", "fno_apply", "grid_coordinates",
    "init_fno_params", "make_plume_dataset", "make_plume_time_dataset",
    "relative_l2", "train_fno",
]
