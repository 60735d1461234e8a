"""Solvers of the port, and the FNO surrogate (models/fno.py), whose
public names are exported here."""

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

__all__ = [
    "FNOParams",
    "cell_center_index_grid",
    "fno_apply",
    "grid_coordinates",
    "init_fno_params",
    "make_plume_dataset",
    "make_plume_time_dataset",
    "relative_l2",
    "train_fno",
]
