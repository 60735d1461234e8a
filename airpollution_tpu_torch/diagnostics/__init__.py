"""Diagnostics built on the differentiable solve (inverse problems): the
names the JAX package's ``airpollution_tpu.diagnostics`` exports from its
``inverse`` module."""

from airpollution_tpu_torch.diagnostics.inverse import (
    fit_chemistry,
    fit_deposition,
    fit_diffusion,
    fit_initial_condition,
    fit_parameters,
    fit_source,
    fit_surface_exchange,
    posterior_covariance,
    receptor_footprint,
    solve_final_state,
    solve_multispecies_snapshots,
    solve_snapshots,
)

__all__ = [
    "fit_chemistry",
    "fit_deposition",
    "fit_diffusion",
    "fit_initial_condition",
    "fit_parameters",
    "fit_source",
    "fit_surface_exchange",
    "posterior_covariance",
    "receptor_footprint",
    "solve_final_state",
    "solve_multispecies_snapshots",
    "solve_snapshots",
]
