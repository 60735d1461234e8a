"""Diagnostics built on the solvers: physics diagnostics of a CRBE and a
PINN trajectory, inverse problems on the differentiable solve, and
ensemble forecasting with data assimilation and sensor placement (the
names the JAX package's ``airpollution_tpu.diagnostics`` exports)."""

from airpollution_tpu_torch.diagnostics.analysis import (
    ComprehensiveAnalysis,
    center_of_mass_over_time,
    concentration_profiles,
    evaluate_pinn_on_grid,
    mass_over_time,
    peak_tracking,
    quadrature_weights,
    variance_over_time,
)
from airpollution_tpu_torch.diagnostics.ensemble import (
    enkf_update,
    ensemble_forecast,
    place_sensors,
    stack_problems,
)
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
    "ComprehensiveAnalysis",
    "center_of_mass_over_time",
    "concentration_profiles",
    "evaluate_pinn_on_grid",
    "mass_over_time",
    "peak_tracking",
    "quadrature_weights",
    "variance_over_time",
    "enkf_update",
    "ensemble_forecast",
    "place_sensors",
    "stack_problems",
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
