"""Hyperparameter optimization of the port (an optuna-compatible engine,
numpy only)."""

from airpollution_tpu_torch.hpo.search import Study, TPESampler, Trial, create_study

__all__ = ["Study", "TPESampler", "Trial", "create_study"]
