"""Shared experiment configuration of the drivers.

The schedules of the reference drivers, as the JAX package's
``experiments/common.py`` has them: mesh sizes, hidden widths, epochs,
early-stopping patience and learning rates per mesh, the loss weights,
the mesh-coupled collocation budget ``n_col = round(n_dofs / 1.4)``,
``n_ic = n_bc = round(0.2 n_col)``, nt = 128 and the seed; and the
drivers' device: the CUDA card, the CPU only when asked for.
"""

from __future__ import annotations

import os

import torch

from airpollution_tpu_torch.device import resolve_device

MESH_SIZES = [4, 8, 16, 32, 64, 128]
N_NEURONS = [2, 4, 8, 16, 32, 64]
EPOCHS_LIST = [500, 1000, 2000, 4000, 8000, 16000]
EARLY_STOPPING_PATIENCE_LIST = [500, 500, 500, 1000, 1000, 1000]
LR_LIST = [3e-4, 3e-4, 2e-4, 4e-5, 1e-4, 1e-4]
LAMBDA_WEIGHTS = {"pde": 180.0, "ic": 80.0, "bc": 80.0}
N_STEPS = 128
DOMAIN_SIZE = 20.0
SEED = 1234


def collocation_budget(n_dofs: int):
    """The reference's mesh-derived PINN batch sizes."""
    n_col = round(n_dofs / 1.4)
    n_ic = round(0.2 * n_col)
    n_bc = round(0.2 * n_col)
    return {"pde": n_col, "ic": n_ic, "bc": n_bc}


def str2bool(value):
    """argparse bool that takes true/false strings (the reference's
    ``type=bool`` makes every non-empty string True)."""
    if isinstance(value, bool):
        return value
    return str(value).lower() in ("1", "true", "yes", "y")


def driver_device(device=None) -> torch.device:
    """The device a driver runs on: ``device`` when given, the CPU under
    ``APT_PLATFORM=cpu`` (as the port's command line), else the CUDA card;
    raises when no card is present, never falling back to the CPU."""
    if device is None and os.environ.get("APT_PLATFORM") == "cpu":
        device = "cpu"
    return resolve_device(device)


def print_device(device=None) -> torch.device:
    dev = driver_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Using device: {dev.type} ({name})")
    return dev
