"""Checkpoints of the port: PINN parameters and training carry, fields."""
