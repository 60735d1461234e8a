"""Kernels and operators of the port."""
