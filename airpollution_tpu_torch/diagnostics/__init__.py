"""Diagnostics built on the differentiable solve (inverse problems)."""
