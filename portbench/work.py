"""The yardstick's arithmetic: the card's peaks, the scheme's operations and
bytes per forecast, and the least time a forecast can take.

The three counts of floating-point operations per DOF and step are frozen
copies of the port's bring-up gate (``step_flops_per_dof``,
``canvas_step_flops_per_dof``, ``bicgstab_flops_per_dof``): they count the
scheme's arithmetic, not any kernel's, so that every implementation of a
cell's scheme is held to the same work. Bytes are the forecast's inputs
read once and its final field written once, counted from shapes. At every
cell's size operations bound the least time, so no implementation of the
scheme, one that keeps its state on chip across steps included, can read
over 100% against it.
"""

from __future__ import annotations

# Peak rates of one NVIDIA H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense, no sparsity): device memory bandwidth and float32 outside the
# tensor cores.
PEAK_BYTES_PER_S = {"float32": 3.35e12, "float64": 3.35e12}
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ELEMENT_BYTES = {"float32": 4, "float64": 8}

#: Values per DOF of the per-DOF (canvas) operator as the forecast reads
#: it: five stencil coefficients of its row, the masked mass and the
#: inverse diagonal.
CANVAS_VALUES_PER_DOF = 7
#: Scalars of the uniform operator: 15 stencil coefficients, three mass
#: and three inverse-diagonal constants.
UNIFORM_SCALARS = 21
#: One stencil row: 5 multiplies and 4 adds.
ROW = 9


def step_flops_per_dof(k: int, use_ka: bool, extrapolate: bool) -> int:
    """One uniform-operator Chebyshev step: the RHS, warm start, first
    residual and the k iterations (x += d, r -= A d, d = a d + b r); the
    last iteration's r and d are never read, so it counts as x += d."""
    rhs = 1 + (ROW + 2 if use_ka else 0)
    warm = 2 if extrapolate else 0
    first = ROW + 1 + 1
    return rhs + warm + first + (k - 1) * (1 + ROW + 1 + 3) + 1


def canvas_step_flops_per_dof(k: int, use_ka: bool, extrapolate: bool) -> int:
    """One per-DOF-operator Chebyshev step: the RHS (BE M u; CN 2 M u +
    (1 - mask) u - S u), the warm start, the first residual and
    d = (id r) / theta, then k iterations, the last of which is x += d."""
    rhs = (ROW + 6) if use_ka else 1
    warm = 3 if extrapolate else 1
    first = ROW + 1 + 2
    return rhs + warm + first + (k - 1) * (1 + ROW + 1 + 4) + 1


def bicgstab_flops_per_dof(k: int, use_ka: bool, extrapolate: bool) -> int:
    """One fixed-k BiCGStab step: the RHS, the warm start and the first
    residual, then k iterations of two matvecs, four dot products and six
    vector updates (40 per DOF)."""
    rhs = (ROW + 6) if use_ka else 1
    warm = 3 if extrapolate else 1
    first = ROW + 1
    iteration = 2 * ROW + 4 * 2 + 4 + 1 + 2 + 2 + 1 + 2 + 2
    return rhs + warm + first + k * iteration


def flops_per_dof(operator: str, method: str, k: int, order: int,
                  extrapolate: bool) -> int:
    """The scheme's operations per DOF and step for ``operator``
    ('uniform' or 'canvas') and ``method`` ('chebyshev' or 'bicgstab')."""
    use_ka = order == 2
    if method == "bicgstab":
        return bicgstab_flops_per_dof(k, use_ka, extrapolate)
    if operator == "uniform":
        return step_flops_per_dof(k, use_ka, extrapolate)
    if operator == "canvas":
        return canvas_step_flops_per_dof(k, use_ka, extrapolate)
    raise ValueError(f"unknown operator {operator!r}")


def forecast_bytes(operator: str, n_dofs: int, precision: str) -> int:
    """A forecast's inputs read once (the initial field and the operator)
    and its final field written once."""
    elem = ELEMENT_BYTES[precision]
    if operator == "uniform":
        operator_values = UNIFORM_SCALARS
    elif operator == "canvas":
        operator_values = CANVAS_VALUES_PER_DOF * n_dofs
    else:
        raise ValueError(f"unknown operator {operator!r}")
    return elem * (n_dofs + operator_values + n_dofs)


def least_time(flops: float, n_bytes: float, precision: str):
    """``(seconds, bound)``: the larger of operations at the peak rate and
    bytes at the peak bandwidth, and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[precision]
    t_bytes = n_bytes / PEAK_BYTES_PER_S[precision]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def structured_dofs(points_per_side: int) -> int:
    """Edge DOFs of the structured CR mesh with ``points_per_side`` points
    a side: 3 (n-1)^2 interior-cell edges plus 2 (n-1) on two sides."""
    m = points_per_side - 1
    return 3 * m * m + 2 * m


def forecast_work(operator: str, method: str, k: int, order: int,
                  extrapolate: bool, n_dofs: int, n_steps: int,
                  precision: str) -> dict:
    """Operations, bytes and least time of one forecast."""
    flops = flops_per_dof(operator, method, k, order, extrapolate) \
        * n_dofs * n_steps
    n_bytes = forecast_bytes(operator, n_dofs, precision)
    seconds, bound = least_time(flops, n_bytes, precision)
    return {"flops": flops, "bytes": n_bytes, "least_s": seconds,
            "bound": bound}
