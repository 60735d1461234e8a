"""L-BFGS with a zoom line search on one flat parameter tensor.

The algorithm of optax 0.2.6's ``optax.lbfgs(memory_size=m,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=32))``,
the optimiser of the JAX package's ``PINN.finetune_lbfgs``, restated on
tensors (``torch.optim.LBFGS`` is a different algorithm):

- the direction is minus the two-loop recursion of the last m parameter
  and gradient differences applied to the gradient, on an identity scaled
  by ``dw.du / du.du`` of the newest pair, and at the first step by
  ``min(1, 1 / |g|)`` (``scale_init_precond=True``);
- the step size comes from the zoom line search of Nocedal and Wright
  (algorithms 3.5 and 3.6), with the approximate sufficient decrease of
  Hager and Zhang, and the defaults of ``scale_by_zoom_linesearch``
  (the module's constants; ``initial_guess_strategy="keep"``: the first
  trial step of a search is the previous accepted one, 1 at the start);
- the value and gradient at the accepted point are kept and reused by the
  next step, as ``optax.value_and_grad_from_state`` does.

The memory and the two-loop recursion stay on the parameters' device; the
line search's scalars are float64 numbers on the host, one read of the
value and slope per trial step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

# value_and_grad(x) -> (value: 0-dim tensor, grad: tensor like x, aux)
ValueAndGrad = Callable[[torch.Tensor], tuple]

_F = np.float64

# The zoom line search's settings: the defaults of optax 0.2.6's
# scale_by_zoom_linesearch, and the 32 trial steps the JAX package's
# finetune_lbfgs asks for. The tolerance on the decrease and curvature
# errors is 0: a step is accepted only when it meets both conditions.
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5
MAX_LINESEARCH_STEPS = 32


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the parabola through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


@dataclasses.dataclass
class _Point:
    """A trial step on the line: its size, value, slope, gradient and the
    objective's auxiliary output there."""

    stepsize: Any
    value: Any
    slope: Any
    grad: torch.Tensor
    aux: Any = None


@dataclasses.dataclass
class LBFGSState:
    count: int
    params: torch.Tensor          # the parameters of the previous step
    updates: torch.Tensor         # the gradient of the previous step
    diff_params: torch.Tensor     # (m, n) parameter differences
    diff_updates: torch.Tensor    # (m, n) gradient differences
    weights: torch.Tensor         # (m,) 1 / (du . dw)
    learning_rate: Any = _F(1.0)  # the last accepted step size
    value: Any = _F(np.inf)       # the objective at the current parameters
    grad: torch.Tensor = None
    aux: Any = None
    linesearch_steps: int = 0


class LBFGS:
    """L-BFGS on a flat tensor with the zoom line search (module
    docstring), keeping the last ``memory_size`` pairs. ``init(x)`` makes
    the state; ``step(x, state, value_and_grad)`` returns the next
    parameters and state, where ``value_and_grad(x)`` gives ``(value,
    grad, aux)``; the state keeps the value, gradient and aux at the new
    parameters."""

    def __init__(self, memory_size=20):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = int(memory_size)

    def init(self, x: torch.Tensor) -> LBFGSState:
        x = x.detach()
        stack = torch.zeros((self.memory_size,) + x.shape, dtype=x.dtype,
                            device=x.device)
        return LBFGSState(
            count=0, params=torch.zeros_like(x), updates=torch.zeros_like(x),
            diff_params=stack, diff_updates=stack.clone(),
            weights=torch.zeros(self.memory_size, dtype=x.dtype,
                                device=x.device))

    # --- the direction ---------------------------------------------------

    def _direction(self, x, g, state):
        m = self.memory_size
        mem_idx = state.count % m
        prev_idx = (state.count - 1) % m
        if state.count > 0:
            dp = x - state.params
            du = g - state.updates
            vd = torch.dot(du, dp)
            w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            num = torch.dot(du, dp)
            den = torch.dot(du, du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
        else:
            dp = torch.zeros_like(x)
            du = torch.zeros_like(x)
            w = torch.zeros((), dtype=x.dtype, device=x.device)
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        state.diff_params[prev_idx] = dp
        state.diff_updates[prev_idx] = du
        state.weights[prev_idx] = w
        rhos, dws, dus = state.weights, state.diff_params, state.diff_updates
        order = [(mem_idx + i) % m for i in range(m)]
        vec = g
        alphas = {}
        for i in reversed(order):
            alphas[i] = rhos[i] * torch.dot(dws[i], vec)
            vec = vec + (-alphas[i]) * dus[i]
        vec = scale * vec
        for i in order:
            beta = rhos[i] * torch.dot(dus[i], vec)
            vec = vec + (alphas[i] - beta) * dws[i]
        return -vec

    # --- the zoom line search --------------------------------------------

    def _decrease_error(self, stepsize, p: _Point, value_init, slope_init):
        dec = p.value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = p.slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = p.value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, 0.0)
        return _F(np.inf) if np.isnan(dec) else dec

    def _curvature_error(self, slope, slope_init):
        curv = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init),
                          0.0)
        return _F(np.inf) if np.isnan(curv) else curv

    def _linesearch(self, x, d, start: _Point, guess, value_and_grad):
        value_init, slope_init = start.value, start.slope

        def at(stepsize):
            value, grad, aux = value_and_grad(x + float(stepsize) * d)
            value, slope = torch.stack(
                [value.detach(), torch.dot(grad, d)]).tolist()
            return _Point(stepsize, _F(value), _F(slope), grad, aux)

        cur, safe = start, start
        low = high = cubic = start
        dec_err = _F(np.inf)
        interval_found = done = failed = False
        count = 0
        with np.errstate(all="ignore"):
            while not (done or failed):
                if not interval_found:
                    # Interval search (Nocedal and Wright, algorithm 3.5).
                    stepsize = (guess if count == 0
                                else _F(INCREASE_FACTOR) * cur.stepsize)
                    new = at(stepsize)
                    dec_err = self._decrease_error(stepsize, new, value_init,
                                                   slope_init)
                    error = np.maximum(
                        dec_err, self._curvature_error(new.slope, slope_init))
                    if dec_err <= 0.0:
                        safe = new
                    high_new = dec_err > 0.0 or (new.value >= cur.value
                                                 and count > 0)
                    low_new = new.slope >= 0.0 and not high_new
                    low, high = (new, cur) if low_new else (cur, new)
                    cubic = low
                    interval_found = high_new or low_new or error <= 0.0
                    done = bool(error <= 0.0)
                    failed = (count + 1 >= MAX_LINESEARCH_STEPS
                              and not done)
                else:
                    # Zoom (Nocedal and Wright, algorithm 3.6).
                    delta = np.abs(high.stepsize - low.stepsize)
                    left = np.minimum(high.stepsize, low.stepsize)
                    right = np.maximum(high.stepsize, low.stepsize)
                    too_small = delta <= STEPSIZE_PRECISION
                    mid_c = _cubicmin(low.stepsize, low.value, low.slope,
                                      high.stepsize, high.value,
                                      cubic.stepsize, cubic.value)
                    use_cubic = (mid_c > left + 0.2 * delta
                                 and mid_c < right - 0.2 * delta)
                    mid_q = _quadmin(low.stepsize, low.value, low.slope,
                                     high.stepsize, high.value)
                    use_quad = (not use_cubic and mid_q > left + 0.1 * delta
                                and mid_q < right - 0.1 * delta)
                    if use_cubic:
                        middle = mid_c
                    elif use_quad:
                        middle = mid_q
                    else:
                        middle = (low.stepsize + high.stepsize) / 2.0
                    new = at(middle)
                    dec_err = self._decrease_error(middle, new, value_init,
                                                   slope_init)
                    error = np.maximum(
                        dec_err, self._curvature_error(new.slope, slope_init))
                    if dec_err <= 0.0 and new.value < safe.value:
                        safe = new
                    done = bool(error <= 0.0)
                    high_mid = dec_err > 0.0 or new.value >= low.value
                    high_low = (new.slope * (high.stepsize - low.stepsize)
                                >= 0.0 and not high_mid)
                    cubic = high if (high_mid or high_low) else low
                    new_high = new if high_mid else high
                    new_high = low if high_low else new_high
                    low = low if high_mid else new
                    high = new_high
                    failed = ((count + 1 >= MAX_LINESEARCH_STEPS
                               or (too_small and safe.stepsize > 0.0))
                              and not done)
                cur = new
                count += 1
                if failed and (safe.stepsize > 0.0 or np.isinf(dec_err)):
                    # The step that gives at least sufficient decrease.
                    cur = safe
        return cur, count

    def step(self, x: torch.Tensor, state: LBFGSState,
             value_and_grad: ValueAndGrad):
        """One L-BFGS step from ``x``: the new parameters and state."""
        x = x.detach()
        if math.isfinite(state.value):
            value, grad, aux = state.value, state.grad, state.aux
        else:
            value_t, grad, aux = value_and_grad(x)
            value = _F(value_t.detach().item())
        d = self._direction(x, grad, state)
        slope = _F(torch.dot(d, grad).item())
        start = _Point(_F(0.0), _F(value), slope, grad, aux)
        # initial_guess_strategy="keep": the search starts from the last
        # accepted step size.
        final, n_steps = self._linesearch(x, d, start, state.learning_rate,
                                          value_and_grad)
        x_new = x + float(final.stepsize) * d
        return x_new, LBFGSState(
            count=state.count + 1, params=x, updates=grad,
            diff_params=state.diff_params, diff_updates=state.diff_updates,
            weights=state.weights, learning_rate=final.stepsize,
            value=final.value, grad=final.grad, aux=final.aux,
            linesearch_steps=n_steps)
