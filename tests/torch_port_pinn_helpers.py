"""Shared set-up of the port's PINN tests (tests/test_torch_port_pinn*.py):
one set of network parameters made with numpy in the JAX package's layout
and carried into both packages, fixed collocation points, and the
problems defined in both packages."""

import numpy as np
import jax.numpy as jnp
import torch

import airpollution_tpu.problems as jprob
import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.interop import pinn_params_from_numpy

F64 = torch.float64
BOX = (-20.0, 20.0, -20.0, 20.0)


def np_params(layers, activation="adaptive_tanh", fourier=0, amp=None,
              seed=0):
    """A JAX-layout parameter list of float64 numpy arrays: Xavier-scaled
    weights, small random biases (so that every term of a layer is
    exercised) and alphas near 1."""
    rng = np.random.default_rng(seed)
    params = []
    widths = list(layers)
    if fourier:
        B = rng.standard_normal((layers[0], fourier))
        params.append({"B": B / np.array([20.0, 20.0, 5.0])[:, None]})
        widths[0] = 2 * fourier
    for i in range(len(widths) - 1):
        fan_in, fan_out = widths[i], widths[i + 1]
        layer = {
            "W": np.sqrt(2.0 / (fan_in + fan_out))
            * rng.standard_normal((fan_in, fan_out)),
            "b": 0.1 * rng.standard_normal(fan_out),
        }
        if activation == "adaptive_tanh" and i < len(widths) - 2:
            layer["alpha"] = 1.0 + 0.1 * rng.standard_normal(fan_out)
        params.append(layer)
    if amp is not None:
        params[-1]["amp"] = np.asarray(amp)
    return params


def jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def port_mlp(params, activation="adaptive_tanh"):
    return pinn_params_from_numpy(params, activation, dtype=F64,
                                  device="cpu")


def points(n, seed, t_range=(0.0, 10.0), box=BOX):
    """(n, 3) space-time points [x, y, t], uniform in the box."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = box
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n),
                     rng.uniform(*t_range, n)], axis=1)


def boundary_points(n, seed, t_range=(0.0, 10.0), box=BOX):
    """(4 (n // 4), 3) points in blocks on the sides left, right, bottom,
    top, the layout of both packages' boundary samplers."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = box
    k = n // 4
    t = rng.uniform(*t_range, 4 * k)
    along_y, along_x = rng.uniform(y0, y1, 2 * k), rng.uniform(x0, x1, 2 * k)
    x = np.concatenate([np.full(k, x0), np.full(k, x1), along_x])
    y = np.concatenate([along_y, np.full(k, y0), np.full(k, y1)])
    return np.stack([x, y, t], axis=1)


def tree_rel(port_tree, jax_tree, skip=("B",)):
    """max |port - jax| over every leaf, over the largest |jax| of all of
    them."""
    num = scale = 0.0
    for p, j in zip(port_tree, jax_tree):
        for k, jv in j.items():
            if k in skip:
                continue
            pv = p[k].detach().numpy() if isinstance(p[k], torch.Tensor) \
                else np.asarray(p[k])
            jv = np.asarray(jv)
            num = max(num, float(np.abs(pv - jv).max()))
            scale = max(scale, float(np.abs(jv).max()))
    return num / scale


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# A variable-D problem in both packages: D(x, y[, t]) a smooth field, the
# constant wind of the plume.
def _d_field(lib, x, y, t=None):
    d = 0.1 + 0.04 * lib.sin(x / 4.0) * lib.cos(y / 3.0)
    return d if t is None else d * (1.0 + 0.05 * t)


class JVariableD(jprob.Problem):
    variable_coefficients = True

    def diffusion_at(self, xy, t=None):
        xy = jnp.asarray(xy)
        return _d_field(jnp, xy[..., 0], xy[..., 1], t)


class TVariableD(tapt.Problem):
    variable_coefficients = True

    def diffusion_at(self, xy, t=None):
        return _d_field(torch, xy[..., 0], xy[..., 1], t)


class JTimeVaryingD(JVariableD):
    time_varying = True


class TTimeVaryingD(TVariableD):
    time_varying = True


def problem_pair(name):
    """(JAX problem, port problem) of one name."""
    if name == "plume":
        return jprob.Problem(), tapt.Problem()
    if name == "reaction":
        return jprob.Problem(reaction=0.2), tapt.Problem(reaction=0.2)
    if name == "emitter":
        kw = dict(q=3.0, xs=-2.0, ys=1.0, sigma_s=3.0)
        return (jprob.GaussianSourceProblem(**kw),
                tapt.GaussianSourceProblem(**kw))
    if name == "rotating":
        kw = dict(omega=0.05, D=0.3)
        return (jprob.RotatingPlumeProblem(**kw),
                tapt.RotatingPlumeProblem(**kw))
    if name == "variable_D":
        return JVariableD(), TVariableD()
    if name == "time_varying_D":
        return JTimeVaryingD(), TTimeVaryingD()
    if name == "robin":
        pair = []
        for base in (jprob.Problem, tapt.Problem):
            p = base(sigma=3.0)
            p.robin_sides = {"left": 0.1, "top": 0.0}
            pair.append(p)
        return tuple(pair)
    if name == "obstacles":
        pair = []
        for base in (jprob.Problem, tapt.Problem):
            p = base(sigma=3.0)
            p.obstacles = ((-6.0, -1.0, -4.0, 3.0), (4.0, 9.0, 2.0, 5.0))
            pair.append(p)
        return tuple(pair)
    raise KeyError(name)
