"""Traffic kind ``forecast_loop``: one client in a closed loop, each request
one whole forecast through the port's public solver entry,
``CRBESolver.solve(store_solutions=False)``, ending when the final field
is in host memory.

The seed draws the release point once per run; set-up builds the mesh and
the solver once and warms up with one forecast, and the window repeats
that scenario's forecast back to back. The port's solver binds its
problem (release, initial state, boundary data) when it is built, so a
new release is a new solver, whose assembly, interval and plan a request
would then measure instead of the time steps. The mix file gives the mesh
size, the time steps, the solver's arguments (``fused_operator`` names the
operator whose work the forecast is counted at: 'uniform' or 'canvas')
and the iterations.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import work
from portbench.registry import load_module

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def release(config: dict, seed: int) -> dict:
    """The problem's parameters for ``seed``: the configuration's fixed
    parameters plus the release point it draws uniformly in its box (the
    same seed gives the same point)."""
    rng = np.random.default_rng(seed)
    spec = config["release"]
    if spec["shape"] != "box":
        raise ValueError(f"unknown release shape {spec['shape']!r}")
    params = dict(config["params"])
    params[spec["into"]] = [float(rng.uniform(*spec["x"])),
                            float(rng.uniform(*spec["y"]))]
    return params


class Forecasts:
    """The system under test for one run: a solver built once, and one
    request = one forecast to the host."""

    def __init__(self, config: dict, mix: dict, seed: int, device, span):
        import airpollution_tpu_torch as apt
        from airpollution_tpu_torch import problems

        self.config, self.mix, self.seed = config, mix, seed
        self.span = span
        self.device = torch.device(device)
        self.params = release(config, seed)
        dom = config["domain"]
        domain = apt.Domain(Lx=dom["half_width"], Ly=dom["half_width"],
                            T=dom["T"])
        n = mix["points_per_side"]
        with span("mesh_setup"):
            mesh = apt.create_mesh(n, dom["half_width"])
            self.mesh_data = apt.MeshData(
                mesh, domain, nt=mix["nt"], dtype=DTYPES[config["precision"]],
                device=self.device)
            _sync(self.device)
        with span("solver_setup"):
            kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in self.params.items()}
            problem = getattr(problems, config["problem"])(**kwargs)
            self.solver = apt.CRBESolver(
                domain, problem, self.mesh_data,
                time_scheme_order=config["time_scheme_order"],
                stiffness_convention=config["stiffness_convention"],
                device=self.device, **mix["solver"])
            self.request()
        self.n_dofs = self.mesh_data.number_of_segments
        self.steps_per_request = mix["nt"] - 1
        solver = mix["solver"]
        method = solver["solver_method"]
        k = (solver["chebyshev_iters"] if method == "chebyshev"
             else solver["fused_iters"])
        self.work = work.forecast_work(
            solver["fused_operator"], method, k, config["time_scheme_order"],
            solver.get("extrapolate_warm_start", False), self.n_dofs,
            self.steps_per_request, config["precision"])

    def request(self) -> torch.Tensor:
        with self.span("solve"):
            out = self.solver.solve(store_solutions=False)
        with self.span("copy_out"):
            return out[-1].to("cpu")

    @staticmethod
    def finite(field: torch.Tensor) -> bool:
        """Whether every value of a final field is finite."""
        return bool(torch.isfinite(field).all())

    def release_state(self):
        """Drop the program's mesh and solver (before the reference runs)."""
        self.solver = None
        self.mesh_data = None

    def reference(self, loop_dtype=torch.float64) -> torch.Tensor:
        """The configuration's plain reference for this run's inputs."""
        ref = load_module("reference", self.config["reference"])
        solver = self.mix["solver"]
        method = solver["solver_method"]
        dom = self.config["domain"]
        return ref.forecast(
            points_per_side=self.mix["points_per_side"],
            half_width=dom["half_width"], T=dom["T"], nt=self.mix["nt"],
            problem=self.config["problem"], params=self.params,
            convention=self.config["stiffness_convention"],
            order=self.config["time_scheme_order"], method=method,
            iters=(solver["chebyshev_iters"] if method == "chebyshev"
                   else solver["fused_iters"]),
            extrapolate=solver.get("extrapolate_warm_start", False),
            device=self.device, loop_dtype=loop_dtype)

    def judge(self, fields) -> dict:
        """The numbers compared, each beside its limit: the widest gap of
        the sampled final fields from the reference's (:func:`widest_gap`)."""
        gap = widest_gap(fields, self.reference())
        return {"max_gap_rel": {"value": gap,
                                "limit": self.mix["limits"]["max_gap_rel"]}}


def widest_gap(fields, expect) -> float:
    """The largest ``max|field - expect| / (max|field| + max|expect|)``
    over the fields: about half the gap relative to the reference's
    largest value where the two agree, at most 1 however far a field
    runs off; inf for a field that is not finite."""
    top = float(expect.abs().max())
    gap = 0.0
    for f in fields:
        got = f.to(device=expect.device, dtype=torch.float64)
        g = float((got - expect).abs().max()) / (
            float(got.abs().max()) + top)
        gap = max(gap, g if math.isfinite(g) else math.inf)
    return gap


def setup(config: dict, mix: dict, seed: int, device, span) -> Forecasts:
    return Forecasts(config, mix, seed, device, span)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
