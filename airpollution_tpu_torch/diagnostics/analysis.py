"""Physics diagnostics: mass, centre of mass, spreading, peaks, profiles.

The JAX package's ``diagnostics/analysis.py`` on PyTorch tensors, where
the mesh data lives (the card, or the CPU when the caller asked for it).
Every quantity is one batched computation over the whole (nt, n_seg)
trajectory:

- the per-triangle midpoint quadrature ``integral f ~ sum_tri area/3 *
  sum_{midpoints} f`` is a dot product with per-DOF weights ``w_i =
  sum_{tri owning i} area/3`` (the diagonal CR mass matrix), built by one
  ``index_add_``;
- masses, moments and variances are products of the trajectory with
  weighted coordinate vectors;
- the PINN field is one forward pass over the space-time grid.

Physics oracles: the centre of mass ``(10, 10) + v t`` and the spreading
``sigma0^2 + 2 D t`` with ``sigma0^2 = (12 - 8)^2 / 12`` (the square
pulse's). Results are numpy arrays on the host, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_MASS_EPS = 1e-10


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _promoted(U, *vectors):
    """``U`` and ``vectors`` in their common promoted dtype (JAX's
    promotion: a float32 PINN field against float64 weights computes in
    float64)."""
    dtype = U.dtype
    for v in vectors:
        dtype = torch.promote_types(dtype, v.dtype)
    return (U.to(dtype),) + tuple(v.to(dtype) for v in vectors)


def quadrature_weights(mesh_data) -> torch.Tensor:
    """Per-DOF quadrature weights: w_i = sum over incident triangles of
    area/3 (the diagonal CR mass matrix)."""
    areas = mesh_data.triangle_areas
    w = torch.zeros(mesh_data.number_of_segments, dtype=areas.dtype,
                    device=areas.device)
    return w.index_add_(0, mesh_data.triangle_to_segments.reshape(-1),
                        (areas / 3.0).repeat_interleave(3))


def evaluate_pinn_on_grid(model, mesh_data, times=None) -> torch.Tensor:
    """PINN field on the (nt, n_seg) space-time grid, one forward pass.

    ``times`` defaults to the full ``mesh_data.time_discr``; pass the
    snapshot times when comparing against a strided CRBE trajectory."""
    mid = mesh_data.midpoints
    times = (mesh_data.time_discr if times is None
             else torch.tensor(np.asarray(times), dtype=mid.dtype,
                               device=mid.device))
    nt, n = times.shape[0], mid.shape[0]
    xyt = torch.cat([
        mid[None, :, :].expand(nt, n, 2).reshape(-1, 2),
        times[:, None, None].expand(nt, n, 1).reshape(-1, 1),
    ], dim=1)
    return model.forward(xyt).reshape(nt, n)


def mass_over_time(U, weights) -> torch.Tensor:
    """Total mass per time step: (nt,) = U @ w."""
    U, weights = _promoted(U, weights)
    return U @ weights


def center_of_mass_over_time(U, weights, midpoints):
    """(com_x, com_y, mass) per time step."""
    U, weights, midpoints = _promoted(U, weights, midpoints)
    mass = U @ weights
    mx = U @ (weights * midpoints[:, 0])
    my = U @ (weights * midpoints[:, 1])
    safe = mass > _MASS_EPS
    denom = torch.where(safe, mass, torch.ones_like(mass))
    zero = torch.zeros_like(mass)
    return (torch.where(safe, mx / denom, zero),
            torch.where(safe, my / denom, zero), mass)


def variance_over_time(U, weights, midpoints):
    """Plume variance per axis per time step, by the expansion sum w u
    (x - com)^2 = sum w u x^2 - 2 com sum w u x + com^2 sum w u."""
    U, weights, midpoints = _promoted(U, weights, midpoints)
    com_x, com_y, mass = center_of_mass_over_time(U, weights, midpoints)
    safe = mass > _MASS_EPS
    denom = torch.where(safe, mass, torch.ones_like(mass))

    def var_axis(coord, com):
        s2 = U @ (weights * coord ** 2)
        s1 = U @ (weights * coord)
        acc = s2 - 2 * com * s1 + com ** 2 * mass
        return torch.where(safe, acc / denom, torch.zeros_like(acc))

    return var_axis(midpoints[:, 0], com_x), var_axis(midpoints[:, 1], com_y)


def peak_tracking(U, midpoints):
    """Peak value and location per time step."""
    idx = torch.argmax(U, dim=1)
    peaks = torch.take_along_dim(U, idx[:, None], dim=1)[:, 0]
    return peaks, midpoints[idx]


def concentration_profiles(U, mesh_data, y_slice=10.0, tol=0.5, times=None):
    """Transect profiles at y ~ y_slice for 4 time snapshots (host-side
    selection). ``times`` must match ``U.shape[0]`` (snapshot times for a
    strided trajectory); it defaults to the full time discretization."""
    mid = _numpy(mesh_data.midpoints)
    y_idx = np.where(np.abs(mid[:, 1] - y_slice) < tol)[0]
    y_idx = y_idx[np.argsort(mid[y_idx, 0])]
    x_coords = mid[y_idx, 0]
    nt = U.shape[0]
    snapshots = [nt // 4, nt // 2, 3 * nt // 4, nt - 1]
    times = _numpy(mesh_data.time_discr if times is None else times)
    U_np = _numpy(U)
    return {
        f"t_{times[i]:.1f}": {"x_coords": x_coords, "profile": U_np[i, y_idx]}
        for i in snapshots
    }


class ComprehensiveAnalysis:
    """Batched CRBE-vs-PINN physics diagnostics: the JAX package's class,
    with the same result-dict keys and figure file names."""

    def __init__(self, problem, domain, mesh_data, solver_crbe, model_pinn,
                 quadrature="triangle"):
        """``quadrature``: "triangle" is the triangle-based integration
        (area/3 per incident triangle), "segment" the segment-length
        weights."""
        self.problem = problem
        self.domain = domain
        self.mesh_data = mesh_data
        self.solver_crbe = solver_crbe
        self.model_pinn = model_pinn
        self.results = {}
        if quadrature == "triangle":
            self._w = quadrature_weights(mesh_data)
        elif quadrature == "segment":
            self._w = mesh_data.segment_lengths
        else:
            raise ValueError(f"unknown quadrature {quadrature}")
        self._U_crbe = torch.as_tensor(solver_crbe.solutions,
                                       device=self._w.device)
        # The snapshot times must match the stored trajectory: a solver
        # built with snapshot_every=k stores (nt-1)/k + 1 rows.
        times_full = _numpy(mesh_data.time_discr)
        n_rows = int(self._U_crbe.shape[0])
        k_snap = getattr(solver_crbe, "snapshot_every", None)
        if n_rows == times_full.shape[0]:
            self._times = times_full
        elif k_snap and n_rows == (times_full.shape[0] - 1) // k_snap + 1:
            self._times = times_full[::k_snap]
        else:
            raise ValueError(
                f"stored trajectory has {n_rows} rows but the time "
                f"discretization has {times_full.shape[0]} points "
                f"(snapshot_every={k_snap}); cannot align diagnostics"
            )
        self._U_pinn = evaluate_pinn_on_grid(model_pinn, mesh_data,
                                             times=self._times)

    def compute_mass_conservation(self):
        crbe_masses = _numpy(mass_over_time(self._U_crbe, self._w))
        pinn_masses = _numpy(mass_over_time(self._U_pinn, self._w))
        self.results["mass_conservation"] = {
            "times": self._times,
            "crbe_masses": crbe_masses,
            "pinn_masses": pinn_masses,
            "initial_mass": crbe_masses[0],
        }
        return self.results["mass_conservation"]

    def compute_center_of_mass_tracking(self):
        times = self._times
        mid = self.mesh_data.midpoints
        cx, cy, _ = center_of_mass_over_time(self._U_crbe, self._w, mid)
        px, py, _ = center_of_mass_over_time(self._U_pinn, self._w, mid)
        v = np.asarray([float(c) for c in self.problem.v])
        self.results["center_of_mass"] = {
            "times": times,
            "crbe_com_x": _numpy(cx),
            "crbe_com_y": _numpy(cy),
            "pinn_com_x": _numpy(px),
            "pinn_com_y": _numpy(py),
            # The initial centre is (10, 10).
            "theoretical_com_x": 10.0 + v[0] * times,
            "theoretical_com_y": 10.0 + v[1] * times,
        }
        return self.results["center_of_mass"]

    def compute_spreading_rate_analysis(self):
        times = self._times
        mid = self.mesh_data.midpoints
        cvx, cvy = variance_over_time(self._U_crbe, self._w, mid)
        pvx, pvy = variance_over_time(self._U_pinn, self._w, mid)
        initial_variance = (12 - 8) ** 2 / 12  # uniform on [8, 12]
        self.results["spreading_rate"] = {
            "times": times,
            "crbe_var_x": _numpy(cvx),
            "crbe_var_y": _numpy(cvy),
            "pinn_var_x": _numpy(pvx),
            "pinn_var_y": _numpy(pvy),
            "theoretical_var": initial_variance
            + 2 * float(self.problem.D) * times,
        }
        return self.results["spreading_rate"]

    def compute_peak_concentration_tracking(self):
        mid = self.mesh_data.midpoints
        cp, cl = peak_tracking(self._U_crbe, mid)
        pp, pl = peak_tracking(self._U_pinn, mid)
        self.results["peak_tracking"] = {
            "times": self._times,
            "crbe_peaks": _numpy(cp),
            "pinn_peaks": _numpy(pp),
            "crbe_peak_locations": _numpy(cl),
            "pinn_peak_locations": _numpy(pl),
        }
        return self.results["peak_tracking"]

    def compute_concentration_profiles(self, y_slice=10.0):
        crbe = concentration_profiles(self._U_crbe, self.mesh_data, y_slice,
                                      times=self._times)
        pinn = concentration_profiles(self._U_pinn, self.mesh_data, y_slice,
                                      times=self._times)
        profiles = {
            k: {
                "x_coords": crbe[k]["x_coords"],
                "crbe_profile": crbe[k]["profile"],
                "pinn_profile": pinn[k]["profile"],
            }
            for k in crbe
        }
        self.results["concentration_profiles"] = profiles
        return profiles

    def run_all_analyses(self):
        print("Starting comprehensive analysis...")
        self.compute_mass_conservation()
        self.compute_center_of_mass_tracking()
        self.compute_spreading_rate_analysis()
        self.compute_peak_concentration_tracking()
        self.compute_concentration_profiles()
        print("All analyses completed!")
        return self.results

    def summary_statistics(self):
        """Summary lines: mass loss %, final centre-of-mass error, peak
        decay %."""
        out = {}
        if "mass_conservation" in self.results:
            mc = self.results["mass_conservation"]
            out["mass_loss_crbe_pct"] = (
                (mc["crbe_masses"][-1] - mc["crbe_masses"][0])
                / mc["crbe_masses"][0] * 100
            )
            out["mass_loss_pinn_pct"] = (
                (mc["pinn_masses"][-1] - mc["pinn_masses"][0])
                / mc["pinn_masses"][0] * 100
            )
        if "center_of_mass" in self.results:
            com = self.results["center_of_mass"]
            out["com_error_x_crbe"] = abs(
                com["crbe_com_x"][-1] - com["theoretical_com_x"][-1]
            )
            out["com_error_x_pinn"] = abs(
                com["pinn_com_x"][-1] - com["theoretical_com_x"][-1]
            )
        if "peak_tracking" in self.results:
            pt = self.results["peak_tracking"]
            out["peak_decay_crbe_pct"] = (
                (pt["crbe_peaks"][0] - pt["crbe_peaks"][-1])
                / pt["crbe_peaks"][0] * 100
            )
            out["peak_decay_pinn_pct"] = (
                (pt["pinn_peaks"][0] - pt["pinn_peaks"][-1])
                / pt["pinn_peaks"][0] * 100
            )
        return out

    def plot_all_results(self, save_dir="analysis_plots"):
        """The five diagnostic figures (the JAX package's file names),
        from the host copies in ``results``."""
        from airpollution_tpu_torch.reporting.plots import pyplot

        plt = pyplot(f"{save_dir}/ (the analysis figures)")
        if plt is None:
            return
        os.makedirs(save_dir, exist_ok=True)
        colors = {"crbe": "#1f77b4", "pinn": "#ff7f0e",
                  "theoretical": "#2ca02c"}

        def save(fig, name):
            fig.tight_layout()
            fig.savefig(f"{save_dir}/{name}.png", dpi=300)
            fig.savefig(f"{save_dir}/{name}.pdf", dpi=600,
                        bbox_inches="tight")
            plt.close(fig)

        def curves(ax, times, crbe, pinn, ylabel, title, theory=None,
                   theory_label="Theoretical", xlabel="Time (s)"):
            ax.plot(times, crbe, "o-", color=colors["crbe"], label="CRBE",
                    markersize=4)
            ax.plot(times, pinn, "s-", color=colors["pinn"], label="PINN",
                    markersize=4)
            if theory is not None:
                ax.plot(times, theory, "--", color=colors["theoretical"],
                        label=theory_label)
            ax.set_xlabel(xlabel)
            ax.set_ylabel(ylabel)
            ax.set_title(title)
            ax.legend(frameon=True, fancybox=True, shadow=True)
            ax.grid(True, alpha=0.3)

        if "mass_conservation" in self.results:
            mc = self.results["mass_conservation"]
            fig, ax = plt.subplots(1, 1, figsize=(10, 6))
            curves(ax, mc["times"], mc["crbe_masses"], mc["pinn_masses"],
                   "Total Mass", "Mass Conservation Comparison")
            ax.axhline(y=mc["initial_mass"], color=colors["theoretical"],
                       linestyle="--", label="Initial Mass")
            ax.legend(frameon=True, fancybox=True, shadow=True)
            save(fig, "mass_conservation")

        if "center_of_mass" in self.results:
            com = self.results["center_of_mass"]
            fig, axes = plt.subplots(1, 2, figsize=(15, 6))
            for ax, a in zip(axes, ("x", "y")):
                curves(ax, com["times"], com[f"crbe_com_{a}"],
                       com[f"pinn_com_{a}"],
                       f"Center of Mass {a.upper()} (m)",
                       f"Center of Mass - {a.upper()} Direction",
                       theory=com[f"theoretical_com_{a}"])
            save(fig, "center_of_mass")

        if "spreading_rate" in self.results:
            sr = self.results["spreading_rate"]
            fig, axes = plt.subplots(1, 2, figsize=(15, 6))
            for ax, a in zip(axes, ("x", "y")):
                curves(ax, sr["times"], sr[f"crbe_var_{a}"],
                       sr[f"pinn_var_{a}"], f"Variance {a.upper()} (m²)",
                       f"Plume Spreading - {a.upper()} Direction",
                       theory=sr["theoretical_var"])
            save(fig, "spreading_rate")

        if "peak_tracking" in self.results:
            pt = self.results["peak_tracking"]
            fig, ax = plt.subplots(1, 1, figsize=(10, 6))
            curves(ax, pt["times"], pt["crbe_peaks"], pt["pinn_peaks"],
                   "Peak Concentration", "Peak Concentration Evolution")
            save(fig, "peak_concentration")

        if "concentration_profiles" in self.results:
            profiles = self.results["concentration_profiles"]
            fig, axes = plt.subplots(2, 2, figsize=(15, 12))
            for ax, (time_key, pdata) in zip(axes.flatten(),
                                             profiles.items()):
                curves(ax, pdata["x_coords"], pdata["crbe_profile"],
                       pdata["pinn_profile"], "Concentration",
                       f"Concentration Profile at {time_key}",
                       xlabel="X coordinate (m)")
            save(fig, "concentration_profiles")

        print(f"All plots saved to {save_dir}/")
