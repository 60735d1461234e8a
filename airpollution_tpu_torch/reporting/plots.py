"""Solution and error plots: the JAX package's ``reporting/plots.py``.

Filled contours over the midpoint triangulation, vertex-averaged
("interpolated") plots, error-evolution and loss curves, the ensemble's
exceedance maps and a receptor footprint, with the JAX package's file
names. Each figure takes its tensors to numpy on the host once.
matplotlib is imported by the function that draws (:func:`pyplot`); where
it is not installed, the function prints one line naming the skipped
figure and returns None.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def pyplot(figure: str):
    """matplotlib's pyplot on the Agg backend, or None, after one printed
    line naming ``figure``, when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"skipped figure {figure}: matplotlib is not installed",
              flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _tri():
    import matplotlib.tri as mtri

    return mtri


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _exact(fn, xyt, like):
    """A problem's closed form at host points ``xyt``, evaluated on the
    device and in the dtype of ``like``, back on the host."""
    pts = torch.as_tensor(xyt, dtype=like.dtype, device=like.device)
    return _numpy(fn(pts)).ravel()


def vertex_average(points, segments, midpoint_values):
    """Average segment-midpoint DOF values onto mesh vertices."""
    vertex_values = np.zeros(len(points))
    count = np.zeros(len(points))
    vals = _numpy(midpoint_values)
    segs = _numpy(segments)
    np.add.at(vertex_values, segs[:, 0], vals)
    np.add.at(vertex_values, segs[:, 1], vals)
    np.add.at(count, segs[:, 0], 1)
    np.add.at(count, segs[:, 1], 1)
    return vertex_values / np.maximum(count, 1)


def _solution_row(solver, time_index):
    """Map a full-resolution step index onto the stored trajectory's row:
    ``(row, time_index, t)``. A solver built with ``snapshot_every=k``
    stores ``(nt-1)/k + 1`` rows, one with ``store_solutions=False`` only
    the final state."""
    md = solver.mesh_data
    if time_index is None:
        time_index = md.nt - 1
    n_rows = len(solver.solutions)
    if n_rows == 1:
        if time_index != md.nt - 1:
            raise ValueError(
                f"time_index {time_index} requested but this solver "
                f"stored only the final state (store_solutions=False); "
                f"re-solve with store_solutions=True for intermediate "
                f"steps"
            )
        return 0, time_index, time_index * solver.dt
    stride = getattr(solver, "snapshot_every", None) or 1
    if time_index % stride:
        raise ValueError(
            f"time_index {time_index} is not a stored snapshot: this "
            f"solver stores every {stride}-th step (snapshot_every)"
        )
    row = time_index // stride
    if not 0 <= row < n_rows:
        raise ValueError(
            f"time_index {time_index} (row {row}) is outside the stored "
            f"trajectory of {n_rows} rows"
        )
    return row, time_index, time_index * solver.dt


def _panels(fig, panels, triang, cmap="viridis"):
    """One filled contour (20 levels) per (axes, values, title) with its
    colour bar; the error panel passes its own colour map as a fourth
    item."""
    for ax, vals, title, *own_cmap in panels:
        c = ax.tricontourf(triang, vals, 20, cmap=(own_cmap or [cmap])[0])
        ax.set_title(title)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        fig.colorbar(c, ax=ax)


def plot_solution_on_midpoints(solver, analytical_sol_fn=None,
                               time_index=None, save_dir="results"):
    """Numerical / analytical / error panels on the midpoint
    triangulation: ``<save_dir>/solution_t<index>.png``."""
    md = solver.mesh_data
    row, time_index, t = _solution_row(solver, time_index)
    plt = pyplot(f"{save_dir}/solution_t{time_index}.png")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    midpoints = _numpy(md.midpoints)
    u_num = _numpy(solver.solutions[row])
    triang = _tri().Triangulation(midpoints[:, 0], midpoints[:, 1],
                                  _numpy(md.triangle_to_segments))
    if analytical_sol_fn is not None:
        xyt = np.hstack([midpoints, np.full((len(midpoints), 1), t)])
        u_ex = _exact(analytical_sol_fn, xyt, md.midpoints)
        fig, axs = plt.subplots(1, 3, figsize=(18, 6))
        _panels(fig, (
            (axs[0], u_num, f"Numerical Solution at t = {t:.3f}"),
            (axs[1], u_ex, f"Analytical Solution at t = {t:.3f}"),
            (axs[2], u_num - u_ex, f"Error at t = {t:.3f}", "coolwarm"),
        ), triang)
    else:
        fig, ax = plt.subplots(figsize=(10, 8))
        _panels(fig, ((ax, u_num, f"Numerical Solution at t = {t:.3f}"),),
                triang)
    plt.tight_layout()
    plt.savefig(f"{save_dir}/solution_t{time_index}.png", dpi=300)
    plt.close(fig)


def plot_interpolated_solution(solver, analytical_sol_fn=None,
                               time_index=None, save_dir="results", name=""):
    """Vertex-averaged solution plot, PNG and PDF:
    ``<save_dir>/solution_t<index>_interpolated_<name>.{png,pdf}``."""
    md = solver.mesh_data
    row, time_index, t = _solution_row(solver, time_index)
    base = f"{save_dir}/solution_t{time_index}_interpolated_{name}"
    plt = pyplot(base + ".png/pdf")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    points = _numpy(md.points)
    vertex_values = vertex_average(points, md.segments,
                                   solver.solutions[row])
    triang = _tri().Triangulation(points[:, 0], points[:, 1],
                                  _numpy(md.triangles))
    if analytical_sol_fn is not None:
        xyt = np.hstack([points, np.full((len(points), 1), t)])
        u_ex = _exact(analytical_sol_fn, xyt, md.points)
        fig, axs = plt.subplots(1, 2, figsize=(15, 5))
        _panels(fig, (
            (axs[0], vertex_values, f"Numerical Solution at t = {t:.3f}"),
            (axs[1], u_ex, f"Analytical Solution at t = {t:.3f}"),
        ), triang)
    else:
        fig, ax = plt.subplots(figsize=(10, 8))
        _panels(fig, ((ax, vertex_values,
                       f"Numerical Solution at t = {t:.3f}"),), triang)
    plt.tight_layout()
    plt.savefig(base + ".png", dpi=300)
    plt.savefig(base + ".pdf", dpi=300)
    plt.close(fig)
    print(f"Saved at {base}.png/pdf")


def plot_error_evolution(solver, errors, save_dir="results"):
    """Semilogy L2 / Linf error curves over time:
    ``<save_dir>/error_evolution.png``."""
    plt = pyplot(f"{save_dir}/error_evolution.png")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    l2 = _numpy(errors["l2_errors"])
    linf = _numpy(errors["linf_errors"])
    # The time axis follows the curves: a strided trajectory has fewer
    # rows than nt.
    time_values = np.linspace(0, solver.domain.T, len(l2))
    fig = plt.figure(figsize=(10, 6))
    plt.semilogy(time_values, l2, "b-", label="L2 Error")
    plt.semilogy(time_values, linf, "r-", label="L∞ Error")
    plt.grid(True)
    plt.xlabel("Time")
    plt.ylabel("Error (log scale)")
    plt.title("Error Evolution")
    plt.legend()
    plt.tight_layout()
    plt.savefig(f"{save_dir}/error_evolution.png", dpi=300)
    plt.close(fig)


def plot_loss_history(history, save_dir="results", name=""):
    """Semilogy loss curves: ``<save_dir>/loss_history_<name>.{pdf,png}``."""
    plt = pyplot(f"{save_dir}/loss_history_{name}.pdf/png")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    fig = plt.figure(figsize=(10, 6))
    plt.semilogy(history["total_loss"], label="Total Loss", ls="-.")
    plt.semilogy(history["pde_loss"], label="PDE Loss")
    plt.semilogy(history["ic_loss"], label="IC Loss")
    plt.semilogy(history["bc_loss"], label="BC Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Training Loss History")
    plt.legend()
    plt.grid(True, which="both", ls="--")
    plt.savefig(f"{save_dir}/loss_history_{name}.pdf", dpi=500)
    plt.savefig(f"{save_dir}/loss_history_{name}.png", dpi=500)
    plt.tight_layout()
    plt.close(fig)


def _pinn_panels(plt, u_num, u_ex, t, triang):
    if u_ex is not None:
        fig, axs = plt.subplots(1, 2, figsize=(15, 5))
        panels = ((axs[0], u_num, "Numerical"), (axs[1], u_ex, "Analytical"))
    else:
        fig, ax = plt.subplots(figsize=(10, 8))
        panels = ((ax, u_num, "Numerical"),)
    _panels(fig, [(ax, vals, f"{label} Solution at t = {t:.3f}")
                  for ax, vals, label in panels], triang)
    plt.tight_layout()
    return fig


def plot_pinn_solution(model, t, mesh_data, analytical_sol_fn=None,
                       save_dir="results"):
    """The PINN at the mesh vertices: ``<save_dir>/solution_<t>.{pdf,png}``."""
    plt = pyplot(f"{save_dir}/solution_{t}.pdf/png")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    points = _numpy(mesh_data.points)
    xyt = np.hstack([points, np.full((len(points), 1), t)])
    u_num = _numpy(model.forward(xyt)).ravel()
    u_ex = (None if analytical_sol_fn is None
            else _exact(analytical_sol_fn, xyt, mesh_data.points))
    triang = _tri().Triangulation(points[:, 0], points[:, 1],
                                  _numpy(mesh_data.triangles))
    fig = _pinn_panels(plt, u_num, u_ex, t, triang)
    plt.savefig(f"{save_dir}/solution_{t}.pdf", dpi=500)
    plt.savefig(f"{save_dir}/solution_{t}.png", dpi=500)
    plt.close(fig)


def plot_pinn_interpolated_solution(model, t, mesh_data,
                                    analytical_sol_fn=None,
                                    save_dir="results", name=""):
    """The PINN at the CR midpoints, averaged onto the vertices like the
    FEM plots: ``<save_dir>/solution_<t>_interpolated_solution_<name>``
    (.pdf, .png)."""
    base = f"{save_dir}/solution_{t}_interpolated_solution_{name}"
    plt = pyplot(base + ".pdf/png")
    if plt is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    midpoints = _numpy(mesh_data.midpoints)
    xyt_mid = np.hstack([midpoints, np.full((len(midpoints), 1), t)])
    u_mid = _numpy(model.forward(xyt_mid)).ravel()
    points = _numpy(mesh_data.points)
    vertex_values = vertex_average(points, mesh_data.segments, u_mid)
    u_ex = None
    if analytical_sol_fn is not None:
        xyt_v = np.hstack([points, np.full((len(points), 1), t)])
        u_ex = _exact(analytical_sol_fn, xyt_v, mesh_data.points)
    triang = _tri().Triangulation(points[:, 0], points[:, 1],
                                  _numpy(mesh_data.triangles))
    fig = _pinn_panels(plt, vertex_values, u_ex, t, triang)
    plt.savefig(base + ".pdf", dpi=500)
    plt.savefig(base + ".png", dpi=500)
    plt.close(fig)
    print(f"Saved at {base}.pdf/png")


def _midpoint_triangulation(mesh_data):
    midpoints = _numpy(mesh_data.midpoints)
    return midpoints, _tri().Triangulation(
        midpoints[:, 0], midpoints[:, 1],
        _numpy(mesh_data.triangle_to_segments))


def plot_exceedance_maps(mesh_data, exceedance, thresholds,
                         save_dir="results", name="exceedance"):
    """Alert-probability panels P(c(x, T) > tau) of an ensemble forecast
    (``ensemble_forecast``'s 'exceedance' product): one filled contour per
    threshold on the midpoint triangulation, the colour scale fixed to
    [0, 1]. Returns ``<save_dir>/<name>.png``, or None when skipped."""
    path = f"{save_dir}/{name}.png"
    plt = pyplot(path)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    _, triang = _midpoint_triangulation(mesh_data)
    exc = _numpy(exceedance)
    n = exc.shape[0]
    fig, axs = plt.subplots(1, n, figsize=(6 * n, 5.5), squeeze=False)
    levels = np.linspace(0.0, 1.0, 21)
    for ax, probs, tau in zip(axs[0], exc, thresholds):
        c = ax.tricontourf(triang, probs, levels=levels, cmap="magma",
                           vmin=0.0, vmax=1.0)
        ax.set_title(f"P(c > {tau:g}) at t = T")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        fig.colorbar(c, ax=ax)
    plt.tight_layout()
    plt.savefig(path, dpi=300)
    plt.close(fig)
    return path


def plot_footprint(mesh_data, footprint, receptor_index,
                   save_dir="results", name="footprint"):
    """Receptor source-attribution map (a ``receptor_footprint`` row): the
    adjoint sensitivity of one station's final reading to a steady
    per-DOF emission field, the receptor marked. Returns
    ``<save_dir>/<name>.png``, or None when skipped."""
    path = f"{save_dir}/{name}.png"
    plt = pyplot(path)
    if plt is None:
        return None
    os.makedirs(save_dir, exist_ok=True)
    midpoints, triang = _midpoint_triangulation(mesh_data)
    fig, ax = plt.subplots(figsize=(8, 6.5))
    c = ax.tricontourf(triang, _numpy(footprint), 30, cmap="viridis")
    rx, ry = midpoints[int(receptor_index)]
    ax.plot([rx], [ry], marker="*", markersize=16, color="red",
            markeredgecolor="white", linestyle="none", label="receptor")
    ax.legend(loc="upper right")
    ax.set_title("Receptor footprint  dc(x_r, T) / ds_j")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.colorbar(c, ax=ax)
    plt.tight_layout()
    plt.savefig(path, dpi=300)
    plt.close(fig)
    return path
