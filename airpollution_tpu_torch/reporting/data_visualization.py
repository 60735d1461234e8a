"""Publication figures: the JAX package's
``reporting/data_visualization.py`` without pandas.

Reads the four experiment CSVs (``frames.read_csv``) and draws the
paper's five figures: log-log convergence with the empirical-rate guide
lines O(h^1.37) / O(h^0.98), training-time bars and efficiency curves,
D-sensitivity, CPU-vs-device memory bars, and the fixed-budget analysis,
with the same file names and rcParams. Without matplotlib each figure is
skipped with one printed line. Run as
``python -m airpollution_tpu_torch.reporting.data_visualization``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from airpollution_tpu_torch.reporting import frames
from airpollution_tpu_torch.reporting.plots import pyplot

RC_PARAMS = {
    "font.size": 12,
    "font.family": "serif",
    "axes.linewidth": 1.2,
    "axes.labelsize": 14,
    "xtick.labelsize": 12,
    "ytick.labelsize": 12,
    "legend.fontsize": 11,
    "figure.figsize": (10, 8),
    "lines.linewidth": 2,
    "grid.alpha": 0.3,
}


def _plt(path):
    """pyplot with the figures' rcParams, or None when matplotlib is
    missing (one printed line names ``path``)."""
    plt = pyplot(path)
    if plt is not None:
        plt.rcParams.update(RC_PARAMS)
    return plt


def figure_convergence(df_crbe, df_pinn, exp_dir):
    """Log-log L2/Linf convergence with guide lines."""
    plt = _plt(f"{exp_dir}/convergence_analysis.pdf")
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 6))
    ax1.loglog(df_crbe["mesh_size"], df_crbe["rel_l2_error"], "o-",
               label="CR-BE", color="blue", markersize=8, linewidth=3)
    ax1.loglog(df_pinn["mesh_size"], df_pinn["rel_l2_error"], "s--",
               label="PINN", color="orange", markersize=8, linewidth=3)
    ax1.set_xlabel("Mesh Size")
    ax1.set_ylabel("Relative L² Error")
    ax1.set_title("Convergence Analysis: L² Error")
    ax1.grid(True, which="both", ls="--", alpha=0.3)
    mesh_range = np.array([4, 128])
    ax1.loglog(mesh_range, 10 * (mesh_range / 4) ** (-1.37), "-.",
               color="blue", label="$O(h^{1.37}$)", linewidth=1.5)
    ax1.legend(frameon=True, fancybox=True, shadow=True)

    ax2.loglog(df_crbe["mesh_size"], df_crbe["max_error"], "o-",
               label="CR-BE", color="blue", markersize=8, linewidth=3)
    ax2.loglog(df_pinn["mesh_size"], df_pinn["max_error"], "s--",
               label="PINN", color="orange", markersize=8, linewidth=3)
    ax2.set_xlabel("Mesh Size")
    ax2.set_ylabel("Maximum Error (L∞)")
    ax2.set_title("Convergence Analysis: L∞ Error")
    ax2.grid(True, which="both", ls="--", alpha=0.3)
    ax2.loglog(mesh_range, 0.5 * (mesh_range / 4) ** (-0.98), "-.",
               color="blue", label="$O(h^{0.98})$", linewidth=1.5)
    ax2.legend(frameon=True, fancybox=True, shadow=True)
    plt.tight_layout()
    plt.savefig(f"{exp_dir}/convergence_analysis.pdf", dpi=600,
                bbox_inches="tight")
    plt.close(fig)


def figure_efficiency(df_crbe, df_pinn, exp_dir):
    """Training-time bars and error-x-time curves."""
    plt = _plt(f"{exp_dir}/computational_efficiency.pdf")
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 6))
    x = np.arange(len(df_crbe["mesh_size"]))
    width = 0.35
    bars1 = ax1.bar(x - width / 2, df_crbe["train_time"], width,
                    label="CR-BE", color="blue")
    bars2 = ax1.bar(x + width / 2, df_pinn["train_time"], width,
                    label="PINN", color="orange")
    ax1.set_xlabel("Mesh Size")
    ax1.set_ylabel("Training Time (seconds)")
    ax1.set_title("Training Time Comparison")
    ax1.set_xticks(x)
    ax1.set_xticklabels(df_crbe["mesh_size"])
    ax1.set_yscale("log")
    ax1.legend(frameon=True, fancybox=True, shadow=True)
    ax1.grid(True, which="both", ls="--", alpha=0.3)
    for bars, fmt in ((bars1, "{:.2f}"), (bars2, "{:.0f}")):
        for bar in bars:
            h = bar.get_height()
            ax1.text(bar.get_x() + bar.get_width() / 2.0, h * 1.1,
                     fmt.format(h), ha="center", va="bottom", fontsize=9)

    for df, style, label in ((df_crbe, "o-", "CR-BE"),
                             (df_pinn, "s--", "PINN")):
        eff = df["rel_l2_error"] * df["train_time"]
        ax2.semilogy(df["mesh_size"], eff, style, label=label,
                     color="blue" if label == "CR-BE" else "orange",
                     linewidth=4, markersize=10, markeredgecolor="white",
                     markeredgewidth=2)
    ax2.set_xlabel("Mesh Size")
    ax2.set_ylabel("Efficiency (L² Error × Time)")
    ax2.set_title("Computational Efficiency")
    ax2.legend(frameon=True, fancybox=True, shadow=True)
    ax2.grid(True, which="both", ls="--", alpha=0.3)
    plt.tight_layout()
    plt.savefig(f"{exp_dir}/computational_efficiency.pdf", dpi=600,
                bbox_inches="tight")
    plt.close(fig)


def figure_sensitivity(df_sensitivity, exp_dir):
    """Error vs diffusion coefficient."""
    plt = _plt(f"{exp_dir}/sensitivity_analysis.pdf")
    if plt is None:
        return
    fig, ax = plt.subplots(1, 1, figsize=(10, 7))
    ax.semilogx(df_sensitivity["diffusion_coef"],
                df_sensitivity["cr_l2_error"], "o-", linewidth=3,
                markersize=8, label="CRBE", color="blue",
                markeredgecolor="white", markeredgewidth=2)
    ax.semilogx(df_sensitivity["diffusion_coef"],
                df_sensitivity["pinn_l2_error"], "s-", linewidth=3,
                markersize=8, label="PINN", color="orange",
                markeredgecolor="white", markeredgewidth=2)
    ax.set_xlabel("Diffusion Coefficient")
    ax.set_ylabel("Relative L² Error")
    ax.set_title("Sensitivity to Diffusion Coefficient")
    ax.legend(frameon=True, fancybox=True, shadow=True)
    ax.grid(True, which="both", ls="--", alpha=0.3)
    plt.tight_layout()
    plt.savefig(f"{exp_dir}/sensitivity_analysis.pdf", dpi=600,
                bbox_inches="tight", facecolor="white", edgecolor="none")
    plt.close(fig)


def figure_memory(df_crbe, df_pinn, exp_dir):
    """CPU vs accelerator memory bars."""
    plt = _plt(f"{exp_dir}/memory_comparison_cpu_gpu.pdf")
    if plt is None:
        return
    fig, ax = plt.subplots(1, 1, figsize=(12, 8))
    mesh_sizes = df_crbe["mesh_size"]
    x = np.arange(len(mesh_sizes))
    width = 0.35
    crbe_cpu = df_crbe["cpu_memory_usage_MB"]
    pinn_dev = df_pinn["gpu_memory_usage_MB"]
    ax.bar(x - width / 2, crbe_cpu, width, label="CRBE (CPU)",
           color="blue", edgecolor="white", linewidth=1)
    ax.bar(x + width / 2, pinn_dev, width, label="PINN (device)",
           color="orange", edgecolor="white", linewidth=1)
    ax.set_xlabel("Mesh Size")
    ax.set_ylabel("Memory Usage (MB)")
    ax.set_title("Memory Usage Comparison: CPU vs Device Implementation")
    ax.set_xticks(x)
    ax.set_xticklabels(mesh_sizes)
    ax.legend(fontsize=12, frameon=True, fancybox=True, shadow=True)
    ax.set_yscale("log")
    ax.grid(True, which="both", ls="--", alpha=0.3, axis="y")
    for i, val in enumerate(pinn_dev):
        if val > 0:
            ax.annotate(f"{val:.0f} MB", (i + width / 2, val),
                        xytext=(0, 5), textcoords="offset points",
                        ha="center", va="bottom", fontsize=9,
                        bbox=dict(boxstyle="round,pad=0.2",
                                  facecolor="wheat", alpha=0.7))
    for i, val in enumerate(crbe_cpu):
        if val > 0:
            ax.annotate(f"{val:.0f} MB", (i - width / 2, val),
                        xytext=(0, 5), textcoords="offset points",
                        ha="center", va="bottom", fontsize=9,
                        bbox=dict(boxstyle="round,pad=0.2",
                                  facecolor="wheat", alpha=0.7))
    plt.tight_layout()
    plt.savefig(f"{exp_dir}/memory_comparison_cpu_gpu.pdf", dpi=600,
                bbox_inches="tight", facecolor="white", edgecolor="none")
    plt.close(fig)


def figure_runtime_budget(df_runtime, exp_dir):
    """Error and epochs vs time budget."""
    plt = _plt(f"{exp_dir}/runtime_budget_analysis.pdf")
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 6))
    groups = frames.group_mean(
        df_runtime, ["method", "time_budget"],
        ["rel_l2_error", "max_error", "epochs_completed"])
    pinn_g = frames.select(groups, groups["method"] == "PINN")
    crbe_g = frames.select(groups, groups["method"] == "CRBE")

    ax1.plot(pinn_g["time_budget"], pinn_g["rel_l2_error"], "s-",
             label="PINN", color="orange", markersize=8, linewidth=3)
    ax1.axhline(y=crbe_g["rel_l2_error"][0], color="blue",
                linestyle="-", linewidth=3, label="CR-BE (constant)")
    ax1.set_xlabel("Time Budget (seconds)")
    ax1.set_ylabel("Relative L² Error")
    ax1.set_title("Performance vs Time Budget")
    ax1.legend(frameon=True, fancybox=True, shadow=True)
    ax1.grid(True, which="both", ls="--", alpha=0.3)

    ax2.plot(pinn_g["time_budget"], pinn_g["epochs_completed"], "o-",
             color="green", markersize=8, linewidth=3)
    ax2.set_xlabel("Time Budget (seconds)")
    ax2.set_ylabel("Epochs Completed")
    ax2.set_title("PINN Training Progress")
    ax2.grid(True, which="both", ls="--", alpha=0.3)
    plt.tight_layout()
    plt.savefig(f"{exp_dir}/runtime_budget_analysis.pdf", dpi=600,
                bbox_inches="tight", facecolor="white", edgecolor="none")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Publication figures.")
    parser.add_argument("--exp_dir", type=str,
                        default="experimental_results/figures")
    args = parser.parse_args(argv)
    os.makedirs(args.exp_dir, exist_ok=True)

    read = frames.read_csv
    df_crbe = read("experimental_results/crbe/df_crbe_training_results.csv")
    df_pinn = read("experimental_results/pinn/df_pinn_training_results.csv")
    df_sens = read("experimental_results/sensibility/df_sensitivity_data.csv")
    df_runtime = read(
        "experimental_results/fixed_runtime/fixed_runtime_comparison.csv"
    )

    if df_crbe is not None and df_pinn is not None:
        figure_convergence(df_crbe, df_pinn, args.exp_dir)
        figure_efficiency(df_crbe, df_pinn, args.exp_dir)
        figure_memory(df_crbe, df_pinn, args.exp_dir)
    if df_sens is not None:
        figure_sensitivity(df_sens, args.exp_dir)
    if df_runtime is not None:
        figure_runtime_budget(df_runtime, args.exp_dir)
    print(f"Figures saved under {args.exp_dir}")


if __name__ == "__main__":
    main()
