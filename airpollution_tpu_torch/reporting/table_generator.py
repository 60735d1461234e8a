"""LaTeX table generator: the JAX package's
``reporting/table_generator.py`` without pandas.

Reads the four experiment CSVs (``frames.read_csv``: column dicts of
numpy arrays) and writes ``convergence_tables.tex`` with the paper's
eight tables (convergence comparison, rates, resources, efficiency,
summary, characteristics, D-sensitivity, fixed-runtime), the same
captions and labels, the same ``format_sci`` LaTeX number formatting and
log-log ``linregress`` convergence rates with R; on the same CSV files
its text is the JAX package's, byte for byte. A missing sensitivity or
fixed-runtime CSV skips its table. Run as
``python -m airpollution_tpu_torch.reporting.table_generator``.
"""

from __future__ import annotations

import argparse
import os
import numpy as np
from scipy.stats import linregress

from airpollution_tpu_torch.reporting import frames


def format_sci(x):
    """LaTeX scientific or fixed formatting of one number."""
    if x == 0:
        return "$0$"
    abs_x = abs(x)
    if abs_x < 1e-4 or abs_x >= 1e4:
        s = f"{x:.5e}"
        base, exp = s.split("e")
        base = f"{float(base):.5f}".rstrip("0").rstrip(".")
        return f"${base[:4]}\\cdot 10^{{{int(exp)}}}$"
    int_part = int(abs_x)
    digits_before_dot = len(str(int_part))
    if digits_before_dot >= 4:
        return f"${x:.1f}$"
    if digits_before_dot >= 3:
        return f"${x:.2f}$"
    if digits_before_dot >= 2:
        return f"${x:.3f}$"
    return f"${x:.4f}$"


def convergence_rates(df):
    """Log-log linregress of error vs 1/mesh_size of a frame. Returns
    (l2_rate, l2_r, linf_rate, linf_r)."""
    log_h = np.log(1 / df["mesh_size"])
    l2 = linregress(log_h, np.log(df["rel_l2_error"]))
    linf = linregress(log_h, np.log(df["max_error"]))
    return l2.slope, l2.rvalue, linf.slope, linf.rvalue


def _tabular(caption, label, colspec, header, rows):
    out = "\\begin{table}[htbp]\n\\centering\n"
    out += f"\\caption{{{caption}}}\n\\label{{{label}}}\n"
    out += f"\\begin{{tabular}}{{{colspec}}}\n\\toprule\n"
    out += header
    out += "".join(rows)
    out += "\\bottomrule\n\\end{tabular}\n\\end{table}"
    return out


def generate_latex_tables(df_crbe, df_pinn, memory_data=None,
                          sensitivity_data=None, df_fixed_runtime=None):
    """The tables by name, from frames (dicts of column arrays): the CRBE
    and PINN sweeps, the memory frame (``cr_memory_mb``,
    ``pinn_memory_mb``), the D-sensitivity and the fixed-runtime rows;
    the last three may be None."""
    tables = {}
    mesh_sizes = df_crbe["mesh_size"]
    crbe_l2_rate, crbe_l2_r2, crbe_linf_rate, crbe_linf_r2 = (
        convergence_rates(df_crbe)
    )
    pinn_l2_rate, pinn_l2_r2, pinn_linf_rate, pinn_linf_r2 = (
        convergence_rates(df_pinn)
    )

    # Table 1: convergence comparison.
    header = (
        "\\multirow{2}{*}{Mesh Size} & \\multicolumn{2}{c}{Relative $L^2$"
        " Error} & \\multicolumn{2}{c}{Maximum Error ($L^\\infty$)} &"
        " \\multicolumn{2}{c}{Training Time (s)} \\\\\n"
        "\\cmidrule(lr){2-3} \\cmidrule(lr){4-5} \\cmidrule(lr){6-7}\n"
        "& CR-BE & PINN & CR-BE & PINN & CR-BE & PINN \\\\\n"
        "\\midrule\n\\midrule\n"
    )
    rows = []
    for i, mesh in enumerate(mesh_sizes):
        rows.append(
            f"{mesh} & {format_sci(df_crbe['rel_l2_error'][i])} &"
            f" {format_sci(df_pinn['rel_l2_error'][i])} &"
            f" {format_sci(df_crbe['max_error'][i])} &"
            f" {format_sci(df_pinn['max_error'][i])} &"
            f" ${df_crbe['train_time'][i]:.2f}$ &"
            f" ${df_pinn['train_time'][i]:.2f}$ \\\\\n"
        )
    tables["convergence_comparison"] = _tabular(
        "Convergence comparison of CR-BE and PINN methods",
        "tab:convergence_comparison", "ccccccc", header, rows,
    )

    # Table 2: convergence rates.
    header = (
        "\\multirow{2}{*}{Method} & \\multicolumn{2}{c}{Convergence Rate} &"
        " \\multicolumn{2}{c}{Goodness of Fit ($R^2$)} \\\\\n"
        "\\cmidrule(lr){2-3} \\cmidrule(lr){4-5}\n"
        "& $L^2$ Error & $L^\\infty$ Error & $L^2$ Error & $L^\\infty$"
        " Error \\\\\n\\midrule\n\\midrule\n"
    )
    rows = [
        f"CR-BE & ${crbe_l2_rate:.4f}$ & ${crbe_linf_rate:.4f}$ &"
        f" ${crbe_l2_r2:.4f}$ & ${crbe_linf_r2:.4f}$ \\\\\n",
        f"PINN & ${pinn_l2_rate:.4f}$ & ${pinn_linf_rate:.4f}$ &"
        f" ${pinn_l2_r2:.4f}$ & ${pinn_linf_r2:.4f}$ \\\\\n",
    ]
    tables["convergence_rates"] = _tabular(
        "Empirical convergence rates for CR-BE and PINN methods",
        "tab:convergence_rates", "ccccc", header, rows,
    )

    # Table 3: computational resources.
    header = (
        "\\multirow{2}{*}{Mesh Size} & \\multicolumn{2}{c}{Memory Usage"
        " (MB)} & \\multicolumn{2}{c}{DOFs / Parameters} \\\\\n"
        "\\cmidrule(lr){2-3} \\cmidrule(lr){4-5}\n"
        "& CR-BE & PINN & CR-BE & PINN \\\\\n\\midrule\n\\midrule\n"
    )
    rows = []
    for i, mesh in enumerate(mesh_sizes):
        dofs = f"${df_crbe['number_of_collocation_points'][i]}$"
        params = (
            f"${df_pinn['n_parameters'][i]}$"
            if "n_parameters" in df_pinn else "$-$"
        )
        if memory_data is not None:
            mem_c = format_sci(memory_data["cr_memory_mb"][i])
            mem_p = format_sci(memory_data["pinn_memory_mb"][i])
        else:
            mem_c = mem_p = "$-$"
        rows.append(f"{mesh} & {mem_c} & {mem_p} & {dofs} & {params} \\\\\n")
    tables["computational_resources"] = _tabular(
        "Computational resource requirements",
        "tab:computational_resources", "ccccc", header, rows,
    )

    # Table 4: efficiency (error x time).
    header = ("Mesh Size & CR-BE Efficiency & PINN Efficiency \\\\\n"
              "\\midrule\n\\midrule\n")
    rows = []
    for i, mesh in enumerate(mesh_sizes):
        eff_c = df_crbe["rel_l2_error"][i] * df_crbe["train_time"][i]
        eff_p = df_pinn["rel_l2_error"][i] * df_pinn["train_time"][i]
        rows.append(f"{mesh} & {format_sci(eff_c)} & {format_sci(eff_p)} \\\\\n")
    tables["efficiency_comparison"] = _tabular(
        "Efficiency comparison ($L^2$ error $\\times$ training time)",
        "tab:efficiency_comparison", "ccc", header, rows,
    )

    # Table 5: summary statistics.
    header = "Metric & CR-BE & PINN \\\\\n\\midrule\n\\midrule\n"
    rows = [
        f"Minimum $L^2$ Error & {format_sci(df_crbe['rel_l2_error'].min())} &"
        f" {format_sci(df_pinn['rel_l2_error'].min())} \\\\\n",
        f"Minimum $L^\\infty$ Error & {format_sci(df_crbe['max_error'].min())}"
        f" & {format_sci(df_pinn['max_error'].min())} \\\\\n",
        f"Maximum Training Time (s) & ${df_crbe['train_time'].max():.2f}$ &"
        f" ${df_pinn['train_time'].max():.2f}$ \\\\\n",
        f"$L^2$ Convergence Rate & {format_sci(crbe_l2_rate)} &"
        f" {format_sci(pinn_l2_rate)} \\\\\n",
        f"$L^\\infty$ Convergence Rate & {format_sci(crbe_linf_rate)} &"
        f" {format_sci(pinn_linf_rate)} \\\\\n",
        f"Error Scaling & $O(n^{{{abs(crbe_l2_rate):.1f}}})$ &"
        f" $O(n^{{{abs(pinn_l2_rate):.1f}}})$ \\\\\n",
    ]
    tables["summary_statistics"] = _tabular(
        "Summary of method performance", "tab:summary_statistics", "lcc",
        header, rows,
    )

    # Table 6: method characteristics at mesh 64. A sweep without a
    # mesh-64 row falls back to its largest mesh and says so in the row
    # labels.
    sizes = list(mesh_sizes)
    if 64 in sizes:
        idx64, ms_label = sizes.index(64), 64
    else:
        idx64 = int(np.argmax(sizes))
        ms_label = sizes[idx64]
    eff_c = (df_crbe["rel_l2_error"][idx64]
             * df_crbe["train_time"][idx64])
    eff_p = (df_pinn["rel_l2_error"][idx64]
             * df_pinn["train_time"][idx64])
    if memory_data is not None:
        mem_row = (
            f"Memory Usage (MB for mesh={ms_label}) &"
            f" ${memory_data['cr_memory_mb'][idx64]:.2f}$ &"
            f" ${memory_data['pinn_memory_mb'][idx64]:.2f}$ \\\\\n"
        )
    else:
        mem_row = (f"Memory Usage (MB for mesh={ms_label}) & $-$ &"
                   " $-$ \\\\\n")
    header = "Characteristic & CR-BE & PINN \\\\\n\\midrule\n\\midrule\n"
    rows = [
        f"Accuracy (Best $L^2$ Error) &"
        f" {format_sci(df_crbe['rel_l2_error'].min())} &"
        f" {format_sci(df_pinn['rel_l2_error'].min())} \\\\\n",
        f"Computational Efficiency (Time for mesh={ms_label}) &"
        f" ${df_crbe['train_time'][idx64]:.2f}$ s &"
        f" ${df_pinn['train_time'][idx64]:.2f}$ s \\\\\n",
        mem_row,
        f"Convergence Rate ($L^2$) & ${crbe_l2_rate:.4f}$ &"
        f" ${pinn_l2_rate:.4f}$ \\\\\n",
        f"Error/Cost Ratio (mesh={ms_label}) & ${eff_c:.4f}$ &"
        f" ${eff_p:.4f}$ \\\\\n",
    ]
    tables["method_characteristics"] = _tabular(
        "Quantitative evidence for method characteristics",
        "tab:method_characteristics", "lcc", header, rows,
    )

    # Table 7: D-sensitivity.
    if sensitivity_data is not None:
        for mesh in [64]:
            header = ("Diffusion Coefficient & CR-BE $L^2$ Error & PINN"
                      " $L^2$ Error \\\\\n\\midrule\n\\midrule\n")
            rows = []
            sel = frames.select(sensitivity_data,
                                sensitivity_data["mesh_size"] == mesh)
            for d, cr, pinn in zip(sel["diffusion_coef"], sel["cr_l2_error"],
                                   sel["pinn_l2_error"]):
                rows.append(
                    f"${d:.4f}$ & {format_sci(cr)} &"
                    f" {format_sci(pinn)} \\\\\n"
                )
            tables["parameter_sensitivity"] = _tabular(
                "Sensitivity to diffusion coefficient variations",
                "tab:sensitivity_diffusion", "ccc", header, rows,
            )

    # Table 8: fixed-runtime comparison.
    if df_fixed_runtime is not None:
        summary = frames.group_mean(
            df_fixed_runtime, ["method", "time_budget"],
            ["rel_l2_error", "max_error", "actual_runtime",
             "epochs_completed", "gpu_memory_usage_MB",
             "cpu_memory_usage_MB"])
        summary["time_utilized"] = np.round(
            (summary["actual_runtime"] * 100) / summary["time_budget"], 0)
        df_c = frames.select(summary, summary["method"] == "CRBE")
        df_p = frames.select(summary, summary["method"] == "PINN")
        header = (
            "\\multirow{2}{*}{Time Budget(s)} & \\multicolumn{2}{c}{Rel"
            " $L^2$ Error} & \\multicolumn{2}{c}{Max Error ($L^\\infty$)} &"
            " \\multicolumn{2}{c}{Time Utilized (\\%)} &"
            " \\multicolumn{2}{c}{Memory Usage (MB)} & Epochs \\\\\n"
            "\\cmidrule(lr){2-3} \\cmidrule(lr){4-5} \\cmidrule(lr){6-7}"
            " \\cmidrule(lr){8-9}\n"
            "& CR-BE & PINN & CR-BE & PINN & CR-BE & PINN & CR-BE & PINN &"
            " (PINN) \\\\\n\\midrule\n"
        )
        rows = []
        # The methods are paired by budget; a budget that only one method
        # ran is dropped.
        p_budgets = list(df_p["time_budget"])
        for i, budget in enumerate(df_c["time_budget"]):
            if budget not in p_budgets:
                continue
            j = p_budgets.index(budget)
            rows.append(
                f"{budget} & {format_sci(df_c['rel_l2_error'][i])} &"
                f" {format_sci(df_p['rel_l2_error'][j])} &"
                f" {format_sci(df_c['max_error'][i])} &"
                f" {format_sci(df_p['max_error'][j])} &"
                f" {df_c['time_utilized'][i]} &"
                f" {df_p['time_utilized'][j]} &"
                f" {format_sci(df_c['cpu_memory_usage_MB'][i])} &"
                f" {format_sci(df_p['gpu_memory_usage_MB'][j])} &"
                f" {round(df_p['epochs_completed'][j])} \\\\\n"
            )
        tables["fixed_runtime"] = _tabular(
            "Performance comparison under fixed runtime budgets",
            "tab:fixed_runtime_comparison", "cccccccccc", header, rows,
        )

    return tables


def main(argv=None):
    parser = argparse.ArgumentParser(description="LaTeX table generation.")
    parser.add_argument("--exp_dir", type=str,
                        default="experimental_results/tables")
    args = parser.parse_args(argv)
    os.makedirs(args.exp_dir, exist_ok=True)

    read = frames.read_csv
    df_crbe = read("experimental_results/crbe/df_crbe_training_results.csv")
    df_pinn = read("experimental_results/pinn/df_pinn_training_results.csv")
    sensitivity = read(
        "experimental_results/sensibility/df_sensitivity_data.csv")
    fixed_runtime = read(
        "experimental_results/fixed_runtime/fixed_runtime_comparison.csv")
    if df_crbe is None or df_pinn is None:
        raise SystemExit(
            "Missing CRBE/PINN result CSVs — run the experiments first.")

    tables = generate_latex_tables(
        df_crbe, df_pinn, memory_data=memory_frame(df_crbe, df_pinn),
        sensitivity_data=sensitivity, df_fixed_runtime=fixed_runtime,
    )
    out = f"{args.exp_dir}/convergence_tables.tex"
    with open(out, "w") as f:
        f.write(render(tables))
    print(f"LaTeX tables generated and saved to {out}")
    return tables


def memory_frame(df_crbe, df_pinn):
    """The resources table's memory columns: the CRBE sweep's CPU memory
    and the PINN sweep's card memory."""
    return {"cr_memory_mb": df_crbe["cpu_memory_usage_MB"],
            "pinn_memory_mb": df_pinn["gpu_memory_usage_MB"]}


def render(tables):
    """The ``convergence_tables.tex`` text: each table after a comment
    line with its name."""
    return "".join(f"% {name}\n{table}\n\n" for name, table in tables.items())


if __name__ == "__main__":
    main()
