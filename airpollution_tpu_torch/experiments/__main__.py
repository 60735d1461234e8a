"""The paper's pipeline on the port: ``python -m
airpollution_tpu_torch.experiments``.

The JAX package's ``run_experiments.py``: every driver at its smoke-test
settings (one epoch, the testing budget) as a subprocess, then the
figures and the LaTeX tables from the CSVs under
``experimental_results/``. Exits 1 when a stage fails, naming it.
"""

from __future__ import annotations

import subprocess
import sys

EPOCHS = 1
STAGES = [
    ("Running PINN experiments...",
     ["airpollution_tpu_torch.experiments.pinn_experiments", "--width=4",
      f"--epochs={EPOCHS}", "--activation=tanh"]),
    ("Running CRBE experiments...",
     ["airpollution_tpu_torch.experiments.crbe_experiments"]),
    ("Running sensitivity analysis...",
     ["airpollution_tpu_torch.experiments.sensitivity_analysis",
      "--width=4", f"--epochs={EPOCHS}", "--activation=tanh"]),
    ("Running fixed runtime experiments...",
     ["airpollution_tpu_torch.experiments.fixed_runtime_experiments",
      "--run_for_testing=True"]),
    ("Generating visualizations...",
     ["airpollution_tpu_torch.reporting.data_visualization"]),
    ("Generating LaTeX tables...",
     ["airpollution_tpu_torch.reporting.table_generator"]),
]


def main(stages=STAGES) -> int:
    failures = []
    for label, args in stages:
        print(label, flush=True)
        proc = subprocess.run([sys.executable, "-m", *args])
        if proc.returncode != 0:
            failures.append((args[0], proc.returncode))
    if failures:
        print("\nFAILED stages:", failures)
        return 1
    print("\nAll experiments completed!")
    print("Results saved in experimental_results/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
