"""The paper's experiment drivers on the port: the CRBE mesh sweep, the
PINN sweep, the D-sensitivity sweep, the fixed-runtime comparison and the
hyperparameter search, each a module with ``main(argv)`` that takes the
JAX drivers' flags, writes their CSVs under ``experimental_results/`` and
returns its rows; ``python -m airpollution_tpu_torch.experiments`` runs the
whole pipeline. They run on the CUDA card, or on the CPU under
``APT_PLATFORM=cpu`` (or ``main(argv, device="cpu")``)."""
