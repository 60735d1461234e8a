"""``python -m airpollution_tpu_torch``: the port's command line (cli.py)."""

from airpollution_tpu_torch.cli import main

main()
