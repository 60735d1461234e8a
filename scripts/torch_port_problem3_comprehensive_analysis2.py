#!/usr/bin/env python3
"""Problem 3's physics diagnostics with the triangle quadrature on the
PyTorch + CUDA port (the JAX package's
scripts/problem3_comprehensive_analysis2.py): the second reference
variant, which pins ``--quadrature triangle`` on
scripts/torch_port_problem3_comprehensive_analysis.py (area / 3 per
incident triangle; that script's default too). Runs on the card, or on
the CPU under ``APT_PLATFORM=cpu`` or with ``device="cpu"``:

    python3 -m scripts.torch_port_problem3_comprehensive_analysis2 \\
        [--epochs N] [--m_size M]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.torch_port_problem3_comprehensive_analysis import (  # noqa: E402
    main as _main,
)


def main(argv=None, device=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--quadrature" not in argv:
        argv += ["--quadrature", "triangle"]
    return _main(argv, device=device)


if __name__ == "__main__":
    main()
