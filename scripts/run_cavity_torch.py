#!/usr/bin/env python
"""Lid-driven cavity CLI of the PyTorch/CUDA port (lbm_tpu_torch.run_cavity).

    python scripts/run_cavity_torch.py                 # Ghia 129^2 x 10k on cuda
    python scripts/run_cavity_torch.py --lean
    python scripts/run_cavity_torch.py --multistep 100
    python scripts/run_cavity_torch.py --device cpu --nx 33 --steps 50
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lbm_tpu_torch.run_cavity import main  # noqa: E402

if __name__ == "__main__":
    main()
