#!/usr/bin/env python
"""Plasma CLI of the PyTorch/CUDA port (lbm_tpu_torch.run_plasma).

    python scripts/run_plasma_torch.py                 # golden 200x200/200 on cuda
    python scripts/run_plasma_torch.py --poisson SOR --bc bounceback
    python scripts/run_plasma_torch.py --device cpu --nx 64 --ny 64 --steps 6
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lbm_tpu_torch.run_plasma import main  # noqa: E402

if __name__ == "__main__":
    main()
