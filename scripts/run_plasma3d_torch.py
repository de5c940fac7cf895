#!/usr/bin/env python
"""3-D plasma column CLI of the PyTorch/CUDA port (lbm_tpu_torch.run_plasma3d).

    python scripts/run_plasma3d_torch.py               # 64^2x64, 50 steps on cuda
    python scripts/run_plasma3d_torch.py --n 128 --nz 128 --storage bf16
    python scripts/run_plasma3d_torch.py --device cpu --n 16 --nz 8 --steps 3
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lbm_tpu_torch.run_plasma3d import main  # noqa: E402

if __name__ == "__main__":
    main()
