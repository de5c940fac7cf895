"""Run-time guards (counterpart of lbm_tpu/utils)."""
from . import watchdog  # noqa: F401
