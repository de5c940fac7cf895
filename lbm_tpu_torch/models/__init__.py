"""Simulation models (counterparts of lbm_tpu/models)."""
