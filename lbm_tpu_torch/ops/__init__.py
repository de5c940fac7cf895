"""Physics operators in eager torch (counterparts of lbm_tpu/ops)."""
