"""Observation and timing I/O (counterparts of lbm_tpu/io)."""
