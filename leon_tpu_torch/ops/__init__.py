"""Device operators of the port (counterparts of leon_tpu/ops)."""
