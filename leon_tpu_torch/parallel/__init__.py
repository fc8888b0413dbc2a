"""Multi-device pieces of the port (counterpart of leon_tpu/parallel)."""
