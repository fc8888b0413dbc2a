"""Record writer of the port (leon_tpu/io/bank.py writer counterpart)."""
