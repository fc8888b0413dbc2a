"""Block stream codec of the port (leon_tpu/codecs/blocks.py counterpart)."""
