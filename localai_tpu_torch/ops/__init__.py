"""Tensor ops of the port (counterparts of localai_tpu/ops)."""
