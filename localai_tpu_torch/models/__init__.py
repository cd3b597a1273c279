"""Model definitions of the port (counterparts of localai_tpu/models)."""
