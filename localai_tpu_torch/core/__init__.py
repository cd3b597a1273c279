"""Process roles of the port (counterpart of localai_tpu/core): the
tensor-parallel worker."""
