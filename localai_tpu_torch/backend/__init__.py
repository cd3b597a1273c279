"""gRPC backend process of the port (counterpart of localai_tpu/backend):
the `llm` role over the same proto contract, so the reference's control
plane can drive either package's backend."""
