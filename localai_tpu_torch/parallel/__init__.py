"""Tensor parallelism on the `model` axis over torch.distributed
(counterpart of localai_tpu/parallel): mesh.py places one process's rank,
distributed.py brings the process group up and carries rank 0's dispatch
stream to the follower ranks."""
