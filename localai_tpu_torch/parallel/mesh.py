"""The port's mesh (counterpart of localai_tpu/parallel/mesh.py).

The reference builds one `jax.sharding.Mesh` over ('data', 'model') and
lets XLA place shards and insert collectives. PyTorch runs tensor
parallelism as SPMD instead: one process per rank, each holding its own
shard of every weight and of the KV cache, with the collectives written
out in the model code. So a `Mesh` here is one process's place in the
mesh: its rank on the `model` axis, the axis size, the process group and
the device. Megatron-style TP (models/llama.shard_params): q/k/v/gate/up
column-parallel, wo/down row-parallel with one all-reduce after each,
the untied lm_head vocab-parallel with one all-gather, the KV cache on
the rank's KV heads.

Only the `model` axis is served. `data` (replicas), `seq` (ring
attention) and `pipe` (pipeline stages) raise, naming their slice.

The model code reads the mesh its params were sharded on (`Llama.mesh`);
there is no ambient mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from localai_tpu_torch import not_ported


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape knobs, the reference's fields. data x model x seq x pipe
    is the number of processes; only `model` may exceed 1 here."""
    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    def __post_init__(self):
        if self.model < 1:
            raise ValueError(f"mesh model axis must be >= 1, got "
                             f"{self.model}")
        for name, what in (("data", "the data axis (data-parallel "
                                    "replicas)"),
                           ("seq", "the seq axis (ring attention)"),
                           ("pipe", "the pipe axis (pipeline stages)")):
            if getattr(self, name) != 1:
                raise not_ported(what, "parallel")


@dataclasses.dataclass(eq=False)
class Mesh:
    """One process's place in a ('data', 'model') mesh: `rank` on the model
    axis of size `model`, the torch.distributed process group its
    collectives run on (None for a one-rank mesh, or for a check that runs
    one shard's kernels without collectives), and the device its shards
    live on."""
    rank: int
    model: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": 1, "model": self.model}

    def local(self, n: int, what: str = "dimension") -> int:
        """This rank's share of a dimension of `n` split on the model
        axis; raises when the axis does not divide it."""
        if n % self.model:
            raise ValueError(f"{what} {n} does not divide the model axis "
                             f"({self.model})")
        return n // self.model

    def span(self, n: int, what: str = "dimension") -> slice:
        """This rank's slice of a dimension of `n` split on the model
        axis (contiguous: rank r holds [r*n/tp, (r+1)*n/tp))."""
        k = self.local(n, what)
        return slice(self.rank * k, (self.rank + 1) * k)

    def _group(self):
        if self.group is None:
            raise RuntimeError(
                f"mesh rank {self.rank} of {self.model} has no process "
                f"group: its collectives cannot run")
        return self.group

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the model axis, in place, in x's dtype (what the
        reference's psum after a row-parallel product does); every rank
        gets the same sum."""
        if self.model == 1:
            return x
        import torch.distributed as dist

        dist.all_reduce(x, group=self._group())
        return x

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim` in rank order (the
        vocab-parallel head's logits)."""
        if self.model == 1:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.model)]
        dist.all_gather(parts, x, group=self._group())
        return torch.cat(parts, dim=dim)


def build_mesh(cfg: MeshConfig | None = None, device=None) -> Mesh:
    """This process's Mesh. With a model axis above 1, torch.distributed
    must be up (parallel/distributed.init_distributed) with one process a
    rank: the axis is the world. Default (no cfg): every process of the
    world on the model axis."""
    import torch.distributed as dist

    from localai_tpu_torch.device import resolve_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = cfg or MeshConfig(model=world)
    device = resolve_device(device)
    if cfg.model == 1:
        return Mesh(rank=0, model=1, device=device)
    if world != cfg.model:
        raise ValueError(f"mesh model axis {cfg.model} != {world} "
                         f"processes in the torch.distributed world")
    return Mesh(rank=dist.get_rank(), model=cfg.model, device=device,
                group=dist.group.WORLD)


def mesh_shape(mesh: Mesh | None) -> dict[str, int] | None:
    """Mesh axes as a plain {'data': d, 'model': m} dict (None without a
    mesh)."""
    return None if mesh is None else dict(mesh.shape)


def max_model_axis(cfg, n_devices: int) -> int:
    """Largest divisor of n_devices usable as the TP ('model') axis: it must
    divide every dimension the shards split (models/llama.shard_params and
    the KV cache's heads). A copy of the reference's
    models/llama.max_model_axis."""
    dims = [
        cfg.num_heads * cfg.head_dim,
        cfg.num_kv_heads * cfg.head_dim,
        cfg.intermediate_size,
        cfg.num_kv_heads,  # kv cache shards the head axis
    ]
    if cfg.num_experts:
        dims.append(cfg.num_experts)  # expert parallelism
    if not cfg.tie_embeddings:
        dims.append(cfg.vocab_size)  # vocab-parallel lm_head
    for d in range(n_devices, 0, -1):
        if n_devices % d == 0 and all(dim % d == 0 for dim in dims):
            return d
    return 1

