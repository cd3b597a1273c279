"""The worker role (counterpart of localai_tpu/core/worker.py): one
process a rank of a tensor-parallel world on this host.

Every rank joins one torch.distributed world (parallel/distributed.py:
gloo when ranks share a card or run on the CPU, NCCL when each has a card
of its own) and loads its shards of the same model (engine/loader.py,
mesh=). Rank 0 runs the serving engine behind the gRPC backend and
broadcasts each device dispatch; the other ranks replay rank 0's
dispatch stream (Engine.follow) so the collectives stay in lockstep.
Rank 0 sends its EngineConfig first (op "engine"), so every follower's
engine is rank 0's, whoever started it: all ranks may run this same
command (different --process-id), or the backend's LoadModel(mesh_model=N)
starts ranks 1..N-1 itself (backend/llm.py).

    python -m localai_tpu_torch.core.worker --model DIR \\
        --coordinator 127.0.0.1:PORT --num-processes N --process-id R \\
        [--replicate-port P] [--dtype D] [--device cuda|cpu] [--addr ...]

Rank r runs on cuda:r % device_count, or on the CPU with --device cpu;
without CUDA and without an explicit cpu it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile

log = logging.getLogger("localai_tpu_torch.worker")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class World:
    """A tensor-parallel world this process leads as rank 0 (the backend's
    LoadModel(mesh_model=N)): ranks 1..N-1 started as processes of this
    worker role on this host, each writing its output to a temporary log
    file of its own, the process group joined, the dispatch replicator
    (`replicator`, its followers still to be awaited) and rank 0's `mesh`.
    `close()` keeps each follower's output (`outputs`) and removes its
    file. The followers load the same kernels' libraries: the build takes
    a file lock (ops/kernels/_build.py)."""

    def __init__(self, model_dir: str, dtype, tp: int, device):
        from localai_tpu_torch.parallel.distributed import (
            Replicator, init_distributed, rank_device,
        )
        from localai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

        coordinator = f"127.0.0.1:{_free_port()}"
        self.replicator = Replicator(0, tp - 1, token=coordinator)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        dev = "cpu" if rank_device(0, device).type == "cpu" else "cuda"
        self.procs, self.logs, self.outputs = [], [], []
        try:
            for r in range(1, tp):
                fd, path = tempfile.mkstemp(prefix=f"localai-rank{r}-",
                                            suffix=".log")
                self.logs.append(path)
                with os.fdopen(fd, "w") as out:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m", "localai_tpu_torch.core.worker",
                         "--model", model_dir, "--dtype", dtype or "",
                         "--coordinator", coordinator,
                         "--num-processes", str(tp), "--process-id", str(r),
                         "--mesh-model", str(tp), "--device", dev,
                         "--replicate-port", str(self.replicator.port)],
                        stdout=out, stderr=subprocess.STDOUT, env=env))
            init_distributed(coordinator, tp, 0, device=device)
            self.mesh = build_mesh(MeshConfig(model=tp),
                                   rank_device(0, device))
        except BaseException:
            self.close()
            raise

    def close(self) -> list:
        """Stop the followers (the replicator's `stop`, or a kill after
        60 s), leave the process group, keep their output in `outputs`
        and remove their log files; returns their exit codes (non-zero for
        a follower that failed an op)."""
        import torch.distributed as dist

        self.replicator.close()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        if dist.is_initialized():
            dist.destroy_process_group()
        for path in self.logs:
            with open(path, errors="replace") as f:
                self.outputs.append(f.read())
            os.unlink(path)
        self.logs = []
        return codes


def engine_fields(ec) -> dict:
    """An EngineConfig's fields as rank 0 sends them to its followers (the
    mesh and the replicator are each rank's own)."""
    return {f.name: getattr(ec, f.name) for f in dataclasses.fields(ec)
            if f.name not in ("mesh", "replicator")}


def follow(model: str, dtype, mesh, chan) -> int:
    """A follower rank's life once the world is up: load this rank's
    shards, take rank 0's EngineConfig, replay its dispatches until
    `stop`. A failed op raises (Engine.follow), so the process exits
    non-zero."""
    from localai_tpu_torch.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.loader import (
        load_config, load_params, load_tokenizer,
    )
    from localai_tpu_torch.ops.kernels import launch_counts

    cfg = load_config(model, dtype=dtype)
    params = load_params(model, cfg, dtype=dtype, device=mesh.device,
                         mesh=mesh)
    tok = load_tokenizer(model)
    op, kw = chan.recv()
    if op != "engine":
        raise RuntimeError(f"follower: expected rank 0's engine config, got "
                           f"{op!r}")
    eng = Engine(cfg, params, tok, EngineConfig(**kw, mesh=mesh),
                 device=mesh.device)
    eng.follow(chan)
    # this rank's kernel launches over its life, for the log
    print(f"rank {mesh.rank} launches " + json.dumps(
        {k: v for k, v in launch_counts().items() if v}), flush=True)
    return 0


def run_worker(args) -> int:
    import torch.distributed as dist

    from localai_tpu_torch.engine.loader import load_config
    from localai_tpu_torch.parallel.distributed import (
        Follower, init_distributed, rank_device,
    )
    from localai_tpu_torch.parallel.mesh import (
        MeshConfig, build_mesh, max_model_axis,
    )

    coordinator = args.coordinator or os.environ.get("LOCALAI_COORDINATOR")
    rank = init_distributed(coordinator, args.num_processes, args.process_id,
                            device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    dtype = args.dtype or None
    cfg = load_config(args.model, dtype=dtype)
    model = args.mesh_model or max_model_axis(cfg, world)
    mesh = build_mesh(MeshConfig(data=args.mesh_data or 1, model=model),
                      rank_device(rank, args.device))
    log.info("rank %d/%d on %s, mesh model=%d", rank, world, mesh.device,
             model)
    try:
        if rank > 0:
            chan = Follower(f"127.0.0.1:{args.replicate_port}",
                            token=coordinator)
            try:
                return follow(args.model, dtype, mesh, chan)
            finally:
                chan.close()
        return _serve_rank0(args, cfg, dtype, mesh, world, coordinator)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve_rank0(args, cfg, dtype, mesh, world, coordinator):
    from localai_tpu_torch.backend.llm import LLMServicer
    from localai_tpu_torch.backend.server import serve_blocking
    from localai_tpu_torch.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.loader import load_params, load_tokenizer
    from localai_tpu_torch.parallel.distributed import Replicator

    params = load_params(args.model, cfg, dtype=dtype, device=mesh.device,
                         mesh=mesh)
    tok = load_tokenizer(args.model)
    rep = (Replicator(args.replicate_port, world - 1, token=coordinator)
           if world > 1 else None)
    context = args.context_size or min(2048, cfg.max_position)
    chunk = min(512, context)
    buckets = tuple(b for b in (64, 256, 512) if b <= chunk) or (chunk,)
    ec = EngineConfig(max_slots=args.parallel, max_context=context,
                      prefill_buckets=buckets, prefill_chunk=chunk,
                      mesh=mesh, replicator=rep)
    eng = Engine(cfg, params, tok, ec, device=mesh.device)
    try:
        if rep is not None:
            log.info("waiting for %d follower(s) on port %d", world - 1,
                     rep.port)
            rep.wait_for_followers()
            rep.broadcast("engine", engine_fields(ec))
        eng.start()
        servicer = LLMServicer(preloaded=(eng, cfg, tok, args.model))
        return serve_blocking(args.addr, servicer=servicer)
    finally:
        eng.stop()
        if rep is not None:
            rep.close()


def parser() -> argparse.ArgumentParser:
    """The reference's `worker` subcommand's flags, plus --device."""
    p = argparse.ArgumentParser(prog="localai_tpu_torch.core.worker")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous host:port (127.0.0.1: rank 0's host)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--model", required=True,
                   help="model directory (all ranks)")
    p.add_argument("--dtype", default=None)
    p.add_argument("--context-size", type=int, default=None)
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    p.add_argument("--replicate-port", type=int, default=39219,
                   help="rank 0's dispatch-broadcast port")
    p.add_argument("--addr", default="127.0.0.1:50051",
                   help="rank 0's gRPC backend bind address")
    p.add_argument("--device", default=None,
                   help="'cpu', or the CUDA device (default; rank r on "
                        "cuda:r % device_count)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    return run_worker(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
