"""Backend process entry point: one gRPC server on a localhost port
(counterpart of localai_tpu/backend/server.py), `llm` role only."""
from __future__ import annotations

import signal
import threading
from concurrent import futures

import grpc

from localai_tpu_torch.backend.base import add_backend_servicer


def serve(addr: str = "127.0.0.1:50051", device=None, max_workers: int = 16):
    """Start a backend server; returns (grpc.Server, servicer, bound_port).
    `device` (default: the CUDA device) is where LoadModel places the
    model."""
    from localai_tpu_torch.backend.llm import LLMServicer

    servicer = LLMServicer(device=device)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", 128 * 1024 * 1024),
                 ("grpc.max_send_message_length", 128 * 1024 * 1024)],
    )
    add_backend_servicer(server, servicer)
    port = server.add_insecure_port(addr)
    if port == 0:
        raise OSError(f"could not bind {addr}")
    server.start()
    return server, servicer, port


def serve_blocking(addr: str = "127.0.0.1:50051", device=None) -> int:
    server, servicer, port = serve(addr, device=device)
    print(f"backend[llm] serving on port {port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    servicer.shutdown()
    server.stop(grace=5).wait(10)
    return 0
