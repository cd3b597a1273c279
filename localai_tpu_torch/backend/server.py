"""Backend process entry point: one gRPC server on a localhost port
(counterpart of localai_tpu/backend/server.py), `llm` role only."""
from __future__ import annotations

import os
import signal
import threading
from concurrent import futures

import grpc

from localai_tpu_torch.backend.base import add_backend_servicer


def serve(addr: str = "127.0.0.1:50051", device=None, max_workers: int = 16,
          servicer=None):
    """Start a backend server; returns (grpc.Server, servicer, bound_port).
    `device` (default: the CUDA device) is where LoadModel places the
    model; `servicer`: an already-constructed one to serve instead."""
    from localai_tpu_torch.backend.llm import LLMServicer

    servicer = servicer or LLMServicer(device=device)
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


def serve_blocking(addr: str = "127.0.0.1:50051", device=None,
                   servicer=None) -> int:
    server, servicer, port = serve(addr, device=device, servicer=servicer)
    print(f"backend[llm] serving on port {port}", flush=True)
    stop = threading.Event()

    def _preempt_then_stop():
        # SIGTERM: spill-drain the live slots, so their terminal
        # "preempted" replies (carrying ResumeTokens) flush through the
        # still-open streams, THEN stop. The drain runs off the signal
        # handler's thread: engine.preempt blocks until the freeze is done.
        # LOCALAI_PREEMPT_GRACE (seconds, default 0) lets slots finish first.
        try:
            servicer.preempt(float(
                os.environ.get("LOCALAI_PREEMPT_GRACE", "0") or 0))
        except Exception:
            import traceback

            traceback.print_exc()
        finally:
            stop.set()

    def _sig(signum, frame):
        if signum == signal.SIGTERM:
            threading.Thread(target=_preempt_then_stop, daemon=True).start()
        else:
            stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    stop.wait()
    servicer.shutdown()
    server.stop(grace=5).wait(10)
    return 0
