"""Bring-up of the torch.distributed world and the lockstep follower
protocol that lets ONE engine loop drive a model sharded across processes
(counterpart of localai_tpu/parallel/distributed.py).

PyTorch runs tensor parallelism as SPMD, one process a rank, so the
port's single-host TP is the reference's multi-host protocol: rank 0 runs
the real Engine (admission, sampling bookkeeping, streams) and, before
every device dispatch, broadcasts (op, host args) over a TCP side channel;
follower ranks replay the identical call sequence into their own engine,
which holds their shards of the same model. Host args are bit-identical,
so every rank runs the same kernels and the same collectives in the same
order, and the logits every rank holds are equal: the sampled tokens and
the fused loops' stop decisions agree without another collective.

The side channel is a copy of the reference's: length-framed pickles over
TCP, a connection counted as a follower only after it presents the
sha256 digest of the shared token (LOCALAI_REPLICATE_TOKEN, else the
token given, else "localai"). It carries one message the other way: a
follower whose replay of an op failed reports it (`Follower.report`)
before it exits, and rank 0's next broadcast raises `FollowerFailed`, as
it does when a follower's connection has dropped: a world that lost a
rank's lockstep serves nothing more.

The collectives' backend follows the placement: NCCL when every rank has
a card of its own, gloo when ranks share a card (NCCL refuses two ranks
on one card) or run on the CPU. The process group rendezvous on
127.0.0.1: nothing leaves the host.
"""
from __future__ import annotations

import hashlib
import hmac
import logging
import os
import pickle
import select
import socket
import struct
import threading

from localai_tpu_torch import not_ported

_LEN = struct.Struct(">I")
_LOCAL = ("127.0.0.1", "localhost", "")

log = logging.getLogger("localai_tpu_torch.parallel")


def _token_digest(token: str | None) -> bytes:
    """32-byte handshake proof. LOCALAI_REPLICATE_TOKEN overrides the default
    (the coordinator address) for deployments that want a real shared
    secret."""
    secret = os.environ.get("LOCALAI_REPLICATE_TOKEN") or token or "localai"
    return hashlib.sha256(secret.encode()).digest()


def rank_device(rank: int, device=None):
    """The device of `rank`: the CPU when asked for, else card
    rank % device_count (ranks share cards round-robin). Raises without
    CUDA unless the CPU is asked for."""
    import torch

    from localai_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def collective_backend(num_processes: int, device=None) -> str:
    """"nccl" when every rank has a card of its own, else "gloo" (ranks
    sharing a card, or on the CPU)."""
    import torch

    if rank_device(0, device).type == "cuda" and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> int:
    """torch.distributed.init_process_group from args or the reference's
    LOCALAI_COORDINATOR / LOCALAI_NUM_PROCESSES / LOCALAI_PROCESS_ID
    variables; returns this process's rank (0, doing nothing, when
    unconfigured or with one process). The coordinator's port hosts the
    rendezvous store on 127.0.0.1; a coordinator on another host raises
    (multi-host TP waits for its slice). Prints the backend it chose."""
    import torch
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("LOCALAI_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LOCALAI_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid = os.environ.get("LOCALAI_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes or num_processes <= 1:
        return 0
    if process_id is None:
        raise ValueError("a multi-process world needs this process's id "
                         "(process_id or LOCALAI_PROCESS_ID)")
    host, _, port = coordinator.rpartition(":")
    if host not in _LOCAL:
        raise not_ported(f"a coordinator on another host ({host}): "
                         f"multi-host tensor parallelism", "parallel")
    backend = collective_backend(num_processes, device)
    if backend == "gloo":
        # the loopback interface: the world never leaves this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    else:
        torch.cuda.set_device(rank_device(process_id, device))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=num_processes, rank=process_id)
    print(f"rank {process_id}/{num_processes}: torch.distributed backend "
          f"{backend} on {rank_device(process_id, device)}", flush=True)
    return process_id


def _send_msg(sock: socket.socket, payload: bytes):
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> bytes:
    hdr = b""
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            raise ConnectionError("follower channel closed")
        hdr += chunk
    (n,) = _LEN.unpack(hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("follower channel closed mid-message")
        buf += chunk
    return bytes(buf)


class FollowerFailed(RuntimeError):
    """A follower rank failed an op or dropped its connection."""


class Replicator:
    """Rank-0 side: accepts `num_followers` connections, then broadcast()
    ships each (op, kwargs) to every follower before the local dispatch.

    A connection only counts as a follower after it presents the shared-token
    digest — a stray connection can neither occupy a follower slot nor
    receive the dispatch stream."""

    def __init__(self, port: int, num_followers: int,
                 host: str = "127.0.0.1", accept_timeout: float = 300.0,
                 token: str | None = None):
        self.num_followers = num_followers
        self._expect = _token_digest(token)
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(accept_timeout)
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self._failed: str | None = None

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def wait_for_followers(self):
        while len(self._conns) < self.num_followers:
            conn, peer = self._srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.settimeout(10.0)
                proof = _recv_msg(conn)
                conn.settimeout(None)
            except (ConnectionError, OSError):
                conn.close()
                continue
            if not hmac.compare_digest(proof, self._expect):
                log.warning("replicator: rejected connection from %s "
                            "(bad token)", peer)
                conn.close()
                continue
            self._conns.append(conn)

    def check_followers(self):
        """Raise FollowerFailed when a follower has reported a failed op
        or closed its connection (a follower sends nothing else), then at
        every later call: the world stays failed."""
        if self._failed is None:
            ready, _, _ = select.select(self._conns, [], [], 0)
            for c in ready[:1]:
                i = self._conns.index(c) + 1
                try:
                    c.settimeout(10.0)
                    _, info = pickle.loads(_recv_msg(c))
                    self._failed = (f"follower {i} failed op "
                                    f"{info['op']!r}: {info['error']}")
                except (ConnectionError, OSError, EOFError) as e:
                    self._failed = (f"follower {i} dropped its connection "
                                    f"({e})")
        if self._failed is not None:
            raise FollowerFailed(self._failed)

    def broadcast(self, op: str, kwargs: dict):
        """Ship (op, kwargs) to every follower; raises FollowerFailed when
        one has failed."""
        payload = pickle.dumps((op, kwargs), protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self.check_followers()
            for c in self._conns:
                # sendall under the lock is the ordering guarantee: every
                # follower sees the ops in one global order
                _send_msg(c, payload)

    def close(self):
        """Send `stop` to every follower still connected; close."""
        payload = pickle.dumps(("stop", {}))
        for c in self._conns:
            try:
                _send_msg(c, payload)
            except OSError:
                pass
            c.close()
        self._srv.close()


class Follower:
    """Rank>0 side: connect to rank 0's Replicator and iterate messages."""

    def __init__(self, addr: str, connect_timeout: float = 300.0,
                 token: str | None = None):
        import time

        host, _, port = addr.rpartition(":")
        deadline = time.monotonic() + connect_timeout
        while True:
            # rank 0 may still be loading its shard: retry a refused
            # connection until the timeout
            try:
                self._sock = socket.create_connection(
                    (host or "127.0.0.1", int(port)), timeout=connect_timeout)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_msg(self._sock, _token_digest(token))

    def recv(self) -> tuple[str, dict]:
        return pickle.loads(_recv_msg(self._sock))

    def report(self, op: str, error: BaseException):
        """Tell rank 0 that this rank's replay of `op` failed."""
        try:
            _send_msg(self._sock, pickle.dumps(
                ("failed", {"op": op, "error": f"{type(error).__name__}: "
                                                f"{error}"})))
        except OSError:
            pass

    def close(self):
        self._sock.close()
