"""CUDA-graph runner of the fused decode loops' segments. The JAX package
has no counterpart: there `jax.jit` compiles the whole loop into one XLA
program, where the port launches every op of a step from Python.

The engine's fused loops (models/llama.drive_loop) run in segments of up
to _DONE_CHECK_EVERY iterations over fixed tensors (models/llama.LoopState,
loop_segment). On the card, `GraphRunner.run` replays one
`torch.cuda.CUDAGraph` per key — (path, segment length, sampling width,
grammar: whether the segment gathers grammar masks from the device
tables and steps the slots' automata):
the same kernels on the same addresses, one launch from the host for the
whole segment. A key's first use (or `prepare`) warms the segment up on a
side stream, as torch.cuda.graph asks (the warm-up builds the kernels'
libraries and fills their lru caches — _build.load, _sm_count,
decode_split — and cuBLAS's workspace), with every slot frozen so that it
changes no state, then captures it. All of a runner's graphs share one
memory pool: they run one at a time, on one stream.

A failed capture or replay raises; nothing falls back to running the
segment eagerly on the card, and nothing turns the graphs off. On the CPU
`run` calls the segment directly.

Launch counts (ops/kernels.launch_counts) stay counts of kernel launches on
the card: the warm-up's launches run and count; the capture launches
nothing, so the runner takes back what the wrappers counted during it;
each replay adds the capture's counts. The runner's own counters, per
path: captures, replays, steps replayed and warm-up steps (`counters()`);
and the replays of each key (`key_replays()`).

`EagerSegments` runs every segment eagerly, on any device, and counts
what it ran (eager_segments, eager_steps a path). It is the engine's
runner on a tensor-parallel mesh — a stated mode, not a fallback: a
segment's collectives (an all-reduce after wo and w_down each layer, the
vocab-parallel head's all-gather) run through gloo when ranks share a
card, which stages them through the host and cannot be captured; graphs
under NCCL capture wait for a later slice. Checks also set it on an
engine to hold the graphs against (tests/test_torch_graphs.py,
chip_smoke.py).
"""
from __future__ import annotations

import contextlib
import functools
import gc

import torch

from localai_tpu_torch.ops.kernels import add_launch_counts, launch_counts

COUNTERS = ("captures", "replays", "steps_replayed", "warmup_steps")


@functools.lru_cache(maxsize=None)
def _warm_stream(device) -> torch.cuda.Stream:
    """The warm-up stream of `device`, one for the process: PyTorch gives
    every stream that runs a cuBLAS call a workspace of its own, kept until
    the process ends."""
    return torch.cuda.Stream(device)


class GraphRunner:
    """The CUDA graphs of one engine's loop segments, by key (path,
    segment length, sampling width, grammar); `path` names the fused loop
    ("dense", "paged" or "rloop") for the counters."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self._graphs: dict = {}
        self._pool = None
        self._counts: dict = {}
        self._key_replays: dict = {}

    def counters(self) -> dict:
        """{path: {captures, replays, steps_replayed, warmup_steps}}."""
        return {p: dict(c) for p, c in self._counts.items()}

    def key_replays(self) -> dict:
        """{key: replays of its graph}."""
        return dict(self._key_replays)

    def _count(self, path) -> dict:
        return self._counts.setdefault(path, dict.fromkeys(COUNTERS, 0))

    def prepare(self, key, steps: int, segment, freeze, addresses=()):
        """Capture key's graph if it has none: `segment()` runs `steps`
        loop iterations over fixed tensors, at `addresses` (their
        data_ptrs); `freeze()` is a context in which it changes no state
        (the warm-up's). Returns (replay, launches per replay,
        addresses)."""
        entry = self._graphs.get(key)
        if entry is None:
            c = self._count(key[0])
            self._warm_up(segment, freeze)
            c["warmup_steps"] += steps
            before = launch_counts()
            try:
                replay = self._capture(segment)
            finally:
                counted = {k: v - before[k] for k, v in
                           launch_counts().items() if v != before[k]}
                add_launch_counts({k: -v for k, v in counted.items()})
            entry = self._graphs[key] = (replay, counted, tuple(addresses))
            c["captures"] += 1
        return entry

    def run(self, key, steps: int, segment, freeze, addresses=()):
        """Run `segment` once: on the CPU directly; on the card as the
        replay of key's graph (captured at its first use). Raises if the
        tensors are not at the addresses the graph was captured over."""
        if not self.graphed:
            segment()
            return
        replay, counted, captured = self.prepare(key, steps, segment, freeze,
                                                 addresses)
        if tuple(addresses) != captured:
            raise RuntimeError(f"CUDA graph {key}: its tensors moved since "
                               f"the capture; a replay would read stale "
                               f"addresses")
        replay()
        add_launch_counts(counted)
        self._key_replays[key] = self._key_replays.get(key, 0) + 1
        c = self._count(key[0])
        c["replays"] += 1
        c["steps_replayed"] += steps

    def _warm_up(self, segment, freeze):
        cur = torch.cuda.current_stream(self.device)
        side = _warm_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), freeze():
            segment()
        cur.wait_stream(side)

    def _capture(self, segment):
        """The graph of one call of `segment` (captured, not run), as its
        replay callable. Python's cyclic garbage collector is off during
        the capture: an engine dropped earlier holds its graphs in
        reference cycles, and a collection inside the capture would
        destroy them there, which CUDA refuses while a stream captures
        and which ends the capture (cudaErrorStreamCaptureInvalidated)."""
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with gc_paused(), torch.cuda.graph(graph, pool=self._pool):
            segment()
        return graph.replay


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic garbage collector off for the block (a CUDA graph
    capture: see GraphRunner._capture), back as it was after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


EAGER_COUNTERS = ("eager_segments", "eager_steps")


class EagerSegments(GraphRunner):
    """A runner that calls each segment directly, on the card too, and
    counts the segments and steps it ran a path (no graph): the engine's
    runner on a mesh, and the checks' stand-in for the graphs."""

    def __init__(self, device):
        super().__init__(device)
        self.graphed = False

    def run(self, key, steps: int, segment, freeze, addresses=()):
        segment()
        c = self._counts.setdefault(key[0], dict.fromkeys(EAGER_COUNTERS, 0))
        c["eager_segments"] += 1
        c["eager_steps"] += steps
