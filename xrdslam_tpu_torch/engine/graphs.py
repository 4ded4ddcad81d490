"""Replay a device program as a CUDA graph: the port's counterpart of
``jax.jit`` over the reference package's group programs.

``GraphReplay(generator)(key, fn, inputs)`` runs ``fn(*inputs)`` and
returns its outputs (a tuple of tensors). ``fn`` reads its inputs and the
state it closes over, and writes that state in place.

* On CPU tensors it calls ``fn`` eagerly: the CPU path, and what the tests
  compare against.
* On the card, the first call with a key runs ``fn`` eagerly on a side
  stream, the warm-up that a capture needs (autograd and cuBLAS set up on
  that stream); its result is the call's. Then it captures ``fn`` on the
  same inputs, now copied into static buffers, into a
  ``torch.cuda.CUDAGraph``. Every later call with the key copies its
  inputs into those buffers on the current stream (so the copies come
  after the replay before them), replays the graph there, and returns
  copies of the graph's outputs made on that stream (the next replay
  overwrites the static ones). A capture that fails raises; nothing falls
  back to eager on the card. A capture runs after a garbage collection and
  with the collector off: a collection inside it could destroy an earlier,
  dead graph (a program's closure holds its algorithm in a cycle), which
  CUDA refuses while a stream captures, and the capture would fail.
* The run's generator is registered with every graph, so that each replay
  draws new numbers, the ones an eager call from the same generator state
  would draw. All keys share one memory pool: their graphs never run
  concurrently.
* The kernel wrappers count a launch where they launch. A capture launches
  nothing, so the counts it made are taken back, and each replay adds
  them again: the counters say what ran.

``captures`` (key -> seconds of warm-up and of capture), ``replays``
(key -> count) and ``pool_bytes()`` say what a run spent on graphs.

``PendingFetch`` copies small device tensors to the host without a wait:
a pinned buffer, a copy on the current stream and an event to wait for.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import gaussian_raster, hashgrid_fast, hashgrid_planes, row_gather, scatter

# the wrappers' launch counters, each a dict of name (or N) -> count
COUNTERS = (hashgrid_fast.LAUNCHES, hashgrid_fast.FWD_LAUNCHES_BY_N, hashgrid_planes.LAUNCHES,
            gaussian_raster.LAUNCHES, scatter.LAUNCHES, scatter.LAUNCHES_BY_ROWS, row_gather.LAUNCHES)


def _counts() -> List[Dict]:
    return [dict(c) for c in COUNTERS]


def _restore_counts(saved: List[Dict]) -> List[Dict]:
    """Put the counters back to ``saved``; returns what they had gained."""
    gained = []
    for counter, before in zip(COUNTERS, saved):
        gained.append({k: v - before.get(k, 0) for k, v in counter.items() if v != before.get(k, 0)})
        counter.clear()
        counter.update(before)
    return gained


class _Graph:
    def __init__(self, graph, static_in: List[torch.Tensor], static_out: Tuple[torch.Tensor, ...],
                 launches: List[Dict]) -> None:
        self.graph, self.static_in, self.static_out, self.launches = graph, static_in, static_out, launches


class GraphReplay:
    """CUDA graphs of device programs, one per key (see the module
    docstring)."""

    def __init__(self, generator: Optional[torch.Generator] = None) -> None:
        self.generator = generator
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures: Dict[Hashable, Dict[str, float]] = {}
        self.replays: Dict[Hashable, int] = defaultdict(int)

    def __call__(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if inputs[0].device.type == "cpu":
            return tuple(fn(*inputs))
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, fn, inputs)
        for buf, x in zip(entry.static_in, inputs):
            buf.copy_(x)
        entry.graph.replay()
        for counter, gained in zip(COUNTERS, entry.launches):
            for k, v in gained.items():
                counter[k] = counter.get(k, 0) + v
        self.replays[key] += 1
        return tuple(o.clone() for o in entry.static_out)

    def _capture(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=inputs[0].device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(inputs[0].device)
        static_in = [x.clone() for x in inputs]
        t0 = time.perf_counter()
        # the warm-up, on the stream that captures: the call's own result
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = tuple(fn(*static_in))
        self._stream.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                static_out = tuple(fn(*static_in))
        finally:
            if collecting:
                gc.enable()
            launches = _restore_counts(before)
        current.wait_stream(self._stream)
        self._graphs[key] = _Graph(graph, static_in, static_out, launches)
        self.captures[key] = {"warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1}
        return out

    def pool_bytes(self) -> int:
        """Device memory held by the graphs' shared pool."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))


class PendingFetch:
    """A copy of device tensors to the host, under way: ``wait()`` returns
    them as numpy arrays. On the card the copy goes into pinned memory on
    the current stream behind an event, so that the host waits only for the
    work enqueued before it; CPU tensors are read at once."""

    def __init__(self, *tensors: torch.Tensor) -> None:
        self._event = None
        if tensors[0].device.type == "cpu":
            self._host = [t.detach().clone() for t in tensors]
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]
