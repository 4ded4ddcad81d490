"""Per-phase wall-clock timers and ``torch.profiler`` traces.

Counterpart of ``xrdslam_tpu/engine/profiling.py``: a process-wide
registry accumulates named phase times, which the pipeline writes to
``timings.json`` at the end of a run, and ``torch_trace`` records a span
of work (host and, on the card, CUDA activity) as a Chrome trace, in place
of the reference package's ``jax_trace``.

Usage::

    from xrdslam_tpu_torch.engine.profiling import phase_timer, timing_summary
    with phase_timer("tracking"):
        ...
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_ACC: Dict[str, float] = defaultdict(float)
_CNT: Dict[str, int] = defaultdict(int)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def phase_timer(name: str) -> Iterator[None]:
    """Host wall time of the block, added to phase ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACC[name] += time.perf_counter() - t0
        _CNT[name] += 1


def timing_summary() -> Dict[str, Dict[str, float]]:
    """{phase: {total_s, count, mean_ms}} accumulated since the last reset."""
    return {k: {"total_s": _ACC[k], "count": _CNT[k], "mean_ms": 1e3 * _ACC[k] / max(_CNT[k], 1)}
            for k in sorted(_ACC)}


def reset_timers() -> None:
    _ACC.clear()
    _CNT.clear()


@contextlib.contextmanager
def torch_trace(out_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where CUDA is available) and write it as a Chrome trace,
    ``<out_dir>/trace.json`` (view with Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
