"""Profiling hooks: torch.profiler trace capture and annotated regions.

Port of the JAX package's `utils/profiling.py`: `trace` writes a Chrome
trace (open it in Perfetto or chrome://tracing) of the enclosed region,
`annotate` names a sub-region on its timeline, and `device_memory_profile`
snapshots the CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the enclosed region (host, and the card when CUDA is
    available) and write its Chrome trace into `log_dir`. Yields the
    profiler, whose `key_averages()` sum the region by operator."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a trace (shows up on the timeline)."""
    with record_function(name):
        yield


def device_memory_profile(path: Optional[str] = None) -> bytes:
    """A snapshot of the CUDA caching allocator (`torch.cuda.memory.
    _snapshot()`: its segments and blocks, and allocation stacks where
    `torch.cuda.memory._record_memory_history` was on), pickled to bytes
    and written to `path` if given. This is PyTorch's snapshot format
    (`torch.cuda.memory._viz` renders it), not the JAX package's pprof."""
    snap = pickle.dumps(torch.cuda.memory._snapshot())
    if path:
        with open(path, "wb") as f:
            f.write(snap)
    return snap
