"""Observability: a JSONL metrics stream and profiler hooks (counterpart of
``deepaco_tpu/utils/metrics.py``).

* :class:`MetricsLogger`: an append-only JSONL event stream (epoch metrics,
  validation, phase durations) with wall-clock offsets;
* :func:`phase`: times a named phase and marks it as a
  ``torch.profiler.record_function`` range, so that profiles show the
  heuristic, rollout, backward and optimizer spans;
* :func:`trace`: a ``torch.profiler`` capture of a code region, written into
  a directory in TensorBoard's trace format.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

import torch


class MetricsLogger:
    """Append-only JSONL metrics stream; one event per line, also kept in
    ``events``."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = None
        self.events: list[dict] = []
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 4), **fields}
        self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def phase(name: str, logger: MetricsLogger | None = None,
          sync: bool = False) -> Iterator[None]:
    """Time a named phase and mark it in profiles. ``sync=True`` waits for
    the card's queued work before and after (once CUDA is in use), so the
    span holds the device time, at the cost of the host running ahead."""
    wait = sync and torch.cuda.is_initialized()
    if wait:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if wait:
        torch.cuda.synchronize()
    if logger is not None:
        logger.log("phase", name=name,
                   duration_s=round(time.perf_counter() - t0, 6))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the region (host, and the card when there is one) into
    ``logdir`` as a TensorBoard trace file."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
