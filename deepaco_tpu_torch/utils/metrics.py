"""Observability: the program's spans and counters, a JSONL metrics stream
and a profiler exporter (counterpart of ``deepaco_tpu/utils/metrics.py``).

* :func:`phase`: the program's one span. Tracing is on exactly while a
  ``torch.profiler`` records in the process (an operator's :func:`trace`, a
  benchmark's traced stretch); then each span opens a
  ``torch.profiler.record_function("deepaco.<name>")`` range, so the spans
  lie on the profiler's timeline beside the device's kernels, and the
  tracer keeps its host times, a CUDA event pair when the card is in use,
  its parent and its request or step. Off, a span costs one flag read.
* :func:`count` and :func:`counter_buffer`: counters of the work done in a
  span, added on the host or by a kernel into a device buffer, recorded
  only while tracing is on.
* :func:`report` resolves what was recorded (one synchronise) into totals a
  span name; :func:`reset` clears it.
* :class:`MetricsLogger`: an append-only JSONL event stream (epoch metrics,
  validation).
* :func:`trace`: a ``torch.profiler`` capture of a code region, written into
  a directory in TensorBoard's trace format; the spans' ranges are in it.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Callable, Iterator

import torch
import torch.autograd.profiler as _profiler

# a span of these names that no request or step encloses opens a new id
ROOTS = ("request", "step")
_OFF = contextlib.nullcontext()


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


def tracing() -> bool:
    """Whether a ``torch.profiler`` records in this process: the tracer's
    switch."""
    return _profiler._is_profiler_enabled


class Span:
    """One recorded span: its name, the index of its parent in
    ``Tracer.spans`` (-1 for none), the id of its request or step (None
    outside them), host start and end (``perf_counter_ns``) and, when the
    card was in use, its CUDA events."""

    __slots__ = ("name", "parent", "rid", "t0", "t1", "e0", "e1")

    def __init__(self, name: str, parent: int, rid: int | None):
        self.name, self.parent, self.rid = name, parent, rid
        self.t0 = self.t1 = None
        self.e0 = self.e1 = None


def _covered(lo: float, hi: float, parts: list[tuple[float, float]]) -> float:
    """The length of ``[lo, hi]`` that the union of ``parts`` covers."""
    total, end = 0.0, lo
    for s, e in sorted(parts):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Tracer:
    """The spans and counters recorded while tracing is on, in one thread.
    The module's functions use one process-wide instance, ``TRACER``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter."""
        self.spans: list[Span] = []
        self._open: list[int] = []
        self._rids = 0
        self._counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self._buffers: dict[tuple, torch.Tensor] = {}
        self._report: dict | None = None

    def _here(self) -> str:
        return self.spans[self._open[-1]].name if self._open else ""

    @contextlib.contextmanager
    def span(self, name: str, hook: Callable | None = None) -> Iterator[None]:
        parent = self._open[-1] if self._open else -1
        rid = self.spans[parent].rid if parent >= 0 else None
        if rid is None and name in ROOTS:
            self._rids += 1
            rid = self._rids
        rec = Span(name, parent, rid)
        self.spans.append(rec)
        self._report = None
        with (hook(name) if hook is not None else _OFF), \
                torch.profiler.record_function(f"deepaco.{name}"):
            if torch.cuda.is_initialized():
                rec.e0 = torch.cuda.Event(enable_timing=True)
                rec.e1 = torch.cuda.Event(enable_timing=True)
                rec.e0.record()
            self._open.append(len(self.spans) - 1)
            rec.t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                rec.t1 = time.perf_counter_ns()
                self._open.pop()
                if rec.e1 is not None:
                    rec.e1.record()

    def count(self, group: str, **values: float) -> None:
        """Add ``values`` to the counters ``<group>.<key>`` of the innermost
        open span."""
        counts = self._counts[self._here()]
        for key, v in values.items():
            counts[f"{group}.{key}"] += v
        self._report = None

    def counter_buffer(self, group: str, fields: tuple[str, ...],
                       device: torch.device) -> torch.Tensor:
        """A zeroed int64 device buffer of ``len(fields)`` counters that a
        kernel adds into, kept for the innermost open span (one a span name,
        group and device) and read once, by :meth:`report`."""
        key = (self._here(), group, fields, torch.device(device))
        if key not in self._buffers:
            self._buffers[key] = torch.zeros(len(fields), dtype=torch.int64, device=device)
        self._report = None
        return self._buffers[key]

    def report(self) -> dict[str, dict]:
        """Totals a span name over the closed spans: ``count``, ``host_ms``
        and ``self_host_ms``, ``device_ms`` and ``self_device_ms`` (from the
        events; None where no span of the name ran on the card), and
        ``counters``. A span's self time is its own less the part of it that
        its children cover. Waits for the card once; the same result until
        something more is recorded."""
        if self._report is not None:
            return self._report
        done = [i for i, s in enumerate(self.spans) if s.t1 is not None]
        if self._buffers or any(self.spans[i].e1 is not None for i in done):
            torch.cuda.synchronize()
        anchor = next((self.spans[i].e0 for i in done if self.spans[i].e0 is not None), None)
        host, dev = {}, {}
        for i in done:
            s = self.spans[i]
            host[i] = (s.t0 / 1e6, s.t1 / 1e6)
            if s.e0 is not None:
                dev[i] = (anchor.elapsed_time(s.e0), anchor.elapsed_time(s.e1))
        children = defaultdict(list)
        for i in done:
            if self.spans[i].parent >= 0:
                children[self.spans[i].parent].append(i)
        out: dict[str, dict] = {}

        def totals(name: str) -> dict:
            return out.setdefault(name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                         "device_ms": None, "self_device_ms": None,
                                         "counters": {}})

        for i in done:
            tot = totals(self.spans[i].name)
            tot["count"] += 1
            lo, hi = host[i]
            tot["host_ms"] += hi - lo
            tot["self_host_ms"] += hi - lo - _covered(lo, hi, [host[c] for c in children[i]])
            if i in dev:
                lo, hi = dev[i]
                inner = _covered(lo, hi, [dev[c] for c in children[i] if c in dev])
                tot["device_ms"] = (tot["device_ms"] or 0.0) + hi - lo
                tot["self_device_ms"] = (tot["self_device_ms"] or 0.0) + hi - lo - inner
        for name, counts in self._counts.items():
            totals(name)["counters"].update(counts)
        for (name, group, fields, _), buf in self._buffers.items():
            counters = totals(name)["counters"]
            for field, v in zip(fields, buf.tolist()):
                counters[f"{group}.{field}"] = counters.get(f"{group}.{field}", 0) + v
        self._report = out
        return out


TRACER = Tracer()


def phase(name: str, hook: Callable | None = None):
    """The program's span ``name``, a context manager. ``hook(name)``, a
    caller's context manager (the private ``_ops.timer``), is entered
    around it either way. With tracing on (:func:`tracing`) the span is
    recorded and carries a profiler range ``deepaco.<name>``."""
    if not _profiler._is_profiler_enabled:
        return _OFF if hook is None else hook(name)
    return TRACER.span(name, hook)


def count(group: str, **values: float) -> None:
    """Add host counts to the innermost open span's counters
    ``<group>.<key>`` while tracing is on; else nothing."""
    if _profiler._is_profiler_enabled:
        TRACER.count(group, **values)


def counter_buffer(group: str, fields: tuple[str, ...],
                   device: torch.device) -> torch.Tensor | None:
    """While tracing is on, the innermost open span's int64 device buffer
    for ``fields`` (:meth:`Tracer.counter_buffer`); else None, which tells a
    kernel to count nothing."""
    if not _profiler._is_profiler_enabled:
        return None
    return TRACER.counter_buffer(group, fields, device)


def report() -> dict[str, dict]:
    """:meth:`Tracer.report` of the process's tracer."""
    return TRACER.report()


def reset() -> None:
    """Forget every recorded span and counter."""
    TRACER.reset()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the region (host, and the card when there is one) into
    ``logdir`` as a TensorBoard trace file; tracing is on inside it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
