"""Reduction of a ``torch.profiler`` trace of the traced stretch to what the
metrics read: the stretch's length, the device's busy time (the union of
every operation's interval on the device), device time per kernel, the
largest device operations and the longest idle gaps by what the host was
doing.

Copied from ``scripts/profile_torch_main_path.py:188-228`` (device events
that are no user annotation, summed by name), with the busy time taken as
the union of intervals inside the stretch, not a sum.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

REQUEST = "acobench.request"       # the harness's range around each request
SPAN_PREFIX = "acobench."          # the harness's ranges around each phase


def _is_device(ev) -> bool:
    """An operation that ran on the device (not a range's annotation)."""
    import torch

    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))


def _is_host(ev) -> bool:
    import torch

    return ev.device_type == torch.autograd.DeviceType.CPU


def _short(name: str) -> str:
    return name if len(name) < 100 else name[:97] + "..."


def kernel_pattern(names: list[str]) -> re.Pattern:
    """Matches a demangled kernel name of any of ``names`` (``void
    (anonymous namespace)::sweep_kernel<...>(...)``, ``head_kernel(...)``)."""
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(^|[\s:]){'(?:' + alt + ')'}[<(]")


def reduce(events, kernels: dict) -> dict:
    """``events`` (``prof.events()``) → the stretch's reduction. ``kernels``
    maps a kernel's name to its file (``profiler_names``)."""
    requests = [ev for ev in events if ev.name == REQUEST and _is_host(ev)]
    if not requests:
        return {}
    lo = min(ev.time_range.start for ev in requests)
    hi = max(ev.time_range.end for ev in requests)
    dev = sorted((max(ev.time_range.start, lo), min(ev.time_range.end, hi), ev.name)
                 for ev in events if _is_device(ev)
                 and ev.time_range.end > lo and ev.time_range.start < hi)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[_short(name)] += e - s
    busy, gaps, cur_s, cur_e = 0.0, [], None, lo
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))
    per_kernel = {}
    for k, spec in kernels.items():
        pat = kernel_pattern(spec["profiler_names"])
        per_kernel[k] = sum(e - s for s, e, name in dev if pat.search(name)) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "requests": len(requests), "kernel_s": per_kernel,
            "device_ops": sorted(([n, t / 1e6] for n, t in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": _label_gaps(events, gaps)}


def _label_gaps(events, gaps) -> list:
    """Idle time summed by what the host was doing when each gap began: the
    innermost phase range of the harness and the innermost host operation
    (``phase/op``); the 10 largest sums."""
    host = sorted(((ev.time_range.start, ev.time_range.end, ev.name) for ev in events
                   if _is_host(ev) and ev.name != REQUEST),
                  key=lambda x: x[0])
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    span_starts = [h[0] for h in spans]
    totals = defaultdict(float)
    for g0, g1 in gaps:
        phase = "between requests"        # the phases follow one another
        i = bisect.bisect_right(span_starts, g0) - 1
        if i >= 0 and spans[i][1] >= g0:
            phase = spans[i][2][len(SPAN_PREFIX):]
        op = "python"
        j = bisect.bisect_right(starts, g0) - 1
        for back in range(j, max(j - 200, -1), -1):
            s, e, name = host[back]
            if e >= g0 and not name.startswith(SPAN_PREFIX):
                op = name
                break
        totals[f"{phase}/{op}"] += g1 - g0
    return sorted(([n, t / 1e6] for n, t in totals.items()), key=lambda x: -x[1])[:10]
