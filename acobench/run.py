"""One run of one cell:

    python -m acobench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (found by the names in ``BENCHMARK.json``), sets the
program up (the kernel library is built once into the checkout's
``build/kernels/`` and loaded from there after), warms up the cell's own
shapes, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines on standard error). Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits with 2; if
JAX or the JAX package got loaded, with 3.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

IMPORTED_AT = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "deepaco_tpu")


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (from
    ``/proc/self/stat``; the harness's import time where that is not
    readable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 600.0:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return IMPORTED_AT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def measure(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", started: float | None = None) -> dict:
    """Set up, measure, check: the result's fields (without the device's
    name). ``device="cpu"`` serves the tests, which skip the look for a
    card."""
    import torch

    kind = importlib.import_module(f"acobench.kinds.{spec['workload']['kind']}")
    cell = kind.Cell(spec, seed, device)
    cell.setup(trace)
    window = cell.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    started = process_start() if started is None else started
    ctx = cell.context(window, window[0] - started)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        from acobench.spec import reader

        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cell.release()
    failed, numbers = cell.check()
    limits = spec["workload"]["check"]["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in sorted(numbers.items())}
    for k, lim in limits.items():
        checks.setdefault(k, {"value": None, "limit": lim})
    correct = failed == 0 and all(c["value"] is not None and c["limit"] is not None
                                  and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": len(cell.records), "failed": failed,
           "metrics": metrics, "device": {"memory_peak_bytes": int(peak)}}
    if trace:
        prof = ctx.get("profile", {})
        out["device"].update(busy_s=prof.get("busy_s", 0.0), window_s=prof.get("window_s", 0.0))
        out["breakdown"] = {"device_ops": prof.get("device_ops", []),
                            "idle_gaps": prof.get("idle_gaps", [])}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m acobench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = process_start()
    from acobench.spec import cell_spec

    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"acobench: {spec['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = measure(spec, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"acobench: loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": spec["chips"], **out["device"]}
    out["card"] = card_line()
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
