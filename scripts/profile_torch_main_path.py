#!/usr/bin/env python3
"""Where the port's main path spends device time, on one NVIDIA GPU.

    python3 scripts/profile_torch_main_path.py [--out DIR]

Runs the main path of ``chip_smoke.py`` (neural ``evaluate_tsp`` with its
weights, instances and configuration: tsp500_selftrained, B=100, N=500, K=50,
A=20, T=10) once to warm up, then once under ``torch.profiler``, and prints one
JSON line: device time per CUDA kernel name, the profiled wall time, the
device's busy and idle share of that window, and the card's name and power
limit. ``--out`` also writes the Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    net, coords = chip_smoke.main_path_inputs(ROOT, torch.device("cuda"))
    run = lambda: chip_smoke.drive(net, coords)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name if len(ev.name) < 120 else ev.name[:117] + "..."
            entry = kernels.setdefault(name, {"ms": 0.0, "count": 0})
            entry["ms"] += ev.time_range.elapsed_us() / 1e3
            entry["count"] += 1
    busy = sum(k["ms"] for k in kernels.values())
    card = chip_smoke.card_line()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / "main_path_trace.json"))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))
    print(json.dumps({"card": card, "wall_ms": wall_ms,
                      "device_busy_ms": busy if kernels else "not measured",
                      "device_idle_share": 1 - busy / wall_ms if kernels else "not measured",
                      "kernels": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
