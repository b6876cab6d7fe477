#!/usr/bin/env python3
"""Where the port's main path spends device time, on one NVIDIA GPU.

    python3 scripts/profile_torch_main_path.py [--ls nls|2opt | --train] [--out DIR]

Runs a path of ``chip_smoke.py`` with its weights, instances and
configuration once to warm up, then once under ``torch.profiler``: by default
the main path (neural ``evaluate_tsp``, tsp500_selftrained, B=100, N=500,
K=50, A=20, T=10); with ``--ls nls`` the NLS path (tsp_nls500_selftrained on
the first B=16 instances, local search on every ant); with ``--ls 2opt`` the
classic arm with 2-opt on the same 16; with ``--train`` one TSP500-NLS
training step (``chip_smoke.train_configs``: the one-hot start Net, B=20,
N=500, K=50, 30 ants, NLS advantage) after one step of warm-up. Prints one
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


def train_step_runner(chip_smoke):
    """One TSP500-NLS train step per call, on a state that carries over."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train import reinforce as tr

    cfg, net_kwargs, ls = chip_smoke.train_configs()["tsp500_nls"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    state = [tr.init_train_state(Net(**net_kwargs).to(dev), cfg, gen)]
    step = tr.make_tsp_train_step(cfg, local_search=ls)

    def run():
        state[0], _ = step(state[0], gen)

    return run


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--ls", choices=("nls", "2opt"), default=None)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if args.train and args.ls:
        parser.error("--train profiles the training step; it takes no --ls")
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if args.train:
        run = train_step_runner(chip_smoke)
    else:
        net, coords = chip_smoke.main_path_inputs(ROOT, torch.device("cuda"), args.ls)
        if args.ls == "2opt":
            net = None                               # the classic arm
        run = lambda: chip_smoke.drive(net, coords, ls=args.ls)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        # a record_function range (AdamW's step) also shows on the device
        # timeline; it is no kernel and would count its span twice
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.is_user_annotation):
            name = ev.name if len(ev.name) < 120 else ev.name[:117] + "..."
            entry = kernels.setdefault(name, {"ms": 0.0, "count": 0})
            entry["ms"] += ev.time_range.elapsed_us() / 1e3
            entry["count"] += 1
    busy = sum(k["ms"] for k in kernels.values())
    card = chip_smoke.card_line()
    path = "train_nls" if args.train else args.ls or "main"
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / f"{path}_path_trace.json"))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))
    print(json.dumps({"path": path, "card": card, "wall_ms": wall_ms,
                      "device_busy_ms": busy if kernels else "not measured",
                      "device_idle_share": 1 - busy / wall_ms if kernels else "not measured",
                      "kernels": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
