#!/usr/bin/env python3
"""Where the port's main path spends device time, on one NVIDIA GPU.

    python3 scripts/profile_torch_main_path.py [--ls nls|2opt | --train [--family F] | --family F | --sparse] [--out DIR]

(F: cvrp, op, pctsp, smtwtp, sop, bpp, mkp, mkp_items or rcpsp; without
--train also cvrp_nls)

Runs a path of ``chip_smoke.py`` with its weights, instances and
configuration once to warm up, then once under ``torch.profiler``: by default
the main path (neural ``evaluate_tsp``, tsp500_selftrained, B=100, N=500,
K=50, A=20, T=10); with ``--ls nls`` the NLS path (tsp_nls500_selftrained on
the first B=16 instances, local search on every ant); with ``--ls 2opt`` the
classic arm with 2-opt on the same 16; with ``--train`` one TSP500-NLS
training step (``chip_smoke.train_configs``: the one-hot start Net, B=20,
N=500, K=50, 30 ants, NLS advantage) after one step of warm-up; with
``--train --family F`` one training step of that family at its envelope
(``chip_smoke.family_train_config``: CVRP500 with 50 ants, the 12-layer
Net on the dense graph, K = N = 501; OP300 with 20 ants, K = 30; PCTSP500
with 20 ants and SMTWTP500 with 50, K = N = 501; SOP100 with 50 ants on
its masked graph, K = N = 100; BPP120 with 120 ants, K = N = 121; MKP300
with 50 ants, K = N = 300; MKP-items 500 with 50 ants, the transformer;
batch 1, through ``make_family_train_step``, the batch drawn as
``train_family`` draws it; RCPSP j120 through ``make_rcpsp_train_step``,
20 ants, the fresh 12-layer Net, each step on the next instance of the
train split of the seeded archive below) after one step of warm-up; with
``--family F`` alone that family's path
(``evaluate_family``, its largest checkpoint on its golden set at that
scale: CVRP500, OP300, PCTSP500, SMTWTP500, SOP100, BPP120, MKP300,
MKP-items 500; A=20, T=10; ``rcpsp``: ``evaluate_rcpsp``, the CLI's
``test rcpsp -n 120`` kernel arm, on the 100 test instances of
``chip_smoke.write_psplib_archive``'s seeded j120 archive, written under
``build/`` and read back, with ``rcpsp120_selftrained``, A=20, T=10); with
``--family cvrp_nls`` the CVRP-NLS path on
one instance (``test cvrp -n 500 --local-search swapstar --limit 1``,
``cvrp_nls500_selftrained``, A=20, T=1 and 10, the native engine on the
host); with
``--sparse`` the kernel arm of the sparse path (``test tsp --sparse -n
2000``: tsp500_selftrained, the CLI's 30 fixed-seed instances, k=200,
A=20, T=10). Prints one
JSON line: device time and launches per CUDA kernel name, their sums, the
profiled wall time, the
wall of three runs without the profiler (which adds host time to every
launch), the device's busy and idle share of the profiled window, the
card's name and power limit, and the heuristic kernels' split (K1:
``knn_elin0_kernel``, ``node_pass_kernel``, ``edge_pass_kernel``,
``head_kernel``; K9: ``elin0_kernel`` and the same layer passes) with its
sum. ``--out`` also writes the Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the kernels of K1 (csrc/dense_heuristic.cu) and K9 (csrc/embnet_layers.cu)
HEURISTIC_KERNELS = ("knn_elin0_kernel", "elin0_kernel", "node_pass_kernel",
                     "edge_pass_kernel", "head_kernel")


def rcpsp_inputs(chip_smoke, dev):
    """Phase 17's seeded j120 archive, written under ``build/`` and read
    back: its test and train splits."""
    import shutil
    import tempfile

    from deepaco_tpu_torch.core.rcpsp import load_psplib

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        archive, subset = str(chip_smoke.write_psplib_archive(tmp)), f"j{chip_smoke.RCPSP_N}rcp"
        return (load_psplib(archive, subset, device=dev),
                load_psplib(archive, subset, split="train", device=dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rcpsp_step_runner(chip_smoke):
    """One RCPSP j120 train step per call, on a state that carries over, each
    on the next train instance."""
    import torch

    from deepaco_tpu_torch.aco.problems.rcpsp import RCPSPConfig
    from deepaco_tpu_torch.core.rcpsp import stack_rcpsp
    from deepaco_tpu_torch.eval.rcpsp import rcpsp_net
    from deepaco_tpu_torch.train import special

    dev = torch.device("cuda")
    _, train = rcpsp_inputs(chip_smoke, dev)
    t_max = max(d.t_max for d in train)
    batches = [stack_rcpsp([d], t_max) for d in train]
    cfg = special.rcpsp_config(train[0].n, n_ants=chip_smoke.A, lr=3e-4)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    state = [special.init_train_state(rcpsp_net().to(dev), cfg, gen), 0]
    step = special.make_rcpsp_train_step(cfg, RCPSPConfig(n_ants=chip_smoke.A))

    def run():
        state[0], _ = step(state[0], batches[state[1] % len(batches)], gen)
        state[1] += 1

    return run


def train_step_runner(chip_smoke, family: str | None = None):
    """One train step per call, on a state that carries over: TSP500-NLS, or
    with ``family`` that family's envelope on a new batch each call."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.train import reinforce as tr

    if family == "rcpsp":
        return rcpsp_step_runner(chip_smoke)
    if family is not None:
        fam, cfg, fam_state, rng, fam_gen = chip_smoke.family_train_inputs(
            torch.device("cuda"), family)
        fam_step = drivers.make_family_train_step(fam, cfg)
        fam_states = [fam_state]

        def run_family():
            batch = drivers.gen_batch(fam, rng, cfg.n_nodes, cfg.train.batch_size)
            fam_states[0], _ = fam_step(fam_states[0], batch, fam_gen)

        return run_family
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
    parser.add_argument("--family", choices=("cvrp", "op", "pctsp", "smtwtp", "sop", "bpp",
                                             "mkp", "mkp_items", "rcpsp", "cvrp_nls"),
                        default=None)
    parser.add_argument("--sparse", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if sum((args.train or args.family is not None, args.sparse, args.ls is not None)) > 1:
        parser.error("--ls, --train [--family], --family and --sparse each name one path")
    if args.train and args.family == "cvrp_nls":
        parser.error("--train profiles the family trainer; cvrp_nls trains apart from it")
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if args.train:
        run = train_step_runner(chip_smoke, args.family)
    elif args.sparse:
        sparse_args = chip_smoke.sparse_args(ROOT)
        run = lambda: chip_smoke.drive_sparse(sparse_args)
    elif args.family == "cvrp_nls":
        run = lambda: chip_smoke.drive_cvrp_nls(chip_smoke.cvrp_nls_args(ROOT, 1))
    elif args.family == "rcpsp":
        from deepaco_tpu_torch.eval.rcpsp import evaluate_rcpsp, rcpsp_net
        from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

        dev = torch.device("cuda")
        test, _ = rcpsp_inputs(chip_smoke, dev)
        net = rcpsp_net(load_checkpoint(str(ROOT / chip_smoke.RCPSP_CKPT))).to(dev)
        run = lambda: evaluate_rcpsp(test, net, n_ants=chip_smoke.A, t_values=chip_smoke.T_VALUES,
                                     seed=chip_smoke.SEED, device=dev)
    elif args.family:
        net, ds = chip_smoke.family_inputs(ROOT, torch.device("cuda"), args.family)
        run = lambda: chip_smoke.drive_family(net, ds, name=args.family)
    else:
        net, coords = chip_smoke.main_path_inputs(ROOT, torch.device("cuda"), args.ls)
        if args.ls == "2opt":
            net = None                               # the classic arm
        run = lambda: chip_smoke.drive(net, coords, ls=args.ls)
    run()
    torch.cuda.synchronize()
    # the profiler adds host time to every launch, so the wall is also
    # taken without it
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
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
    path = (f"train_{args.family or 'nls'}" if args.train else "sparse" if args.sparse
            else args.family or args.ls or "main")
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / f"{path}_path_trace.json"))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]))
    split = {}
    for name, entry in kernels.items():
        short = next((k for k in HEURISTIC_KERNELS
                      if f"::{k}(" in name or name.startswith(f"{k}(")), None)
        if short:
            part = split.setdefault(short, {"ms": 0.0, "count": 0})
            part["ms"] += entry["ms"]
            part["count"] += entry["count"]
    print(json.dumps({"path": path, "card": card, "wall_ms": wall_ms,
                      "unprofiled_wall_ms": walls,
                      "device_busy_ms": busy if kernels else "not measured",
                      "launches": sum(k["count"] for k in kernels.values()),
                      "device_idle_share": 1 - busy / wall_ms if kernels else "not measured",
                      "heuristic_kernels": split,
                      "heuristic_kernels_ms": sum(v["ms"] for v in split.values()),
                      "kernels": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
