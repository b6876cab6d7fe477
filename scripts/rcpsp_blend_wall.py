#!/usr/bin/env python3
"""The wall time and launches of RCPSP's summation blend run as
``chip_smoke.py``'s phase 17 drives it: ``RCPSPACO`` with
``chip_smoke.RCPSP_BLEND`` (gamma 0.5, c 0.6) on the first test instance of
the seeded j120 archive that ``chip_smoke.write_psplib_archive`` writes, 20
ants, ``RCPSP_BLEND_T`` iterations, on the card. It imports the package and
``chip_smoke.py`` of the tree given with ``--root`` (default: this one), so
that two trees compare in turns in one call, each building its own kernels
under its own ``build/``:

    python3 scripts/rcpsp_blend_wall.py --root build/parent_tree
    python3 scripts/rcpsp_blend_wall.py

Prints one JSON line: the card, the tree, the wall of each of ``--repeats``
runs after one warm-up run (a fresh facade each), their median, the
launches of K7 (``fused_pick``), K7r's untraced forward
(``fused_rollout_paths``) and K8 (``tour_deposit``) in the last run, and its
best makespan. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("rcpsp_blend_wall: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deepaco_tpu_torch.aco.problems.rcpsp import RCPSPACO
    from deepaco_tpu_torch.core.rcpsp import load_psplib
    from deepaco_tpu_torch.ops import _build, deposit, pick, rollout

    dev = torch.device("cuda")
    _build.library()
    with tempfile.TemporaryDirectory(dir=root / "build") as tmp:
        archive = cs.write_psplib_archive(Path(tmp))
        data = load_psplib(str(archive), f"j{cs.RCPSP_N}rcp", device=dev)[0]
    counted = (pick.fused_pick, rollout.fused_rollout_paths, deposit.tour_deposit)

    def run():
        aco = RCPSPACO(data, n_ants=cs.A, seed=cs.SEED, device=dev, **cs.RCPSP_BLEND)
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = float(aco.run(cs.RCPSP_BLEND_T))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, best, {fn.__name__: fn.launches for fn in counted}

    warm = run()[0]
    walls, best, launches = [], None, None
    for _ in range(args.repeats):
        wall, best, launches = run()
        walls.append(wall)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip().splitlines()[0], "tree": str(root),
                      "N": data.n, "A": cs.A, "T": cs.RCPSP_BLEND_T, **cs.RCPSP_BLEND,
                      "warmup_s": warm, "wall_s": walls, "median_s": statistics.median(walls),
                      "launches": launches, "best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
