"""A cell of the benchmark cut to a size that a CPU test run holds: 20
cities, 5 neighbours, 2 instances a request or step, 3 iterations (solve)
or 4 ants (training), with the cell's own weights and check."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 4099


def tiny_spec(cell: str) -> dict:
    from acobench.spec import cell_spec

    spec = copy.deepcopy(cell_spec(cell))
    spec["config"].update(n_nodes=20, k_sparse=5)
    if spec["workload"]["kind"] == "train":
        spec["traffic"].update(batch=2, n_ants=4)
    else:
        spec["traffic"].update(batch=2, iterations=3, pool=2)
        spec["workload"]["check"].update(samples=1, sample_span=2)
        # 2 x 4 ants x 19 steps x 3 iterations: the law's sampling noise is
        # about 0.05 nats a step at this size, not the cell's 1e-3
        spec["workload"]["check"]["limits"]["law_gap"] = 0.25
    return spec


def run_tiny(cell: str, seconds: float = 0.5, seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU, the look for a card skipped."""
    import time

    import torch

    from acobench.run import measure

    torch.set_num_threads(2)
    return measure(tiny_spec(cell), seed, seconds, False, "cpu", started=time.perf_counter())
