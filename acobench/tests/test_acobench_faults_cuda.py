"""On the card, at the training cell's own size: the faults a training step
can have, planted under the timed path, each on three seeds, and the numbers
they read (``pytest -m cuda -s`` prints them). Each has to come out not
correct."""
from __future__ import annotations

import json

import pytest

from acobench_tiny import SEED
from test_acobench_check import TRAIN, plant_training_fault

SEEDS = [SEED + 11, SEED + 12, SEED + 13]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_training_faults_at_the_cells_size(fault, monkeypatch):
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from acobench.run import measure
    from acobench.spec import cell_spec

    plant_training_fault(fault, monkeypatch)
    for seed in SEEDS:
        out = measure(cell_spec(TRAIN), seed, 1.0, False, "cuda", started=time.perf_counter())
        print(json.dumps({"fault": fault, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"]}))
        assert not out["correct"]
