"""The one traffic generator: every request's instances and sampling seed
from the run's ``--seed`` and a traffic file's parameters.

Instances follow the TSP instance law of DeepACO (tsp/utils.py): N cities
uniform on the unit square, f32 (deepaco_tpu_torch/families.py:109-111,
``gen_tsp``). Set-up draws a pool of ``pool`` distinct batches of
``batch`` instances; request ``i`` takes batch ``i mod pool`` as a host
array and its own sampling seed, both fixed by ``--seed`` and ``i``.
"""
from __future__ import annotations

import numpy as np

LAW = "tsp_uniform_unit_square"


def _entropy(seed: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % 2 ** 64, *words])


def instance_pool(seed: int, pool: int, batch: int, n: int) -> np.ndarray:
    """``[pool, batch, n, 2]`` f32 coordinates, U(0,1)^2."""
    rng = np.random.default_rng(_entropy(seed, 0))
    return rng.random((pool, batch, n, 2), dtype=np.float32)


def request_seed(seed: int, i: int, stream: int = 1) -> int:
    """Request ``i``'s sampling seed, a 63-bit number (``stream=3``: the
    warm-up's)."""
    words = _entropy(seed, stream, int(i)).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def sample_requests(seed: int, count: int, span: int) -> list[int]:
    """The ``count`` requests, among the first ``span``, whose outputs the
    check compares in full."""
    rng = np.random.default_rng(_entropy(seed, 2))
    return sorted(int(i) for i in rng.choice(span, size=count, replace=False))
