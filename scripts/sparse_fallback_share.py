#!/usr/bin/env python3
"""The sparse-support TSP runner's fallback share in both packages, on the
CPU, at the inputs of ``chip_smoke.py``'s main path.

    JAX_PLATFORMS=cpu python3 scripts/sparse_fallback_share.py [--instances 100] [--iterations 10]

The inputs are the main path's: ``tsp500_selftrained``, ``--instances`` of
its seeded U(0,1)^2 instances (N=500; 100 by default), k=50, 20 ants; the
heuristic is the port's plain K1 (``tsp_dense_heuristic_plain``), floored
off the k-NN support. Each package then runs ``--iterations`` of its sparse
runner from seed 0: the JAX package's ``sweep_construct(count_dense=True)``
and ``_batched_update`` an iteration (jitted), the port's
``run_anytime_sparse`` with its plain update. Prints one JSON line: each
package's dense-fallback steps over all sweep steps, and its cost@T1 and
cost@T{iterations}. The two sample from different streams, so they agree
in law only. Both packages run here, so this script imports JAX; the port
itself never does. Walls are this CPU's and are not printed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--instances", type=int, default=100)
    parser.add_argument("--iterations", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as cs
    from deepaco_tpu.aco import batched_tsp as jbt
    from deepaco_tpu.aco.runner import ACOConfig as JACOConfig
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops.fused_gnn import tsp_dense_heuristic_plain
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    torch.set_num_threads(4)
    net, coords = cs.main_path_inputs(ROOT, torch.device("cpu"))
    coords = coords[:args.instances]
    dist = distance_matrix(coords)
    with torch.no_grad():
        heu = tsp_dense_heuristic_plain(net, coords, dist, cs.K)
    nbr = topk_smallest(dist, cs.K)[1]
    t = args.iterations
    b, n = coords.shape[:2]

    stats = {}
    curve = bt.run_anytime_sparse(heu, dist, nbr, ACOConfig(n_ants=cs.A),
                                  torch.Generator().manual_seed(cs.SEED), t, stats=stats)
    port = {"fallback_steps": stats["fallback_steps"], "steps": stats["steps"],
            "fallback_share": stats["fallback_steps"] / stats["steps"],
            "cost": [curve[:, 0].mean().item(), curve[:, -1].mean().item()]}

    cfg = JACOConfig(n_ants=cs.A)
    jheu, jdist, jnbr = (jnp.asarray(x.numpy()) for x in (heu, dist, nbr))
    log_heu = cfg.beta * jnp.log(jnp.maximum(jheu, 1e-30))

    @jax.jit
    def iteration(state, key):
        # the body of run_anytime_sparse (batched_tsp.py:424-433), with the
        # sweep's fallback count
        score_d = cfg.alpha * jnp.log(jnp.maximum(state.phe.tau, 1e-30)) + log_heu
        score_s = jnp.take_along_axis(score_d, jnbr, axis=-1)
        k_start, k_sweep = jax.random.split(key)
        start = jbt._start_cities(k_start, b, cfg.n_ants, n, None)
        paths, dense = jbt.sweep_construct(score_d, score_s, jnbr, start, k_sweep,
                                           count_dense=True)
        state = jbt._batched_update(cfg, state, paths, jdist)
        return state, dense

    state = jbt._batched_init(b, n, cfg)
    dense, jcurve = 0, []
    for key in jax.random.split(jax.random.PRNGKey(cs.SEED), t):
        state, d = iteration(state, key)
        dense += int(d)
        jcurve.append(np.asarray(state.best_cost).mean())
    jax_out = {"fallback_steps": dense, "steps": t * (n - 1),
               "fallback_share": dense / (t * (n - 1)),
               "cost": [float(jcurve[0]), float(jcurve[-1])]}
    print(json.dumps({"B": b, "N": n, "K": cs.K, "A": cs.A, "T": t, "device": "cpu",
                      "jax": jax_out, "port": port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
