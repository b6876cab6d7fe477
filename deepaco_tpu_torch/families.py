"""Problem-family registry (counterpart of ``deepaco_tpu/families.py``): one
description per problem, read by :mod:`deepaco_tpu_torch.train.drivers`.

A family bundles the instance generator, the GNN graph, the heuristic's
post-processing, the rollout plug-in, the objective and the ACO flags. Its
functions take instance dicts of tensors batched over ``B`` instances. This
slice ports ``tsp`` and ``cvrp``; the others follow in ROADMAP.md's order.

The CVRP reference reshapes its per-edge heuristic with the source index
varying fast (cvrp/train.ipynb cell 1, cvrp/utils.py:27-29), so its dense
heuristic is the transpose of the ``(src, dst)`` layout; TSP scatters by
``(src, dst)`` with no transpose.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_paths, cvrp_spec, route_cost
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.core.builders import cvrp_graph
from deepaco_tpu_torch.core.graph import (knn_graph, scatter_to_dense,
                                          sparse_distance_matrix)

EPS = 1e-10
CVRP_CAPACITY = 50.0                                # cvrp/aco.py:7


class Family(NamedTuple):
    """``gen(rng, n)`` → one instance of numpy arrays; ``graph(inst, k)``
    → :class:`~deepaco_tpu_torch.core.graph.SparseGraph`; ``heu_matrix(g,
    out, inst)`` → the dense heuristic ``[B, N, N]``; ``spec(tau, heu, inst,
    n_ants)`` → the rollout plug-in (``aco.engine.RolloutSpec``) that
    training samples and replays, a pick a step; ``construct(tau, heu,
    inst, n_ants, generator, ops)`` → one inference iteration's paths
    through ``ops`` (``train.drivers.FamilyOps``): TSP the rollout of
    ``tsp_spec``, a pick a step; CVRP one pass (``ops.construct``) where K7c
    takes N; ``cost(paths, inst)`` → ``[B, A]``; ``horizon_states(n_nodes)``
    → ``(pheromone size, rollout horizon)``; ``classic_heu(inst, k)`` → the
    classic arm's heuristic; ``model_kwargs`` the ``Net`` arguments as
    sorted pairs."""

    name: str
    model_kwargs: tuple
    gen: Callable[[np.random.Generator, int], dict]
    graph: Callable
    heu_matrix: Callable
    spec: Callable
    construct: Callable
    cost: Callable
    aco: ACOConfig
    horizon_states: Callable[[int], tuple]
    classic_heu: Callable
    k_sparse: Callable[[int], int] = staticmethod(lambda n: max(n // 10, 3))


# ----------------------------------------------------------- generators ----
def _dist(coords, diag):
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    np.fill_diagonal(d, diag)
    return d.astype(np.float32)


def gen_tsp(rng: np.random.Generator, n: int) -> dict:
    coords = rng.random((n, 2), dtype=np.float32)
    return {"coords": coords, "dist": _dist(coords, 1e9)}


def gen_cvrp(rng: np.random.Generator, n: int) -> dict:
    """(cvrp/utils.py:9-22): depot pinned at (0.5, 0.5), integer demands."""
    coords = np.concatenate([[[0.5, 0.5]], rng.random((n, 2))]).astype(np.float32)
    demands = np.concatenate([[0.0], rng.integers(1, 10, n)]).astype(np.float32)
    return {"coords": coords, "dist": _dist(coords, 1e-10), "demand": demands}


# ------------------------------------------------- heuristic post-process --
def _std_heu(g, out, inst):
    return scatter_to_dense(g, out) + EPS


def _dense_transposed_heu(g, out, inst):
    # the [.., N, N] output is row = src; the reference's reshape is dst-major
    return out.transpose(-1, -2) + EPS


# ------------------------------------------------------------- registry ----
# TSP is served by ``eval.anytime.evaluate_tsp`` (K1-K3); its entry here is
# the generic driver's parity fixture against the JAX package.
FAMILIES = {
    "tsp": Family(
        name="tsp",
        model_kwargs=(("dual_heads", True),),
        gen=gen_tsp,
        graph=lambda inst, k: knn_graph(inst["coords"], inst["dist"], k),
        heu_matrix=_std_heu,
        spec=lambda tau, heu, inst, a: tsp_spec(tau, heu, a),
        construct=lambda tau, heu, inst, a, generator, ops: rollout(
            tsp_spec(tau, heu, a), generator, pick=ops.pick).paths,
        cost=lambda paths, inst: tour_cost(inst["dist"], paths),
        aco=ACOConfig(),
        horizon_states=lambda n: (n, n - 1),
        classic_heu=lambda inst, k: 1.0 / sparse_distance_matrix(inst["dist"], k)),
    "cvrp": Family(
        name="cvrp",
        model_kwargs=(("feats", 1),),
        gen=gen_cvrp,
        graph=lambda inst, k: cvrp_graph(inst["demand"], inst["dist"]),
        heu_matrix=_dense_transposed_heu,
        spec=lambda tau, heu, inst, a: cvrp_spec(tau, heu, inst["demand"],
                                                 CVRP_CAPACITY, a),
        construct=lambda tau, heu, inst, a, generator, ops: cvrp_paths(
            tau, heu, inst["demand"], CVRP_CAPACITY, a, generator,
            construct=ops.construct, pick=ops.pick),
        cost=lambda paths, inst: route_cost(inst["dist"], paths),
        aco=ACOConfig(cyclic=False, symmetric=False, floor=1e-10),
        horizon_states=lambda n: (n + 1, 2 * n),
        classic_heu=lambda inst, k: 1.0 / inst["dist"]),
}


def get_family(name: str) -> Family:
    """The registered family ``name``; a family not ported yet raises."""
    if name not in FAMILIES:
        raise NotImplementedError(
            f"family {name!r} is not ported to deepaco_tpu_torch (ported: "
            f"{sorted(FAMILIES)}); see ROADMAP.md")
    return FAMILIES[name]
