"""Problem-family registry (counterpart of ``deepaco_tpu/families.py``): one
description per problem, read by :mod:`deepaco_tpu_torch.train.drivers`.

A family bundles the instance generator, the GNN graph, the heuristic's
post-processing, the rollout plug-in, the objective and the ACO flags. Its
functions take instance dicts of tensors batched over ``B`` instances, and
every reduction that JAX takes over one instance (its ``vmap``) reduces
over the instance's own axes here, never over the batch: ``tsp``,
``cvrp``, ``op``, ``pctsp``, ``smtwtp``, ``sop``, ``bpp``, ``mkp`` and
``mkp_items``, the JAX registry's. CVRP-NLS and RCPSP are no families here,
as in the JAX package: their trainers are in ``train.special``.

The CVRP reference reshapes its per-edge heuristic with the source index
varying fast (cvrp/train.ipynb cell 1, cvrp/utils.py:27-29), so its dense
heuristic is the transpose of the ``(src, dst)`` layout, and so is BPP's,
which reuses the CVRP graph with unit edge attributes; TSP, OP, PCTSP,
SMTWTP and SOP scatter by ``(src, dst)`` with no transpose. PCTSP divides
its heuristic by its smallest entry (pctsp/train.ipynb cell 1); MKP does too
and then transposes. SOP's masked dense block zeroes the output on the
edges its precedences forbid. MKP-items replaces the GNN wholesale: its
``model_ctor``, ``forward`` and ``model_init`` hooks give the transformer
over ``[price, weights]`` tokens, whose per-item heuristic meets a per-item
vector pheromone.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from deepaco_tpu_torch.aco.engine import rollout
from deepaco_tpu_torch.aco.problems.bpp import bpp_default_heuristic, bpp_fitness
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_paths, cvrp_spec, route_cost
from deepaco_tpu_torch.aco.problems.mkp import (extend_mkp, mkp_default_heuristic,
                                                mkp_items_spec, mkp_objective, mkp_prior,
                                                mkp_spec)
from deepaco_tpu_torch.aco.problems.op import (extend_op_instance, op_default_heuristic,
                                               op_objective, op_spec)
from deepaco_tpu_torch.aco.problems.pctsp import (pctsp_default_heuristic,
                                                  pctsp_objective, pctsp_spec)
from deepaco_tpu_torch.aco.problems.smtwtp import (smtwtp_cost, smtwtp_default_heuristic,
                                                   smtwtp_spec)
from deepaco_tpu_torch.aco.problems.sop import sop_cost, sop_spec
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.core.builders import (cvrp_graph, mkp_graph, op_graph, pctsp_graph,
                                             smtwtp_graph, sop_graph)
from deepaco_tpu_torch.core.graph import (knn_graph, scatter_to_dense,
                                          sparse_distance_matrix)
from deepaco_tpu_torch.models.transformer import (TransformerModel,
                                                  init_transformer_like_flax)

EPS = 1e-10
OP_MAX_LEN = {100: 4.0, 200: 5.0, 300: 6.0}        # op/test.py:13-17
PCTSP_KN = {20: 2.0, 100: 4.0, 500: 9.0}           # pctsp/utils.py:4-8
CVRP_CAPACITY = 50.0                                # cvrp/aco.py:7
BPP_CAPACITY = 150.0                                # bpp/aco.py:9


class Family(NamedTuple):
    """``gen(rng, n)`` → one instance of numpy arrays; ``graph(inst, k)``
    → :class:`~deepaco_tpu_torch.core.graph.SparseGraph`; ``heu_matrix(g,
    out, inst)`` → the dense heuristic ``[B, N, N]``; ``spec(tau, heu, inst,
    n_ants)`` → the rollout plug-in (``aco.engine.RolloutSpec``) that
    training samples (TSP, SMTWTP, CVRP, BPP, SOP, MKP: K7r's one launch;
    the others a pick a step) and replays; ``construct(tau, heu,
    inst, n_ants, generator, ops)`` → one inference iteration's paths
    through ``ops`` (``train.drivers.FamilyOps``): TSP, OP, PCTSP, SMTWTP,
    SOP, MKP and MKP-items the rollout of their ``spec`` (TSP, SMTWTP, SOP
    and MKP K7r's untraced forward, the others a pick a step); CVRP and BPP
    one pass (``ops.construct``) where K7c takes N; ``cost(paths, inst)`` → ``[B, A]``; ``horizon_states(n_nodes)``
    → ``(pheromone size, rollout horizon)``; ``classic_heu(inst, k)`` → the
    classic arm's heuristic; ``model_kwargs`` the ``Net`` arguments as
    sorted pairs; ``prepare(inst)`` → the instance with the arrays its spec
    and cost read (OP's and MKP's extended ones), applied before everything
    else; ``extras(inst)`` → the search's per-instance arguments (OP's,
    MKP's and MKP-items' ``q``). A family whose model is no GNN (MKP-items)
    sets ``model_ctor`` (the model's class, with ``from_jax_variables``),
    ``forward(net, inst, k_sparse)`` → its heuristic, and ``model_init(net,
    generator)``, its initialisation by the JAX package's law."""

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
    prepare: Callable[[dict], dict] = staticmethod(lambda inst: inst)
    extras: Callable[[dict], dict] = staticmethod(lambda inst: {})
    model_ctor: type | None = None
    forward: Callable | None = None
    model_init: Callable | None = None


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


def gen_op(rng: np.random.Generator, n: int) -> dict:
    """Prizes by distance to the depot, node 0 (op/utils.py:5-11)."""
    coords = rng.random((n, 2), dtype=np.float32)
    d0 = np.linalg.norm(coords - coords[0], axis=-1)
    prizes = 1.0 + np.floor(99.0 * d0 / d0.max())
    prizes = (prizes / prizes.max()).astype(np.float32)
    return {"coords": coords, "dist": _dist(coords, 1e9), "prizes": prizes,
            "max_len": np.float32(OP_MAX_LEN.get(n, 4.0))}


def gen_pctsp(rng: np.random.Generator, n: int) -> dict:
    """The depot and n nodes with uniform prizes and penalties of scale
    ``3 k / n`` (pctsp/utils.py:10-28)."""
    coords = rng.random((n + 1, 2), dtype=np.float32)
    k = PCTSP_KN.get(n, 3.0 * max(n, 1) / 100.0 + 1.0)
    prizes = np.concatenate([[0.0], rng.random(n)]).astype(np.float32)
    penalties = np.concatenate([[0.0], rng.random(n) * 3.0 * k / n]).astype(np.float32)
    return {"coords": coords, "dist": _dist(coords, 0.0), "prizes": prizes,
            "penalties": penalties}


def gen_smtwtp(rng: np.random.Generator, n: int) -> dict:
    """Due times ``due_norm * n`` from the same draw as the model's
    ``due_norm`` feature (smtwtp/utils.py:6-8), weights, processing times."""
    due_norm = rng.random(n, dtype=np.float32)
    return {"due_norm": due_norm, "due": due_norm * n,
            "weights": rng.random(n, dtype=np.float32),
            "processing": rng.random(n, dtype=np.float32)}


def gen_mkp(rng: np.random.Generator, n: int, m: int = 5) -> dict:
    """Well-stated instances (mkp/utils.py:6-24): each dimension's weights
    scaled so that the capacity ``n // 2`` lies between its largest weight
    and its sum."""
    prize = rng.random(n, dtype=np.float32)
    w = rng.random((n, m), dtype=np.float32)
    constraints = np.array([rng.uniform(w[:, j].max(), w[:, j].sum()) for j in range(m)])
    w = w * (n // 2) / constraints[None, :]
    return {"prize": prize, "weight": w.astype(np.float32)}


def gen_mkp_items(rng: np.random.Generator, n: int, m: int = 5) -> dict:
    """PH_items instances (mkp_transformer/utils.py:6-21): weights drawn as
    ``[m, n]`` and each dimension divided by a constraint drawn between its
    largest weight and its sum, so that every capacity is 1."""
    price = rng.random(n, dtype=np.float32)
    w = rng.random((m, n))
    constraints = np.array([rng.uniform(w[j].max(), w[j].sum()) for j in range(m)])
    w = (w / constraints[:, None]).T
    return {"prize": price, "weight": w.astype(np.float32)}


def gen_bpp(rng: np.random.Generator, n: int) -> dict:
    """The separator (size 0) and n items of integer sizes 20..100."""
    demand = np.concatenate([[0.0], rng.integers(20, 101, n)]).astype(np.float32)
    return {"demand": demand}


def gen_sop(rng: np.random.Generator, n: int) -> dict:
    """A random precedence DAG and a shifted cost matrix (sop/utils.py:5-43):
    ``prec[j, i] = 1`` iff ``i`` must precede ``j``, ``adj[i, j] = 1`` iff
    ``j`` may follow ``i``."""
    r = [(0, i) for i in range(1, n)]
    a = list(range(1, n))
    precede = [set() for _ in range(n)]
    for i in range(n - 3, -1, -1):
        for j in range(i + 1, n - 1):
            if rng.random() > 0.2:
                continue
            precede[i].add(j)
            precede[i].update(precede[j])
        for j in precede[i]:
            r.append((a[i], a[j]))
    dist = rng.random((n, n)).astype(np.float32)
    dist[1:, :] += dist[0, :][None, :]
    return {"dist": dist, **sop_masks(n, r)}


def sop_masks(n: int, pairs) -> dict:
    """``adj`` and ``prec [n, n]`` (f32) of the ordering pairs ``(i, j)``, ``i``
    before ``j``: the diagonal and each edge ``j -> i`` are forbidden."""
    adj = np.ones((n, n), np.float32)
    np.fill_diagonal(adj, 0)
    prec = np.zeros((n, n), np.float32)
    for i, j in pairs:
        adj[j, i] = 0.0
        prec[j, i] = 1.0
    return {"adj": adj, "prec": prec}


# ------------------------------------------------- heuristic post-process --
def _std_heu(g, out, inst):
    return scatter_to_dense(g, out) + EPS


def _dense_transposed_heu(g, out, inst):
    # the [.., N, N] output is row = src; the reference's reshape is dst-major
    return out.transpose(-1, -2) + EPS


def _pctsp_heu(g, out, inst):
    # each instance's dense [N, N] output (row = src) over its own smallest entry
    return out / (out.amin(dim=(-2, -1), keepdim=True) + EPS) + EPS


def _mkp_heu(g, out, inst):
    # each instance's [n, n] output (row = src) over its own smallest entry,
    # then transposed (mkp/train.py), and extended with the dummy item
    heu = (out / (out.amin(dim=(-2, -1), keepdim=True) + EPS) + EPS).transpose(-1, -2)
    return extend_mkp(inst["prize"], inst["weight"], heu)[2]


def _sop_heu(g, out, inst):
    # the masked dense block: forbidden edges contribute 0 (families.py:417-421)
    return out * g.mask + EPS


# ------------------------------------------------------- rollout plug-ins --
def _per_step(spec: Callable) -> Callable:
    """The ``construct`` of a family that samples its ``spec``'s rollout in
    inference too, through ``engine.rollout`` with ``ops.pick``: one
    launch of K7r's untraced forward where the spec carries ``fused``, else
    K7 a step."""
    return lambda tau, heu, inst, a, generator, ops: rollout(
        spec(tau, heu, inst, a), generator, pick=ops.pick).paths


def _tsp_spec(tau, heu, inst, a):
    return tsp_spec(tau, heu, a)


def _op_spec(tau, heu, inst, a):
    return op_spec(tau, heu, inst["dist_ext"], inst["max_len"], a)


def _pctsp_spec(tau, heu, inst, a):
    # the prize gate n / 4 of n nodes (deepaco_tpu/families.py:275)
    return pctsp_spec(tau, heu, inst["prizes"], (inst["prizes"].shape[-1] - 1) / 4.0, a)


def _smtwtp_spec(tau, heu, inst, a):
    return smtwtp_spec(tau, heu, a)


def _sop_spec(tau, heu, inst, a):
    return sop_spec(tau, heu, inst["prec"], a)


def _mkp_spec(tau, heu, inst, a):
    # the capacity n // 2 of n items (deepaco_tpu/families.py:331-333)
    return mkp_spec(tau, heu, inst["weight_ext"], inst["prize"].shape[-1] // 2, a)


def _mkp_prepare(inst: dict) -> dict:
    prize_e, weight_e = extend_mkp(inst["prize"], inst["weight"])
    return {**inst, "prize_ext": prize_e, "weight_ext": weight_e}


def _items_src(inst: dict) -> torch.Tensor:
    """The transformer's tokens ``[..., n, 1+m]``: each item's price, then
    its weights (mkp_transformer/utils.py:24-30)."""
    return torch.cat([inst["prize"][..., None], inst["weight"]], dim=-1)


def _items_forward(net, inst: dict, k_sparse: int) -> torch.Tensor:
    # the transformer's heuristic + EPS, extended with the dummy's 1e-8
    # (families.py:383-386)
    heu = net(_items_src(inst)) + EPS
    return extend_mkp(inst["prize"], inst["weight"], heu_vec=heu)[2]


def _mkp_items_spec(tau, heu, inst, a):
    return mkp_items_spec(tau, heu, inst["weight_ext"], 1.0, a)


def _op_prepare(inst: dict) -> dict:
    dist_e, prizes_e, _ = extend_op_instance(inst["dist"], inst["prizes"],
                                             torch.zeros_like(inst["dist"]))
    return {**inst, "dist_ext": dist_e, "prizes_ext": prizes_e}


def _op_extend_heu(inst: dict, heu: torch.Tensor) -> torch.Tensor:
    return extend_op_instance(inst["dist"], inst["prizes"], heu)[2]


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
        spec=_tsp_spec,
        construct=_per_step(_tsp_spec),
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
    "op": Family(
        name="op",
        model_kwargs=(),
        gen=gen_op,
        graph=lambda inst, k: op_graph(inst["coords"], inst["dist"], inst["prizes"], k),
        heu_matrix=lambda g, out, inst: _op_extend_heu(inst, _std_heu(g, out, inst)),
        spec=_op_spec,
        construct=_per_step(_op_spec),
        cost=lambda paths, inst: op_objective(inst["prizes_ext"], paths),
        aco=ACOConfig(maximize=True, cyclic=False, symmetric=False),
        horizon_states=lambda n: (n + 1, n + 1),
        classic_heu=lambda inst, k: _op_extend_heu(
            inst, op_default_heuristic(inst["dist"], inst["prizes"], k)),
        prepare=_op_prepare,
        extras=lambda inst: {"q": 1.0 / inst["prizes"].sum(dim=-1)}),
    "pctsp": Family(
        name="pctsp",
        model_kwargs=(),
        gen=gen_pctsp,
        graph=lambda inst, k: pctsp_graph(inst["prizes"], inst["penalties"], inst["dist"]),
        heu_matrix=_pctsp_heu,
        spec=_pctsp_spec,
        construct=_per_step(_pctsp_spec),
        cost=lambda paths, inst: pctsp_objective(inst["dist"], inst["prizes"],
                                                 inst["penalties"], paths),
        aco=ACOConfig(cyclic=False, symmetric=False),
        horizon_states=lambda n: (n + 1, n + 2),
        classic_heu=lambda inst, k: pctsp_default_heuristic(inst["dist"], inst["prizes"])),
    "smtwtp": Family(
        name="smtwtp",
        model_kwargs=(("node_update", False),),
        gen=gen_smtwtp,
        graph=lambda inst, k: smtwtp_graph(inst["due_norm"], inst["weights"],
                                           inst["processing"]),
        heu_matrix=_std_heu,
        spec=_smtwtp_spec,
        construct=_per_step(_smtwtp_spec),
        cost=lambda paths, inst: smtwtp_cost(inst["processing"], inst["due"],
                                             inst["weights"], paths),
        aco=ACOConfig(cyclic=False, symmetric=False, cost_offset=1.0),
        horizon_states=lambda n: (n + 1, n),
        classic_heu=lambda inst, k: smtwtp_default_heuristic(inst["due"])),
    "sop": Family(
        name="sop",
        model_kwargs=(("feats", 1), ("node_update", False)),
        gen=gen_sop,
        graph=lambda inst, k: sop_graph(inst["dist"], inst["adj"]),
        heu_matrix=_sop_heu,
        spec=_sop_spec,
        construct=_per_step(_sop_spec),
        cost=lambda paths, inst: sop_cost(inst["dist"], paths),
        aco=ACOConfig(cyclic=False, symmetric=False),
        horizon_states=lambda n: (n, n - 1),
        classic_heu=lambda inst, k: 1.0 / (inst["dist"] + 1e-10)),
    "bpp": Family(
        name="bpp",
        model_kwargs=(("feats", 1),),
        gen=gen_bpp,
        # bpp/utils.py:14-23: the dense graph, x = sizes, unit edge attributes
        graph=lambda inst, k: cvrp_graph(inst["demand"], inst["demand"].new_ones(
            (*inst["demand"].shape, inst["demand"].shape[-1]))),
        heu_matrix=_dense_transposed_heu,
        spec=lambda tau, heu, inst, a: cvrp_spec(tau, heu, inst["demand"], BPP_CAPACITY, a),
        construct=lambda tau, heu, inst, a, generator, ops: cvrp_paths(
            tau, heu, inst["demand"], BPP_CAPACITY, a, generator,
            construct=ops.construct, pick=ops.pick),
        cost=lambda paths, inst: bpp_fitness(inst["demand"], BPP_CAPACITY, paths),
        aco=ACOConfig(maximize=True, cyclic=False, symmetric=False, floor=1e-10,
                      deposit_div_ants=True),
        horizon_states=lambda n: (n + 1, 2 * n),
        classic_heu=lambda inst, k: bpp_default_heuristic(inst["demand"])),
    "mkp": Family(
        name="mkp",
        model_kwargs=(("feats", 5),),
        gen=gen_mkp,
        graph=lambda inst, k: mkp_graph(inst["prize"], inst["weight"]),
        heu_matrix=_mkp_heu,
        spec=_mkp_spec,
        construct=_per_step(_mkp_spec),
        cost=lambda paths, inst: mkp_objective(inst["prize_ext"], paths),
        aco=ACOConfig(maximize=True, cyclic=False, symmetric=False, floor=1e-10),
        horizon_states=lambda n: (n + 1, n + 1),
        classic_heu=lambda inst, k: extend_mkp(
            inst["prize"], inst["weight"],
            mkp_default_heuristic(inst["prize"], inst["weight"]))[2],
        prepare=_mkp_prepare,
        extras=lambda inst: {"q": 1.0 / inst["prize"].sum(dim=-1)}),
    "mkp_items": Family(
        name="mkp_items",
        model_kwargs=(),
        gen=gen_mkp_items,
        graph=lambda inst, k: _items_src(inst),
        heu_matrix=lambda g, out, inst: out,
        spec=_mkp_items_spec,
        construct=_per_step(_mkp_items_spec),
        cost=lambda paths, inst: mkp_objective(inst["prize_ext"], paths),
        aco=ACOConfig(maximize=True, cyclic=False, symmetric=False, vector_pheromone=True),
        horizon_states=lambda n: (n + 1, n + 1),
        classic_heu=lambda inst, k: extend_mkp(
            inst["prize"], inst["weight"], heu_vec=mkp_prior(inst["prize"], inst["weight"]))[2],
        prepare=_mkp_prepare,
        extras=lambda inst: {"q": 1.0 / inst["prize"].sum(dim=-1)},
        model_ctor=TransformerModel,
        forward=_items_forward,
        model_init=init_transformer_like_flax),
}


def get_family(name: str) -> Family:
    """The registered family ``name``; ``KeyError`` for another name, as the
    JAX registry raises (RCPSP is no family in either package: its trainer
    is ``train.special.train_rcpsp``, its protocol ``eval.rcpsp``)."""
    if name not in FAMILIES:
        raise KeyError(f"no family {name!r} (families: {sorted(FAMILIES)})")
    return FAMILIES[name]
