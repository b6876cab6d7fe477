"""Multiple Knapsack Problem plug-in (PH_suc, pairwise pheromone) for the
rollout engine, its objective, the validator and the reference-style facade
(counterpart of ``deepaco_tpu/aco/problems/mkp.py``), batched over instances.

Items 0..n-1 and a dummy item ``n`` (prize 0, weight 0; mkp/aco.py:60-65).
Each ant starts at an item drawn uniformly from the real ones
(mkp/aco.py:118), then each pick reads the pheromone row of the item it
picked last. The knapsack mask removes the picked items and every item that
would overflow any of the ``m`` capacity dimensions (capacity ``n // 2``,
mkp/aco.py:174-181), one comparison ``[B, A, n+1, m]`` a step; the dummy
stays shut until no real item fits (mkp/aco.py:155-160), and then the ant
parks on it. The objective is the total prize, maximized; an update
deposits ``q * objective`` with ``q = 1 / sum(prize)`` on the directed
consecutive pairs, floored at 1e-10 (mkp/aco.py:42, 85-111).

State: ``(cur [B, A], mask [B, A, n+1], dummy_mask [B, A, n+1], knapsack
[B, A, m])``.

PH_items (mkp_transformer/aco.py:5-178; ``mkp_items_spec``,
``MKPItemsACO``): the pheromone is a vector ``[B, n+1]``, every pick is
history-free over ``phe^alpha * heu^beta * mask`` with the same knapsack
masks, and an update deposits ``q * objective`` on every picked item. The
capacity is 1 (the weights are normalised). Its spec carries K7r's
``"items"`` shape: the one score row an instance and MKP's knapsack.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.aco.problems.op import op_objective
from deepaco_tpu_torch.aco.problems.tsp import clear_onehot, row_gatherer, score_matrix
from deepaco_tpu_torch.aco.runner import ACOConfig, ProblemACO, as_instance
from deepaco_tpu_torch.device import resolve_device


def _knapsack_masks(weight_e: torch.Tensor, capacity):
    """The mask update of mkp.py:29-50 for the extended ``weight_e [B, n+1,
    m]``: ``update(mask, dummy_mask, knapsack, new_item) -> (mask,
    dummy_mask, knapsack)`` with ``new_item [B, A]`` (None: no pick, the
    PH_items start), and the dummy's index. The knapsack adds each item's
    weights in the order the ant picks them, as JAX's does, so the
    comparisons agree bit for bit."""
    b, m_items, _ = weight_e.shape
    dummy = m_items - 1
    rows = row_gatherer(b, m_items, weight_e.device)

    def update(mask, dummy_mask, knapsack, new_item):
        if new_item is not None:
            mask = clear_onehot(mask, new_item)
            knapsack = knapsack + rows(weight_e, new_item)
        fits = (knapsack[..., None, :] + weight_e[:, None] <= capacity).all(dim=-1)
        mask = mask * fits.to(mask.dtype)
        mask[..., dummy] = 1.0
        finished = (mask[..., :dummy] == 0.0).all(dim=-1, keepdim=True)
        dummy_mask = torch.where(finished, torch.ones_like(dummy_mask), dummy_mask)
        return mask, dummy_mask, knapsack

    return update, dummy


def mkp_spec(phe: torch.Tensor, heu: torch.Tensor, weight_e: torch.Tensor, capacity,
             n_ants: int, alpha: float = 1.0, beta: float = 1.0):
    """The engine's plug-in for the dummy-extended ``phe, heu [B, n+1, n+1]``
    and ``weight_e [B, n+1, m]``; ``start`` draws each ant's first item
    uniformly from the real ones with the caller's generator. The spec
    carries MKP's shape for the engine's one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, m_items, _ = phe.shape
    update, dummy = _knapsack_masks(weight_e, capacity)
    score = score_matrix(phe, heu, alpha, beta)
    rows = row_gatherer(b, m_items, phe.device)

    def start(generator: torch.Generator) -> torch.Tensor:
        return torch.randint(0, m_items - 1, (b, n_ants), generator=generator,
                             device=generator.device).to(phe.device)

    def init(start_items: torch.Tensor):
        a = start_items.shape[1]
        mask = torch.ones((b, a, m_items), dtype=phe.dtype, device=phe.device)
        dummy_mask = mask.clone()
        dummy_mask[..., dummy] = 0.0
        knapsack = torch.zeros((b, a, weight_e.shape[-1]), dtype=phe.dtype, device=phe.device)
        return (start_items, *update(mask, dummy_mask, knapsack, start_items))

    def step(state, actions):
        return (actions, *update(*state[1:], actions))

    return RolloutSpec(horizon=m_items, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=lambda state: state[1] * state[2], step=step,
                       score_rows=lambda state: rows(score, state[0]),
                       fused=(score, RolloutShape("mkp", capacity=capacity, weight=weight_e,
                                                  dummy=dummy)))


def mkp_items_spec(phe_vec: torch.Tensor, heu_vec: torch.Tensor, weight_e: torch.Tensor,
                   capacity, n_ants: int, alpha: float = 1.0, beta: float = 1.0):
    """PH_items' plug-in (mkp.py:90-133) for ``phe_vec, heu_vec [B, n+1]``
    and ``weight_e [B, n+1, m]``: every ant starts on the dummy item (prize
    0, weight 0, no change to the state), so each real pick goes through
    the sampler with its log-probability, as the reference loop does
    (mkp_transformer/aco.py:111-135); every step scores the same row
    ``alpha*log(phe) + beta*log(heu)`` for every ant, ``[B*A, n+1]`` rows
    for the pick. The spec carries the ``"items"`` shape (that row ``[B,
    n+1]``, the knapsack, the dummy start that is no pick) for the engine's
    one-launch route (K7r)."""
    from deepaco_tpu_torch.aco.engine import RolloutSpec
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, m_items = phe_vec.shape
    update, dummy = _knapsack_masks(weight_e, capacity)
    score_vec = score_matrix(phe_vec, heu_vec, alpha, beta)

    def rows(vec: torch.Tensor, a: int) -> torch.Tensor:
        return vec[:, None, :].expand(b, a, m_items)

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.full((b, n_ants), dummy, dtype=torch.int64, device=phe_vec.device)

    def init(start_items: torch.Tensor):
        a = start_items.shape[1]
        mask = torch.ones((b, a, m_items), dtype=phe_vec.dtype, device=phe_vec.device)
        dummy_mask = mask.clone()
        dummy_mask[..., dummy] = 0.0
        knapsack = torch.zeros((b, a, weight_e.shape[-1]), dtype=phe_vec.dtype,
                               device=phe_vec.device)
        return (start_items, *update(mask, dummy_mask, knapsack, None))

    def step(state, actions):
        return (actions, *update(*state[1:], actions))

    return RolloutSpec(horizon=m_items, start=start, init=init,
                       prob_rows=lambda state: (rows(phe_vec, state[0].shape[1]),
                                                rows(heu_vec, state[0].shape[1])),
                       mask=lambda state: state[1] * state[2], step=step,
                       score_rows=lambda state: rows(score_vec, state[0].shape[1]),
                       fused=(score_vec, RolloutShape("items", capacity=capacity,
                                                      weight=weight_e, dummy=dummy)))


def mkp_objective(prizes_e: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Total prize per ant ``[..., A]`` (mkp/aco.py:104-111) of ``paths
    [..., L, A]`` over the extended ``prizes_e [..., n+1]``; the dummy's
    repeats add 0."""
    return op_objective(prizes_e, paths)


def extend_mkp(prize: torch.Tensor, weight: torch.Tensor,
               heu_mat: torch.Tensor | None = None,
               heu_vec: torch.Tensor | None = None) -> tuple:
    """The dummy item (mkp/aco.py:60-65, mkp_transformer/aco.py:61-64):
    ``prize_e [..., n+1]``, ``weight_e [..., n+1, m]``, then given ``heu_mat
    [..., n, n]`` ``heu_e [..., n+1, n+1]`` with 0 out of the dummy and 1e-10
    into it, and given ``heu_vec [..., n]`` ``[..., n+1]`` with 1e-8 for
    the dummy."""
    lead, n = prize.shape[:-1], prize.shape[-1]
    prize_e = torch.cat([prize, prize.new_zeros((*lead, 1))], dim=-1)
    weight_e = torch.cat([weight, weight.new_zeros((*lead, 1, weight.shape[-1]))], dim=-2)
    out = [prize_e, weight_e]
    if heu_mat is not None:
        h = torch.cat([heu_mat, heu_mat.new_zeros((*lead, 1, n))], dim=-2)
        out.append(torch.cat([h, torch.full((*lead, n + 1, 1), 1e-10, dtype=h.dtype,
                                            device=h.device)], dim=-1))
    if heu_vec is not None:
        out.append(torch.cat([heu_vec, torch.full((*lead, 1), 1e-8, dtype=heu_vec.dtype,
                                                  device=heu_vec.device)], dim=-1))
    return tuple(out)


def mkp_prior(prize: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``prize / sum(weight)`` per item ``[..., n]``. Each item's m weights
    are added one after another, the order in which XLA sums a short row,
    so that the prior is the JAX package's bit for bit."""
    total = weight[..., 0]
    for j in range(1, weight.shape[-1]):
        total = total + weight[..., j]
    return prize / total


def mkp_default_heuristic(prize: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The classic prior :func:`mkp_prior` of the destination item, the
    same for every row (mkp/aco.py:50-52): ``[..., n, n]``."""
    prior = mkp_prior(prize, weight)
    n = prior.shape[-1]
    return prior[..., None, :].expand(*prior.shape[:-1], n, n)


def validate_mkp(paths: torch.Tensor, weight: torch.Tensor, capacity) -> torch.Tensor:
    """Feasibility per ant ``[..., A]`` of ``paths [..., L, A]`` over the n
    real items and the dummy ``n`` (``weight [..., n, m]``): no real item
    twice and, in each dimension, the picked weights at most ``capacity``
    (summed in f64; 1e-6 relative slack for the mask's f32 sums)."""
    n = weight.shape[-2]
    p = paths.transpose(-1, -2).long()                              # [..., A, L]
    counts = torch.zeros((*p.shape[:-1], n + 1), dtype=torch.int64, device=p.device)
    counts.scatter_add_(-1, p, torch.ones_like(p))
    once = (counts[..., :n] <= 1).all(dim=-1)
    picked = (counts[..., :n] > 0).double()                         # [..., A, n]
    load = picked @ weight.double()                                 # [..., A, m]
    return once & (load <= capacity * (1 + 1e-6)).all(dim=-1)


class MKPACO(ProblemACO):
    """Reference-style facade (mkp/aco.py; ``deepaco_tpu/aco/problems/mkp.py:155-195``)
    over one instance: ``prize [n]``, ``weight [n, m]``, ``capacity``
    (default ``n // 2``) and a ``heuristic [n, n]`` (default the classic
    prior), extended with the dummy item; ``run`` and ``best_cost`` report
    the total prize, maximized."""

    def __init__(self, prize, weight, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, capacity=None, seed: int = 0, *,
                 device=None, generator: torch.Generator | None = None):
        dev = resolve_device(device)
        prize, weight = as_instance(prize, dev), as_instance(weight, dev)
        n = prize.shape[-1]
        self.capacity = float(n // 2) if capacity is None else float(capacity)
        heuristic = (mkp_default_heuristic(prize, weight) if heuristic is None
                     else as_instance(heuristic, dev))
        self.prize, self.weight, self.heuristic = extend_mkp(prize, weight, heuristic)
        self.q = 1.0 / prize.sum(dim=-1)
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, maximize=True, cyclic=False,
                        symmetric=False, floor=1e-10,
                        mm_static_max=20.0 if min_max else None)
        super().__init__(cfg, n + 1, n + 1, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return mkp_spec(tau, heu, self.weight, self.capacity, cfg.n_ants, cfg.alpha,
                        cfg.beta)

    def cost(self, paths):
        return mkp_objective(self.prize, paths)

    def extras(self) -> dict:
        return {"q": self.q}


class MKPItemsACO(ProblemACO):
    """PH_items facade (mkp_transformer/aco.py; ``deepaco_tpu/aco/problems/
    mkp.py:196-233``) over one instance: ``price [n]``, ``weight [n, m]``
    (normalised, ``capacity`` 1), a ``heuristic [n]`` (default
    :func:`mkp_prior`), extended with the dummy item; the pheromone is the
    vector ``[n+1]``. ``run`` constructs through K7r's untraced forward
    (``sample`` its traced forward) and deposits on every picked item;
    ``best_cost`` is the total prize, maximized."""

    def __init__(self, price, weight, n_ants: int = 20, decay: float = 0.9,
                 alpha: float = 1.0, beta: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, capacity: float = 1.0,
                 seed: int = 0, *, device=None, generator: torch.Generator | None = None):
        dev = resolve_device(device)
        price, weight = as_instance(price, dev), as_instance(weight, dev)
        n = price.shape[-1]
        self.capacity = float(capacity)
        heuristic = mkp_prior(price, weight) if heuristic is None else as_instance(heuristic, dev)
        self.prize, self.weight, self.heuristic = extend_mkp(price, weight, heu_vec=heuristic)
        self.q = 1.0 / price.sum(dim=-1)
        cfg = ACOConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                        elitist=elitist, min_max=min_max, maximize=True,
                        vector_pheromone=True, mm_static_max=20.0 if min_max else None)
        super().__init__(cfg, n + 1, n + 1, seed, device=dev, generator=generator)

    def spec(self, tau, heu):
        cfg = self.cfg
        return mkp_items_spec(tau, heu, self.weight, self.capacity, cfg.n_ants, cfg.alpha,
                              cfg.beta)

    def cost(self, paths):
        return mkp_objective(self.prize, paths)

    def extras(self) -> dict:
        return {"q": self.q}
