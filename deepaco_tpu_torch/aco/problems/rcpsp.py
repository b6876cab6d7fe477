"""RCPSP plug-in: activity-list construction, the serial schedule
generation scheme (SSGS) and the elitist MAX-MIN search (counterpart of
``deepaco_tpu/aco/problems/rcpsp.py``), batched over instances.

Construction (rcpsp/aco.py:183-206): every ant starts at activity 0; an
activity is open once it is unvisited and all its predecessors are
visited. Selection is the direct evaluation ``(phe^a heu^b)[cur]``, the
gamma-discounted summation over the visited prefix, ``((S m)^a)
(heu[cur]^b)`` with the running sum ``S <- gamma S + phe[action]``, or a
blend of both by ``c``: the spec's ``probs_fn``. The direct evaluation
alone (``RCPSPConfig.direct_only``, every entry point's default) is SOP's
state on another score: the spec carries ``fused = (where(p > 0, log(max(p,
1e-30)), -1e30), SOP's shape with prec = adj^T)``, the engine's logits bit
for bit. The blend (``gamma >= 0.05`` and ``c < 1``) with ``alpha > 0``
carries ``fused = (phe^a heu^b, the "blend" shape)``: SOP's state with the
running sum beside it, the probabilities computed inside the rollout as
``probs_fn`` computes them. Either way its rollouts take K7r's one launch
(one each way in training). At ``alpha <= 0`` ``(S m)^alpha`` is not 0 at
a closed activity (``0 ** 0 = 1``), so the step loop lets an ant pick a
visited one again, which K7r's state does not follow: that configuration
keeps one pick a step (K7 on the card). State: ``(cur [B, A], visited [B,
A, n], indeg [B, A, n], s_sum [B, A, n])``.

Decoding: SSGS over each ant's activity list with a ``[B, A, T, m]`` int32
resource timeline (``T = t_max``), in PyTorch on every device; its starts
equal the JAX package's bit for bit. The update (rcpsp/aco.py:221-256):
evaporate, then the best-so-far path deposits ``q/best`` and the
iteration-best ``q/it_cost`` (``elitist``) or every ant ``q/cost``, all in
one deposit (K8 on the card, directed, no wraparound); under ``min_max``
tau is clamped into ``[tau_min, tau_max]`` with ``tau_max = q n / best``
set on each improvement.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.aco.engine import NEG_INF, RolloutSpec, rollout
from deepaco_tpu_torch.aco.problems.tsp import row_gatherer
from deepaco_tpu_torch.core.rcpsp import RCPSPData, default_rcpsp_heuristic, stack_rcpsp
from deepaco_tpu_torch.device import resolve_device
from deepaco_tpu_torch.ops.pick import fused_pick
from deepaco_tpu_torch.utils.metrics import phase


class RCPSPConfig(NamedTuple):
    """The reference's defaults (rcpsp/aco.py:100-112): 5 ants, decay
    0.975, alpha 1, beta 2, gamma 0, c 0.6, Q 1, tau_min 0.1; ``backfill``
    picks the decoder (:func:`ssgs_schedule`)."""

    n_ants: int = 5
    decay: float = 0.975
    alpha: float = 1.0
    beta: float = 2.0
    gamma: float = 0.0
    c: float = 0.6
    q: float = 1.0
    tau_min: float = 0.1
    elitist: bool = False
    min_max: bool = False
    backfill: bool = False

    @property
    def direct_only(self) -> bool:
        """The reference evaluates directly when gamma < 0.05 or c == 1."""
        return self.gamma < 0.05 or self.c == 1.0


def rcpsp_spec(phe: torch.Tensor, heu: torch.Tensor, data: RCPSPData,
               cfg: RCPSPConfig) -> RolloutSpec:
    """The engine's plug-in for ``phe, heu [B, n, n]`` and the batched
    instances ``data``; its ``probs_fn`` stays differentiable in ``phe``
    and ``heu``. Under ``cfg.direct_only`` it also carries SOP's shape on
    ``adj^T`` and the score ``where(p > 0, log(max(p, 1e-30)), -1e30)``
    (differentiable in both too) for the engine's one-launch route (K7r):
    an activity is open when unvisited and its count of unvisited
    predecessors is 0, SOP's rule, and the mask multiplies ``p`` by 1.
    Otherwise, with ``alpha > 0``, it carries the score ``probmat`` and the
    ``"blend"`` shape (``phe``, ``heu``, ``beta``, ``gamma``, ``c``,
    ``alpha``), whose rollout computes ``probs_fn``'s logits and mask ``p >
    0`` itself; at ``alpha <= 0`` it carries none."""
    from deepaco_tpu_torch.ops.rollout import RolloutShape

    b, n, _ = phe.shape
    a, dev = cfg.n_ants, phe.device
    probmat = (phe ** cfg.alpha) * (heu ** cfg.beta)
    rows = row_gatherer(b, n, dev)
    adj = data.adj.to(dev)

    def start(_generator: torch.Generator) -> torch.Tensor:
        return torch.zeros((b, a), dtype=torch.int64, device=dev)

    def init(start_nodes: torch.Tensor):
        visited = torch.zeros((b, a, n), dtype=torch.bool, device=dev)
        visited[..., 0] = True
        indeg = (adj.sum(dim=-2) - adj[:, 0])[:, None, :].expand(b, a, n)
        s_sum = phe[:, 0][:, None, :].expand(b, a, n)
        return start_nodes, visited, indeg, s_sum

    def mask(state) -> torch.Tensor:
        _, visited, indeg, _ = state
        return (~visited & (indeg == 0)).to(phe.dtype)

    def probs_fn(state) -> torch.Tensor:
        cur, _, _, s_sum = state
        m = mask(state)
        direct = rows(probmat, cur) * m
        if cfg.direct_only:
            return direct
        summation = ((s_sum * m) ** cfg.alpha) * (rows(heu, cur) ** cfg.beta)
        if cfg.c == 0.0:
            return summation
        return cfg.c * direct + (1.0 - cfg.c) * summation

    def step(state, actions):
        _, visited, indeg, s_sum = state
        hit = torch.arange(n, device=dev) == actions[..., None]
        return (actions, visited | hit, indeg - rows(adj, actions),
                cfg.gamma * s_sum + rows(phe, actions))

    fused = None
    if cfg.direct_only:
        score = torch.where(probmat > 0, torch.log(torch.clamp(probmat, min=1e-30)), NEG_INF)
        fused = (score, RolloutShape("sop", prec=adj.transpose(-1, -2)))
    elif cfg.alpha > 0:
        fused = (probmat, RolloutShape("blend", prec=adj.transpose(-1, -2), phe=phe, heu=heu,
                                       beta=cfg.beta, gamma=cfg.gamma, c=cfg.c,
                                       alpha=cfg.alpha))
    return RolloutSpec(horizon=n - 1, start=start, init=init,
                       prob_rows=lambda state: (rows(phe, state[0]), rows(heu, state[0])),
                       mask=mask, step=step, probs_fn=probs_fn, fused=fused)


def _take(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``t[b, j[b, a]]`` for ``t [B, n, ...]`` and ``j [B, A]``."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], j]


def ssgs_schedule(data: RCPSPData, sequences: torch.Tensor,
                  backfill: bool = False) -> torch.Tensor:
    """Serial schedule generation: start times ``[B, A, n]`` int32 of the
    activity lists ``sequences [B, A, n]`` (each topological) of the
    batched instances ``data``, on a ``[B, A, t_max, m]`` resource timeline.

    Each activity in turn starts at the first time ``t*`` from which its
    whole duration fits the remaining capacity, no earlier than its
    predecessors' ends and its earliest start. ``backfill=False`` is the
    reference's decoder (rcpsp_inst.py:57-91): ``t*`` is also no earlier
    than the latest start on any resource the activity uses (the
    per-resource ``last_event``, advanced only where it requests), and is
    clamped to ``latest_finish - duration`` (rcpsp/aco.py:30,55);
    ``backfill=True`` drops both and fills gaps."""
    b, a, n = sequences.shape
    dev = sequences.device
    t_max, m = data.t_max, data.m
    dur_all, res_all = data.duration.to(dev), data.resources.to(dev)
    es_all, lf_all = data.earliest_start.to(dev), data.latest_finish.to(dev)
    cap = data.capacity.to(dev)[:, None, None, :]
    preds_all = data.adj.to(dev).transpose(-1, -2) > 0          # row j: j's predecessors
    i32 = torch.int32
    usage = torch.zeros((b, a, t_max, m), dtype=i32, device=dev)
    end_time = torch.zeros((b, a, n), dtype=i32, device=dev)
    start = torch.zeros((b, a, n), dtype=i32, device=dev)
    last_event = torch.zeros((b, a, m), dtype=i32, device=dev)
    t_starts = torch.arange(t_max + 1, dtype=i32, device=dev)
    t_slots = t_starts[:-1]
    zero = torch.zeros((), dtype=i32, device=dev)
    csum = torch.zeros((b, a, t_max + 1), dtype=i32, device=dev)
    for p in range(n):
        j = sequences[..., p].long()
        dur, req = _take(dur_all, j), _take(res_all, j)
        est = torch.maximum(torch.where(_take(preds_all, j), end_time, zero).amax(dim=-1),
                            _take(es_all, j))
        if not backfill:
            est = torch.maximum(est, torch.where(req > 0, last_event, zero).amax(dim=-1))
        viol = ((usage + req[:, :, None, :]) > cap).any(dim=-1)
        csum[..., 1:] = torch.cumsum(viol, dim=-1, dtype=i32)
        end_idx = torch.clamp(t_starts + dur[..., None], max=t_max)
        win_bad = (torch.gather(csum, -1, end_idx.long()) - csum) > 0
        ok = ~win_bad & (t_starts >= est[..., None]) & (t_starts + dur[..., None] <= t_max)
        t_star = torch.argmax(ok.to(torch.uint8), dim=-1).to(i32)
        if not backfill:
            t_star = torch.minimum(t_star, _take(lf_all, j) - dur)
        in_win = (t_slots >= t_star[..., None]) & (t_slots < (t_star + dur)[..., None])
        usage = usage + in_win[..., None].to(i32) * req[:, :, None, :]
        end_time.scatter_(-1, j[..., None], (t_star + dur)[..., None])
        start.scatter_(-1, j[..., None], t_star[..., None])
        last_event = torch.where(req > 0, torch.maximum(last_event, t_star[..., None]),
                                 last_event)
    return start


def makespans(data: RCPSPData, paths: torch.Tensor, backfill: bool = False) -> torch.Tensor:
    """Every ant's makespan ``[B, A]`` f32, the start of the sink, from the
    activity lists ``paths [B, n, A]`` (update_cost, rcpsp/aco.py:221-236)."""
    return ssgs_schedule(data, paths.transpose(-1, -2), backfill)[..., -1].float()


class RCPSPSearchState(NamedTuple):
    """Per instance: ``tau [B, n, n]``, ``tau_max [B]`` (inf until a best),
    ``best_cost [B]`` and ``best_path [B, n]``."""

    tau: torch.Tensor
    tau_max: torch.Tensor
    best_cost: torch.Tensor
    best_path: torch.Tensor


def init_rcpsp_search(b: int, n: int, cfg: RCPSPConfig, *, device=None,
                      tau: torch.Tensor | None = None) -> RCPSPSearchState:
    """Tau of ones (``tau_min`` under MAX-MIN, rcpsp/aco.py:118-121) unless
    given, no bound, no best."""
    if tau is None:
        tau = torch.full((b, n, n), cfg.tau_min if cfg.min_max else 1.0, device=device)
    inf = torch.full((b,), math.inf, device=device)
    return RCPSPSearchState(tau, inf, inf.clone(),
                            torch.zeros((b, n), dtype=torch.int64, device=device))


def rcpsp_update(cfg: RCPSPConfig, state: RCPSPSearchState, paths: torch.Tensor,
                 costs: torch.Tensor, *, deposit: Callable = ph.deposit) -> RCPSPSearchState:
    """The best-so-far scheme (rcpsp/aco.py:238-256) for ``paths [B, n, A]``
    and ``costs [B, A]``: track the best (the first cheapest ant improves it
    when strictly cheaper, and sets ``tau_max = q n / best``), evaporate,
    one deposit of the best path's ``q/best`` and the iteration-best's
    ``q/it_cost`` (``elitist``) or every ant's ``q/cost``, then the MAX-MIN
    clamp."""
    b, n, _ = paths.shape
    it_best = torch.argmin(costs, dim=-1)
    it_cost = costs.gather(-1, it_best[:, None])[:, 0]
    it_path = paths.gather(-1, it_best[:, None, None].expand(b, n, 1))[..., 0]
    improved = it_cost < state.best_cost
    best_cost = torch.where(improved, it_cost, state.best_cost)
    best_path = torch.where(improved[:, None], it_path, state.best_path)
    tau_max = torch.where(improved, cfg.q * n / best_cost, state.tau_max)
    if cfg.elitist:
        dep_paths = torch.stack([best_path, it_path], dim=-1)
        amounts = torch.stack([cfg.q / best_cost, cfg.q / it_cost], dim=-1)
    else:
        dep_paths = torch.cat([best_path[..., None], paths], dim=-1)
        amounts = torch.cat([(cfg.q / best_cost)[:, None], cfg.q / costs], dim=-1)
    tau = deposit(state.tau * cfg.decay, dep_paths, amounts, cyclic=False, symmetric=False)
    if cfg.min_max:
        tau = torch.clamp(torch.minimum(tau, tau_max[:, None, None]), min=cfg.tau_min)
    return RCPSPSearchState(tau, tau_max, best_cost, best_path)


@torch.no_grad()
def rcpsp_iteration(data: RCPSPData, heu: torch.Tensor, cfg: RCPSPConfig,
                    state: RCPSPSearchState, generator: torch.Generator, *,
                    pick: Callable = fused_pick, deposit: Callable = ph.deposit,
                    timer: Callable | None = None) -> RCPSPSearchState:
    """One iteration over the batched instances: construct (K7r's untraced
    forward once on the card; at ``alpha <= 0`` off the direct evaluation a
    ``pick`` a step, K7), decode, update (one ``deposit``, K8 on the
    card); ``timer(name)`` wraps the phases ``"construction"``,
    ``"decode"`` and ``"update"``."""
    with phase("construction", timer):
        paths = rollout(rcpsp_spec(state.tau, heu, data, cfg), generator, pick=pick).paths
    with phase("decode", timer):
        costs = makespans(data, paths, cfg.backfill)
    with phase("update", timer):
        return rcpsp_update(cfg, state, paths, costs, deposit=deposit)


class RCPSPACO:
    """Reference-style facade (ACO_RCPSP, rcpsp/aco.py:96-256;
    ``deepaco_tpu/aco/problems/rcpsp.py:201-260``) over one instance
    (``RCPSPData`` without a batch axis), on ``device`` (``cuda`` by
    default), drawing from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, data: RCPSPData, n_ants: int = 5, decay: float = 0.975,
                 alpha: float = 1.0, beta: float = 2.0, gamma: float = 0.0,
                 c: float = 0.6, q: float = 1.0, elitist: bool = False,
                 min_max: bool = False, heuristic=None, pheromone=None,
                 tau_min: float = 0.1, seed: int = 0, backfill: bool = False, *,
                 device=None):
        dev = resolve_device(device)
        self.data = stack_rcpsp([data], device=dev)
        self.cfg = RCPSPConfig(n_ants=n_ants, decay=decay, alpha=alpha, beta=beta,
                               gamma=gamma, c=c, q=q, tau_min=tau_min, elitist=elitist,
                               min_max=min_max, backfill=backfill)
        self.heuristic = (default_rcpsp_heuristic(self.data) if heuristic is None
                          else torch.as_tensor(heuristic, dtype=torch.float32,
                                               device=dev).reshape(1, data.n, data.n))
        tau = None
        if pheromone is not None:
            tau = torch.as_tensor(pheromone, dtype=torch.float32, device=dev)[None].clone()
        self.state = init_rcpsp_search(1, data.n, self.cfg, device=dev, tau=tau)
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    def sample(self):
        """``(costs [A], log_probs [n-1, A], paths [n, A])`` of one
        construction on the current pheromone (rcpsp/aco.py:215-219), the
        log-probabilities differentiable in the heuristic."""
        ro = rollout(rcpsp_spec(self.state.tau, self.heuristic, self.data, self.cfg),
                     self.generator, require_prob=True)
        return makespans(self.data, ro.paths, self.cfg.backfill)[0], ro.log_probs[0], \
            ro.paths[0]

    def run(self, n_iterations: int) -> torch.Tensor:
        """``n_iterations`` of the search; returns the best makespan."""
        heu = self.heuristic.detach()
        for _ in range(n_iterations):
            self.state = rcpsp_iteration(self.data, heu, self.cfg, self.state,
                                         self.generator)
        return self.state.best_cost[0]

    @property
    def best_solution(self):
        """``(activity list, start times, makespan)`` of the best so far, as
        numpy arrays and a float."""
        route = self.state.best_path[0]
        schedule = ssgs_schedule(self.data, route[None, None], self.cfg.backfill)[0, 0]
        return (route.cpu().numpy(), schedule.cpu().numpy(),
                float(self.state.best_cost[0]))

