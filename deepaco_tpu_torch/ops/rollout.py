"""A whole sampled construction, every step of every ant in one launch: kernel
K7r, the construction scan ``deepaco_tpu/aco/engine.py:104-129`` (``rollout``)
whose step is ``deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas``. In
training it also writes each step's log-probability, and its backward is one
more launch; in inference it writes the paths alone.

Over ``score [B, N, N]`` f32 (``score_matrix(tau, heu, alpha, beta)``,
differentiable), ``start [B, A]`` and ``noise [T, B, A, N]``, each ant at
each step ``t < T``

    open_t   = TSP:  not visited_t(c)
               CVRP: visit_mask_t(c) and demand[c] <= capacity - used_t
               SOP:  not visited_t(c) and no predecessor of c unvisited
               MKP:  c real: not visited_t(c) and knapsack_t + weight[c] <=
                     capacity in every dimension; the dummy: no real c open
               ITEMS: MKP's, on one score row ``score [B, N]`` an instance
               OP:   c real: not visited_t(c) and, at every node s <= t the
                     ant stood on but the dummy, (travel_s + dist[cur_s, c])
                     + dist[c, 0] <= max_len; the dummy: no real c open
               PCTSP: c > 0: not visited_t(c) and no depot pick yet; the
                     depot: the prize collected rose above min_prizes, or
                     every customer was visited, at a pick before t
               BLEND: SOP's, with m_t = open_t as 0/1 and the running sum
                     S_0 = phe[b, a_0, :], S_t = gamma S_{t-1} + phe[b, a_t, :]:
                     p_t = c (score[b, cur_t, :] m_t)
                           + (1 - c) ((S_t m_t)^alpha heu[b, cur_t, :]^beta)
                     (c = 0: the second term alone)
    logits_t = where(open_t, score[b, cur_t, :], -1e30)      ITEMS: score[b, :]
               BLEND: where(p_t > 0, log(max(p_t, 1e-30)), -1e30), below
    a_{t+1}  = first argmax(logits_t + noise[t])      NaN above every number
    logp_t   = logits_t[a_{t+1}] - logsumexp(logits_t)

with the state of the plug-ins of ``aco/problems/``: ``tsp.py`` (and
``smtwtp.py``, TSP's walk from the dummy job), ``cvrp.py`` (the load
``used`` resets at a depot pick and then adds the pick's demand in f32, and
the depot closes right after a depot pick while customers remain),
``sop.py`` (the count of each node's unvisited predecessors; also
``rcpsp.py``'s direct evaluation, on the score ``where(p > 0, log p,
-1e30)`` and ``prec = adj^T``), ``mkp.py``'s PH_suc plug-in (the knapsack
adds the picked weights in f32, in pick order) and its PH_items plug-in
(ITEMS: the start, the dummy, is no pick), ``op.py`` (the tour length adds
``dist[cur, a]`` in f32 a pick; the mask is cumulative: a column out of
reach once stays shut) and
``pctsp.py`` (the start is no pick; the prize adds in f32 in pick order; a
depot pick parks the ant) and ``rcpsp.py``'s summation blend (BLEND: the
engine's ``probs_fn`` logits and mask ``p > 0``, each product and sum
rounded in the step loop's order). The outputs are ``paths [B, T+1, A]`` (row 0 the start) and
``log_probs [B, T, A]``, as ``engine.Rollout`` holds them. The backward of
``sum(g * log_probs)`` in ``score`` is

    d_score[b, r, c] = sum over (a, t) with cur_t = r of
                       g[b, t, a] * (1[c = a_{t+1}] - softmax(logits_t)[c]) * open_t(c)

and for ITEMS ``d_score [B, N]``, the same terms over every ``(a, t)``. For
BLEND, with ``e_t(c)`` that term (open_t: ``p_t(c) > 0``) and ``dp = e /
p`` where ``p >= 1e-30`` (else 0, the clamp's gradient), the backward
returns ``(d_score, d_heu_pow, d_phe)``, ``heu_pow = heu ** beta``:

    d_score[b, r, c]   += c dp_t(c)                         at cur_t = r
    d_heu_pow[b, r, c] += (1 - c) dp_t(c) (S_t m_t)^alpha   at cur_t = r
    D_t(c) = (1 - c) dp_t(c) heu_pow[cur_t, c] alpha S_t^(alpha - 1) m_t(c) + gamma D_{t+1}(c)
    d_phe[b, r, c]     += D_t(c)                            at cur_t = r

the derivative of the function: 0 where ``m_t = 0`` (``S_t m_t`` does not
depend on ``S_t`` there), where autograd through ``x ** alpha`` at ``x =
0`` gives ``0 * inf = NaN`` for ``alpha < 1``.

- :func:`fused_rollout_plain`: the step loop over ``fused_pick_plain``
  that ``engine.rollout`` runs, with ``noise[t]`` at step ``t``; autograd
  differentiates it. It is K7r's oracle; :func:`fused_rollout_paths_plain`
  its paths.
- :func:`rollout_backward_plain`: the backward above in PyTorch, from the
  paths; the oracle of K7r's backward.
- :func:`fused_rollout`: the training wrapper. A CPU tensor takes the step
  loop over ``fused_pick`` (K7's plain forward and its PyTorch backward, a
  step); a CUDA tensor launches K7r's forward (:func:`fused_rollout_forward`,
  ``csrc/rollout.cu``), and its backward K7r's backward
  (:func:`fused_rollout_backward`), or raises.
- :func:`fused_rollout_paths`: the inference wrapper, the paths alone: the
  same step loop under ``no_grad`` on a CPU tensor, one launch of K7r's
  untraced forward on a CUDA tensor.

K7r takes 2 <= N <= 4096, MKP and ITEMS N <= 2048 with at most 8 dimensions
(:func:`fused_rollout_supported`), BLEND ``alpha > 0`` (at ``alpha = 0``
``(S m)^0`` is 1 at a closed column, which the plug-in then lets the ant
pick again); past that the engine steps through K7.
Every kind's parked steps (a CVRP or PCTSP ant home for good, an MKP, ITEMS
or OP ant on the dummy) are certain, with log-probability 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from deepaco_tpu_torch.ops import _build
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain

NEG_INF = -1e30
FUSED_ROLLOUT_MAX_N = 4096      # 16 columns a thread, 8 warps an ant
MKP_MAX_N, MKP_MAX_DIMS = 2048, 8   # MKP, ITEMS: 8 columns a thread, their weights in registers
ITEMS_SPLIT_TERMS = 256     # ITEMS backward: at least this many (ant, step) terms a block
_KINDS = {"tsp": 0, "cvrp": 1, "sop": 2, "mkp": 3, "op": 4, "pctsp": 5, "items": 6,
          "blend": 7}
_KNAPSACK = ("mkp", "items")
_PRECEDENCE = ("sop", "blend")


class RolloutShape(NamedTuple):
    """Which plug-in's state the rollout keeps: ``"tsp"`` (the visited set);
    ``"cvrp"`` with ``demand [B, N]`` (0 at the depot, node 0) and the
    vehicle's ``capacity``; ``"sop"`` with ``prec [B, N, N]`` (``prec[b, j,
    k]`` nonzero iff ``k`` must precede ``j``, a 0/1 matrix as
    ``sop_spec`` takes it); ``"mkp"`` with ``weight [B, N, m]`` (the dummy
    item's row among them), the ``capacity`` of every dimension and the
    ``dummy`` item's index; ``"items"`` (MKP's PH_items, over ``score [B,
    N]``) with MKP's fields, every ant starting on the dummy, which is no
    pick; ``"op"`` with the extended ``dist [B, N, N]``,
    each instance's ``max_len [B]`` and the ``dummy`` node's index;
    ``"pctsp"`` with ``prizes [B, N]`` (the depot, node 0, first) and the
    gate ``min_prizes`` (compared in f32); ``"blend"`` (RCPSP's summation
    blend) with SOP's ``prec``, the pheromone ``phe [B, N, N]`` that the
    running sum adds, the heuristic ``heu [B, N, N]`` and ``beta`` (the
    step loop raises a step's rows to ``beta``, the card ``heu ** beta``
    once), ``gamma``, ``c`` and ``alpha > 0``; its score is the direct term
    ``phe^alpha heu^beta`` itself, not a logit, and ``phe`` and ``heu``
    take gradients as the score does."""

    kind: str
    demand: torch.Tensor | None = None
    capacity: float = 0.0
    prec: torch.Tensor | None = None
    weight: torch.Tensor | None = None
    dummy: int = -1
    dist: torch.Tensor | None = None
    max_len: torch.Tensor | None = None
    prizes: torch.Tensor | None = None
    min_prizes: float = 0.0
    phe: torch.Tensor | None = None
    heu: torch.Tensor | None = None
    beta: float = 1.0
    gamma: float = 0.0
    c: float = 0.0
    alpha: float = 1.0


TSP_SHAPE = RolloutShape("tsp")


class RolloutTrace(NamedTuple):
    """What K7r's forward leaves for its backward: ``paths [B, T+1, A]``,
    each step's ``lse [B, T, A]`` (the logsumexp of its logits), ``pos [B,
    A, N]`` int32 (the path index where each node was first reached, ``T +
    1`` if never); for CVRP ``rem [B, T, A]`` (``capacity - used_t`` in f32)
    and each ant's depot departures ``dep [B, A, T]`` int32 (``2 t + 1`` if
    no customer was left at step ``t``, else ``2 t``), ``ndep [B, A]`` of
    them; for SOP and BLEND ``ready [B, A, N]`` int32 (the step at which each node's
    last predecessor was visited, ``T + 1`` if never); for MKP the knapsack
    ``knap [B, T, A, m]`` of each step (ITEMS too; its start is no pick,
    so ``pos`` holds each item's pick). For SOP and BLEND ``pos`` also holds the step
    at which a repeat of column 0 shut a column for good. For OP ``pos``
    holds the path index at which each column closed, by a visit or out of
    reach (``T + 1`` if never); for PCTSP, whose start is no pick, the path index of each
    customer's pick, and ``gate [B, A]`` int32 the path index of the pick
    that opened the depot (``T + 1`` if none). Parked steps (a CVRP ant back
    at the depot with every customer served, a PCTSP ant back at the depot,
    an MKP or OP ant on the dummy, whose pick and log-probability 0 are
    certain) are left out."""

    paths: torch.Tensor
    lse: torch.Tensor
    pos: torch.Tensor
    rem: torch.Tensor | None = None
    dep: torch.Tensor | None = None
    ndep: torch.Tensor | None = None
    ready: torch.Tensor | None = None
    knap: torch.Tensor | None = None
    gate: torch.Tensor | None = None


def fused_rollout_supported(n: int, shape: RolloutShape = TSP_SHAPE) -> bool:
    """Whether K7r takes ``n`` nodes of the plug-in ``shape``."""
    if shape.kind in _KNAPSACK:
        return 2 <= n <= MKP_MAX_N and 1 <= shape.weight.shape[-1] <= MKP_MAX_DIMS
    if shape.kind == "blend" and not shape.alpha > 0:
        return False
    return 2 <= n <= FUSED_ROLLOUT_MAX_N


def _succ(prec: torch.Tensor) -> torch.Tensor:
    """``succ [B, N, N]`` uint8 of a SOP precedence matrix: row ``k`` the
    nodes that ``k`` must precede (``prec^T``), 1 where nonzero."""
    return (prec != 0).transpose(-1, -2).contiguous().to(torch.uint8)


class _Walk:
    """The plug-in's state for ``B x A`` ants from ``start [B, A]``: the
    visited set and, for CVRP, the load, the customers left and the depot
    rule, as ``cvrp_construct_plain`` keeps them; for SOP the count of each
    node's unvisited predecessors (BLEND: also the running sum ``S``, rows
    of ``phe`` added as the plug-in adds them); for MKP the knapsack (ITEMS: the start is
    no pick); for OP the tour
    length, with the columns out of reach among the closed ones; for PCTSP
    the prize collected and the depot's gate (the start is no pick)."""

    def __init__(self, start: torch.Tensor, n: int, shape: RolloutShape):
        self.shape = shape
        self.closed = torch.zeros((*start.shape, n), dtype=torch.bool, device=start.device)
        if shape.kind == "cvrp":
            self.left = torch.full(start.shape, n - 1, dtype=torch.int64, device=start.device)
            self.used = torch.zeros(start.shape, dtype=torch.float32, device=start.device)
        elif shape.kind in _PRECEDENCE:
            self.succ = _succ(shape.prec).long()
            self.count = self.succ.sum(dim=1)[:, None, :].expand(*start.shape, n).clone()
            self.S = None
        elif shape.kind in _KNAPSACK:
            self.knap = torch.zeros((*start.shape, shape.weight.shape[-1]),
                                    dtype=torch.float32, device=start.device)
            if shape.kind == "items":
                return
        elif shape.kind == "op":
            self.travel = torch.zeros(start.shape, dtype=torch.float32, device=start.device)
            self.cur = start
            self._reach()
            return
        elif shape.kind == "pctsp":
            self.collected = torch.zeros(start.shape, dtype=torch.float32, device=start.device)
            self.gate = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
            return
        self.step(start)

    def _rows(self, m: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """Row ``act`` of each instance's ``m [B, N, ...]``, ``[B, A, ...]``."""
        return m[torch.arange(m.shape[0], device=m.device)[:, None], act]

    def _reach(self) -> None:
        """OP's mask update at ``cur``: ``cur`` closes, and unless it is the
        dummy every real column that the ant could not reach and still get
        back to the depot within ``max_len`` from there, added in op.py's
        order."""
        dist, dummy = self.shape.dist, self.shape.dummy
        self.closed.scatter_(-1, self.cur[..., None], True)
        trails = self.travel[..., None] + self._rows(dist, self.cur) + dist[..., :, 0][:, None, :]
        out = ~(trails <= self.shape.max_len[:, None, None]) & (self.cur != dummy)[..., None]
        out[..., dummy] = False
        self.closed |= out

    def open(self) -> torch.Tensor:
        """``[B, A, N]`` bool: the columns this step may pick."""
        kind = self.shape.kind
        if kind == "tsp":
            return ~self.closed
        if kind == "pctsp":
            real = ~self.closed
            real[..., 0] = self.gate
            return real
        if kind == "op":
            real = ~self.closed
            real[..., self.shape.dummy] = False
            real[..., self.shape.dummy] = ~real.any(dim=-1)
            return real
        if kind in _PRECEDENCE:
            return ~self.closed & (self.count == 0)
        if kind in _KNAPSACK:
            w, dummy = self.shape.weight, self.shape.dummy
            fit = (self.knap[..., None, :] + w[:, None] <= self.shape.capacity).all(dim=-1)
            real = ~self.closed & fit
            real[..., dummy] = False
            real[..., dummy] = ~real.any(dim=-1)
            return real
        rem = self.shape.capacity - self.used
        return ~self.closed & (self.shape.demand[:, None, :] <= rem[..., None])

    def step(self, act: torch.Tensor) -> None:
        kind = self.shape.kind
        if kind == "op":
            n = self.closed.shape[-1]
            self.travel = self.travel + torch.gather(self.shape.dist.reshape(-1, n * n), 1,
                                                     self.cur * n + act)
            self.cur = act
            self._reach()
            return
        if kind == "pctsp":
            self.collected = self.collected + torch.gather(self.shape.prizes, 1, act)
            self.closed.scatter_(-1, act[..., None], True)
            home = act == 0
            self.closed[..., 1:] |= home[..., None]
            everyone = self.closed[..., 1:].all(dim=-1)
            self.gate |= ~home & ((self.collected > self.shape.min_prizes) | everyone)
            return
        if kind in _PRECEDENCE:
            self.count = self.count - self._rows(self.succ, act)
            if kind == "blend":
                phe = self._rows(self.shape.phe, act)
                self.S = phe if self.S is None else self.shape.gamma * self.S + phe
        elif kind in _KNAPSACK:
            self.knap = self.knap + self._rows(self.shape.weight, act)
        elif kind == "cvrp":
            was = self.closed.gather(-1, act[..., None])[..., 0]
            self.left = self.left - ((act != 0) & ~was).long()
            self.used = torch.where(act == 0, 0.0, self.used) + torch.gather(self.shape.demand,
                                                                            1, act)
        self.closed.scatter_(-1, act[..., None], True)
        if kind == "cvrp":
            self.closed[..., 0] = (act == 0) & (self.left > 0)


def _rows_of(score, shape: RolloutShape, a: int):
    """``rows(score, cur) -> [B, A, N]``: ``score[b, cur, :]`` gathered as
    ``tsp.row_gatherer`` does; ITEMS: the one row ``score[b, :]`` expanded
    over the ants, as ``mkp_items_spec.score_rows`` gives it."""
    from deepaco_tpu_torch.aco.problems.tsp import row_gatherer

    b, n = score.shape[0], score.shape[-1]
    if shape.kind == "items":
        return lambda s, _cur: s[:, None, :].expand(b, a, n)
    return row_gatherer(b, n, score.device)


def _blend_probs(score, walk: _Walk, rows, cur):
    """BLEND's ``p [B, A, N]`` at the ant's state: ``rcpsp_spec``'s
    ``probs_fn`` with each product and sum in its order, so equal to it
    bit for bit where a column is open (elsewhere both are 0, or NaN where
    the step loop multiplies an infinite entry by 0: shut either way).
    ``x ** alpha`` takes ``S`` at the open columns and 1 at the others, so
    that its gradient there is 0 and not ``0 * inf``."""
    shape = walk.shape
    open_ = walk.open()
    m = open_.to(score.dtype)
    base = torch.where(open_, walk.S, 1.0)
    summation = ((base ** shape.alpha) * m) * (rows(shape.heu, cur) ** shape.beta)
    if shape.c == 0.0:
        return summation
    return shape.c * (rows(score, cur) * m) + (1.0 - shape.c) * summation


def _step_inputs(score, walk: _Walk, rows, cur):
    """A step's rows and mask ``[B, A, N]`` as the pick takes them: the
    score's rows under the plug-in's open set or, for BLEND, the engine's
    ``log(max(p, 1e-30))`` under ``p > 0``."""
    if walk.shape.kind == "blend":
        p = _blend_probs(score, walk, rows, cur)
        return torch.log(torch.clamp(p, min=1e-30)), (p > 0).to(p.dtype)
    return rows(score, cur), walk.open().to(score.dtype)


def _step_loop(score, start, noise, shape: RolloutShape, pick):
    """``engine.rollout``'s loop, one ``pick`` a step on the rows
    ``score[b, cur, :]`` (:func:`_rows_of`; BLEND: its probabilities)."""
    b, n = score.shape[0], score.shape[-1]
    a = start.shape[1]
    rows = _rows_of(score, shape, a)
    walk = _Walk(start, n, shape)
    cur, actions, log_probs = start, [start], []
    for t in range(noise.shape[0]):
        step_rows, mask = _step_inputs(score, walk, rows, cur)
        act, logp = pick(step_rows.reshape(b * a, n), mask.reshape(b * a, n),
                         noise[t].reshape(b * a, n))
        cur = act.reshape(b, a)
        walk.step(cur)
        actions.append(cur)
        log_probs.append(logp.reshape(b, a))
    return torch.stack(actions, dim=1), torch.stack(log_probs, dim=1)


def fused_rollout_plain(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                        shape: RolloutShape = TSP_SHAPE):
    """``(paths [B, T+1, A] int64, log_probs [B, T, A])`` in PyTorch, a
    ``fused_pick_plain`` a step; ``log_probs`` differentiable in ``score``."""
    return _step_loop(score, start, noise, shape, fused_pick_plain)


@torch.no_grad()
def fused_rollout_paths_plain(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                              shape: RolloutShape = TSP_SHAPE) -> torch.Tensor:
    """The paths of :func:`fused_rollout_plain`."""
    return _step_loop(score, start, noise, shape, fused_pick_plain)[0]


def rollout_backward_plain(score: torch.Tensor, paths: torch.Tensor, g: torch.Tensor,
                           shape: RolloutShape = TSP_SHAPE):
    """``d_score [B, N, N]`` (ITEMS: ``[B, N]``) of ``sum(g * log_probs)``
    for ``paths [B, T+1, A]`` and ``g [B, T, A]``: the plug-in's state
    replayed along the paths, each step's ``g * (onehot - softmax) * open``
    added into its rows (ITEMS: summed over the ants into the one row);
    BLEND: ``(d_score, d_heu_pow, d_phe)`` (:func:`_blend_backward_plain`)."""
    b, n = score.shape[0], score.shape[-1]
    a = paths.shape[2]
    score = score.detach()
    if shape.kind == "blend":
        return _blend_backward_plain(score, paths, g, shape)
    if shape.kind == "items":
        d = torch.zeros_like(score)
        walk = _Walk(paths[:, 0], n, shape)
        for t in range(paths.shape[1] - 1):
            nxt = paths[:, t + 1]
            open_ = walk.open()
            logits = torch.where(open_, score[:, None, :], NEG_INF)
            rows = -torch.softmax(logits, dim=-1)
            rows.scatter_add_(-1, nxt[..., None], torch.ones_like(rows[..., :1]))
            d += torch.where(open_, rows * g[:, t, :, None], 0.0).sum(dim=1)
            walk.step(nxt)
        return d
    flat = score.reshape(b * n, n)
    inst = torch.arange(b, device=score.device)[:, None] * n
    d = torch.zeros_like(flat)
    walk = _Walk(paths[:, 0], n, shape)
    for t in range(paths.shape[1] - 1):
        cur, nxt = paths[:, t], paths[:, t + 1]
        open_ = walk.open()
        ids = (inst + cur).reshape(-1)
        logits = torch.where(open_, flat.index_select(0, ids).reshape(b, a, n), NEG_INF)
        rows = -torch.softmax(logits, dim=-1)
        rows.scatter_add_(-1, nxt[..., None], torch.ones_like(rows[..., :1]))
        rows = torch.where(open_, rows * g[:, t, :, None], 0.0)
        d.index_add_(0, ids, rows.reshape(b * a, n))
        walk.step(nxt)
    return d.reshape(b, n, n)


def _blend_backward_plain(score, paths, g, shape: RolloutShape):
    """BLEND's backward (the module's formulas): the state and ``S`` replayed
    along the paths, each step's ``dp`` split into the direct and the
    summation terms of its row ``cur_t``, then the running sum's adjoint
    ``D_t = dS_t + gamma D_{t+1}`` added into the rows ``cur_t`` of
    ``d_phe``, last step first."""
    b, n = score.shape[0], score.shape[-1]
    a = paths.shape[2]
    shape = shape._replace(phe=shape.phe.detach(), heu=shape.heu.detach())
    rows = _rows_of(score, shape, a)
    inst = torch.arange(b, device=score.device)[:, None, None] * n + paths
    d_score, d_heu, d_phe = (torch.zeros((b * n, n), device=score.device) for _ in range(3))
    walk, d_s = _Walk(paths[:, 0], n, shape), []
    for t in range(paths.shape[1] - 1):
        cur, nxt = paths[:, t], paths[:, t + 1]
        p = _blend_probs(score, walk, rows, cur)
        live = p > 0
        logits = torch.where(live, torch.log(torch.clamp(p, min=1e-30)), NEG_INF)
        e = -torch.softmax(logits, dim=-1)
        e.scatter_add_(-1, nxt[..., None], torch.ones_like(e[..., :1]))
        e = torch.where(live, e * g[:, t, :, None], 0.0)
        dp = torch.where(p >= 1e-30, e / torch.clamp(p, min=1e-30), 0.0)
        d_sum = dp if shape.c == 0.0 else dp * (1.0 - shape.c)
        open_ = walk.open()
        base = torch.where(open_, walk.S, 1.0)
        ids = inst[:, t].reshape(-1)
        if shape.c != 0.0:
            d_score.index_add_(0, ids, (dp * shape.c).reshape(b * a, n))
        d_heu.index_add_(0, ids, (d_sum * (base ** shape.alpha) * open_).reshape(b * a, n))
        d_base = d_sum * (rows(shape.heu, cur) ** shape.beta)
        if shape.alpha != 1.0:
            d_base = d_base * (shape.alpha * base ** (shape.alpha - 1.0))
        d_s.append(torch.where(open_, d_base, 0.0))
        walk.step(nxt)
    adj = torch.zeros_like(d_s[0]) if d_s else None
    for t in range(len(d_s) - 1, -1, -1):
        adj = d_s[t] + shape.gamma * adj
        d_phe.index_add_(0, inst[:, t].reshape(-1), adj.reshape(b * a, n))
    return tuple(d.reshape(b, n, n) for d in (d_score, d_heu, d_phe))


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _check(name, score, start, noise, shape):
    inputs = {"cvrp": (shape.demand,), "sop": (shape.prec,), "mkp": (shape.weight,),
              "items": (shape.weight,), "op": (shape.dist, shape.max_len),
              "pctsp": (shape.prizes,), "blend": (shape.prec, shape.phe, shape.heu)}
    _build.require_cuda(name, score, start, noise, *inputs.get(shape.kind, ()))
    b, n = score.shape[0], score.shape[-1]
    want = (b, n) if shape.kind == "items" else (b, n, n)
    if score.shape != want or start.dim() != 2 or start.shape[0] != b \
            or noise.shape != (noise.shape[0], b, start.shape[1], n):
        raise ValueError(f"{name}: expected score [B, N, N] (ITEMS: [B, N]), start [B, A] "
                         "and noise [T, B, A, N]")
    if score.dtype != torch.float32 or noise.dtype != torch.float32:
        raise ValueError(f"{name}: K7r takes f32 score and noise")
    if shape.kind not in _KINDS:
        raise ValueError(f"{name}: unknown rollout shape {shape.kind!r}")
    if shape.kind == "cvrp" and (shape.demand.shape != (b, n)
                                 or shape.demand.dtype != torch.float32):
        raise ValueError(f"{name}: expected f32 demand [B, N]")
    if shape.kind in _PRECEDENCE and shape.prec.shape != (b, n, n):
        raise ValueError(f"{name}: expected prec [B, N, N]")
    if shape.kind == "blend" and any(x.shape != (b, n, n) or x.dtype != torch.float32
                                     for x in (shape.phe, shape.heu)):
        raise ValueError(f"{name}: expected f32 phe and heu [B, N, N]")
    if shape.kind in _KNAPSACK and (shape.weight.dim() != 3
                                    or shape.weight.shape[:2] != (b, n)
                                    or shape.weight.dtype != torch.float32
                                    or not 0 <= shape.dummy < n):
        raise ValueError(f"{name}: expected f32 weight [B, N, m] and a dummy item below N")
    if shape.kind == "op" and (shape.dist.shape != (b, n, n) or shape.max_len.shape != (b,)
                               or shape.dist.dtype != torch.float32
                               or shape.max_len.dtype != torch.float32
                               or not 0 <= shape.dummy < n):
        raise ValueError(f"{name}: expected f32 dist [B, N, N], max_len [B] and a dummy "
                         "node below N")
    if shape.kind == "pctsp" and (shape.prizes.shape != (b, n)
                                  or shape.prizes.dtype != torch.float32):
        raise ValueError(f"{name}: expected f32 prizes [B, N]")
    if not fused_rollout_supported(n, shape):
        raise ValueError(f"{name}: K7r takes 2 <= N <= {FUSED_ROLLOUT_MAX_N} (MKP, ITEMS: "
                         f"N <= {MKP_MAX_N}, m <= {MKP_MAX_DIMS}; BLEND: alpha > 0), got "
                         f"N = {n}")


def _heu_pow(shape: RolloutShape, heu_pow: torch.Tensor | None) -> torch.Tensor:
    """BLEND's ``heu ** beta`` as the kernels read it: ``heu_pow`` when
    given, else computed here."""
    if heu_pow is None:
        heu_pow = shape.heu.detach() ** shape.beta
    return heu_pow.detach().contiguous()


def fused_rollout_forward(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                          shape: RolloutShape = TSP_SHAPE, *, warps: int = 0,
                          trace: bool = True, heu_pow: torch.Tensor | None = None):
    """One launch of K7r's forward on CUDA tensors: ``(paths, log_probs,
    trace)``, no gradient; ``trace=False`` writes the paths alone (``(paths,
    None, None)``, the same paths) and counts as a launch of
    :func:`fused_rollout_paths`. ``warps`` (1, 2, 4 or 8 an ant, at least N
    / 512, MKP and ITEMS N / 256; 0 chooses) changes no path. BLEND reads
    ``heu_pow`` (``heu ** beta``, computed when not given)."""
    _check("fused_rollout", score, start, noise, shape)
    b, n = score.shape[0], score.shape[-1]
    a, t = start.shape[1], noise.shape[0]
    dev = score.device
    kind = shape.kind
    m = shape.weight.shape[-1] if kind in _KNAPSACK else 0
    new = lambda dims, dtype, want=True: (torch.empty(dims, dtype=dtype, device=dev)
                                          if trace and want else None)
    paths = torch.empty((b, t + 1, a), dtype=torch.int64, device=dev)
    logp, lse = new((b, t, a), torch.float32), new((b, t, a), torch.float32)
    rt = RolloutTrace(paths, lse, new((b, a, n), torch.int32),
                      new((b, t, a), torch.float32, kind == "cvrp"),
                      new((b, a, t), torch.int32, kind == "cvrp"),
                      new((b, a), torch.int32, kind == "cvrp"),
                      new((b, a, n), torch.int32, kind in _PRECEDENCE),
                      new((b, t, a, m), torch.float32, kind in _KNAPSACK),
                      new((b, a), torch.int32, kind == "pctsp"))
    if b * a > 0:
        # the inputs held contiguous until the launch is queued
        score, start, noise = score.contiguous(), start.contiguous(), noise.contiguous()
        demand = shape.demand.contiguous() if kind == "cvrp" else None
        weight = shape.weight.contiguous() if kind in _KNAPSACK else None
        succ = _succ(shape.prec) if kind in _PRECEDENCE else None
        npred = succ.sum(dim=1, dtype=torch.int32) if kind in _PRECEDENCE else None
        blend = kind == "blend"
        phe = shape.phe.detach().contiguous() if blend else None
        heu_pow = _heu_pow(shape, heu_pow) if blend else None
        dist = shape.dist.contiguous() if kind == "op" else None
        max_len = shape.max_len.contiguous() if kind == "op" else None
        prizes = shape.prizes.contiguous() if kind == "pctsp" else None
        P, I, F = _build.P, _build.I, _build.F
        fn = _build.function("deepaco_rollout_fwd_kind",
                             [P] * 12 + [F] * 6 + [I] * 9 + [P] * 10 + [P])
        rc = fn(score.data_ptr(), start.data_ptr(), noise.data_ptr(), _ptr(demand), _ptr(succ),
                _ptr(npred), _ptr(weight), _ptr(dist), _ptr(max_len), _ptr(prizes), _ptr(phe),
                _ptr(heu_pow), float(shape.capacity), float(shape.min_prizes),
                *_blend_scalars(shape), m, shape.dummy, b, n, a, t,
                _KINDS[kind], int(trace), warps, paths.data_ptr(), _ptr(logp), _ptr(rt.lse),
                _ptr(rt.pos), _ptr(rt.rem), _ptr(rt.dep), _ptr(rt.ndep), _ptr(rt.ready),
                _ptr(rt.knap), _ptr(rt.gate), _build.stream_ptr(dev))
        _build.check(rc, "deepaco_rollout_fwd_kind")
        (fused_rollout if trace else fused_rollout_paths).launches += 1
    return (paths, logp, rt) if trace else (paths, None, None)


def fused_rollout_backward(score: torch.Tensor, trace: RolloutTrace, g: torch.Tensor,
                           shape: RolloutShape = TSP_SHAPE,
                           heu_pow: torch.Tensor | None = None):
    """``d_score [B, N, N]`` (ITEMS: ``[B, N]``) of ``sum(g * log_probs)``
    (BLEND: ``(d_score, d_heu_pow, d_phe)``, ``heu_pow`` as the forward's).
    A CPU tensor takes :func:`rollout_backward_plain` on ``trace.paths``; a
    CUDA tensor launches K7r's backward, a block 32 columns of a row whose
    four warps each sum a fixed share of the ants' steps, then add in order
    (ITEMS: a block 32 columns and a fixed share of the A * T terms, whose
    partial sums a second pass adds in order; BLEND: a first pass, a thread
    an ant's column, replays ``S`` and writes each step's three terms
    ``[3, B, A, T, N]``, the running sum's adjoint summed last step first,
    and the row pass adds the terms of each row's steps, ants in order),
    with no atomics: a repeat gives equal bits."""
    if score.device.type == "cpu":
        return rollout_backward_plain(score, trace.paths, g, shape)
    _build.require_cuda("fused_rollout_backward", score, g, *trace[:3])
    b, n = score.shape[0], score.shape[-1]
    t, a = g.shape[1], g.shape[2]
    if g.shape != (b, t, a) or trace.paths.shape != (b, t + 1, a):
        raise ValueError("fused_rollout_backward: expected g [B, T, A] for paths [B, T+1, A]")
    score, g = score.contiguous(), g.float().contiguous()
    demand = shape.demand.contiguous() if shape.kind == "cvrp" else None
    weight = shape.weight.contiguous() if shape.kind in _KNAPSACK else None
    m = weight.shape[-1] if weight is not None else 0
    d = torch.empty_like(score)
    splits, part = 0, None
    if shape.kind == "items":
        splits = _items_splits(score.device, b, n, a * t)
        part = torch.empty((b, splits, n), dtype=torch.float32, device=score.device)
    blend = shape.kind == "blend"
    phe = shape.phe.detach().contiguous() if blend else None
    heu_pow = _heu_pow(shape, heu_pow) if blend else None
    d_heu, d_phe = (torch.empty_like(score) if blend else None for _ in range(2))
    if blend:
        part = torch.empty((3, b, a, t, n), dtype=torch.float32, device=score.device)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("deepaco_rollout_bwd_kind",
                         [P] * 15 + [F] * 5 + [I] * 8 + [P] * 4 + [P])
    rc = fn(score.data_ptr(), trace.paths.data_ptr(), g.data_ptr(), trace.lse.data_ptr(),
            trace.pos.data_ptr(), _ptr(trace.rem), _ptr(trace.dep), _ptr(trace.ndep),
            _ptr(trace.ready), _ptr(trace.knap), _ptr(trace.gate), _ptr(demand), _ptr(weight),
            _ptr(phe), _ptr(heu_pow), float(shape.capacity), *_blend_scalars(shape), m,
            shape.dummy, b, n, a, t, _KINDS[shape.kind], splits, _ptr(part), d.data_ptr(),
            _ptr(d_heu), _ptr(d_phe), _build.stream_ptr(score.device))
    _build.check(rc, "deepaco_rollout_bwd_kind")
    fused_rollout_backward.launches += 1
    return (d, d_heu, d_phe) if blend else d


def _blend_scalars(shape: RolloutShape):
    """BLEND's ``gamma``, ``c`` and ``alpha`` as the C entries take them,
    and ``1 - c`` rounded from the double, as ``(1.0 - c) * x`` rounds it."""
    return float(shape.gamma), float(shape.c), float(1.0 - shape.c), float(shape.alpha)


def _items_splits(dev, b: int, n: int, terms: int) -> int:
    """ITEMS' backward: the shares of a column's ``A * T`` terms, so that
    the grid holds about two blocks an SM and a block at least
    ITEMS_SPLIT_TERMS terms; a function of the shapes and the card alone, so
    a repeat sums in the same order."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = b * -(-n // 32)
    return max(1, min(-(-terms // ITEMS_SPLIT_TERMS), -(-2 * sms // tiles)))


class FusedRollout(torch.autograd.Function):
    """K7r forward on CUDA tensors, K7r backward for the gradient in
    ``score`` (BLEND: and in ``heu_pow = heu ** beta`` and ``phe``, passed
    after the shape so that autograd sees them); ``start``, ``noise`` and
    the shape take none."""

    @staticmethod
    def forward(ctx, score, start, noise, shape, heu_pow=None, _phe=None):
        paths, logp, trace = fused_rollout_forward(score, start, noise, shape, heu_pow=heu_pow)
        ctx.shape = shape
        ctx.held = [x is not None for x in trace]
        ctx.save_for_backward(score, heu_pow, *(x for x in trace if x is not None))
        ctx.mark_non_differentiable(paths)
        return paths, logp

    @staticmethod
    def backward(ctx, _d_paths, d_logp):
        score, heu_pow, *saved = ctx.saved_tensors
        saved = iter(saved)
        trace = RolloutTrace(*(next(saved) if held else None for held in ctx.held))
        d = fused_rollout_backward(score, trace, d_logp, ctx.shape, heu_pow)
        if ctx.shape.kind == "blend":
            return d[0], None, None, None, d[1], d[2]
        return d, None, None, None


def fused_rollout(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                  shape: RolloutShape = TSP_SHAPE):
    """``(paths [B, T+1, A] int64, log_probs [B, T, A])`` of the rollout,
    ``log_probs`` differentiable in ``score`` (BLEND: and in the shape's
    ``heu`` and ``phe``); on CUDA one K7r launch forward and one
    backward, on the CPU a ``fused_pick`` a step."""
    if score.device.type == "cpu":
        return _step_loop(score, start, noise, shape, fused_pick)
    if shape.kind == "blend":
        return FusedRollout.apply(score, start, noise, shape, shape.heu ** shape.beta,
                                  shape.phe)
    return FusedRollout.apply(score, start, noise, shape)


@torch.no_grad()
def fused_rollout_paths(score: torch.Tensor, start: torch.Tensor, noise: torch.Tensor,
                        shape: RolloutShape = TSP_SHAPE) -> torch.Tensor:
    """The paths ``[B, T+1, A]`` of the rollout, no log-probabilities: on
    CUDA one launch of K7r's untraced forward, on the CPU a ``fused_pick``
    a step (the paths of :func:`fused_rollout`)."""
    if score.device.type == "cpu":
        return _step_loop(score, start, noise, shape, fused_pick)[0]
    return fused_rollout_forward(score, start, noise, shape, trace=False)[0]


fused_rollout.launches = 0
fused_rollout_backward.launches = 0
fused_rollout_paths.launches = 0
