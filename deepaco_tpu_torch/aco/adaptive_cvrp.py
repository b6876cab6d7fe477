"""The reference's adaptive-elitist Ant System for CVRP, its classic-ACO
comparison engine (counterpart of ``deepaco_tpu/aco/adaptive_cvrp.py:35-242``;
reference cvrp/aco.py:24-104, 207-383).

Around the construction loop of :class:`~deepaco_tpu_torch.aco.problems.cvrp.CVRPACO`
(forced elitist) it runs three host phases:

* improvement: each subroute of the 5 cheapest ants rebuilt by cheapest
  insertion, kept when the ant's whole solution gets shorter;
* intensification: on a new best, ``count`` random N1 relocations (a
  customer moved to its best place in another subroute with room for it)
  and the best one applied when it shortens the best solution; the N2
  random swap neighbourhood is there too, though the loop never calls it;
* diversification: after an iteration that found no better solution,
  ``tau * decay * 0.5 + 0.01``, then each route of the elite pool (the last
  5 bests, newest first) deposits ``1 / cost`` along its edges.

The construction is the facade's (K7c on the card where it takes N) and the
update of an improving iteration the runner's elitist ``search_update``
(K8); diversification adds with ``index_put_(accumulate=True)``, as the JAX
package adds with ``.at[].add`` outside any kernel. The host phases are
numpy in float64 with the instance's ``np.random.default_rng(seed)``, so
that from the same paths, costs, pheromone and seed they give the JAX
package's results exactly. Paths are ``[L, A]`` on the host, as the JAX
facade's; the port's construction gives ``[1, L, A]``, L = 2(N-1)+1.
"""
from __future__ import annotations

import numpy as np
import torch

from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO
from deepaco_tpu_torch.aco.runner import search_update


def get_subroutes(path, end_with_zero: bool = True) -> list[np.ndarray]:
    """The depot-delimited subroutes of ``path`` that visit a customer
    (cvrp/aco.py:209-217), each from its leading 0, with the closing 0
    when ``end_with_zero``."""
    path = np.asarray(path)
    zeros = np.nonzero(path == 0)[0]
    return [path[a:b + 1] if end_with_zero else path[a:b]
            for a, b in zip(zeros, zeros[1:]) if b - a > 1]


def merge_subroutes(subroutes, length: int) -> np.ndarray:
    """0-led, 0-closed subroutes back into one path of ``length`` entries,
    padded with the depot (cvrp/aco.py:240-251); routes with no customer
    are dropped."""
    route = np.zeros(length, np.int64)
    i = 0
    for r in subroutes:
        seg = np.asarray(r)[:-1]
        if len(seg) > 1:
            route[i:i + len(seg)] = seg
            i += len(seg)
    return route


def insertion_single(dist: np.ndarray, route, node: int) -> tuple[int, float]:
    """The cheapest edge ``(route[p], route[p+1])`` of a 0...0 route to put
    ``node`` into (cvrp/aco.py:219-224): ``(p, added length)``."""
    route = np.asarray(route)
    p1, p2 = route[:-1], route[1:]
    deltas = dist[p1, node] + dist[node, p2] - dist[p1, p2]
    best = int(np.argmin(deltas))
    return best, float(deltas[best])


def insertion(dist: np.ndarray, nodes) -> tuple[list[int], float]:
    """Cheapest-insertion construction of one subroute over ``nodes`` (its
    depot first) (cvrp/aco.py:226-238): ``(0...0 route, length)``."""
    nodes = np.asarray(nodes)
    route = [int(nodes[0])] * 2
    cost = 0.0
    for node in nodes[1:]:
        pos, dc = insertion_single(dist, route, int(node))
        route.insert(pos + 1, int(node))
        cost += dc
    return route, cost


def _without(route: np.ndarray, i: int) -> np.ndarray:
    return np.concatenate([route[:i], route[i + 1:]])


def _with(route: np.ndarray, i: int, node) -> np.ndarray:
    return np.concatenate([route[:i], [node], route[i:]])


def _removal(dist: np.ndarray, route: np.ndarray, i: int) -> float:
    """The change of length when ``route[i]`` leaves its route, ``d(pred,
    next) - d(pred, node) - d(node, next)``."""
    pred, node, nxt = route[i - 1], route[i], route[i + 1]
    return dist[pred, nxt] - dist[pred, node] - dist[node, nxt]


class AdaptiveCVRPACO(CVRPACO):
    """The reference's ``adaptive=True`` engine over one instance: elitist
    (forced, cvrp/aco.py:37), an elite pool of ``pool_size`` routes, and the
    host phases of the module note, drawn from ``np.random.default_rng(seed)``;
    the construction draws from the facade's generator. Everything else is
    :class:`CVRPACO`'s."""

    def __init__(self, distances, demand, capacity: float = 50.0, n_ants: int = 20,
                 pool_size: int = 5, seed: int = 0, **kwargs):
        kwargs["elitist"] = True
        super().__init__(distances, demand, capacity, n_ants=n_ants, seed=seed, **kwargs)
        self.pool_size = pool_size
        self.elite_pool: list[tuple[np.ndarray, float]] = []
        self._np_rng = np.random.default_rng(seed)
        self._dist_np = self.distances[0].cpu().numpy().astype(np.float64)
        self._dem_np = self.demand[0].cpu().numpy().astype(np.float64)

    # ---------------------------------------------------------- phases ----
    def improvement_phase(self, paths: np.ndarray, costs: np.ndarray, topk: int = 5):
        """Each subroute of the ``topk`` cheapest ants (every ant when
        ``topk`` is 0 or covers them all) rebuilt by :func:`insertion`; an
        ant takes the rebuilt solution when it is shorter. ``paths [L, A]``
        and ``costs [A]`` change in place and are returned."""
        a = paths.shape[1]
        idx = range(a) if topk <= 0 or topk >= a else np.argsort(costs)[:topk]
        for i in idx:
            rebuilt = [insertion(self._dist_np, r)
                       for r in get_subroutes(paths[:, i], end_with_zero=False)]
            new_cost = sum((c for _, c in rebuilt), 0.0)
            if new_cost < costs[i]:
                paths[:, i] = merge_subroutes([r + [0] for r, _ in rebuilt], paths.shape[0])
                costs[i] = new_cost
        return paths, costs

    def n1_neighbourhood(self, subroutes, demands: np.ndarray, count: int = 5):
        """``count`` random relocations: a random customer of a random
        subroute, tried at its best place in every other subroute with room
        for it. Returns the subroutes after the best move that shortens the
        solution and its change of length, or ``(None, 0.0)``."""
        dist, dem = self._dist_np, self._dem_np
        best, best_delta = None, 0.0
        for _ in range(count):
            sri = int(self._np_rng.integers(len(subroutes)))
            route = subroutes[sri]
            if len(route) < 3:
                continue
            sni = int(self._np_rng.integers(1, len(route) - 1))
            node = route[sni]
            room = demands + dem[node] <= self.capacity
            room[sri] = False
            if not room.any():
                continue
            removal = _removal(dist, route, sni)
            for i in np.nonzero(room)[0]:
                loc, ins = insertion_single(dist, subroutes[i], int(node))
                if removal + ins < best_delta:
                    best, best_delta = (sri, sni, int(i), loc + 1), removal + ins
        if best is None:
            return None, 0.0
        sri, sni, tri, tni = best
        subroutes = list(subroutes)
        node = subroutes[sri][sni]
        subroutes[tri] = _with(subroutes[tri], tni, node)
        if len(subroutes[sri]) == 3:
            del subroutes[sri]
        else:
            subroutes[sri] = _without(subroutes[sri], sni)
        return subroutes, best_delta

    def n2_neighbourhood(self, subroutes, demands: np.ndarray, count: int = 5):
        """``count`` random swaps between two random subroutes (cvrp/aco.py:
        287-334): a random customer of the first and a random one of the
        second that the loads allow, each put at its best place in the
        other route. Returns the subroutes after the best swap that shortens
        the solution and its change of length, or ``(None, 0.0)``."""
        dist, dem = self._dist_np, self._dem_np
        best, best_delta = None, 0.0
        if len(subroutes) < 2:
            return None, 0.0
        for _ in range(count):
            i1, i2 = self._np_rng.choice(len(subroutes), 2, replace=False)
            sr1, sr2 = subroutes[i1], subroutes[i2]
            if len(sr1) < 3 or len(sr2) < 3:
                continue
            n1i = int(self._np_rng.integers(1, len(sr1) - 1))
            node1 = sr1[n1i]
            ok = ((demands[i2] + dem[node1] - dem[sr2] <= self.capacity)
                  & (demands[i1] - dem[node1] + dem[sr2] <= self.capacity))
            ok[0] = ok[-1] = False
            if not ok.any():
                continue
            delta = _removal(dist, sr1, n1i)
            sr1_mod = _without(sr1, n1i)
            n2i = int(self._np_rng.choice(np.nonzero(ok)[0]))
            node2 = sr2[n2i]
            delta += _removal(dist, sr2, n2i)
            sr2_mod = _without(sr2, n2i)
            loc1, ins1 = insertion_single(dist, sr2_mod, int(node1))
            delta += ins1
            sr2_mod = _with(sr2_mod, loc1 + 1, node1)
            loc2, ins2 = insertion_single(dist, sr1_mod, int(node2))
            delta += ins2
            sr1_mod = _with(sr1_mod, loc2 + 1, node2)
            if delta < best_delta:
                best, best_delta = (int(i1), sr1_mod, int(i2), sr2_mod), delta
        if best is None:
            return None, 0.0
        i1, sr1, i2, sr2 = best
        subroutes = list(subroutes)
        subroutes[i1], subroutes[i2] = sr1, sr2
        return subroutes, best_delta

    def intensification_phase(self) -> None:
        """N1 on the best solution; an improving move replaces the best path
        and takes its change off the best cost."""
        best = self.best_path.cpu().numpy()
        subroutes = get_subroutes(best, end_with_zero=True)
        demands = np.array([self._dem_np[r].sum() for r in subroutes])
        subs, delta = self.n1_neighbourhood(subroutes, demands)
        if subs is not None and delta < 0.0:
            new_path = merge_subroutes(subs, len(best))
            dev = self.state.best_path.device
            self.state = self.state._replace(
                best_path=torch.as_tensor(new_path, device=dev)[None],
                best_cost=torch.tensor([float(self.best_cost) + delta], dtype=torch.float32,
                                       device=dev))

    def diversification_phase(self) -> None:
        """``tau * decay * 0.5 + 0.01``, then ``1 / cost`` added along each
        elite route's edges, in pool order (repeated edges add each time)."""
        tau = self.state.phe.tau * (self.cfg.decay * 0.5) + 0.01
        for path, cost in self.elite_pool:
            u = torch.as_tensor(path[:-1], device=tau.device)
            v = torch.as_tensor(path[1:], device=tau.device)
            tau.index_put_((torch.zeros_like(u), u, v),
                           torch.full(u.shape, 1.0 / cost, dtype=tau.dtype, device=tau.device),
                           accumulate=True)
        self.state = self.state._replace(phe=self.state.phe._replace(tau=tau))

    # ------------------------------------------------------------- loop ----
    @torch.no_grad()
    def run(self, n_iterations: int) -> torch.Tensor:
        """``n_iterations`` of construction, improvement, then the elitist
        update with intensification and a new elite route when the
        iteration found a better solution, else diversification. Returns
        the best cost so far."""
        heu = self.heuristic.detach()
        dev = heu.device
        for _ in range(n_iterations):
            built = self.construct(self.state.phe.tau, heu, self.generator)
            paths = built[0].cpu().numpy().copy()
            costs = self.cost(built)[0].cpu().numpy().copy()
            paths, costs = self.improvement_phase(paths, costs)
            if costs.min() < float(self.best_cost):
                self.state = search_update(self.cfg, self.state,
                                           torch.as_tensor(paths, device=dev)[None],
                                           torch.as_tensor(costs, device=dev)[None])
                self.intensification_phase()
                self.elite_pool.insert(0, (self.best_path.cpu().numpy().copy(),
                                           float(self.best_cost)))
                del self.elite_pool[self.pool_size:]
            else:
                self.diversification_phase()
        return self.best_cost
