"""Port parity: the adaptive-elitist CVRP baseline (deepaco_tpu_torch/aco/
adaptive_cvrp.py) against the JAX package's. The helpers and the host
phases (improvement, N1, N2, intensification, diversification) on the same
seeded paths, costs, pheromone and rng seed; then tests/test_adaptive_cvrp.py's
checks re-run on the port."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepaco_tpu.aco import adaptive_cvrp as jac
from deepaco_tpu_torch.aco import adaptive_cvrp as ac
from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO, route_cost, validate_routes


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_instance(n=20, seed=0):
    """tests/test_adaptive_cvrp.py's instance: a central depot, n uniform
    customers, demands 1-9, distances with a 1e-10 diagonal."""
    rng = np.random.default_rng(seed)
    coords = np.concatenate([[[0.5, 0.5]], rng.random((n, 2))]).astype(np.float32)
    d = np.linalg.norm(coords[:, None] - coords[None], axis=-1).astype(np.float32)
    np.fill_diagonal(d, 1e-10)
    demand = np.concatenate([[0.0], rng.integers(1, 10, n)]).astype(np.float32)
    return d, demand


def _pair(n=20, seed=0, a=12, rng_seed=7):
    """The two packages' facades on one instance, with one rng seed, and a
    batch of the port's sampled paths ``[L, A]`` with their costs ``[A]``."""
    d, demand = make_instance(n, seed)
    port = ac.AdaptiveCVRPACO(d, demand, n_ants=a, seed=rng_seed, device="cpu")
    ref = jac.AdaptiveCVRPACO(d, demand, n_ants=a, seed=rng_seed)
    paths = port.construct(port.state.phe.tau, port.heuristic, torch.Generator().manual_seed(5))
    costs = port.cost(paths)[0].numpy()
    return port, ref, paths[0].numpy(), costs


def _same_subroutes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_helpers_equal_jax():
    _, _, paths, _ = _pair()
    d = make_instance()[0].astype(np.float64)
    for i in range(paths.shape[1]):
        for end in (True, False):
            _same_subroutes(ac.get_subroutes(paths[:, i], end),
                            jac.get_subroutes(paths[:, i], end))
        subs = ac.get_subroutes(paths[:, i], True)
        np.testing.assert_array_equal(ac.merge_subroutes(subs, paths.shape[0]),
                                      jac.merge_subroutes(subs, paths.shape[0]))
        for r in subs:
            for node in range(1, 21):
                assert ac.insertion_single(d, r, node) == jac.insertion_single(d, r, node)
        for r in ac.get_subroutes(paths[:, i], False):
            assert ac.insertion(d, r) == jac.insertion(d, r)


@pytest.mark.parametrize("topk", [5, 0])
def test_improvement_phase_equals_jax(topk):
    port, ref, paths, costs = _pair()
    got_p, got_c = port.improvement_phase(paths.copy(), costs.copy(), topk)
    want_p, want_c = ref.improvement_phase(paths.copy(), costs.copy(), topk)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_c, want_c)
    assert (got_c < costs).any()


@pytest.mark.parametrize("which", ["n1_neighbourhood", "n2_neighbourhood"])
def test_neighbourhoods_equal_jax(which):
    """Every ant's subroutes through N1 or N2 (20 random moves each), one
    rng stream a side from the same seed: the same moves and changes."""
    port, ref, paths, _ = _pair()
    dem = make_instance()[1].astype(np.float64)
    moved = 0
    for i in range(paths.shape[1]):
        subs = ac.get_subroutes(paths[:, i], True)
        demands = np.array([dem[r].sum() for r in subs])
        got, g_delta = getattr(port, which)(subs, demands.copy(), count=20)
        want, w_delta = getattr(ref, which)(subs, demands.copy(), count=20)
        assert g_delta == w_delta
        if want is None:
            assert got is None
        else:
            _same_subroutes(got, want)
            moved += 1
    assert moved > 0


def test_intensification_and_diversification_equal_jax():
    port, ref, paths, costs = _pair()
    best = int(np.argmin(costs))
    port.state = port.state._replace(best_path=torch.from_numpy(paths[:, best])[None],
                                     best_cost=torch.tensor([costs[best]]))
    ref.state = ref.state._replace(best_path=jnp.asarray(paths[:, best], jnp.int32),
                                   best_cost=jnp.asarray(costs[best], jnp.float32))
    for _ in range(4):
        port.intensification_phase()
        ref.intensification_phase()
        np.testing.assert_array_equal(port.best_path.numpy(), np.asarray(ref.state.best_path))
        assert port.best_cost.item() == float(ref.state.best_cost)
    assert port.best_cost.item() < costs[best]
    tau = 0.5 + np.random.default_rng(1).random(port.state.phe.tau.shape[1:], dtype=np.float32)
    port.state = port.state._replace(phe=port.state.phe._replace(tau=torch.from_numpy(tau)[None]))
    ref.state = ref.state._replace(phe=ref.state.phe._replace(tau=jnp.asarray(tau)))
    pool = [(paths[:, i].copy(), float(costs[i])) for i in range(3)]
    port.elite_pool, ref.elite_pool = list(pool), list(pool)
    port.diversification_phase()
    ref.diversification_phase()
    np.testing.assert_allclose(port.state.phe.tau[0].numpy(), np.asarray(ref.state.phe.tau),
                               rtol=1e-6, atol=0)


def test_subroute_roundtrip():
    path = np.array([0, 3, 1, 0, 2, 5, 0, 0])
    subs = ac.get_subroutes(path, end_with_zero=True)
    assert [list(s) for s in subs] == [[0, 3, 1, 0], [0, 2, 5, 0]]
    assert list(ac.merge_subroutes(subs, 8)) == [0, 3, 1, 0, 2, 5, 0, 0]


def test_insertion_builds_valid_route():
    d, _ = make_instance(10, 1)
    nodes = np.array([0, 3, 7, 2, 9])
    route, cost = ac.insertion(np.asarray(d, np.float64), nodes)
    assert route[0] == 0 and route[-1] == 0
    assert sorted(route[1:-1]) == sorted(nodes[1:].tolist())
    length = sum(d[route[i], route[i + 1]] for i in range(len(route) - 1))
    np.testing.assert_allclose(cost, length, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("elitist", [False, True])
def test_adaptive_beats_or_matches_the_facade_and_stays_feasible(elitist):
    """CVRP20, 12 ants, 8 iterations, seed 3: the adaptive cost within 1.05x
    of the plain facade's (Ant System as the JAX test runs it, or elitist),
    a feasible best, an elite pool of 1-5 routes."""
    d, demand = make_instance(20, 2)
    adaptive = ac.AdaptiveCVRPACO(d, demand, n_ants=12, seed=3, device="cpu")
    plain = CVRPACO(d, demand, n_ants=12, seed=3, elitist=elitist, device="cpu")
    c_adaptive = adaptive.run(8).item()
    assert c_adaptive <= plain.run(8).item() * 1.05
    best = adaptive.best_path[None, :, None]
    assert bool(validate_routes(best, torch.from_numpy(demand)[None], 50.0).all())
    assert 1 <= len(adaptive.elite_pool) <= 5


def test_best_cost_consistent_with_best_path():
    d, demand = make_instance(15, 4)
    aco = ac.AdaptiveCVRPACO(d, demand, n_ants=8, seed=5, device="cpu")
    aco.run(6)
    best = aco.best_path.numpy()
    recomputed = sum(d[best[i], best[i + 1]] for i in range(len(best) - 1))
    np.testing.assert_allclose(recomputed, aco.best_cost.item(), rtol=1e-4)
    torch.testing.assert_close(route_cost(torch.from_numpy(d), aco.best_path[:, None])[0],
                               aco.best_cost, rtol=1e-4, atol=0)
