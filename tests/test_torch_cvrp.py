"""Port parity: the CVRP golden set (utils/golden.py), graph
(core/builders.py), plug-in, route costs and validator
(aco/problems/cvrp.py) against the JAX package."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import cvrp as jcvrp
from deepaco_tpu.core.builders import cvrp_graph as jcvrp_graph
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost, validate_routes
from deepaco_tpu_torch.core.builders import cvrp_graph
from deepaco_tpu_torch.families import CVRP_CAPACITY
from deepaco_tpu_torch.utils import golden


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B, N = 3, 21                      # 20 customers and the depot


@pytest.fixture(scope="module")
def ds():
    """The first B instances of the golden CVRP20 set, as numpy."""
    return {k: v[:B] for k, v in golden.cvrp_test(20).items()}


def test_golden_cvrp_equals_jax_bit_for_bit():
    got, ref = golden.cvrp_test(20), jgolden.cvrp_test(20)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["dist"].shape == (100, N, N)
    with pytest.raises(ValueError, match="scale"):
        golden.cvrp_test(50)


def test_cvrp_graph_equals_jax(ds):
    g = cvrp_graph(torch.from_numpy(ds["demand"]), torch.from_numpy(ds["dist"]))
    for i in range(B):
        ref = jcvrp_graph(jnp.asarray(ds["demand"][i]), jnp.asarray(ds["dist"][i]))
        np.testing.assert_array_equal(g.x[i].numpy(), np.asarray(ref.x))
        np.testing.assert_array_equal(g.nbr[i].numpy(), np.asarray(ref.nbr))
        np.testing.assert_array_equal(g.edge[i].numpy(), np.asarray(ref.edge))


def _phe_heu(ds, seed):
    rng = np.random.default_rng(seed)
    phe = (0.5 + rng.random((B, N, N))).astype(np.float32)
    heu = (rng.random((B, N, N)) / ds["dist"]).astype(np.float32)
    return phe, heu


@pytest.mark.parametrize("capacity", [CVRP_CAPACITY, 15.0])
def test_greedy_rollout_equals_jax(ds, capacity):
    """Greedy routes on random pheromone and heuristic equal JAX's exactly,
    at the family's capacity and at a tight one (more depot returns)."""
    phe, heu = _phe_heu(ds, 0)
    a = 4
    spec = cvrp_spec(torch.from_numpy(phe), torch.from_numpy(heu),
                     torch.from_numpy(ds["demand"]), capacity, a, alpha=1.2, beta=0.9)
    got = engine.greedy_rollout(spec, torch.Generator().manual_seed(0)).paths
    assert got.shape == (B, 2 * (N - 1) + 1, a)
    for i in range(B):
        jspec = jcvrp.cvrp_spec(jnp.asarray(phe[i]), jnp.asarray(heu[i]),
                                jnp.asarray(ds["demand"][i]), capacity, a,
                                alpha=1.2, beta=0.9)
        ref = np.asarray(jengine.greedy_rollout(jspec, jax.random.PRNGKey(0)).paths)
        np.testing.assert_array_equal(got[i].numpy(), ref)


def test_masks_equal_jax_on_forced_actions(ds):
    """The feasibility mask after each of a fixed action sequence (depot
    revisits, a return to the depot right after it) equals JAX's."""
    phe, heu = _phe_heu(ds, 1)
    forced = [[1, 2, 3], [0, 0, 4], [0, 1, 0], [5, 6, 7], [0, 8, 0]]
    spec = cvrp_spec(torch.from_numpy(phe), torch.from_numpy(heu),
                     torch.from_numpy(ds["demand"]), 15.0, 3)
    state = spec.init(spec.start(None))
    jspecs = [jcvrp.cvrp_spec(jnp.asarray(phe[i]), jnp.asarray(heu[i]),
                              jnp.asarray(ds["demand"][i]), 15.0, 3) for i in range(B)]
    jstates = [s.init(jax.random.PRNGKey(0))[0] for s in jspecs]
    for acts in [None] + forced:
        if acts is not None:
            state = spec.step(state, torch.tensor([acts] * B))
            jstates = [s.step(st, jnp.asarray(acts)) for s, st in zip(jspecs, jstates)]
        for i in range(B):
            np.testing.assert_array_equal(spec.mask(state)[i].numpy(),
                                          np.asarray(jspecs[i].mask(jstates[i])),
                                          err_msg=f"after {acts}")


def test_sampled_routes_are_valid_and_costed_as_jax(ds):
    """Sampled routes (64 ants, the parked tail included) pass the port's
    validator and JAX's; route_cost agrees with JAX's at rtol 1e-6 (sum
    order); a broken route fails both validators."""
    _, heu = _phe_heu(ds, 2)
    a = 64
    spec = cvrp_spec(torch.ones(B, N, N), torch.from_numpy(heu),
                     torch.from_numpy(ds["demand"]), CVRP_CAPACITY, a)
    paths = engine.rollout(spec, torch.Generator().manual_seed(4)).paths
    dist, demand = torch.from_numpy(ds["dist"]), torch.from_numpy(ds["demand"])
    assert bool(validate_routes(paths, demand, CVRP_CAPACITY).all())
    costs = route_cost(dist, paths)
    assert costs.shape == (B, a)
    bad = paths.clone()
    bad[:, 1, 0] = bad[:, 2, 0]                  # ant 0 serves one customer twice
    bad[:, :, 1] = torch.arange(2 * (N - 1) + 1).clamp(max=N - 1)  # ant 1: one trip
    for i in range(B):
        p = jnp.asarray(paths[i].numpy())
        np.testing.assert_allclose(costs[i].numpy(),
                                   np.asarray(jcvrp.route_cost(jnp.asarray(ds["dist"][i]), p)),
                                   rtol=1e-6)
        ref = np.asarray(jcvrp.validate_routes(jnp.asarray(bad[i].numpy()),
                                               jnp.asarray(ds["demand"][i]), CVRP_CAPACITY))
        got = validate_routes(bad[i:i + 1], demand[i:i + 1], CVRP_CAPACITY)[0]
        np.testing.assert_array_equal(got.numpy(), ref)
        assert not ref[:2].any() and ref[2:].all()
