"""Port parity: the CVRP construction in one pass (ops/cvrp_construct.py, the
function of kernel K7c) against the JAX package's rollout and the port's
own per-step rollout, its Philox4x32-10, and the route past K7c's N.

The same numpy instances go to both packages. Greedy routes are compared
exactly with JAX's; sampled routes exactly with the port's rollout fed the
same per-step noise (JAX's noise stream differs, so in law only:
tests/test_torch_family.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import cvrp as jcvrp
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems import cvrp as pcvrp
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost, validate_routes
from deepaco_tpu_torch.aco.problems.tsp import row_gatherer, score_matrix
from deepaco_tpu_torch.ops import cvrp_construct as cc
from deepaco_tpu_torch.ops import philox
from deepaco_tpu_torch.ops.philox import draw_seed
from deepaco_tpu_torch.ops.pick import fused_pick_plain
from deepaco_tpu_torch.train import drivers


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B = 3
M32 = 0xFFFFFFFF


def _philox_ints(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1], p0 & M32]
        k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
    return c


def _philox_torch(ctrs, key):
    cols = [torch.tensor([c[i] for c in ctrs], dtype=torch.int64) for i in range(4)]
    return [list(w) for w in zip(*(x.tolist() for x in philox.philox4x32_10(*cols, key)))]


def test_philox_equals_python_ints_and_random123_known_answer():
    """Random123's known answer for counter 0 and key 0, and random counters
    and keys (words near 2^32 included) against Python's exact integers."""
    assert _philox_torch([(0, 0, 0, 0)], 0) == [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]]
    assert _philox_ints((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rng = np.random.default_rng(0)
    for _ in range(4):
        key = int(rng.integers(0, 2 ** 62))
        ctrs = [tuple(int(x) for x in rng.integers(0, 2 ** 32, 4)) for _ in range(64)]
        ctrs.append((M32, M32, M32, M32))
        want = [_philox_ints(c, (key & M32, key >> 32)) for c in ctrs]
        assert _philox_torch(ctrs, key) == want


def test_noise_is_k2s_f32_law_of_the_counter_words():
    """Column c of step s for ant row r takes word c % 4 of the counter
    (c // 4, s, r, 0), through gumbel_f32_from_bits."""
    from deepaco_tpu_torch.ops.philox import gumbel_f32_from_bits

    key = 0x123456789ABCDEF
    g = philox.philox_gumbel(key, 5, 2, 3, 10, "cpu")
    assert g.shape == (2, 3, 10) and g.dtype == torch.float32
    for s, r, c in ((0, 0, 0), (1, 2, 9), (0, 1, 6), (1, 0, 3)):
        word = _philox_ints((c // 4, 5 + s, r, 0), (key & M32, key >> 32))[c % 4]
        assert g[s, r, c] == gumbel_f32_from_bits(torch.tensor([word]))[0]


def _instances(n, seed):
    """B instances of n nodes: the family's generator (integer demands 1-9,
    depot at the centre) and random pheromone and heuristic."""
    rng = np.random.default_rng(seed)
    insts = [families.gen_cvrp(rng, n - 1) for _ in range(B)]
    ds = {k: np.stack([i[k] for i in insts]) for k in insts[0]}
    phe = (0.5 + rng.random((B, n, n))).astype(np.float32)
    heu = (rng.random((B, n, n)) / ds["dist"]).astype(np.float32)
    return ds, phe, heu


@pytest.mark.parametrize("n,capacity", [(21, families.CVRP_CAPACITY), (21, 15.0),
                                        (50, families.CVRP_CAPACITY), (50, 12.0)])
def test_greedy_plain_equals_jax_greedy_rollout(n, capacity):
    """Greedy routes of cvrp_construct_plain equal JAX's greedy_rollout over
    cvrp_spec exactly, per instance, at capacity 50 and a tight one."""
    ds, phe, heu = _instances(n, n)
    a = 5
    score = score_matrix(torch.from_numpy(phe), torch.from_numpy(heu), 1.2, 0.9)
    got = cc.cvrp_construct_plain(score, torch.from_numpy(ds["demand"]), capacity, a,
                                  torch.Generator().manual_seed(0), stochastic=False)
    assert got.shape == (B, 2 * (n - 1) + 1, a) and got.dtype == torch.int64
    for i in range(B):
        jspec = jcvrp.cvrp_spec(jnp.asarray(phe[i]), jnp.asarray(heu[i]),
                                jnp.asarray(ds["demand"][i]), capacity, a,
                                alpha=1.2, beta=0.9)
        ref = np.asarray(jengine.greedy_rollout(jspec, jax.random.PRNGKey(0)).paths)
        np.testing.assert_array_equal(got[i].numpy(), ref)


def _rollout_with_philox_noise(spec, b, n, a, seed):
    """The port's rollout of ``spec`` whose pick substitutes, at each step,
    the Philox noise of that step under the key that the plain version
    draws from a generator seeded with ``seed``."""
    key = int(draw_seed(torch.Generator().manual_seed(seed), "cpu").item())
    steps = iter(range(2 * (n - 1)))

    def pick(rows, mask, _noise):
        noise = philox.philox_gumbel(key, next(steps), 1, b * a, n, "cpu")[0]
        return fused_pick_plain(rows, mask, noise)

    return engine.rollout(spec, torch.Generator().manual_seed(seed + 1), pick=pick).paths


@pytest.mark.parametrize("n,capacity,a,depot_loop", [
    (21, families.CVRP_CAPACITY, 16, None), (21, 15.0, 16, None),
    (50, families.CVRP_CAPACITY, 7, None), (50, 10.0, 7, None),
    (21, 15.0, 16, float("-inf"))])
def test_sampled_plain_equals_rollout_given_the_same_noise(n, capacity, a, depot_loop):
    """Given each step's Philox noise, the plain construction's sampled
    routes equal the port's rollout of cvrp_spec exactly. With a score of
    -inf on instance 0's depot self-loop a finished ant does not park: the
    masked -1e30 of column 1 beats it, so it serves customer 1 again, and
    the count of customers left must not drop for that."""
    ds, phe, heu = _instances(n, 100 + n)
    phe_t, heu_t = torch.from_numpy(phe), torch.from_numpy(heu)
    demand = torch.from_numpy(ds["demand"])
    score = score_matrix(phe_t, heu_t, 1.0, 1.0)
    spec = cvrp_spec(phe_t, heu_t, demand, capacity, a)
    if depot_loop is not None:
        score[0, 0, 0] = depot_loop
        spec = spec._replace(score_rows=lambda st: row_gatherer(B, n, "cpu")(score, st[0]))
    got = cc.cvrp_construct_plain(score, demand, capacity, a, torch.Generator().manual_seed(7))
    want = _rollout_with_philox_noise(spec, B, n, a, 7)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if depot_loop is not None:
        assert bool((got[0, -1] != 0).any())    # some ant of instance 0 never parks
        assert bool((got[1:, -1] == 0).all())


@pytest.mark.parametrize("capacity", [families.CVRP_CAPACITY, 15.0])
def test_sampled_routes_are_valid_and_costed_as_jax(capacity):
    """Routes that cvrp_construct samples on the CPU (its plain version)
    pass validate_routes, the parked tail included, and route_cost equals
    JAX's at rtol 1e-6 (sum order); stochastic routes cost more than
    greedy ones on 1/d."""
    ds = _instances(50, 3)[0]
    dist, demand = torch.from_numpy(ds["dist"]), torch.from_numpy(ds["demand"])
    score = score_matrix(torch.ones_like(dist), 1.0 / dist, 1.0, 1.0)
    before = cc.cvrp_construct.launches
    paths = cc.cvrp_construct(score, demand, capacity, 32, torch.Generator().manual_seed(2))
    assert cc.cvrp_construct.launches == before           # the plain version ran
    assert bool(validate_routes(paths, demand, capacity).all())
    costs = route_cost(dist, paths)
    for i in range(B):
        ref = jcvrp.route_cost(jnp.asarray(ds["dist"][i]), jnp.asarray(paths[i].numpy()))
        np.testing.assert_allclose(costs[i].numpy(), np.asarray(ref), rtol=1e-6)
    greedy = cc.cvrp_construct(score, demand, capacity, 1, torch.Generator(), stochastic=False)
    assert bool((route_cost(dist, greedy)[:, 0] < costs.mean(1)).all())


def test_construct_route_predicate_states_k7c_limit(monkeypatch):
    """K7c takes 1 <= N <= 4096. Past the limit the CVRP family constructs
    step by step through ``pick`` (K7 on the card): the rollout's paths
    exactly, and ``construct`` is not called; within it, ``construct`` on
    the score matrix and no pick."""
    assert cc.cvrp_construct_supported(4096) and not cc.cvrp_construct_supported(4097)
    assert not cc.cvrp_construct_supported(0)
    ds, phe, heu = _instances(21, 9)
    args = (torch.from_numpy(phe), torch.from_numpy(heu), torch.from_numpy(ds["demand"]),
            families.CVRP_CAPACITY, 4)
    boom = lambda *a, **k: pytest.fail("called outside its route")
    monkeypatch.setattr(cc, "CVRP_CONSTRUCT_MAX_N", 20)
    got = pcvrp.cvrp_paths(*args, torch.Generator().manual_seed(3), construct=boom,
                           pick=fused_pick_plain)
    want = engine.rollout(cvrp_spec(*args), torch.Generator().manual_seed(3),
                          pick=fused_pick_plain).paths
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    monkeypatch.setattr(cc, "CVRP_CONSTRUCT_MAX_N", 21)
    got = pcvrp.cvrp_paths(*args, torch.Generator().manual_seed(3),
                           construct=cc.cvrp_construct_plain, pick=boom)
    want = cc.cvrp_construct_plain(score_matrix(*args[:2], 1.0, 1.0), *args[2:],
                                   torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_family_ops_construct_field():
    """``FamilyOps.construct`` comes last with K7c's wrapper as its default,
    so positional uses keep their meaning; the plain ops take the plain
    construction. Every family constructs through its ``construct`` hook:
    TSP's is the rollout of ``tsp_spec`` a ``pick`` a step (its paths
    exactly)."""
    from deepaco_tpu_torch.aco.problems.tsp import tsp_spec

    assert drivers.FamilyOps._fields[-1] == "construct"
    assert drivers.KERNEL_OPS.construct is cc.cvrp_construct
    assert drivers.PLAIN_OPS.construct is cc.cvrp_construct_plain
    ops = drivers.FamilyOps(drivers.PLAIN_OPS.layer, fused_pick_plain)
    assert ops.pick is fused_pick_plain and ops.construct is cc.cvrp_construct
    assert families.get_family("cvrp").construct is not None
    rng = np.random.default_rng(11)
    tau = torch.from_numpy(0.5 + rng.random((2, 9, 9), dtype=np.float32))
    heu = torch.from_numpy(0.1 + rng.random((2, 9, 9), dtype=np.float32))
    got = families.get_family("tsp").construct(tau, heu, {}, 4,
                                               torch.Generator().manual_seed(5), ops)
    want = engine.rollout(tsp_spec(tau, heu, 4), torch.Generator().manual_seed(5),
                          pick=fused_pick_plain).paths
    np.testing.assert_array_equal(got.numpy(), want.numpy())
