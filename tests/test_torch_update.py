"""Port parity: the Ant System update (aco/runner.py, aco/pheromone.py and
K3's function in aco/batched_tsp.py: costs, deposit, floor, best-so-far
state and the next score) on fixed paths, and the batched runner's greedy
curve."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import runner as jrunner
from deepaco_tpu.aco.problems.tsp import tour_cost as jtour_cost
from deepaco_tpu.ops.pallas_kernels import fused_tsp_update_pallas
from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco import runner
from deepaco_tpu_torch.aco.problems.tsp import tour_cost


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _case(b=3, n=20, a=6, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.random((b, n, 2)).astype(np.float32)
    dist = np.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1) + 1e-20).astype(np.float32)
    dist[:, np.arange(n), np.arange(n)] = 1e9
    paths = np.stack([np.stack([rng.permutation(n) for _ in range(a)], axis=1)
                      for _ in range(b)]).astype(np.int32)          # [B, N, A]
    tau = (0.5 + rng.random((b, n, n))).astype(np.float32)
    costs = np.asarray(jax.vmap(jtour_cost)(jnp.asarray(dist), jnp.asarray(paths)))
    # instance 0 improves, instance 1 ties its best (no change), 2 does not
    best = np.array([costs[0].min() + 1.0, costs[1].min(), costs[2].min() - 1.0],
                    np.float32)[:b]
    best_path = rng.integers(0, n, (b, n)).astype(np.int32)
    return dist, paths, tau, best, best_path


def _jax_state(cfg, tau, best, best_path):
    b, n = best_path.shape
    st = jax.vmap(lambda _: jrunner.init_search(n, n - 1, cfg))(jnp.arange(b))
    return st._replace(phe=st.phe._replace(tau=jnp.asarray(tau)),
                       best_cost=jnp.asarray(best),
                       best_path=jnp.asarray(best_path))


def _torch_state(cfg, tau, best, best_path):
    b, n = best_path.shape
    st = runner.init_search(n, n - 1, cfg, batch=(b,), device="cpu")
    return st._replace(phe=st.phe._replace(tau=torch.from_numpy(tau)),
                       best_cost=torch.from_numpy(best),
                       best_path=torch.from_numpy(best_path).long())


def _assert_state(got, ref, rtol=1e-6):
    np.testing.assert_allclose(got.phe.tau.numpy(), np.asarray(ref.phe.tau), rtol=rtol)
    np.testing.assert_allclose(got.best_cost.numpy(), np.asarray(ref.best_cost), rtol=rtol)
    np.testing.assert_array_equal(got.best_path.numpy(), np.asarray(ref.best_path))


@pytest.mark.parametrize("symmetric,floor", [(True, 0.0), (False, 0.0), (True, 0.6)])
def test_update_matches_jax_search_update_and_fused_kernel(symmetric, floor):
    dist, paths, tau, best, best_path = _case()
    jcfg = jrunner.ACOConfig(n_ants=paths.shape[2], symmetric=symmetric, floor=floor)
    cfg = runner.ACOConfig(n_ants=paths.shape[2], symmetric=symmetric, floor=floor)
    jstate = _jax_state(jcfg, tau, best, best_path)
    jcosts = jax.vmap(jtour_cost)(jnp.asarray(dist), jnp.asarray(paths))
    ref = jax.vmap(functools.partial(jrunner.search_update, jcfg))(
        jstate, jnp.asarray(paths), jcosts)

    state = _torch_state(cfg, tau, best, best_path)
    paths_t, dist_t = torch.from_numpy(paths).long(), torch.from_numpy(dist)
    costs = tour_cost(dist_t, paths_t)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-6)
    _assert_state(runner.search_update(cfg, state, paths_t, costs), ref)
    got, score = bt._batched_update(cfg, state, paths_t, dist_t)
    _assert_state(got, ref)
    assert score is None

    # the JAX kernel's boundary: D (one direction) and the costs
    d, kcosts = jax.vmap(functools.partial(fused_tsp_update_pallas, q=cfg.q))(
        jnp.asarray(paths), jnp.asarray(dist))
    if symmetric:
        d = d + jnp.swapaxes(d, -1, -2)
    tau_ref = jnp.maximum(jnp.asarray(tau) * cfg.decay + d, floor)
    got, costs_got, _ = bt.fused_tsp_update(state, paths_t, dist_t, decay=cfg.decay,
                                            q=cfg.q, symmetric=symmetric, floor=floor)
    np.testing.assert_allclose(got.phe.tau.numpy(), np.asarray(tau_ref), rtol=1e-6)
    np.testing.assert_allclose(costs_got.numpy(), np.asarray(kcosts), rtol=1e-6)


def _jax_fused_update(jcfg, jstate, paths, dist, log_heu, dtype):
    """JAX's K3 route of ``_batched_update`` (deepaco_tpu/aco/batched_tsp.py
    127-146, taken on a TPU) with ``fused_tsp_update_pallas`` in interpret
    mode, then the loop's next score (:323-324)."""
    d, costs = jax.vmap(functools.partial(fused_tsp_update_pallas, q=jcfg.q))(paths, dist)
    if jcfg.symmetric:
        d = d + jnp.swapaxes(d, -1, -2)
    tau = jstate.phe.tau * jcfg.decay + d
    if jcfg.floor > 0.0:
        tau = jnp.maximum(tau, jcfg.floor)
    it_best = jnp.argmin(costs, axis=1)
    it_cost = jnp.take_along_axis(costs, it_best[:, None], 1)[:, 0]
    improved = it_cost < jstate.best_cost
    best_cost = jnp.where(improved, it_cost, jstate.best_cost)
    bpath = jnp.take_along_axis(paths, it_best[:, None, None], axis=2)[:, :, 0]
    best_path = jnp.where(improved[:, None], bpath, jstate.best_path)
    score = jcfg.alpha * jnp.log(jnp.maximum(tau, 1e-30)) + log_heu
    return tau, costs, best_cost, best_path, score.astype(dtype), score


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("symmetric,floor,n,seed", [
    (True, 0.0, 20, 2), (False, 0.0, 33, 3), (True, 0.6, 64, 4), (False, 0.6, 100, 5)])
def test_fused_update_with_score_matches_jax(symmetric, floor, n, seed, dtype):
    """K3's whole function on the CPU (its plain version) against JAX's:
    tau' and costs at rtol 1e-6, the best tour exact (its cost at rtol 1e-6:
    the packages sum a tour in other orders), the score in f32
    within 4e-6 of JAX's, and the score in the sampling dtype exactly the
    port's f32 score after that cast. XLA's CPU log and PyTorch's differ by
    an ulp on some entries, and tau' by its sum order, so JAX's bf16 score
    may sit one bf16 step away where its f32 value straddles a rounding
    midpoint; those entries are counted and held to one step. Instance 0
    improves on its best, instance 1 does not, instance 2 ties the port's
    own cheapest tour exactly (the two packages' costs may differ by an
    ulp, so it is held to ``track_best`` alone)."""
    dist, paths, tau, _, best_path = _case(n=n, seed=seed)
    own = tour_cost(torch.from_numpy(dist), torch.from_numpy(paths).long()).min(-1).values
    best = np.array([own[0] + 1.0, own[1] - 1.0, own[2]], np.float32)
    alpha = 1.5
    jcfg = jrunner.ACOConfig(n_ants=paths.shape[2], symmetric=symmetric, floor=floor,
                             alpha=alpha)
    cfg = runner.ACOConfig(n_ants=paths.shape[2], symmetric=symmetric, floor=floor,
                           alpha=alpha)
    heu = np.random.default_rng(seed + 10).random(dist.shape).astype(np.float32) + 1e-3
    log_heu = (0.5 * np.log(heu)).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.jit(_jax_fused_update, static_argnums=(0, 5))(
        jcfg, _jax_state(jcfg, tau, best, best_path), jnp.asarray(paths), jnp.asarray(dist),
        jnp.asarray(log_heu), jdtype)
    tau_ref, costs_ref, best_ref, bpath_ref, score_ref, score_ref32 = map(np.asarray, ref)

    state = _torch_state(cfg, tau, best, best_path)
    paths_t, dist_t = torch.from_numpy(paths).long(), torch.from_numpy(dist)
    got, costs, score = bt.fused_tsp_update(
        state, paths_t, dist_t, decay=cfg.decay, q=cfg.q, symmetric=symmetric, floor=floor,
        log_heu=torch.from_numpy(log_heu), alpha=alpha, score_dtype=tdtype)
    np.testing.assert_allclose(got.phe.tau.numpy(), tau_ref, rtol=1e-6)
    np.testing.assert_allclose(costs.numpy(), costs_ref, rtol=1e-6)
    np.testing.assert_array_equal(got.best_path.numpy()[:2], bpath_ref[:2])
    np.testing.assert_allclose(got.best_cost.numpy()[:2], best_ref[:2], rtol=1e-6)
    assert score.dtype == tdtype and score.shape == dist.shape
    score32 = bt.next_score(got.phe.tau, torch.from_numpy(log_heu), alpha, torch.float32)
    np.testing.assert_allclose(score32.numpy(), score_ref32, rtol=0, atol=4e-6)
    assert torch.equal(score, score32.to(tdtype))
    if dtype == "bfloat16":   # the same cast of JAX's f32 score
        got_f, want_f = score.float().numpy(), np.asarray(score_ref, np.float32)
        off = got_f != want_f
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got_f), np.abs(want_f)))) - 7)
        assert np.all(np.abs(got_f - want_f)[off] <= step[off])
        assert off.mean() < 1e-3
    # the state that search_update would make of the same costs; the tie keeps
    want = runner.track_best(_torch_state(cfg, tau, best, best_path), paths_t, costs)
    assert torch.equal(got.best_cost, want.best_cost)
    assert torch.equal(got.best_path, want.best_path)
    np.testing.assert_array_equal(got.best_path.numpy()[2], best_path[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_runner_curve_matches_jax(monkeypatch, dtype):
    """The whole batched runner, greedy: JAX's ``run_anytime_batched`` and the
    port's on the CPU from the same heuristic, distances and start cities
    give the same tours (the construction takes the first maximum in both),
    so curves equal to the costs' rounding: rtol 1e-6, as the costs (a single
    different choice would move a cost by far more)."""
    import deepaco_tpu.aco.batched_tsp as jbt

    b, n, a, t = 3, 30, 5, 6
    rng = np.random.default_rng(21)
    c = rng.random((b, n, 2)).astype(np.float32)
    dist = np.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1) + 1e-20).astype(np.float32)
    dist[:, np.arange(n), np.arange(n)] = 1e9
    heu = (1.0 / dist).astype(np.float32)
    starts = rng.integers(0, n, (b, a))
    monkeypatch.setattr(jbt, "dense_sweep",
                        functools.partial(jbt.dense_sweep, stochastic=False))
    monkeypatch.setattr(jbt, "_start_cities",
                        lambda *args: jnp.asarray(starts, jnp.int32))
    monkeypatch.setattr(bt, "_start_cities", lambda *args: torch.from_numpy(starts))
    want = np.asarray(jbt.run_anytime_batched(
        jnp.asarray(heu), jnp.asarray(dist), jrunner.ACOConfig(n_ants=a),
        jax.random.PRNGKey(0), t, sample_dtype=getattr(jnp, dtype)))
    ops = bt.PLAIN_OPS._replace(sweep=functools.partial(bt.dense_sweep, stochastic=False))
    got = bt.run_anytime_batched(torch.from_numpy(heu), torch.from_numpy(dist),
                                 runner.ACOConfig(n_ants=a), torch.Generator().manual_seed(0),
                                 t, sample_dtype=getattr(torch, dtype), _ops=ops)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert bool((got[:, 1:] < got[:, :-1]).any())     # the search moves


def test_open_paths_take_search_update():
    """cyclic=False is outside K3's scope: the generic update runs."""
    dist, paths, tau, best, best_path = _case(seed=1)
    jcfg = jrunner.ACOConfig(n_ants=paths.shape[2], cyclic=False)
    cfg = runner.ACOConfig(n_ants=paths.shape[2], cyclic=False)
    assert not bt._fused_update_ok(cfg)
    jcosts = jax.vmap(jtour_cost)(jnp.asarray(dist), jnp.asarray(paths))
    ref = jax.vmap(functools.partial(jrunner.search_update, jcfg))(
        _jax_state(jcfg, tau, best, best_path), jnp.asarray(paths), jcosts)
    got, _ = bt._batched_update(cfg, _torch_state(cfg, tau, best, best_path),
                                torch.from_numpy(paths).long(), torch.from_numpy(dist))
    _assert_state(got, ref)


@pytest.mark.parametrize("flag", [{"elitist": True}, {"min_max": True},
                                  {"vector_pheromone": True}, {"maximize": True},
                                  {"deposit_div_ants": True}, {"cost_offset": 1.0}])
def test_unported_flags_raise(flag):
    """Every strategy flag is ported and runs in init_search and
    search_update (none raises any more): maximize (OP), cost_offset
    (SMTWTP), deposit_div_ants (BPP, as q = 1/A deposits), vector_pheromone
    (MKP-items: ones ``[B, n]``, each item takes 1/cost from each ant that
    picked it), elitist (only the iteration-best ant deposits) and min_max
    (tau starts at tau_min, the first best sets tau_max = n / best and
    rescales tau to it, the clamp holds tau in [tau_min, tau_max])."""
    cfg = runner.ACOConfig(**flag)
    state = runner.init_search(5, 4, runner.ACOConfig(), batch=(1,))
    paths = torch.stack([torch.randperm(5) for _ in range(2)], dim=1)[None]
    if cfg.vector_pheromone:
        state = runner.init_search(5, 4, cfg, batch=(1,))
        assert torch.equal(state.phe.tau, torch.ones(1, 5))
        got = runner.search_update(cfg, state, paths, torch.tensor([[2.0, 4.0]]))
        torch.testing.assert_close(got.phe.tau, torch.full((1, 5), 0.9 + 0.5 + 0.25))
        assert got.best_cost.item() == 2.0
        return
    if set(flag) <= {"maximize", "cost_offset", "deposit_div_ants"}:
        state = runner.init_search(5, 4, cfg, batch=(1,))
        costs = torch.tensor([[2.0, 3.0]])
        got = runner.search_update(cfg, state, paths, costs)
        assert got.best_cost.item() == (3.0 if cfg.maximize else 2.0)
        assert bool(torch.isfinite(got.phe.tau).all())
        if cfg.deposit_div_ants:
            ref = runner.search_update(runner.ACOConfig(), state, paths, costs, q=0.5)
            torch.testing.assert_close(got.phe.tau, ref.phe.tau)
        return
    state = runner.init_search(5, 4, cfg, batch=(1,))
    costs = torch.tensor([[2.0, 4.0]])
    got = runner.search_update(cfg, state, paths, costs)
    assert got.best_cost.item() == 2.0 and torch.equal(got.best_path[0], paths[0, :, 0])
    if cfg.elitist:
        ref = runner.search_update(runner.ACOConfig(), state, paths[..., :1], costs[:, :1])
        torch.testing.assert_close(got.phe.tau, ref.phe.tau)
    else:
        assert torch.equal(state.phe.tau, torch.full((1, 5, 5), 0.1))
        assert got.phe.tau_max.item() == 5 / 2.0
        assert bool((got.phe.tau >= 0.1).all() and (got.phe.tau <= 2.5).all())
        assert got.phe.tau.max().item() == 2.5
