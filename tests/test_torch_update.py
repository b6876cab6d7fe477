"""Port parity: the Ant System update (aco/runner.py, aco/pheromone.py and the
K3 boundary in aco/batched_tsp.py) on fixed paths."""
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
    _assert_state(bt._batched_update(cfg, state, paths_t, dist_t), ref)

    # the JAX kernel's boundary: D (one direction) and the costs
    d, kcosts = jax.vmap(functools.partial(fused_tsp_update_pallas, q=cfg.q))(
        jnp.asarray(paths), jnp.asarray(dist))
    if symmetric:
        d = d + jnp.swapaxes(d, -1, -2)
    tau_ref = jnp.asarray(tau) * cfg.decay + d
    tau_got, costs_got = bt.fused_tsp_update(torch.from_numpy(tau), paths_t, dist_t,
                                             decay=cfg.decay, q=cfg.q,
                                             symmetric=symmetric)
    np.testing.assert_allclose(tau_got.numpy(), np.asarray(tau_ref), rtol=1e-6)
    np.testing.assert_allclose(costs_got.numpy(), np.asarray(kcosts), rtol=1e-6)


def test_open_paths_take_search_update():
    """cyclic=False is outside K3's scope: the generic update runs."""
    dist, paths, tau, best, best_path = _case(seed=1)
    jcfg = jrunner.ACOConfig(n_ants=paths.shape[2], cyclic=False)
    cfg = runner.ACOConfig(n_ants=paths.shape[2], cyclic=False)
    assert not bt._fused_update_ok(cfg)
    jcosts = jax.vmap(jtour_cost)(jnp.asarray(dist), jnp.asarray(paths))
    ref = jax.vmap(functools.partial(jrunner.search_update, jcfg))(
        _jax_state(jcfg, tau, best, best_path), jnp.asarray(paths), jcosts)
    got = bt._batched_update(cfg, _torch_state(cfg, tau, best, best_path),
                             torch.from_numpy(paths).long(), torch.from_numpy(dist))
    _assert_state(got, ref)


@pytest.mark.parametrize("flag", [{"elitist": True}, {"min_max": True},
                                  {"vector_pheromone": True}, {"maximize": True},
                                  {"deposit_div_ants": True}, {"cost_offset": 1.0}])
def test_unported_flags_raise(flag):
    cfg = runner.ACOConfig(**flag)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        runner.init_search(5, 4, cfg, batch=(1,))
    state = runner.init_search(5, 4, runner.ACOConfig(), batch=(1,))
    paths = torch.stack([torch.randperm(5) for _ in range(2)], dim=1)[None]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        runner.search_update(cfg, state, paths, torch.ones(1, 2))
