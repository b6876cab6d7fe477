"""Port parity: the batched construction engine (aco/engine.py) and the TSP
plug-in (aco/problems/tsp.py) against the JAX engine."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems.tsp import tour_cost as jtour_cost, tsp_spec as jtsp_spec
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec


def _instances(b, n, seed):
    """Distances (diagonal 1e9), heuristic 1/d and a random pheromone."""
    rng = np.random.default_rng(seed)
    c = rng.random((b, n, 2)).astype(np.float32)
    d = np.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1)).astype(np.float32)
    d[:, np.arange(n), np.arange(n)] = 1e9
    phe = (rng.random((b, n, n)) + 0.5).astype(np.float32)
    return d, (1.0 / d).astype(np.float32), phe


@pytest.mark.parametrize("fixed_start", [0, None])
def test_greedy_rollout_equals_jax(fixed_start):
    """Greedy paths exactly equal JAX greedy_rollout's on the same plug-in;
    with random starts both take the JAX key-0 starts."""
    b, n, a = 2, 15, 4
    d, heu, phe = _instances(b, n, 0)
    for i in range(b):
        jspec = jtsp_spec(jnp.asarray(phe[i]), jnp.asarray(heu[i]), a, fixed_start,
                          alpha=1.2, beta=0.8)
        ref = np.asarray(jengine.greedy_rollout(jspec, jax.random.PRNGKey(0)).paths)
        spec = tsp_spec(torch.from_numpy(phe[i:i + 1]), torch.from_numpy(heu[i:i + 1]),
                        a, fixed_start, alpha=1.2, beta=0.8)
        start = torch.from_numpy(np.array(ref[0])).long()[None]
        spec = spec._replace(start=lambda _g: start)
        got = engine.greedy_rollout(spec, torch.Generator().manual_seed(0)).paths
        np.testing.assert_array_equal(got[0].numpy(), ref)


def _paths(b, n, a, seed):
    """Random tours ``[B, N, A]`` from city 0."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, n, a), np.int64)
    for i in range(b):
        for j in range(a):
            out[i, 1:, j] = rng.permutation(np.arange(1, n))
    return out


def test_path_log_probs_equal_jax():
    """Teacher-forced log-probs of the same paths, from city 0, against JAX
    path_log_probs on both plug-in routes (score rows; phe/heu rows with
    alpha and beta); rtol 1e-5 / atol 1e-5 (log and logsumexp rounding)."""
    b, n, a = 2, 12, 5
    d, heu, phe = _instances(b, n, 1)
    paths = _paths(b, n, a, 2)
    spec = tsp_spec(torch.from_numpy(phe), torch.from_numpy(heu), a, 0, alpha=1.3, beta=0.7)
    got = engine.path_log_probs(spec, torch.from_numpy(paths))
    no_score = spec._replace(score_rows=None)
    got_rows = engine.path_log_probs(no_score, torch.from_numpy(paths), alpha=1.3, beta=0.7)
    assert got.shape == (b, n - 1, a)
    for i in range(b):
        jspec = jtsp_spec(jnp.asarray(phe[i]), jnp.asarray(heu[i]), a, 0, alpha=1.3, beta=0.7)
        ref = np.asarray(jengine.path_log_probs(jspec, jnp.asarray(paths[i], jnp.int32)))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_rows[i].numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rollout_log_probs_equal_their_replay():
    """rollout(require_prob=True)'s log-probs equal path_log_probs of its own
    paths (JAX's tests/test_engine.py:46), at rtol 1e-5 / atol 1e-6."""
    b, n, a = 3, 10, 6
    _, heu, _ = _instances(b, n, 3)
    spec = tsp_spec(torch.ones(b, n, n), torch.from_numpy(heu), a, 0, beta=1.5)
    ro = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True)
    assert ro.paths.shape == (b, n, a) and ro.log_probs.shape == (b, n - 1, a)
    assert torch.equal(torch.sort(ro.paths, dim=1).values,
                       torch.arange(n)[None, :, None].expand(b, n, a))
    replay = engine.path_log_probs(spec, ro.paths)
    np.testing.assert_allclose(ro.log_probs.numpy(), replay.numpy(), rtol=1e-5, atol=1e-6)
    plain = engine.rollout(spec, torch.Generator().manual_seed(3))
    assert torch.equal(plain.paths, ro.paths) and not plain.log_probs.any()


def test_sampled_cost_matches_jax_in_law():
    """Mean tour cost of 256 sampled ants on each of 2 instances (n=20,
    heuristic 1/d^2, random starts) within 3% of JAX rollout's: the streams
    differ, the law must not (the mean's standard error is under 0.5%)."""
    b, n, a = 2, 20, 256
    d, heu, _ = _instances(b, n, 4)
    heu2 = heu ** 2
    spec = tsp_spec(torch.ones(b, n, n), torch.from_numpy(heu2), a)
    ro = engine.rollout(spec, torch.Generator().manual_seed(5))
    got = tour_cost(torch.from_numpy(d), ro.paths).mean(dim=1).numpy()
    for i in range(b):
        jspec = jtsp_spec(jnp.ones((n, n)), jnp.asarray(heu2[i]), a)
        jro = jengine.rollout(jspec, jax.random.PRNGKey(6))
        ref = float(jnp.mean(jtour_cost(jnp.asarray(d[i]), jro.paths)))
        assert abs(got[i] - ref) <= 0.03 * ref, (got[i], ref)


def test_masked_logits_equal_jax():
    """alpha*log(phe) + beta*log(heu) with the 1e-30 floor (a zero heuristic
    entry included) and -1e30 on masked entries, rtol 1e-6."""
    rng = np.random.default_rng(7)
    phe = (rng.random((3, 9)) + 0.5).astype(np.float32)
    heu = rng.random((3, 9)).astype(np.float32)
    heu[0, 2] = 0.0
    mask = (rng.random((3, 9)) > 0.4).astype(np.float32)
    ref = jengine.masked_logits(jnp.asarray(phe), jnp.asarray(heu), jnp.asarray(mask), 1.3, 0.7)
    got = engine.masked_logits(torch.from_numpy(phe), torch.from_numpy(heu),
                               torch.from_numpy(mask), 1.3, 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
