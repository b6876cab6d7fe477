"""Port parity: the sparse-support TSP sweep and runner
(deepaco_tpu_torch/aco/batched_tsp.py: sweep_construct, run_anytime_sparse)
against the JAX package's, on inputs made from numpy seeds: greedy tours and
fallback counts exactly, stochastic tours in their support, and the anytime
curve in law."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import batched_tsp as jbt
from deepaco_tpu.core.graph import knn_graph, sparse_distance_matrix
from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco.runner import ACOConfig


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed, b, n, k, floor_off_support=False):
    """Uniform coordinates, their distances (1e-10 diagonal), the k-NN
    support (JAX's ``knn_graph``), ``1/d`` (on the support only when
    ``floor_off_support``) and its log score on a pheromone of ones, as
    numpy."""
    coords = np.random.default_rng(seed).random((b, n, 2), dtype=np.float32)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1).astype(np.float32)
    for d in dist:
        np.fill_diagonal(d, 1e-10)
    nbr = np.stack([np.asarray(knn_graph(jnp.asarray(c), jnp.asarray(d), k).nbr)
                    for c, d in zip(coords, dist)])
    if floor_off_support:
        heu = np.stack([1.0 / np.asarray(sparse_distance_matrix(jnp.asarray(d), k))
                        for d in dist]).astype(np.float32)
    else:
        heu = 1.0 / dist
    return dist, nbr, heu, np.log(heu)


def _both(score, nbr, start, *, stochastic=False, seed=4):
    """The two packages' ``sweep_construct`` with ``count_dense``."""
    s_d = torch.from_numpy(score)
    s_s = torch.gather(s_d, -1, torch.from_numpy(nbr).long())
    got, n_got = bt.sweep_construct(s_d, s_s, torch.from_numpy(nbr).long(),
                                    torch.from_numpy(start), torch.Generator().manual_seed(seed),
                                    stochastic=stochastic, count_dense=True)
    want, n_want = jbt.sweep_construct(
        jnp.asarray(score), jnp.take_along_axis(jnp.asarray(score), jnp.asarray(nbr), axis=-1),
        jnp.asarray(nbr), jnp.asarray(start, jnp.int32), jax.random.PRNGKey(seed),
        stochastic=stochastic, count_dense=True)
    return got.numpy(), n_got, np.asarray(want), int(n_want)


@pytest.mark.parametrize("b,n,a,k", [(2, 20, 6, 8), (4, 16, 8, 2)],
                         ids=["K8-N20", "K2-N16-forced-fallback"])
def test_greedy_sweep_equals_jax(b, n, a, k):
    """Greedy tours and the number of dense steps equal JAX's exactly: the
    JAX tests' K=8 / N=20 case and the K=2 / N=16 one, where the dense
    fallback carries most of the construction."""
    _, nbr, _, score = _inputs(2, b, n, k)
    start = np.random.default_rng(3).integers(0, n, (b, a))
    got, n_got, want, n_want = _both(score, nbr, start)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want
    assert n_got > 0 if k == 2 else n_got < n - 1


@pytest.mark.parametrize("k", [8, 2])
def test_stochastic_tours_take_support_edges_outside_fallback_steps(k):
    """Stochastic tours are permutations, and an edge off the k-NN support
    comes only from a counted dense step."""
    b, n, a = 2, 20, 6
    _, nbr, _, score = _inputs(5, b, n, k)
    start = np.zeros((b, a), np.int64)
    got, n_dense, _, _ = _both(score, nbr, start, stochastic=True, seed=6)
    off = 0
    for i in range(b):
        for j in range(a):
            tour = got[i, :, j]
            assert sorted(tour.tolist()) == list(range(n))
            off += sum(tour[t + 1] not in nbr[i, tour[t]] for t in range(n - 1))
    assert off <= n_dense * b * a
    if k == 2:
        assert n_dense > 0


def test_run_anytime_sparse_matches_jax_in_law():
    """TSP50 (B=8, K=10, 16 ants, T=8) on the floored ``1/d``, as
    tests/test_batched_tsp.py holds JAX's runner against the dense one:
    over seeds 0-3 on each side, the mean best at T1 and T8 within 5% of
    JAX's (one seed's mean of 8 instances spreads by about 1.5% at T1);
    each curve falls and ends at its best tour's length, and the statistics
    add up."""
    b, n, k, t = 8, 50, 10, 8
    cfg = ACOConfig(n_ants=16)
    dist, nbr, heu, _ = _inputs(7, b, n, k, floor_off_support=True)
    run_jax = jax.jit(functools.partial(jbt.run_anytime_sparse, cfg=cfg, n_iterations=t))
    got, want = [], []
    for seed in range(4):
        stats = {}
        curve = bt.run_anytime_sparse(torch.from_numpy(heu), torch.from_numpy(dist),
                                      torch.from_numpy(nbr).long(), cfg,
                                      torch.Generator().manual_seed(seed), t,
                                      stats=stats).numpy()
        assert curve.shape == (b, t) and np.all(np.diff(curve, axis=1) <= 0)
        best = stats["best"].numpy()
        assert all(sorted(row.tolist()) == list(range(n)) for row in best)
        length = dist[np.arange(b)[:, None], best, np.roll(best, -1, axis=1)].sum(-1)
        np.testing.assert_allclose(length, curve[:, -1], rtol=1e-5)
        assert stats["steps"] == t * (n - 1) == stats["syncs"]
        assert 0 <= stats["fallback_steps"] <= stats["steps"] and stats["sync_s"] >= 0
        got.append(curve)
        want.append(np.asarray(run_jax(jnp.asarray(heu), jnp.asarray(dist), jnp.asarray(nbr),
                                       rng=jax.random.PRNGKey(seed))))
    got, want = np.stack(got), np.stack(want)
    np.testing.assert_allclose(got[..., 0].mean(), want[..., 0].mean(), rtol=0.05)
    np.testing.assert_allclose(got[..., -1].mean(), want[..., -1].mean(), rtol=0.05)


def test_run_anytime_sparse_plain_update_and_fixed_start():
    """The plain update (``PLAIN_OPS``) gives the CPU's default path's
    curve bit for bit (the wrapper takes the plain version on a CPU
    tensor), and a fixed start runs."""
    b, n, k, t = 2, 24, 8, 3
    cfg = ACOConfig(n_ants=4)
    dist, nbr, heu, _ = _inputs(10, b, n, k)
    args = (torch.from_numpy(heu), torch.from_numpy(dist), torch.from_numpy(nbr).long(), cfg)
    a = bt.run_anytime_sparse(*args, torch.Generator().manual_seed(1), t)
    p = bt.run_anytime_sparse(*args, torch.Generator().manual_seed(1), t, _ops=bt.PLAIN_OPS)
    assert torch.equal(a, p)
    f = bt.run_anytime_sparse(*args, torch.Generator().manual_seed(1), t, fixed_start=0)
    assert f.shape == (b, t) and bool(torch.isfinite(f).all())
