"""Port parity: the construction sweep and its Gumbel law (aco/batched_tsp.py)."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import batched_tsp as jbt
from deepaco_tpu_torch.aco import batched_tsp as bt
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


def _score(b, n, seed):
    c = np.random.default_rng(seed).random((b, n, 2)).astype(np.float32)
    d = np.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1) + 1e-20)
    d[:, np.arange(n), np.arange(n)] = 1e9
    return np.log(1.0 / d).astype(np.float32), d


def test_greedy_sweep_equals_jax_dense_and_fused():
    b, n, a = 3, 37, 5
    score32, _ = _score(b, n, 30)
    start = np.random.default_rng(31).integers(0, n, (b, a)).astype(np.int32)
    score_j = jnp.asarray(score32).astype(jnp.bfloat16)
    ref = np.asarray(jbt.dense_sweep(score_j, jnp.asarray(start),
                                     jax.random.PRNGKey(0), stochastic=False))
    ref_fused = np.asarray(jbt.dense_sweep_fused(
        score_j, jnp.asarray(start), jax.random.PRNGKey(0), stochastic=False,
        tile=64))
    score_t = torch.from_numpy(score32).to(torch.bfloat16)
    assert np.array_equal(score_t.float().numpy(),
                          np.asarray(score_j.astype(jnp.float32)))
    got = bt.dense_sweep(score_t, torch.from_numpy(start).long(),
                         torch.Generator().manual_seed(0), stochastic=False)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), ref_fused)
    # on CPU tensors the K2 wrapper is the plain sweep
    got_w = bt.dense_sweep_fused(score_t, torch.from_numpy(start).long(),
                                 torch.Generator().manual_seed(0), stochastic=False)
    np.testing.assert_array_equal(got_w.numpy(), ref)


def _numpy_gumbel_bf16(bits):
    """numpy mirror of deepaco_tpu/ops/pallas_kernels.py:489-495."""
    u = np.maximum(((bits >> 13) & 0x7F).astype(np.float32) * np.float32(2.0 ** -7),
                   np.float32(1.1754944e-38))
    inner = (-np.log(u)).astype(ml_dtypes.bfloat16)
    return (-np.log(inner.astype(np.float32))).astype(ml_dtypes.bfloat16)


def test_gumbel_bf16_law_matches_jax_support_and_numpy_mirror():
    bits = np.random.default_rng(5).integers(0, 2 ** 32, 4096, dtype=np.int64)
    bits = np.concatenate([bits, np.arange(128, dtype=np.int64) << 13])
    got = bt.gumbel_bf16_from_bits(torch.from_numpy(bits))
    mirror = _numpy_gumbel_bf16(bits.astype(np.uint32))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  mirror.view(np.int16))
    support = set(bt.gumbel_bf16_from_bits(
        torch.arange(128, dtype=torch.int64) << 13).float().tolist())
    draws = jax.random.gumbel(jax.random.PRNGKey(0), (200_000,), dtype=jnp.bfloat16)
    jax_support = set(np.asarray(draws.astype(jnp.float32)).tolist())
    assert support == jax_support
    assert max(support) < 4.9 and min(support) > -4.5


def test_gumbel_f32_is_full_width():
    bits = torch.randint(0, 2 ** 32, (200_000,), generator=torch.Generator().manual_seed(1))
    g = bt.gumbel_f32_from_bits(bits)
    assert bool(torch.isfinite(g).all())
    assert abs(g.mean().item() - 0.5772) < 0.01          # Euler-Mascheroni
    assert len(torch.unique(g)) > 150_000                # not a 128-value law
    assert g.max().item() > 8.0


def test_stochastic_sweep_builds_permutations_from_the_start():
    b, n, a = 2, 30, 6
    score32, d = _score(b, n, 3)
    for dtype in (torch.bfloat16, torch.float32):
        score = torch.from_numpy(3 * score32).to(dtype)
        start = torch.randint(0, n, (b, a), generator=torch.Generator().manual_seed(2))
        paths = bt.dense_sweep(score, start, torch.Generator().manual_seed(4))
        assert paths.shape == (b, n, a) and paths.dtype == torch.int64
        assert torch.equal(paths[:, 0], start)
        assert torch.equal(torch.sort(paths, dim=1).values,
                           torch.arange(n)[None, :, None].expand(b, n, a))
        greedy = bt.dense_sweep(score, start, None, stochastic=False)
        dist = torch.from_numpy(d)
        assert tour_cost(dist, greedy).mean() < tour_cost(dist, paths).mean()


def test_tsp_sweep_construct_greedy_equals_jax_pallas_kernel():
    """Row 9: the single-instance f32 sweep, greedy, against the JAX
    package's tsp_sweep_construct_pallas in interpret mode (its test case:
    n=30, a=4, normal scores); tours exactly equal."""
    from deepaco_tpu.ops.pallas_kernels import tsp_sweep_construct_pallas

    n, a = 30, 4
    score = np.random.default_rng(40).standard_normal((n, n)).astype(np.float32)
    start = np.array([0, 3, 3, 29], dtype=np.int32)
    ref = np.asarray(tsp_sweep_construct_pallas(jnp.asarray(score), jnp.asarray(start),
                                                jnp.int32(0), stochastic=False))
    gen = torch.Generator().manual_seed(0)
    got = bt.tsp_sweep_construct(torch.from_numpy(score), torch.from_numpy(start).long(),
                                 gen, stochastic=False)
    np.testing.assert_array_equal(got.numpy(), ref)
    paths = bt.tsp_sweep_construct(torch.from_numpy(score), torch.from_numpy(start).long(), gen)
    assert paths.shape == (n, a) and torch.equal(paths[0], torch.from_numpy(start).long())
    assert torch.equal(torch.sort(paths, dim=0).values, torch.arange(n)[:, None].expand(n, a))
