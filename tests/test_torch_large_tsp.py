"""Port parity: the large-N sparse-state TSP path (aco/large_tsp.py) against
the JAX package's, on the CPU. Deterministic pieces are held exactly or to
one ulp; sampling in law."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import large_tsp as jl
from deepaco_tpu.aco.runner import ACOConfig as JConfig
from deepaco_tpu_torch.aco import large_tsp as tl
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


def _coords(b, n, seed):
    return np.random.default_rng(seed).random((b, n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def inst():
    """Two instances of 120 cities, k=15, with JAX's support per instance."""
    coords = _coords(2, 120, 7)
    nbr = np.stack([np.asarray(jl.knn_support(jnp.asarray(c), 15)) for c in coords])
    return coords, nbr


@pytest.mark.parametrize("n,k,seed", [(120, 15, 7), (2048, 12, 11)])
def test_knn_support_ids_equal_jax(n, k, seed):
    """n=2048 makes JAX's row tile 1953 (4M/n): its last 95 rows are a
    partial tile, the case that once read earlier rows' lists."""
    coords = _coords(1, n, seed)
    ref = np.asarray(jl.knn_support(jnp.asarray(coords[0]), k))
    got = tl.knn_support(torch.from_numpy(coords), k)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_knn_support_is_the_same_with_small_row_tiles(inst, monkeypatch):
    coords, nbr = inst
    monkeypatch.setattr(tl, "_TILE_DISTANCES", 7 * 120 * 2)   # 7-row tiles, tail of 1
    np.testing.assert_array_equal(tl.knn_support(torch.from_numpy(coords), 15).numpy(), nbr)


def test_graph_edges_and_classic_heuristic_match_jax(inst):
    """Both are a correctly rounded root of the same f32 sum: within 1 ulp."""
    coords, nbr = inst
    c, idx = torch.from_numpy(coords), torch.from_numpy(nbr).long()
    g = tl.sparse_tsp_graph(c, idx)
    heu = tl.classic_knn_heuristic(c, idx)
    for i in range(2):
        jg = jl.sparse_tsp_graph(jnp.asarray(coords[i]), jnp.asarray(nbr[i]))
        np.testing.assert_array_max_ulp(g.edge[i].numpy(), np.asarray(jg.edge), maxulp=1)
        jheu = jl.classic_knn_heuristic(jnp.asarray(coords[i]), jnp.asarray(nbr[i]))
        np.testing.assert_array_max_ulp(heu[i].numpy(), np.asarray(jheu), maxulp=1)
    assert torch.equal(g.x, c)


def _tours(b, n, a, seed):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.permutation(n) for _ in range(a)], axis=1)
                     for _ in range(b)])                                   # [B, N, A]


def test_tour_cost_coords_matches_jax(inst):
    coords, _ = inst
    paths = _tours(2, 120, 3, 0)
    got = tl.tour_cost_coords(torch.from_numpy(coords), torch.from_numpy(paths))
    for i in range(2):
        ref = jl.tour_cost_coords(jnp.asarray(coords[i]), jnp.asarray(paths[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("symmetric", [True, False])
def test_deposit_knn_matches_jax(inst, symmetric):
    """The same paths and amounts: allclose (duplicate adds summed in another
    order), with every off-support edge dropped. Each instance's first tour
    walks nearest-neighbour links, so it deposits on the support; the random
    tours mostly fall off it."""
    coords, nbr = inst
    b, n, k = nbr.shape
    paths = _tours(b, n, 4, 1)
    for i in range(b):
        walk = [0]
        while len(walk) < n:
            nxt = [v for v in nbr[i, walk[-1]] if v not in walk]
            walk.append(nxt[0] if nxt else min(set(range(n)) - set(walk)))
        paths[i, :, 0] = walk
    amounts = np.random.default_rng(2).random((b, 4)).astype(np.float32) + 0.5
    tau = np.random.default_rng(3).random((b, n, k)).astype(np.float32) + 1.0
    got = tl.deposit_knn(torch.from_numpy(tau), torch.from_numpy(nbr).long(),
                         torch.from_numpy(paths), torch.from_numpy(amounts), symmetric)
    for i in range(b):
        ref = jl.deposit_knn(jnp.asarray(tau[i]), jnp.asarray(nbr[i]), jnp.asarray(paths[i]),
                             jnp.asarray(amounts[i]), symmetric)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    v = np.roll(paths, -1, axis=1)
    hit = lambda x, y: (nbr[np.arange(b)[:, None, None], x] == y[..., None]).any(-1).astype(int)
    on = hit(paths, v) + (hit(v, paths) if symmetric else 0)    # [B, N, A] deposits of an edge
    mass = (on * amounts[:, None, :]).sum(axis=(1, 2))
    np.testing.assert_allclose((got.numpy() - tau).sum(axis=(1, 2)), mass, rtol=1e-5)
    assert 0 < on.sum() < (2 if symmetric else 1) * on.size    # some on, some dropped


def test_sweep_construct_knn_permutations_and_fallbacks(inst):
    coords, nbr = inst
    c, idx = torch.from_numpy(coords), torch.from_numpy(nbr).long()
    score = torch.log(tl.classic_knn_heuristic(c, idx)).to(torch.bfloat16)
    start = torch.tensor([[0] * 6, [5] * 6])
    paths, fb = tl.sweep_construct_knn(score, idx, start, torch.Generator().manual_seed(3),
                                       with_stats=True)
    assert paths.shape == (2, 120, 6)
    assert torch.equal(paths[:, 0], start)
    assert torch.equal(torch.sort(paths, dim=1).values,
                       torch.arange(120)[None, :, None].expand_as(paths))
    # small n, k=15: the endgame exhausts some neighbourhoods
    assert bool((fb > 0).all()) and bool((fb <= 6 * 119).all())
    with pytest.raises(ValueError, match="bf16"):
        tl.sweep_construct_knn(score.float(), idx, start, torch.Generator())


def test_fallback_counts_match_jax_in_law(inst):
    """Fallback ant-steps per sweep on the same bf16 score: JAX over 24 keys,
    the port over 24 sweeps of 8 ants, each mean over 192 ant-sweeps of
    about 40 fallbacks each; they must agree within 10%."""
    coords, nbr = inst
    heu = jl.classic_knn_heuristic(jnp.asarray(coords[0]), jnp.asarray(nbr[0]))
    score = jnp.log(jnp.maximum(heu, 1e-30)).astype(jnp.bfloat16)
    start = jnp.arange(8, dtype=jnp.int32) * 13
    sweep = jax.jit(lambda key: jl.sweep_construct_knn(score, jnp.asarray(nbr[0]), start, key,
                                                       with_stats=True)[1])
    ref = np.mean([int(sweep(jax.random.PRNGKey(s))) for s in range(24)])
    t_score = torch.tensor(np.asarray(score.astype(jnp.float32))).to(torch.bfloat16)
    t_nbr = torch.from_numpy(nbr[:1]).long().expand(24, -1, -1)
    _, fb = tl.sweep_construct_knn(t_score[None].expand(24, -1, -1), t_nbr,
                                   torch.tensor(np.asarray(start)).long()[None].expand(24, -1),
                                   torch.Generator().manual_seed(0), with_stats=True)
    assert abs(fb.float().mean().item() - ref) <= 0.1 * ref


@pytest.mark.parametrize("arm", ["classic", "neural"])
def test_run_anytime_knn_matches_jax_in_law(arm):
    """Mean cost@T over 12 instances of 150 cities (k=15, 8 ants, T=5): JAX
    one instance at a time, the port batched; within 2%, as
    test_torch_anytime.py holds the dense path."""
    from deepaco_tpu.models.gnn import Net as JNet
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    b, n, k, ants, t = 12, 150, 15, 8, 5
    coords = _coords(b, n, 21)
    c = torch.from_numpy(coords)
    nbr = tl.knn_support(c, k)
    if arm == "classic":
        heu = tl.classic_knn_heuristic(c, nbr)
        jheu = [jl.classic_knn_heuristic(jnp.asarray(x), jnp.asarray(nbr[i].numpy()))
                for i, x in enumerate(coords)]
    else:
        v = load_checkpoint("checkpoints/tsp100_selftrained.msgpack")
        variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
        heu = tl.neural_knn_heuristic(Net.from_jax_variables(variables), c, nbr)
        model = JNet(dual_heads=True, use_pallas=False)
        fwd = jax.jit(lambda x, nb: model.apply(
            variables, jl.sparse_tsp_graph(x, nb), train=False)[1] + 1e-10)
        jheu = [fwd(jnp.asarray(x), jnp.asarray(nbr[i].numpy())) for i, x in enumerate(coords)]
        np.testing.assert_allclose(heu.numpy(), np.stack([np.asarray(h) for h in jheu]),
                                   rtol=2e-4, atol=2e-5)
    ref = np.stack([np.asarray(jl.run_anytime_knn(
        jnp.asarray(coords[i]), jnp.asarray(nbr[i].numpy()), jheu[i], JConfig(n_ants=ants), t,
        None, jax.random.PRNGKey(i))[0]) for i in range(b)])
    curve, best = tl.run_anytime_knn(c, nbr, heu, ACOConfig(n_ants=ants), t, None,
                                     torch.Generator().manual_seed(0), device="cpu")
    assert curve.shape == (b, t) and bool((curve[:, 1:] <= curve[:, :-1]).all())
    np.testing.assert_allclose(curve.mean(0).numpy(), ref.mean(0), rtol=0.02)
    assert torch.equal(torch.sort(best, dim=1).values, torch.arange(n).expand(b, n))
    torch.testing.assert_close(tl.tour_cost_coords(c, best[..., None])[:, 0], curve[:, -1],
                               rtol=1e-6, atol=0)


def test_run_anytime_knn_with_2opt_and_stats(inst):
    """ls='2opt' improves every iteration's tours (the plain K4 on the CPU);
    stats count fallbacks and off-support edges; another ls raises."""
    coords, nbr = inst
    c, idx = torch.from_numpy(coords), torch.from_numpy(nbr).long()
    heu = tl.classic_knn_heuristic(c, idx)
    cfg = ACOConfig(n_ants=4)
    stats = {}
    plain, _ = tl.run_anytime_knn(c, idx, heu, cfg, 2, None, torch.Generator().manual_seed(1),
                                  device="cpu", stats=stats)
    opt, best = tl.run_anytime_knn(c, idx, heu, cfg, 2, "2opt",
                                   torch.Generator().manual_seed(1), device="cpu")
    assert bool((opt < plain).all())
    assert torch.equal(torch.sort(best, dim=1).values, torch.arange(120).expand(2, 120))
    assert stats["ant_steps"] == 2 * 4 * 119 * 2 and stats["tour_edges"] == 2 * 4 * 120 * 2
    assert 0 < stats["fallback_steps"] <= stats["off_support_edges"] < stats["tour_edges"]
    with pytest.raises(ValueError, match="2opt"):
        tl.run_anytime_knn(c, idx, heu, cfg, 1, "nls", torch.Generator(), device="cpu")
