"""Port parity: 2-opt and NLS local search (deepaco_tpu_torch/ops/two_opt.py)
and the TSP graph builders against deepaco_tpu, on the CPU.

The plain versions are held to the JAX XLA ops, and the kernel wrappers (which
take their plain versions for CPU tensors) to the Pallas kernels run in
interpret mode, as tests/test_pallas_two_opt.py runs them. Every tour is
compared exactly. The same numpy inputs go to both packages.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deepaco_tpu.core import builders as jbuilders
from deepaco_tpu.ops import batched_nls as jbatched_nls
from deepaco_tpu.ops import batched_two_opt as jbatched_two_opt
from deepaco_tpu.ops import heuristic_dist as jheuristic_dist
from deepaco_tpu.ops import pallas_two_opt as jpto
from deepaco_tpu.ops import two_opt_once as jtwo_opt_once
from deepaco_tpu.ops.two_opt import _tour_lengths as jtour_lengths
from deepaco_tpu.utils.datasets import distance_matrix as jdistance
from deepaco_tpu_torch.core import builders
from deepaco_tpu_torch.core.graph import knn_graph
from deepaco_tpu_torch.ops import two_opt


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def instance(n, seed):
    """Coordinates [n, 2] f32 and the JAX distance matrix, both numpy."""
    c = np.random.default_rng(seed).random((n, 2)).astype(np.float32)
    return c, np.asarray(jdistance(jnp.asarray(c)))


def random_tours(n, a, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(a)]).astype(np.int32)


def metric(dist):
    """The f32 asymmetric perturbation metric heuristic_dist(1/dist)."""
    return np.asarray(jheuristic_dist(1.0 / jnp.asarray(dist)))


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def t(x):
    return torch.from_numpy(np.array(x))


def assert_permutations(tours):
    n = tours.shape[-1]
    assert (np.sort(tours, axis=-1) == np.arange(n)).all()


@pytest.mark.parametrize("n,a,budget,seed", [(21, 4, 50, 0), (16, 3, 2, 3)])
def test_batched_two_opt_matches_jax(n, a, budget, seed):
    _, dist = instance(n, seed)
    tours = random_tours(n, a, seed + 1)
    want = np.asarray(jbatched_two_opt(jnp.asarray(dist), jnp.asarray(tours), budget))
    got = two_opt.batched_two_opt(t(dist), t(tours), budget).numpy()
    np.testing.assert_array_equal(got, want)
    assert_permutations(got)


def test_two_opt_once_matches_jax():
    _, dist = instance(19, 2)
    for tour in random_tours(19, 5, 4):
        new, delta = jtwo_opt_once(jnp.asarray(dist), jnp.asarray(tour))
        got_new, got_delta = two_opt.two_opt_once(t(dist), t(tour))
        np.testing.assert_array_equal(got_new.numpy(), np.asarray(new))
        assert got_delta.item() == float(delta)
    converged = two_opt.two_opt(t(dist), t(tour), 1000)
    assert two_opt.two_opt_once(t(dist), converged)[1].item() == 0.0


def test_batched_nls_matches_jax_with_the_f32_metric():
    """The asymmetric metric (each row normalised by its own maximum) is what
    catches a transposed index; a symmetric one would hide it."""
    _, dist = instance(18, 5)
    hd = metric(dist)
    assert not np.array_equal(hd, hd.T)
    tours = random_tours(18, 3, 6)
    want = np.asarray(jbatched_nls(jnp.asarray(dist), jnp.asarray(hd),
                                   jnp.asarray(tours), 30, 2, 5))
    got = two_opt.batched_nls(t(dist), t(hd), t(tours), 30, 2, 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert_permutations(got)


@pytest.mark.parametrize("n,a,budget,seed", [(21, 4, 50, 0), (16, 3, 2, 3)])
def test_two_opt_euclid_matches_pallas_interpret(n, a, budget, seed):
    coords, _ = instance(n, seed)
    tours = random_tours(n, a, seed + 1)
    want = np.asarray(jpto.batched_two_opt_euclid(jnp.asarray(coords),
                                                  jnp.asarray(tours), budget))
    got = two_opt.batched_two_opt_euclid(t(coords), t(tours), budget).numpy()
    np.testing.assert_array_equal(got, want)


def test_nls_euclid_matches_pallas_interpret():
    """The kernel rounds the perturbation metric to bf16; so does the port."""
    coords, dist = instance(18, 5)
    hd = metric(dist)
    tours = random_tours(18, 3, 6)
    want = np.asarray(jpto.batched_nls_euclid(jnp.asarray(coords), jnp.asarray(hd),
                                              jnp.asarray(tours), 30, 2, 5))
    got = two_opt.batched_nls_euclid(t(coords), t(hd), t(tours), 30, 2, 5).numpy()
    np.testing.assert_array_equal(got, want)
    plain = two_opt.batched_nls(t(dist), t(bf16(hd)), t(tours), 30, 2, 5).numpy()
    np.testing.assert_array_equal(got, plain)


def _tiled_call(kernel, n, npad, tours, in_specs, scratch, args, **grid):
    return np.asarray(pl.pallas_call(
        kernel, in_specs=in_specs, scratch_shapes=scratch,
        out_specs=grid.pop("out_specs", pl.BlockSpec(memory_space=pltpu.VMEM)),
        out_shape=jax.ShapeDtypeStruct((tours.shape[0], 1, npad), jnp.int32),
        interpret=True, **grid)(*args))[:, 0, :n]


def test_nls_euclid_matches_tiled_pallas_kernel():
    """_tiled_nls_kernel (n <= 2048 on the TPU) at a small multi-tile shape,
    called directly as tests/test_pallas_two_opt.py calls it."""
    n, npad, tile = 30, 32, 16
    coords, dist = instance(n, 9)
    hd = metric(dist)
    tours = random_tours(n, 3, 10)
    want = _tiled_call(
        functools.partial(jpto._tiled_nls_kernel, n, npad, tile, 40, 2, 5), n, npad, tours,
        [pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pl.ANY),
         pl.BlockSpec(memory_space=pltpu.VMEM)],
        [pltpu.VMEM((npad // 4, npad), jnp.bfloat16), pltpu.VMEM((8, npad), jnp.float32),
         pltpu.SemaphoreType.DMA],
        (jpto._pad_coords(jnp.asarray(coords), npad),
         jpto._pad_square(jnp.asarray(hd), npad).astype(jnp.bfloat16),
         jpto._pad_tours(jnp.asarray(tours), npad)))
    got = two_opt.batched_nls_euclid(t(coords), t(hd), t(tours), 40, 2, 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_two_opt_euclid_matches_tiled_pallas_kernel():
    """_tiled_two_opt_kernel (n <= 4096 on the TPU) at a small multi-tile shape."""
    n, npad, tile = 30, 32, 16
    coords, _ = instance(n, 11)
    tours = random_tours(n, 3, 12)
    want = _tiled_call(
        functools.partial(jpto._tiled_two_opt_kernel, n, npad, tile, 60), n, npad, tours,
        [pl.BlockSpec((8, npad), lambda i: (0, 0)),
         pl.BlockSpec((1, 1, npad), lambda i: (i, 0, 0))], [],
        (jpto._pad_coords(jnp.asarray(coords), npad), jpto._pad_tours(jnp.asarray(tours), npad)),
        grid=(tours.shape[0],), out_specs=pl.BlockSpec((1, 1, npad), lambda i: (i, 0, 0)))
    got = two_opt.batched_two_opt_euclid(t(coords), t(tours), 60).numpy()
    np.testing.assert_array_equal(got, want)


def test_heuristic_dist_matches_jax():
    heu = np.random.default_rng(1).random((3, 25, 25)).astype(np.float32) + 1e-3
    want = np.asarray(jheuristic_dist(jnp.asarray(heu)))
    np.testing.assert_array_equal(two_opt.heuristic_dist(t(heu)).numpy(), want)


@pytest.mark.parametrize("builder,port", [("tsp_graph", knn_graph),
                                          ("tsp_nls_graph", builders.tsp_nls_graph)],
                         ids=["tsp_graph", "tsp_nls_graph"])
def test_tsp_graphs_match_jax(builder, port):
    """The JAX ``tsp_graph`` is ``knn_graph`` under another name; the port
    keeps the one name."""
    coords, dist = instance(40, 13)
    ref = getattr(jbuilders, builder)(jnp.asarray(coords), jnp.asarray(dist), 8)
    got = port(t(coords), t(dist), 8)
    for name in ("x", "nbr", "edge"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_start_node_features_are_batched():
    x = builders.start_node_features(torch.zeros(3, 7, 2), start_node=2)
    assert x.shape == (3, 7, 1)
    assert torch.equal(x[..., 0].sum(-1), torch.ones(3)) and bool((x[:, 2] == 1).all())


@pytest.mark.parametrize("ls,n", [("2opt", 4097), ("nls", 2049)])
def test_wrappers_raise_above_the_caps(ls, n):
    """Above the caps the wrappers no longer raise: they take the dense
    descent, as the JAX package does; 2-opt warns that it builds an [N, N]
    matrix. On coincident cities no move improves, so the tour stays."""
    coords = torch.zeros(n, 2)
    tours = torch.arange(n)[None]
    if ls == "2opt":
        with pytest.warns(UserWarning, match=str(two_opt.LS_CAPS[ls])):
            got = two_opt.batched_two_opt_euclid(coords, tours, 1)
    else:
        got = two_opt.batched_nls_euclid(coords, torch.ones(n, n), tours, 1, 1, 1)
    assert torch.equal(got, tours)


@pytest.mark.parametrize("n,ls", [(1000, "nls"), (2000, "nls"), (2048, "nls"),
                                  (2100, "nls"), (4096, "2opt"), (4200, "2opt")])
def test_ls_supported_matches_the_jax_caps(n, ls):
    assert two_opt.ls_supported(n, ls) == jpto.pallas_ls_supported(n, ls)


def test_leading_dims_run_each_instance_on_its_own():
    """[B, A, n] tours over [B, n, n] give each instance's own result, and
    ``scans`` counts every ant's iterations, the last one included."""
    dists = np.stack([instance(20, s)[1] for s in (20, 21)])
    tours = np.stack([random_tours(20, 3, s) for s in (22, 23)])
    scans = {}
    got = two_opt.batched_nls(t(dists), t(metric(dists)), t(tours), 50, 2, 4,
                              scans=scans).numpy()
    for b in range(2):
        alone = two_opt.batched_nls(t(dists[b]), t(metric(dists[b])), t(tours[b]), 50, 2, 4)
        np.testing.assert_array_equal(got[b], alone.numpy())
    assert scans["true"] >= 2 * 3 * 3 and 2 * 3 * 2 <= scans["perturb"] <= 2 * 3 * 2 * 4


def test_nls_differs_from_jax_only_by_a_reversed_tour_on_a_cost_tie():
    """The one known difference from the JAX package: XLA sums a tour's cost
    in no fixed order, so where a tour and its reverse cost the same to an
    ulp, NLS can keep the one in JAX and the other in the port. On this
    seed one of the four ants ends so. Every ant must equal JAX's tour or its
    reverse (city 0's position fixed), at a JAX cost within one ulp."""
    rng = np.random.default_rng(118)
    coords = rng.random((18, 2)).astype(np.float32)
    tours = np.stack([rng.permutation(18) for _ in range(4)]).astype(np.int32)
    dist = np.asarray(jdistance(jnp.asarray(coords)))
    hd = metric(dist)
    want = np.asarray(jbatched_nls(jnp.asarray(dist), jnp.asarray(hd),
                                   jnp.asarray(tours), 30, 3, 5))
    got = two_opt.batched_nls(t(dist), t(hd), t(tours), 30, 3, 5).numpy()
    assert_permutations(got)
    for mine, theirs in zip(got, want):
        reverse = np.concatenate([theirs[:1], theirs[1:][::-1]])
        assert (mine == theirs).all() or (mine == reverse).all()
        lengths = np.asarray(jtour_lengths(jnp.asarray(dist), jnp.asarray(np.stack([mine, theirs]))))
        assert abs(lengths[0] - lengths[1]) <= np.spacing(lengths[1])


def test_tour_lengths_are_summed_one_by_one():
    """NLS costs add the edges dist[t_k, t_{k-1}] from k = 0 in f32, the order
    K5 repeats."""
    _, dist = instance(23, 14)
    tours = random_tours(23, 4, 15)
    got = two_opt._tour_lengths(t(dist)[None], torch.zeros(4, dtype=torch.long),
                                t(tours).long()).numpy()
    for tour, cost in zip(tours, got):
        want = np.float32(0)
        for e in dist[tour, np.roll(tour, 1)]:
            want = np.float32(want + e)
        assert cost == want
