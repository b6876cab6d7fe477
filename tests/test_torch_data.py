"""Port parity: instance data and the k-NN graph (deepaco_tpu_torch vs deepaco_tpu)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.core import graph as jgraph
from deepaco_tpu.utils import datasets as jdata
from deepaco_tpu_torch.core import graph
from deepaco_tpu_torch.utils import datasets


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _coords(n, seed, dup=0):
    c = np.random.default_rng(seed).random((n, 2)).astype(np.float32)
    if dup:
        c[-dup:] = c[:dup]          # duplicated points: exact distance ties
    return c


@pytest.mark.parametrize("n", [20, 100, 500])
def test_distance_matrix_matches_jax(n):
    c = _coords(n, n)
    ref = np.asarray(jdata.distance_matrix(jnp.asarray(c)))
    got = datasets.distance_matrix(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)         # 2-opt moves compare them
    assert np.all(np.diag(got) == 1e9)


@pytest.mark.parametrize("n,k,dup", [(20, 5, 0), (100, 10, 0), (500, 50, 0),
                                     (100, 10, 30)])
def test_knn_indices_equal_jax(n, k, dup):
    """Same distance matrix into both: indices and edge values exactly equal,
    ties (duplicated points) going to the lowest index as lax.top_k does."""
    c = _coords(n, 7 + n, dup)
    dist = np.array(jdata.distance_matrix(jnp.asarray(c)))
    ref = jgraph.knn_graph(jnp.asarray(c), jnp.asarray(dist), k)
    got = graph.knn_graph(torch.from_numpy(c), torch.from_numpy(dist), k)
    np.testing.assert_array_equal(got.nbr.numpy(), np.asarray(ref.nbr))
    np.testing.assert_array_equal(got.edge.numpy(), np.asarray(ref.edge))
    if dup:
        vals = got.edge[..., 0]                     # ties inside the top-k
        assert bool((vals[:, 1:] == vals[:, :-1]).any())


def test_batched_knn_and_sparse_distance_match_jax():
    b, n, k = 3, 40, 6
    c = np.stack([_coords(n, s, dup=5) for s in range(b)])
    dist = np.array(jax.vmap(jdata.distance_matrix)(jnp.asarray(c)))
    ref = jax.vmap(lambda ci, d: jgraph.knn_graph(ci, d, k))(
        jnp.asarray(c), jnp.asarray(dist))
    got = graph.knn_graph(torch.from_numpy(c), torch.from_numpy(dist), k)
    np.testing.assert_array_equal(got.nbr.numpy(), np.asarray(ref.nbr))
    ref_sd = jax.vmap(lambda d: jgraph.sparse_distance_matrix(d, k))(
        jnp.asarray(dist))
    got_sd = graph.sparse_distance_matrix(torch.from_numpy(dist), k)
    np.testing.assert_array_equal(got_sd.numpy(), np.asarray(ref_sd))
    vec = np.random.default_rng(0).random((b, n, k)).astype(np.float32)
    ref_dense = jax.vmap(jgraph.scatter_to_dense)(ref, jnp.asarray(vec))
    got_dense = graph.scatter_to_dense(got, torch.from_numpy(vec))
    np.testing.assert_array_equal(got_dense.numpy(), np.asarray(ref_dense))


def test_uniform_coords_seeded():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = datasets.uniform_coords(50, g1, batch=4, device="cpu")
    b = datasets.uniform_coords(50, g2, batch=4, device="cpu")
    assert a.shape == (4, 50, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
