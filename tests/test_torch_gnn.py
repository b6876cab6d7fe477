"""Port parity: the GNN heuristic (models/gnn.py, ops/fused_gnn.py) against
the JAX Net and the JAX dense-heuristic kernel (interpret mode on the CPU)."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.core.graph import knn_graph as jknn, scatter_to_dense as jscatter
from deepaco_tpu.models.gnn import Net as JNet, TorchBatchNorm as JBatchNorm
from deepaco_tpu.ops import fused_gnn as jfused
from deepaco_tpu.utils.datasets import distance_matrix as jdist
from deepaco_tpu_torch.core.graph import knn_graph
from deepaco_tpu_torch.models.gnn import Net, TorchBatchNorm
from deepaco_tpu_torch.ops import fused_gnn
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
from deepaco_tpu_torch.utils.datasets import distance_matrix

CKPT = Path(__file__).resolve().parent.parent / "checkpoints"


@pytest.fixture(scope="module")
def tsp100():
    v = load_checkpoint(str(CKPT / "tsp100_selftrained.msgpack"))
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _coords(b, n, seed):
    return np.random.default_rng(seed).random((b, n, 2)).astype(np.float32)


def _jax_pipeline(variables, coords, k):
    """knn_graph + Net.apply(train=False) + scatter_to_dense + 1e-10."""
    model = JNet(dual_heads=True, use_pallas=False)

    def per(c):
        d = jdist(c)
        g = jknn(c, d, k)
        phe, heu = model.apply(variables, g, train=False)
        return phe, heu, jscatter(g, heu) + 1e-10, d

    return jax.vmap(per)(jnp.asarray(coords))


def test_net_matches_jax_net_apply(tsp100):
    b, n, k = 2, 100, 10
    coords = _coords(b, n, 0)
    phe, heu, _, _ = _jax_pipeline(tsp100, coords, k)
    net = Net.from_jax_variables(tsp100)
    c = torch.from_numpy(coords)
    with torch.no_grad():
        got_phe, got_heu = net(knn_graph(c, distance_matrix(c), k))
    np.testing.assert_allclose(got_heu.numpy(), np.asarray(heu), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_phe.numpy(), np.asarray(phe), rtol=2e-4, atol=2e-5)


def test_fold_matches_jax(tsp100):
    ref = jfused.fold_embnet_params(tsp100)
    got = fused_gnn.fold_embnet_params(Net.from_jax_variables(tsp100).emb_net)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_dense_heuristic_matches_jax_kernel_and_pipeline(tsp100):
    b, n, k = 2, 100, 10
    coords = _coords(b, n, 1)
    _, _, ref_pipe, dist = _jax_pipeline(tsp100, coords, k)
    ref_kernel = jfused.tsp_dense_heuristic(tsp100, jnp.asarray(coords), dist, k,
                                            compute_dtype=jnp.float32)
    net = Net.from_jax_variables(tsp100)
    got = fused_gnn.tsp_dense_heuristic(net, torch.from_numpy(coords),
                                        torch.from_numpy(np.array(dist)), k)
    assert got.shape == (b, n, n)
    # both fold BatchNorm the same way; they differ only in sum order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), rtol=1e-4, atol=1e-5)
    # the fold re-associates against the unfolded net (tests/test_fused_gnn.py:156)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pipe), rtol=5e-4, atol=2e-4)


def test_batchnorm_train_mode_matches_jax():
    """Train mode: statistics per instance, as the JAX trainer takes them
    inside its vmap over instances (reinforce.py:166-169), the biased
    variance to normalise, the unbiased one for the running update,
    momentum 0.1, eps 1e-5; running statistics averaged over instances."""
    x = np.random.default_rng(2).normal(size=(3, 7, 32)).astype(np.float32)
    mod = JBatchNorm(use_running_average=False)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    ref, upd = jax.vmap(lambda xb: mod.apply(variables, xb, mutable=["batch_stats"]))(
        jnp.asarray(x))
    stats = jax.tree_util.tree_map(lambda s: s.mean(0), upd["batch_stats"])
    bn = TorchBatchNorm(32).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)
