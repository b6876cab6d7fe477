"""Port parity: the graph-given EmbNet forward (ops/fused_gnn.net_forward_fast
and K9's plain version embnet_layers_plain) against the JAX package's
net_forward_fast in f32, whose Pallas kernel embnet_layers_pallas runs in
interpret mode on the CPU (jitted), and against JAX's Net.apply."""
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import large_tsp as jl
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.ops import fused_gnn as jfused
from deepaco_tpu_torch.aco import large_tsp as tl
from deepaco_tpu_torch.models.gnn import Net, init_like_flax, to_jax_variables
from deepaco_tpu_torch.ops import fused_gnn
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CKPT = Path(__file__).resolve().parent.parent / "checkpoints"
# JAX's own tolerance between its f32 kernel and Net.apply (test_fused_gnn.py)
RTOL, ATOL = 2e-4, 2e-5


def _graph(b, n, k, e, seed):
    """Seeded coordinates, their k-NN support and ``e`` edge features (the
    neighbour distance, then seeded noise)."""
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.random((b, n, 2)).astype(np.float32))
    nbr = tl.knn_support(coords, k)
    edge = tl.sparse_tsp_graph(coords, nbr).edge
    if e > 1:
        extra = rng.random((b, n, k, e - 1)).astype(np.float32)
        edge = torch.cat([edge, torch.from_numpy(extra)], dim=-1)
    return coords, nbr, edge


@partial(jax.jit, static_argnames=("depth", "node_update", "heads"))
def _jax_fast(variables, x, nbr, edge, depth, node_update, heads):
    return jfused.net_forward_fast(variables, x, nbr, edge, depth=depth, units=32,
                                   node_update=node_update, heads=heads,
                                   compute_dtype=jnp.float32)


def _compare(net, coords, nbr, edge, heads, variables=None):
    variables = variables or to_jax_variables(net)
    emb = net.emb_net
    ref = _jax_fast(variables, jnp.asarray(coords.numpy()), jnp.asarray(nbr.int().numpy()),
                    jnp.asarray(edge.numpy()), depth=emb.depth,
                    node_update=emb.node_update, heads=heads)
    got = fused_gnn.net_forward_fast(net, coords, nbr, edge, heads=heads)
    ref, got = (ref, got) if len(heads) > 1 else ((ref,), (got,))
    for g, r in zip(got, ref):
        assert g.shape == nbr.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("heads,node_update,edge_feats", [
    (("phe", "heu"), True, 1),
    (("heu",), True, 1),
    (("heu",), False, 1),
    (("phe", "heu"), True, 2),
])
def test_net_forward_fast_matches_jax_kernel(heads, node_update, edge_feats):
    """Random Flax-law weights (with nonzero BatchNorm statistics, so the
    fold is exercised), 4 layers, n=60, k=8."""
    net = init_like_flax(Net(edge_feats=edge_feats, depth=4, node_update=node_update,
                             dual_heads=len(heads) > 1), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for bn in list(net.emb_net.v_bns) + list(net.emb_net.e_bns):
            bn.running_mean.normal_(0.0, 0.3, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
            bn.weight.uniform_(0.5, 1.5, generator=gen)
    coords, nbr, edge = _graph(2, 60, 8, edge_feats, seed=3)
    _compare(net.eval(), coords, nbr, edge, heads)


def test_net_forward_fast_matches_jax_kernel_and_apply_on_tsp500_selftrained():
    """The sparse path's checkpoint, 12 layers, n=100, k=10: both heads
    against JAX's kernel, and the heuristic head against JAX's
    ``Net(dual_heads=True).apply(train=False)[1]`` on JAX's
    ``sparse_tsp_graph``."""
    v = load_checkpoint(str(CKPT / "tsp500_selftrained.msgpack"))
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    net = Net.from_jax_variables(variables)
    coords, nbr, edge = _graph(2, 100, 10, 1, seed=4)
    _compare(net, coords, nbr, edge, ("phe", "heu"), variables)
    model = JNet(dual_heads=True, use_pallas=False)
    apply = jax.jit(lambda x, nb: model.apply(variables, jl.sparse_tsp_graph(x, nb),
                                              train=False)[1])
    got = tl.neural_knn_heuristic(net, coords, nbr)
    for i in range(2):
        ref = apply(jnp.asarray(coords[i].numpy()), jnp.asarray(nbr[i].int().numpy())) + 1e-10
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_embnet_layers_takes_its_plain_version_on_the_cpu():
    net = init_like_flax(Net(depth=2), torch.Generator().manual_seed(0)).eval()
    coords, nbr, edge = _graph(1, 30, 6, 1, seed=5)
    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, coords)
    before = fused_gnn.embnet_layers.launches
    got = fused_gnn.embnet_layers(f, x, nbr, edge, k=6)
    assert fused_gnn.embnet_layers.launches == before
    assert torch.equal(got, fused_gnn.embnet_layers_plain(f, x, nbr, edge, k=6))
    assert got.shape == (1, 30, 6, 32) and got.dtype == torch.float32
    with pytest.raises(ValueError, match="K=6"):
        fused_gnn.embnet_layers(f, x, nbr, edge, k=5)
