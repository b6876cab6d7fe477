"""Port parity: one EmbNet layer's gather phase (ops/gnn_layer.py) against
the JAX fused layer, its Pallas kernel in interpret mode and its custom VJP,
and the reverse adjacency that K6's backward walks."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.ops.pallas_kernels import (fused_gnn_layer_ad,
                                            fused_gnn_layer_pallas,
                                            fused_gnn_layer_xla,
                                            gated_mean_aggregate_pallas)
from deepaco_tpu_torch.ops import gnn_layer

B, N, K, U = 2, 24, 6, 32
NAMES = ("x2", "x3", "x4", "w", "ew", "eb")


def _inputs(seed, n=N, rows=N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x2": f(B, n, U), "x3": f(B, rows, U), "x4": f(B, n, U),
            "w": f(B, rows, K, U), "ew": f(U, U) * 0.1, "eb": f(U) * 0.1,
            "nbr": rng.integers(0, n, (B, rows, K)).astype(np.int32)}


def _torch(d, grad=False):
    out = {k: torch.from_numpy(v) for k, v in d.items()}
    out["nbr"] = out["nbr"].long()
    if grad:
        for k in NAMES:
            out[k].requires_grad_(True)
    return out


def _args(d):
    return tuple(d[k] for k in ("x2", "x3", "x4", "nbr", "w", "ew", "eb"))


def test_plain_layer_matches_jax_kernel_and_xla():
    """Forward: (agg, pre) per instance against the Pallas kernel (interpret
    mode, f32 HIGHEST products) and fused_gnn_layer_xla; rtol 1e-5 / atol
    1e-5, the sum orders of a 32-term product and a K-term mean."""
    d = _inputs(0)
    t = _torch(d)
    agg, pre = gnn_layer.fused_gnn_layer(*_args(t))
    plain = gnn_layer.fused_gnn_layer_plain(*_args(t))
    for b in range(B):
        args = (d["x2"][b], d["x3"][b], d["x4"][b], d["nbr"][b], d["w"][b],
                d["ew"], d["eb"])
        for ref_agg, ref_pre in (fused_gnn_layer_pallas(*args),
                                 fused_gnn_layer_xla(*args)):
            np.testing.assert_allclose(agg[b].numpy(), ref_agg, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(pre[b].numpy(), ref_pre, rtol=1e-5, atol=1e-5)
    assert torch.equal(agg, plain[0]) and torch.equal(pre, plain[1])


def test_layer_gradients_match_jax_custom_vjp():
    """All six input gradients under the mixed loss of
    tests/test_pallas_kernels.py:223-235, against jax.grad of
    fused_gnn_layer_ad (Pallas forward in interpret mode, hand-written VJP),
    at that test's rtol 1e-4 / atol 1e-5; the wrapper's backward (the
    written-out VJP) and autograd through the plain forward agree too."""
    d = _inputs(1)
    rng = np.random.default_rng(2)
    ca = rng.standard_normal((B, N, U)).astype(np.float32)
    cp = rng.standard_normal((B, N, K, U)).astype(np.float32)

    def jloss(x2, x3, x4, w, ew, eb):
        total = 0.0
        for b in range(B):
            agg, pre = fused_gnn_layer_ad(x2[b], x3[b], x4[b], d["nbr"][b], w[b], ew, eb)
            total = total + jnp.sum(agg * ca[b]) + jnp.sum(jnp.tanh(pre) * cp[b])
        return total

    ref = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(d[k]) for k in NAMES))
    for layer in (gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_plain):
        t = _torch(d, grad=True)
        agg, pre = layer(*_args(t))
        loss = (agg * torch.from_numpy(ca)).sum() + (torch.tanh(pre) * torch.from_numpy(cp)).sum()
        loss.backward()
        for name, r in zip(NAMES, ref):
            np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(r),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_reverse_adjacency_walk_equals_index_add():
    """K6's node pass sums, for each node, the edges into it in increasing
    edge order over the reverse adjacency; that walk, done here in numpy,
    equals index_add_ (node_sum_plain) within f32 rounding (rtol 1e-6)."""
    d = _inputs(3)
    nbr = torch.from_numpy(d["nbr"]).long()
    idx = gnn_layer.reverse_adjacency(nbr)
    assert idx.nbr32.dtype == idx.offsets.dtype == idx.edges.dtype == torch.int32
    values = np.random.default_rng(4).standard_normal((B, N, K, U)).astype(np.float32)
    want = gnn_layer.node_sum_plain(nbr, torch.from_numpy(values)).numpy()
    off, edges = idx.offsets.numpy(), idx.edges.numpy()
    for b in range(B):
        assert off[b, 0] == 0 and off[b, -1] == N * K
        flat = values[b].reshape(N * K, U)
        for j in range(N):
            into = edges[b, off[b, j]:off[b, j + 1]]
            assert np.all(np.diff(into) > 0)                       # increasing
            assert np.all(d["nbr"][b].reshape(-1)[into] == j)       # all into j
            walk = np.zeros(U, np.float32)
            for e in into:
                walk = walk + flat[e]
            np.testing.assert_allclose(walk, want[b, j], rtol=1e-6, atol=1e-6)


def test_gated_mean_aggregate_matches_jax_kernel():
    """Row 8: R=20 rows over an N=24 node table, against
    gated_mean_aggregate_pallas in interpret mode (rtol 1e-5 / atol 1e-6,
    the mean's sum order)."""
    d = _inputs(5, rows=20)
    got = gnn_layer.gated_mean_aggregate(torch.from_numpy(d["x2"]),
                                         torch.from_numpy(d["nbr"]).long(),
                                         torch.from_numpy(d["w"]))
    assert got.shape == (B, 20, U)
    for b in range(B):
        ref = gated_mean_aggregate_pallas(d["x2"][b], d["nbr"][b], d["w"][b])
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["units", "dtype"])
def test_layer_kernel_checks_raise_before_launch(bad):
    """K6 takes 32 f32 units; the checks raise before any launch."""
    d = _torch(_inputs(6))
    if bad == "units":
        d = {k: (v[..., :16] if k in ("x2", "x3", "x4", "w") else v) for k, v in d.items()}
    else:
        d = {k: (v.double() if k == "w" else v) for k, v in d.items()}
    idx = gnn_layer.reverse_adjacency(d["nbr"])
    with pytest.raises(ValueError):
        gnn_layer._check_layer("k6", d["x2"], d["x3"], d["x4"], idx.nbr32, d["w"],
                               d["ew"], d["eb"])
