"""Port parity: the routes that take over where a kernel's limits end, on the
CPU against the JAX package.

- Local search without coordinates, or above K4's and K5's caps, runs the
  dense descents on ``[N, N]`` distances, as the JAX package falls back to
  them (batched_tsp.py:255-277, pallas_two_opt.py:598-611, 641-646).
- The dense TSP heuristic outside K1's limits goes through the k-NN graph
  and ``net_forward_fast`` (K9's limits) or ``Net`` with the plain layer,
  then ``scatter_to_dense`` + 1e-10 (eval/anytime.py:47-75).
- The family driver's heuristic (``train/drivers._forward_heu``) takes the
  folded layer stack (K9) for an eval-mode net that ``embnet_supported``
  takes, and ``Net`` a layer at a time (K6) otherwise.

Tours are compared exactly; heuristics at the tolerance each test states.
The same numpy inputs go to both packages.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.eval.anytime import batched_tsp_heuristic as jbatched_tsp_heuristic
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.ops import batched_nls as jbatched_nls
from deepaco_tpu.ops import batched_two_opt as jbatched_two_opt
from deepaco_tpu.ops import heuristic_dist as jheuristic_dist
from deepaco_tpu.ops import pallas_two_opt as jpto
from deepaco_tpu.utils.datasets import distance_matrix as jdistance
from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.core.builders import start_node_features
from deepaco_tpu_torch.eval import anytime
from deepaco_tpu_torch.models.gnn import Net, init_like_flax, to_jax_variables
from deepaco_tpu_torch.ops import fused_gnn, two_opt


def instances(b, n, seed):
    """Coordinates [b, n, 2] f32 and their JAX distance matrices, numpy."""
    c = np.random.default_rng(seed).random((b, n, 2)).astype(np.float32)
    return c, np.asarray(jax.vmap(jdistance)(jnp.asarray(c)))


def random_tours(b, a, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([[rng.permutation(n) for _ in range(a)] for _ in range(b)]).astype(np.int64)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("ls", ["2opt", "nls"])
def test_local_search_without_coords_matches_jax_on_dist(ls):
    """``_batched_ls_fn`` with no coordinates runs the dense descent on
    ``dist`` (NLS with the metric as it is, not rounded): tours exactly
    equal to JAX's ``batched_two_opt`` / ``batched_nls`` on the same inputs."""
    b, a, n, budget = 3, 4, 10, 50
    _, dist = instances(b, n, 30)
    heu = np.random.default_rng(31).random((b, n, n)).astype(np.float32) + 1e-3
    tours = random_tours(b, a, n, 32)
    fn = bt._batched_ls_fn(ls, None, t(dist), t(heu), budget, bt.KERNEL_OPS)
    before = (two_opt.batched_two_opt_euclid.launches, two_opt.batched_nls_euclid.launches)
    got = fn(t(tours).transpose(1, 2)).transpose(1, 2).numpy()
    assert (two_opt.batched_two_opt_euclid.launches,
            two_opt.batched_nls_euclid.launches) == before
    if ls == "nls":
        hd = jheuristic_dist(jnp.asarray(heu))
        want = jax.vmap(lambda d, h, tt: jbatched_nls(d, h, tt, budget))(
            jnp.asarray(dist), hd, jnp.asarray(tours))
    else:
        want = jax.vmap(lambda d, tt: jbatched_two_opt(d, tt, budget))(
            jnp.asarray(dist), jnp.asarray(tours))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_nls_wrapper_above_its_cap_matches_jax_dense_fallback():
    """``batched_nls_euclid`` at n = 2049, one past K5's cap: the dense NLS
    with ``heu_dist`` unrounded, tours exactly equal to JAX's
    ``batched_nls_euclid``, which falls back there too; no launch counted."""
    n = 2049
    coords, _ = instances(1, n, 33)
    hd = (np.random.default_rng(34).random((n, n)).astype(np.float32) + 0.5)
    tours = random_tours(1, 1, n, 35)[0]
    assert not two_opt.ls_supported(n, "nls") and not jpto.pallas_ls_supported(n)
    want = np.asarray(jpto.batched_nls_euclid(jnp.asarray(coords[0]), jnp.asarray(hd),
                                              jnp.asarray(tours.astype(np.int32)), 1, 1, 1))
    before = two_opt.batched_nls_euclid.launches
    got = two_opt.batched_nls_euclid(t(coords[0]), t(hd), t(tours), 1, 1, 1).numpy()
    assert two_opt.batched_nls_euclid.launches == before
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, tours)


def test_two_opt_wrapper_past_its_cap_warns_and_takes_the_dense_descent(monkeypatch):
    """With K4's cap patched to 16, the wrapper at n = 30 warns that it builds
    an [N, N] matrix and equals JAX's ``batched_two_opt(distance_matrix)``."""
    monkeypatch.setitem(two_opt.LS_CAPS, "2opt", 16)
    coords, dist = instances(2, 30, 36)
    tours = random_tours(2, 3, 30, 37)
    with pytest.warns(UserWarning, match=r"\[N, N\]"):
        got = two_opt.batched_two_opt_euclid(t(coords), t(tours), 60).numpy()
    want = jax.vmap(lambda d, tt: jbatched_two_opt(d, tt, 60))(jnp.asarray(dist),
                                                               jnp.asarray(tours))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_nls_wrapper_past_its_cap_takes_the_metric_unrounded(monkeypatch):
    """With K5's cap patched to 16, the wrapper at n = 30 equals JAX's
    ``batched_nls`` on the f32 metric. The metric lies within 0.003 of 1,
    where bf16 rounds every entry to 1 and no perturbation move would
    improve, so a rounded metric would give other tours."""
    monkeypatch.setitem(two_opt.LS_CAPS, "nls", 16)
    coords, dist = instances(1, 30, 38)
    hd = 1.0 + 0.003 * np.random.default_rng(39).random((30, 30)).astype(np.float32)
    tours = random_tours(1, 4, 30, 40)[0]
    got = two_opt.batched_nls_euclid(t(coords[0]), t(hd), t(tours), 40, 3, 5).numpy()
    want = np.asarray(jbatched_nls(jnp.asarray(dist[0]), jnp.asarray(hd),
                                   jnp.asarray(tours), 40, 3, 5))
    np.testing.assert_array_equal(got, want)
    rounded = two_opt.batched_nls_euclid_plain(t(coords[0]), t(hd), t(tours), 40, 3, 5)
    assert not np.array_equal(got, rounded.numpy())


@pytest.mark.parametrize("units,n,k,want", [(32, 3072, 50, True), (32, 3073, 50, False),
                                            (16, 20, 5, False), (32, 20, 21, False)])
def test_dense_heuristic_route_predicate_states_k1_limits(units, n, k, want):
    net = Net(units=units, depth=1)
    assert fused_gnn.dense_heuristic_supported(net, n, k) is want
    assert fused_gnn.embnet_supported(net, n, k) is (units == 32 and k <= n)


def _random_net(seed, **kwargs):
    """A port Net with Flax-law random weights and moved BatchNorm
    statistics, and the same weights as JAX variables."""
    net = init_like_flax(Net(**kwargs), torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if "running_mean" in name:
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif "running_var" in name:
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return net, to_jax_variables(net)


def _jax_net(net):
    return JNet(depth=net.depth, units=net.units, dual_heads=net.dual_heads,
                use_pallas=False)


def test_heuristic_with_16_units_takes_the_net_route_as_jax_does():
    """``Net(units=16)`` is outside K1's and K9's limits: the k-NN graph
    through ``Net`` with the plain layer, ``scatter_to_dense`` + 1e-10.
    rtol 1e-5 against JAX's ``batched_tsp_heuristic`` (the same products in
    another summation order)."""
    net, variables = _random_net(1, units=16, depth=3, dual_heads=True)
    coords, dist = instances(2, 20, 41)
    boom = lambda *a, **k: pytest.fail("K1 called outside its limits")
    heu, d = anytime.batched_tsp_heuristic(net, t(coords), 5,
                                           _ops=bt.KERNEL_OPS._replace(heuristic=boom))
    want, jd = jbatched_tsp_heuristic(_jax_net(net), variables, jnp.asarray(coords), 5)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(heu.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("start_node", [False, True], ids=["coords", "start_node"])
def test_heuristic_past_k1_cap_takes_the_k9_route_as_jax_does(start_node):
    """At n = 3073, one past K1's cap, a 32-unit Net goes through the k-NN
    graph and ``net_forward_fast`` (K9's plain version on the CPU). Against
    JAX's ``Net.apply`` route: rtol 1e-4, atol 1e-6 (BatchNorm folded into
    the layers re-associates each affine). With the start-node feature it is
    ``_eval_ls``'s heuristic over ``tsp_nls_graph``."""
    from deepaco_tpu.core.builders import tsp_nls_graph
    from deepaco_tpu.core.graph import scatter_to_dense as jscatter

    n, k = 3073, 4
    net, variables = _random_net(2, feats=1 if start_node else 2, depth=2)
    coords, dist = instances(1, n, 42)
    x = start_node_features(t(coords)) if start_node else t(coords)
    boom = lambda *a, **kw: pytest.fail("K1 called outside its limits")
    got = anytime.dense_heuristic(net, x, t(coords), t(dist), k,
                                  _ops=bt.KERNEL_OPS._replace(heuristic=boom)).numpy()
    if start_node:
        g = tsp_nls_graph(jnp.asarray(coords[0]), jnp.asarray(dist[0]), k, start_node=0)
        want = jscatter(g, _jax_net(net).apply(variables, g, train=False)) + 1e-10
    else:
        want = jbatched_tsp_heuristic(_jax_net(net), variables, jnp.asarray(coords), k)[0][0]
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=1e-4, atol=1e-6)


def test_k3_route_predicate_states_k3_limit():
    """K3 takes its staged variant up to 19,000 cities and its unstaged one
    past that; on the CPU ``staged`` changes nothing (the plain version)."""
    assert bt.k3_staged(bt.K3_STAGED_MAX_N) and not bt.k3_staged(bt.K3_STAGED_MAX_N + 1)
    assert bt.K3_STAGED_MAX_N == 19000


@pytest.mark.parametrize("n", [8, 9])
def test_batched_update_past_k3_limit_takes_the_plain_update_as_jax_does(monkeypatch, n):
    """``_batched_update`` hands the update to its ``update`` (K3) on both
    sides of K3's staged limit (here lowered to 8): K3 takes every N, its
    unstaged variant past the limit. On the CPU the K3 wrapper takes the
    plain version, with or without ``staged``: at N = 9 the state and next
    score equal the plain update's, and JAX's ``_batched_update`` (off the
    TPU: tour costs and ``search_update``) at rtol 1e-6 for tau (sum order),
    the best cost and tour exactly."""
    from deepaco_tpu.aco import batched_tsp as jbt
    from deepaco_tpu.aco import runner as jrunner
    from deepaco_tpu_torch.aco import runner

    b, a = 2, 3
    coords, dist = instances(b, n, 50 + n)
    tours = random_tours(b, a, n, 51).transpose(0, 2, 1).copy()         # [B, N, A]
    tau = (0.5 + np.random.default_rng(52).random((b, n, n))).astype(np.float32)
    log_heu = -t(dist).clamp(max=10.0)
    cfg = runner.ACOConfig(n_ants=a)
    state = bt._batched_init(b, n, cfg, "cpu")
    state = state._replace(phe=state.phe._replace(tau=t(tau)))
    monkeypatch.setattr(bt, "K3_STAGED_MAX_N", 8)
    assert bt.k3_staged(n) == (n == 8)
    calls = []

    def k3(*args, **kw):
        calls.append(n)
        return bt.fused_tsp_update(*args, **kw)

    got, score = bt._batched_update(cfg, state, t(tours), t(dist), update=k3,
                                    log_heu=log_heu, sample_dtype=torch.float32)
    assert calls == [n]
    want, _, want_score = bt.fused_tsp_update_plain(
        state, t(tours), t(dist), decay=cfg.decay, q=cfg.q, log_heu=log_heu,
        score_dtype=torch.float32)
    assert torch.equal(got.phe.tau, want.phe.tau) and torch.equal(score, want_score)
    unstaged, _, _ = bt.fused_tsp_update(state, t(tours), t(dist), decay=cfg.decay, q=cfg.q,
                                         staged=False)
    assert torch.equal(unstaged.phe.tau, want.phe.tau)
    jcfg = jrunner.ACOConfig(n_ants=a)
    jstate = jbt._batched_init(b, n, jcfg)
    jstate = jstate._replace(phe=jstate.phe._replace(tau=jnp.asarray(tau)))
    ref = jbt._batched_update(jcfg, jstate, jnp.asarray(tours, jnp.int32), jnp.asarray(dist))
    np.testing.assert_allclose(got.phe.tau.numpy(), np.asarray(ref.phe.tau), rtol=1e-6)
    np.testing.assert_array_equal(got.best_cost.numpy(), np.asarray(ref.best_cost))
    np.testing.assert_array_equal(got.best_path.numpy(), np.asarray(ref.best_path))


def _cvrp_heu_case(**net_kwargs):
    """The golden CVRP20 set's first 3 instances and a CVRP ``Net``: the
    cvrp20 weights, or Flax-law random ones with ``net_kwargs``."""
    from deepaco_tpu_torch import families
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.utils import golden
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    fam = families.get_family("cvrp")
    if net_kwargs:
        net = _random_net(3, feats=1, **net_kwargs)[0]
    else:
        net = drivers.family_model(fam, load_checkpoint(
            str(Path(__file__).resolve().parent.parent / "checkpoints"
                / "cvrp20_selftrained.msgpack")))
    inst = {k: torch.from_numpy(v[:3]) for k, v in golden.cvrp_test(20).items()}
    return fam, net, inst


def _spy_ops(calls):
    """The plain layer and layer stack, each call recorded in ``calls``."""
    from deepaco_tpu_torch.ops import gnn_layer
    from deepaco_tpu_torch.train import drivers

    def layer(*a):
        calls.append("layer")
        return gnn_layer.fused_gnn_layer_plain(*a)

    def layers(*a, **kw):
        calls.append("layers")
        return fused_gnn.embnet_layers_plain(*a, **kw)

    return drivers.KERNEL_OPS._replace(layer=layer, layers=layers)


def test_cvrp_heuristic_takes_the_k9_route_in_eval_mode():
    """The eval-mode CVRP net (one edge feature, 32 units, K = N = 21)
    runs the folded layer stack once and no layer; its heuristic equals the
    per-layer route's (``Net`` with the plain layer, then ``out.T + 1e-10``)
    at rtol 2e-4 (BatchNorm folded into the layers re-associates each
    affine; measured 2.3e-5)."""
    from deepaco_tpu_torch.ops import gnn_layer
    from deepaco_tpu_torch.train import drivers

    fam, net, inst = _cvrp_heu_case()
    calls = []
    with torch.no_grad():
        got = drivers._forward_heu(fam, net, inst, 2, _spy_ops(calls))
        g = fam.graph(inst, 2)
        want = fam.heu_matrix(g, net(g, gnn_layer.fused_gnn_layer_plain), inst)
    assert calls == ["layers"]
    assert got.shape == (3, 21, 21)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=0)


@pytest.mark.parametrize("case", ["train_mode", "units_16"])
def test_cvrp_heuristic_takes_the_layer_route_where_k9_does_not(case):
    """A net in train mode (BatchNorm on batch statistics, which no fold
    can take), or one of 16 units (outside ``embnet_supported``), runs
    ``net(g, ops.layer)`` a layer at a time and never the layer stack; its
    heuristic is that call's output, transposed, plus 1e-10."""
    import copy

    from deepaco_tpu_torch.train import drivers

    fam, net, inst = _cvrp_heu_case(**({"units": 16, "depth": 3} if case == "units_16" else {}))
    if case == "train_mode":
        net.train()
    else:
        assert not fused_gnn.embnet_supported(net, 21, 21)
    twin = copy.deepcopy(net)            # train-mode BatchNorm moves its statistics
    calls = []
    with torch.no_grad():
        got = drivers._forward_heu(fam, net, inst, 2, _spy_ops(calls))
        g = fam.graph(inst, 2)
        want = fam.heu_matrix(g, twin(g, _spy_ops([]).layer), inst)
    assert calls == ["layer"] * net.depth
    np.testing.assert_array_equal(got.numpy(), want.numpy())
