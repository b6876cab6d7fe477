"""Port parity: REINFORCE training (train/reinforce.py) against the JAX
trainer: one step from the same weights on the same instances and paths,
the optimizer alone, the initialisation law, and runs of train_tsp."""
import functools
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco.engine import path_log_probs as jpath_log_probs
from deepaco_tpu.aco.problems.tsp import tour_cost as jtour_cost, tsp_spec as jtsp_spec
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.ops.two_opt import batched_nls as jbatched_nls
from deepaco_tpu.train import config as jconfig
from deepaco_tpu.train import reinforce as jr
from deepaco_tpu_torch.models.gnn import (Net, from_jax_variables, init_like_flax,
                                          to_jax_tree, to_jax_variables)
from deepaco_tpu_torch.ops.two_opt import heuristic_dist
from deepaco_tpu_torch.train import config
from deepaco_tpu_torch.train import reinforce as tr

B, N, K, A, DEPTH = 3, 20, 5, 4, 2


def _cfg(mod, cosine=True, **train):
    return mod.ProblemConfig(
        n_nodes=N, k_sparse=K, model=mod.ModelConfig(depth=DEPTH),
        aco=mod.ACOSettings(n_ants=A),
        train=mod.TrainConfig(epochs=2, steps_per_epoch=5, batch_size=B,
                              cosine_schedule=cosine, **train))


def _paths(starts, seed):
    """Tours ``[B, N, A]``: ant ``a`` starts at ``starts[a]``, then a random
    order of the other cities."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, N, A), np.int64)
    for b in range(B):
        for a in range(A):
            out[b, 0, a] = starts[a]
            out[b, 1:, a] = rng.permutation(np.setdiff1d(np.arange(N), [starts[a]]))
    return out


@functools.partial(jax.jit, static_argnums=(0, 1, 6))
def _jax_step(model, cfg, state, coords, paths, ls_costs, nls):
    """The JAX train step (reinforce.py:153-185) on given instances, paths
    replayed through path_log_probs, and given LS costs; jitted, which
    keeps the interpret-mode Pallas layer from running op by op."""
    tx = jr.make_optimizer(cfg, cfg.train.epochs * cfg.train.steps_per_epoch)

    def per_instance(params, batch_stats, c, p, ls):
        heu, dist, stats = jr.tsp_heuristic(model, params, batch_stats, c,
                                            k_sparse=K, eps=cfg.train.eps,
                                            train=True, nls_graph=nls)
        spec = jtsp_spec(jnp.ones_like(heu), heu, A, 0 if nls else None)
        lp = jpath_log_probs(spec, p)
        loss = jr.reinforce_loss(jtour_cost(dist, p), lp, A,
                                 ls_costs=ls if nls else None)
        return loss, stats

    def loss_fn(params):
        losses, stats = jax.vmap(per_instance, in_axes=(None, None, 0, 0, 0))(
            params, state.batch_stats, coords, paths, ls_costs)
        return jnp.mean(losses), jax.tree_util.tree_map(lambda s: s.mean(0), stats)

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    return loss, grads, stats, optax.apply_updates(state.params, updates)


def _assert_tree_close(got, ref, rtol, atol, what):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_got) == {p for p, _ in flat_ref}, what
    for path, r in flat_ref:
        np.testing.assert_allclose(flat_got[path], np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("branch", ["plain", "nls"])
def test_one_step_matches_jax(branch):
    """B=3 instances (per-instance BatchNorm statistics), a dual-head net on
    the plain branch (its unused pheromone head still decays), the one-hot
    start graph and the NLS-shaped advantage on the NLS branch. JAX runs
    Net(use_pallas=True), so fused_gnn_layer_ad's Pallas forward runs in
    interpret mode. Tolerances: loss rtol 1e-4 (a sum of advantage-weighted
    log-probabilities that nearly cancels); gradients rtol 1e-3 / atol
    1e-6 (12-layer-deep sums in other orders, largest entries ~1e-1); batch
    stats rtol 1e-5 / atol 1e-6; parameters after the AdamW update rtol
    1e-6 / atol 1e-7 wherever |gradient| > 1e-6. A first Adam step moves an
    entry by lr * g / (|g| + 1e-8), about lr = 3e-4 whatever g's size, so
    where the gradient is rounding noise (the biases that a BatchNorm
    cancels, whose exact gradient is 0) only that bound is checked."""
    nls = branch == "nls"
    cfg, jcfg = _cfg(config, cosine=nls), _cfg(jconfig, cosine=nls)
    jmodel = JNet(depth=DEPTH, dual_heads=not nls, use_pallas=True)
    jstate = jr.init_train_state(JNet(depth=DEPTH, dual_heads=not nls), jcfg,
                                 jax.random.PRNGKey(0), nls_graph=nls)
    coords = np.random.default_rng(1).random((B, N, 2)).astype(np.float32)
    starts = (np.zeros(A, np.int64) if nls else
              np.asarray(jax.random.randint(jax.random.PRNGKey(0), (A,), 0, N)))
    paths = _paths(starts, 2)

    net = Net.from_jax_variables({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats})
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, cfg.train.cosine_schedule)
    ls_costs = None
    hook = None
    if nls:
        with torch.no_grad():
            heu, dist = tr.tsp_heuristic(net, torch.from_numpy(coords), k_sparse=K,
                                         eps=cfg.train.eps, train=False, nls_graph=True)
        ls_costs = tr.nls_local_search(t_nls=2, t_p=5)(
            dist, heu, torch.from_numpy(paths), torch.from_numpy(coords))
        hook = lambda *args, **kw: ls_costs
    out = tr.tsp_loss(net, torch.from_numpy(coords), cfg, torch.Generator(),
                      local_search=hook, paths=torch.from_numpy(paths))
    out.loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in net.named_parameters()}
    if not nls:                     # the unused pheromone head gets no gradient
        assert net.par_net_phe.lins[0].weight.grad is None
    state, _ = tr.optimizer_update(state, cfg)

    ls_np = (np.asarray(ls_costs) if nls else np.zeros((B, A), np.float32))
    loss, jgrads, jstats, jparams = _jax_step(
        jmodel, jcfg, jstate, jnp.asarray(coords), jnp.asarray(paths, jnp.int32),
        jnp.asarray(ls_np), nls)
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-4)
    _assert_tree_close(to_jax_tree(grads)["params"], jgrads, 1e-3, 1e-6, "grad")
    after = to_jax_variables(net)
    _assert_tree_close(after["batch_stats"], jstats, 1e-5, 1e-6, "batch_stats")
    lr = cfg.train.lr
    before = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        signal = np.abs(np.asarray(g)) > 1e-6
        ref = np.asarray(dict(jax.tree_util.tree_leaves_with_path(jparams))[path])
        np.testing.assert_allclose(got[path][signal], ref[signal], rtol=1e-6, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
        step = np.abs(got[path] - np.asarray(before[path]))
        assert np.all(step <= lr * (1 + 1e-3) + lr * cfg.train.weight_decay * np.abs(before[path]))
    assert state.step == 1


def test_nls_hook_equals_jax_on_the_bf16_metric():
    """nls_local_search's costs equal the JAX XLA batched_nls's on the same
    heuristic, the perturbation metric rounded to bf16 as K5 reads it
    (budget n // 4, t_nls 2, t_p 5), to f32 rounding of the tour sums."""
    coords = np.random.default_rng(3).random((B, N, 2)).astype(np.float32)
    net = init_like_flax(Net(feats=1, depth=DEPTH), torch.Generator().manual_seed(0))
    with torch.no_grad():
        heu, dist = tr.tsp_heuristic(net, torch.from_numpy(coords), k_sparse=K,
                                     eps=1e-10, train=False, nls_graph=True)
    paths = _paths(np.zeros(A, np.int64), 4)
    got = tr.nls_local_search(t_nls=2, t_p=5)(dist, heu, torch.from_numpy(paths),
                                              torch.from_numpy(coords))
    metric = heuristic_dist(heu).to(torch.bfloat16).float().numpy()
    for b in range(B):
        tours = jbatched_nls(jnp.asarray(dist[b].numpy()), jnp.asarray(metric[b]),
                             jnp.asarray(paths[b].T, jnp.int32), N // 4, 2, 5)
        ref = jtour_cost(jnp.asarray(dist[b].numpy()), tours.T)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=1e-6)
    assert bool((got <= tr.tour_cost(dist, torch.from_numpy(paths)) + 1e-5).all())


def test_optimizer_matches_optax():
    """Five updates of the same synthetic gradients through optax's
    make_optimizer (clip at 3.0, AdamW, cosine over 10 steps) and the
    port's: the clip triggers on the large ones, one leaf gets no gradient
    (weight decay still reaches it), and the parameters agree to rtol 1e-5 /
    atol 4e-6 after each update: optax forms Adam's bias corrections in f32,
    where 1 - 0.999 is 1.3e-5 off, torch in double, so each update of
    lr = 0.05 may differ by 7e-7."""
    cfg, jcfg = _cfg(config, lr=0.05), _cfg(jconfig, lr=0.05)
    net = init_like_flax(Net(depth=1, dual_heads=True), torch.Generator().manual_seed(1))
    params = to_jax_variables(net)["params"]
    tx = jr.make_optimizer(jcfg, 10)
    opt_state = tx.init(params)
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, True)
    rng = np.random.default_rng(2)
    for step in range(5):
        scale = 10.0 if step % 2 == 0 else 0.01          # clip on, clip off
        grads = {name: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32) * scale)
                 for name, p in net.named_parameters()}
        jgrads = to_jax_tree(grads)["params"]
        jgrads["par_net_phe"] = jax.tree_util.tree_map(np.zeros_like, jgrads["par_net_phe"])
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in net.named_parameters():
            p.grad = None if name.startswith("par_net_phe") else grads[name].clone()
        state, norm = tr.optimizer_update(state, cfg)
        _assert_tree_close(to_jax_variables(net)["params"], params, 1e-5, 4e-6, f"step {step}")
    assert state.step == 5
    assert tr.learning_rate(cfg, 10) == 0.0
    assert math.isclose(tr.learning_rate(cfg, 5), 0.025)


def test_init_like_flax_law():
    """Per-layer kernel std within 10% of Flax lecun_normal's (measured on
    the JAX init of the same net), |w| <= 2 sigma, biases 0."""
    jnet = JNet(depth=12, dual_heads=True, use_pallas=False)
    from deepaco_tpu.core.graph import knn_graph
    from deepaco_tpu.utils.datasets import distance_matrix, uniform_coords
    c = uniform_coords(jax.random.PRNGKey(0), 20)
    jparams = jnet.init(jax.random.PRNGKey(1), knn_graph(c, distance_matrix(c), 5))["params"]
    net = init_like_flax(Net(depth=12, dual_heads=True), torch.Generator().manual_seed(0))
    got = to_jax_variables(net)["params"]
    checked = 0
    for path, ref in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        leaf = got
        for key in keys:
            leaf = leaf[key]
        if keys[-1] == "bias":
            assert not leaf.any() and not np.asarray(ref).any()
        elif keys[-1] == "kernel" and leaf.size >= 32 * 32:
            sigma = math.sqrt(1.0 / leaf.shape[0]) / 0.87962566103423978
            assert np.abs(leaf).max() <= 2 * sigma + 1e-7
            assert abs(leaf.std() / np.asarray(ref).std() - 1) < 0.1, keys
            checked += 1
    assert checked == 12 * 5 + 2 * 2


@pytest.mark.parametrize("branch", ["plain", "nls"])
def test_train_tsp_runs_on_the_cpu(branch):
    """Two steps of train_tsp(device="cpu"): finite losses and costs, and
    every weight matrix and running statistic moved (some biases keep 0, as
    in JAX: zero gradient, and decay of 0 is 0)."""
    nls = branch == "nls"
    cfg = _cfg(config, cosine=nls)
    net = Net(feats=1 if nls else 2, depth=DEPTH, dual_heads=not nls)
    infos = []
    state = tr.train_tsp(net, cfg, device="cpu", max_steps=2,
                         local_search=tr.nls_local_search(2, 5) if nls else None,
                         progress=lambda i, info: infos.append(info))
    assert state.step == 2 and len(infos) == 2
    for info in infos:
        assert all(math.isfinite(float(v)) for v in info)
    init = init_like_flax(Net(feats=1 if nls else 2, depth=DEPTH, dual_heads=not nls),
                          torch.Generator().manual_seed(cfg.train.seed))
    moved = [not torch.equal(a, b) for (name, a), b in zip(
        init.state_dict().items(), state.net.state_dict().values())
        if a.dim() == 2 or "running" in name]
    assert len(moved) > 4 * DEPTH and all(moved)
