"""Port parity: MKP-items (models/transformer.py, the vector pheromone of
aco/pheromone.py and aco/runner.py, aco/problems/mkp.py's PH_items plug-in
and facade, the family's hooks in families.py and train/drivers.py, the
single-instance step of train/special.py, utils/golden.mkp_items_test and
the CLI) against the JAX package, on inputs made from numpy seeds and the
golden writer."""
import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu import families as jfamilies
from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco import pheromone as jph
from deepaco_tpu.aco import runner as jrunner
from deepaco_tpu.aco.problems.mkp import MKPItemsACO as JMKPItemsACO
from deepaco_tpu.models.transformer import TransformerModel as JTransformer
from deepaco_tpu.train import config as jconfig
from deepaco_tpu.train import drivers as jdrivers
from deepaco_tpu.train import reinforce as jr
from deepaco_tpu.train import special as jspecial
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch import cli, families
from deepaco_tpu_torch.aco import engine, pheromone, runner
from deepaco_tpu_torch.aco.problems.mkp import MKPItemsACO, validate_mkp
from deepaco_tpu_torch.models.gnn import to_jax_tree
from deepaco_tpu_torch.models.transformer import TransformerModel, init_transformer_like_flax
from deepaco_tpu_torch.train import config, drivers
from deepaco_tpu_torch.train import reinforce as tr
from deepaco_tpu_torch.train import special
from deepaco_tpu_torch.utils import golden
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


ROOT = Path(__file__).resolve().parent.parent
CKPT300 = ROOT / "checkpoints" / "mkp_items300_selftrained.msgpack"
NAME, N, B, A = "mkp_items", 50, 3, 6


def _batch(seed=3, b=B, n=N):
    """``(port instance [B, ...] prepared, JAX instances, each prepared)``."""
    fam, jfam = families.get_family(NAME), jfamilies.get_family(NAME)
    batch = drivers.gen_batch(fam, np.random.default_rng(seed), n, b)
    jinst = [jfam.prepare({k: jnp.asarray(v[i]) for k, v in batch.items()}) for i in range(b)]
    return batch, fam.prepare(drivers.instance_tensors(batch, "cpu")), jinst


def _tau_heu(inst, seed):
    """A random vector pheromone in [0.5, 1.5) and the classic heuristic
    times a random factor, ``[B, n+1]``."""
    heu = families.get_family(NAME).classic_heu(inst, 0)
    rng = np.random.default_rng(seed)
    tau = torch.from_numpy((0.5 + rng.random(heu.shape)).astype(np.float32))
    return tau, heu * torch.from_numpy((0.5 + rng.random(heu.shape)).astype(np.float32))


def _jax_batched(fn, tau, heu, jinst, *more):
    """``fn(spec, inst, *more)`` of every instance's JAX spec, jitted over
    ``vmap``."""
    jfam = jfamilies.get_family(NAME)
    stacked = {k: jnp.stack([ji[k] for ji in jinst]) for k in jinst[0]}
    run = jax.jit(jax.vmap(lambda t, h, inst, *m: fn(jfam.spec(t, h, inst, A), inst, *m)))
    return run(jnp.asarray(tau.numpy()), jnp.asarray(heu.numpy()), stacked, *more)


def _src(n=N, count=3):
    ds = golden.mkp_items_test(300, count=count)
    return np.concatenate([ds["prize"][..., None], ds["weight"]], -1)[:, :n]


@pytest.mark.parametrize("n", [300, 500])
def test_golden_writer_is_bit_equal(n):
    ref, got = jgolden.mkp_items_test(n, count=4), golden.mkp_items_test(n, count=4)
    assert set(ref) == set(got)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    with pytest.raises(ValueError, match="scale"):
        golden.mkp_items_test(100)


def test_transformer_matches_jax_on_the_committed_checkpoint():
    """mkp_items300_selftrained on the first 50 items of three golden
    instances. In f64 on both sides every output agrees at rtol 1e-5 (and
    far closer): the same operations in the same order. In f32 each package
    lies 2-4e-5 from the f64 result (attention and LayerNorm over 3
    layers), so the f32 outputs are held at rtol 1e-4 / atol 1e-7."""
    tree = load_checkpoint(str(CKPT300))
    src = _src()
    net = TransformerModel.from_jax_variables(tree)
    jmodel = JTransformer()
    with torch.no_grad():
        out32 = net(torch.from_numpy(src)).numpy()
        out64 = net.double()(torch.from_numpy(src).double()).numpy()
    ref32 = np.asarray(jax.jit(jax.vmap(lambda s: jmodel.apply({"params": tree["params"]}, s)))(
        jnp.asarray(src)))
    np.testing.assert_allclose(out32, ref32, rtol=1e-4, atol=1e-7)
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        ref64 = np.asarray(jax.vmap(lambda s: JTransformer(dtype=jnp.float64).apply(
            {"params": params}, s))(jnp.asarray(src, jnp.float64)))
    assert ref64.dtype == np.float64
    np.testing.assert_allclose(out64, ref64, rtol=1e-5, atol=0)
    assert (out32.max(-1) == 1.0).all() and (out32 > 0).all()


def test_forward_hook_and_classic_heuristic_equal_jax():
    """The family's heuristic (the transformer + 1e-10, the dummy at 1e-8)
    and its classic one (``prize / sum(weight)``, the dummy at 1e-8) equal
    JAX's: the classic exactly, the neural at rtol 1e-4 (f32 rounding)."""
    batch, inst, jinst = _batch()
    tree = load_checkpoint(str(CKPT300))
    fam, jfam = families.get_family(NAME), jfamilies.get_family(NAME)
    net = drivers.family_model(fam, {"params": tree["params"]})
    assert isinstance(net, TransformerModel)
    with torch.no_grad():
        heu = drivers._forward_heu(fam, net, inst, 0)
    model = jdrivers.family_model(jfam)
    for i in range(B):
        ref, _ = jdrivers._forward_heu(jfam, model, tree["params"], {}, jinst[i], 0, False)
        np.testing.assert_allclose(heu[i].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-9)
        assert heu[i, -1].item() == np.float32(1e-8)
        np.testing.assert_array_equal(fam.classic_heu(inst, 0)[i].numpy(),
                                      np.asarray(jfam.classic_heu(jinst[i], 0)))


def test_greedy_paths_masks_and_objectives_equal_jax():
    """Greedy paths on a random vector pheromone equal JAX's exactly (every
    ant starts on the dummy); sampled paths replayed through both specs
    give the same knapsack masks at every step, log-probabilities within
    1e-5 and objectives at rtol 1e-6; every path is feasible."""
    batch, inst, jinst = _batch()
    fam = families.get_family(NAME)
    tau, heu = _tau_heu(inst, 4)
    spec = fam.spec(tau, heu, inst, A)
    greedy = engine.greedy_rollout(spec, torch.Generator()).paths
    ref = _jax_batched(lambda s, _: jengine.greedy_rollout(s, jax.random.PRNGKey(0)).paths,
                       tau, heu, jinst)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref))
    paths = engine.rollout(spec, torch.Generator().manual_seed(1)).paths
    for p in (greedy, paths):
        assert bool(validate_mkp(p, inst["weight"], 1.0).all())
    assert bool((paths[:, 0] == N).all())
    lp = engine.path_log_probs(spec, paths)
    state = spec.init(paths[:, 0])
    masks = [spec.mask(state)]
    for t in range(1, paths.shape[1]):
        state = spec.step(state, paths[:, t])
        masks.append(spec.mask(state))
    jfam = jfamilies.get_family(NAME)

    def replay(s, one, p):
        st, _ = s.init(jax.random.PRNGKey(0))
        _, ms = jax.lax.scan(lambda st, act: (s.step(st, act), s.mask(st)), st, p[1:])
        return ms, jengine.path_log_probs(s, p), jfam.cost(p, one)

    jmasks, jlp, jcosts = _jax_batched(replay, tau, heu, jinst,
                                       jnp.asarray(paths.numpy(), jnp.int32))
    for t in range(paths.shape[1] - 1):
        np.testing.assert_array_equal(masks[t].numpy(), np.asarray(jmasks[:, t]),
                                      err_msg=f"mask at step {t}")
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fam.cost(paths, inst).numpy(), np.asarray(jcosts), rtol=1e-6)


def test_vector_deposit_and_search_update_equal_jax():
    """On sampled paths (each real item picked at most once an ant, the
    dummy many times): ``vector_deposit`` equals JAX's ``tau.at[picks].add``
    bit for bit on every real item, where it adds in JAX's step-then-ant
    order, and at rtol 1e-6 on the dummy, whose ``c * amount`` terms
    round once instead of ``c`` times (its pheromone reaches no output: the
    dummy is opened only when it is an ant's one choice). The runner's
    update (``q * objective``, maximize) gives the same tau the same way and
    the same best cost and path."""
    batch, inst, jinst = _batch()
    fam = families.get_family(NAME)
    tau, heu = _tau_heu(inst, 5)
    paths = engine.rollout(fam.spec(tau, heu, inst, A), torch.Generator().manual_seed(2)).paths
    amounts = torch.from_numpy(np.random.default_rng(0).random((B, A)).astype(np.float32))
    got = pheromone.vector_deposit(tau * 0.9, paths, amounts)
    costs = fam.cost(paths, inst)
    q = fam.extras(inst)["q"]
    cfg = fam.aco._replace(n_ants=A)
    state = runner.init_search(N + 1, N + 1, cfg, batch=(B,))
    assert state.phe.tau.shape == (B, N + 1)
    state = state._replace(phe=state.phe._replace(tau=tau))
    new = runner.search_update(cfg, state, paths, costs, q)
    jcfg = jfamilies.get_family(NAME).aco._replace(n_ants=A)
    for i in range(B):
        p = jnp.asarray(paths[i].numpy(), jnp.int32)
        ref = np.asarray(jph.vector_deposit(jnp.asarray(tau[i].numpy()) * 0.9, p,
                                            jnp.asarray(amounts[i].numpy())))
        np.testing.assert_array_equal(got[i, :-1].numpy(), ref[:-1])
        np.testing.assert_allclose(got[i, -1].item(), ref[-1], rtol=1e-6)
        js = jrunner.init_search(N + 1, N + 1, jcfg)
        js = js._replace(phe=js.phe._replace(tau=jnp.asarray(tau[i].numpy())))
        jnew = jrunner.search_update(jcfg, js, p, jnp.asarray(costs[i].numpy()),
                                     q=jnp.asarray(q[i].item(), jnp.float32))
        np.testing.assert_array_equal(new.phe.tau[i, :-1].numpy(), np.asarray(jnew.phe.tau)[:-1])
        assert new.best_cost[i].item() == float(jnew.best_cost)
        np.testing.assert_array_equal(new.best_path[i].numpy(), np.asarray(jnew.best_path))


def _cfg(mod):
    return mod.ProblemConfig(name=NAME, n_nodes=30, k_sparse=3, aco=mod.ACOSettings(n_ants=A),
                             train=mod.TrainConfig(epochs=1, steps_per_epoch=10))


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_step(model, cfg, state, batch, paths):
    """JAX's family train step (drivers.py:62-113) on given instances, the
    paths replayed through ``path_log_probs``."""
    jfamily = jfamilies.get_family(NAME)
    tx = jr.make_optimizer(cfg, cfg.train.epochs * cfg.train.steps_per_epoch)

    def per_instance(params, inst, p):
        inst = jfamily.prepare(inst)
        heu, _ = jdrivers._forward_heu(jfamily, model, params, {}, inst, cfg.k_sparse, True)
        spec = jfamily.spec(jnp.ones_like(heu), heu, inst, A)
        lp = jengine.path_log_probs(spec, p)
        costs = jfamily.cost(p, inst)
        adv = jax.lax.stop_gradient(-(costs - jnp.mean(costs)))
        return jnp.sum(adv * jnp.sum(lp, axis=0)) / A

    def loss_fn(params):
        return jnp.mean(jax.vmap(per_instance, in_axes=(None, 0, 0))(params, batch, paths))

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    return loss, grads, jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates)


def test_one_train_step_on_replayed_paths_matches_jax():
    """Two instances of 30 items, 6 ants, the transformer from the port's
    init (Flax's law), the paths the port samples on a pheromone of ones,
    replayed on both sides: the loss at rtol 1e-4, every gradient within
    1e-3 of JAX's (rtol, atol 1e-6), the weights after clip + AdamW (decay
    1e-2) at rtol 1e-6 / atol 1e-7 wherever |gradient| > 1e-6."""
    fam = families.get_family(NAME)
    cfg, jcfg = _cfg(config), _cfg(jconfig)
    batch = drivers.gen_batch(fam, np.random.default_rng(1), cfg.n_nodes, 2)
    net = init_transformer_like_flax(TransformerModel(), torch.Generator().manual_seed(0))
    params = to_jax_tree(net.state_dict(), TransformerModel.jax_path)["params"]
    inst = fam.prepare(drivers.instance_tensors(batch, "cpu"))
    with torch.no_grad():
        heu = drivers._forward_heu(fam, net, inst, cfg.k_sparse)
    paths = engine.rollout(fam.spec(torch.ones_like(heu), heu, inst, A),
                           torch.Generator().manual_seed(3)).paths
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, False)
    out = drivers.family_loss(fam, net, drivers.instance_tensors(batch, "cpu"), cfg,
                              torch.Generator(), paths=paths)
    out.loss.backward()
    grads = to_jax_tree({n: p.grad.clone() for n, p in net.named_parameters()},
                        TransformerModel.jax_path)["params"]
    state, _ = tr.optimizer_update(state, cfg)
    tx = jr.make_optimizer(jcfg, 10)
    jstate = jr.TrainState(params, {}, tx.init(params), 0)
    loss, jgrads, jparams = _jax_step(JTransformer(), jcfg, jstate,
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jnp.asarray(paths.numpy(), jnp.int32))
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-4)
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    after = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_tree(net.state_dict(), TransformerModel.jax_path)["params"]))
    ref_params = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(flat[path], np.asarray(g), rtol=1e-3, atol=1e-6, err_msg=key)
        signal = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(after[path][signal], np.asarray(ref_params[path])[signal],
                                   rtol=1e-6, atol=1e-7, err_msg=key)


def _jax_items_loss(model, params, prize, weight, paths):
    """JAX's MKP-items step's loss (special.py:124-136) with ``paths``
    replayed through ``path_log_probs``: ``(loss, mean objective)``."""
    src = jnp.concatenate([prize[:, None], weight], axis=1)
    heu = model.apply({"params": params}, src) + 1e-10
    prize_e, weight_e, heu_e = jspecial.extend_mkp(prize, weight, heu_vec=heu)
    spec = jspecial.mkp_items_spec(jnp.ones_like(heu_e), heu_e, weight_e,
                                   jnp.asarray(1.0, jnp.float32), A)
    objs = jspecial.mkp_objective(prize_e, paths)
    adv = jax.lax.stop_gradient(jnp.mean(objs) - objs)
    return jnp.sum(adv * jnp.sum(jengine.path_log_probs(spec, paths), axis=0)) / A, \
        jnp.mean(objs)


def test_mkp_items_train_step_on_replayed_paths_matches_jax(monkeypatch):
    """``train.special.make_mkp_items_train_step`` on one instance of 30
    items, 6 ants, the transformer from the port's init (Flax's law): the
    port's step samples, and the family loss it runs draws the same paths
    for the gradients; JAX's own step runs on the same paths (its
    ``rollout`` replaying them through ``path_log_probs``). The loss at rtol
    1e-4 and every gradient within 1e-3 of JAX's (rtol, atol 1e-6), the mean
    objective at rtol 1e-6, and the weights after clip + AdamW at rtol 1e-6
    / atol 1e-7 wherever |gradient| > 1e-6, as the family step is held."""
    cfg, jcfg = _cfg(config), _cfg(jconfig)
    inst = families.get_family(NAME).gen(np.random.default_rng(2), cfg.n_nodes)
    prize, weight = inst["prize"], inst["weight"]
    net = init_transformer_like_flax(TransformerModel(), torch.Generator().manual_seed(0))
    params = to_jax_tree(net.state_dict(), TransformerModel.jax_path)["params"]
    stepped = copy.deepcopy(net)
    one = {"prize": torch.from_numpy(prize)[None], "weight": torch.from_numpy(weight)[None]}
    out = drivers.family_loss(families.get_family(NAME), net, one, cfg,
                              torch.Generator().manual_seed(3))
    out.loss.backward()
    grads = to_jax_tree({n: p.grad for n, p in net.named_parameters()},
                        TransformerModel.jax_path)["params"]
    state, mean_obj = special.make_mkp_items_train_step(cfg)(
        tr.TrainState(stepped, tr.make_optimizer(stepped, cfg), 0, False), prize, weight,
        torch.Generator().manual_seed(3))
    assert state.step == 1 and mean_obj.item() == out.mean_cost.item()
    assert out.paths.shape == (1, cfg.n_nodes + 2, A)
    paths = jnp.asarray(out.paths[0].numpy(), jnp.int32)

    def replay(spec, rng, *, alpha=1.0, beta=1.0, require_prob=False):
        return jengine.Rollout(paths, jengine.path_log_probs(spec, paths, alpha=alpha, beta=beta),
                               None)

    monkeypatch.setattr(jspecial, "rollout", replay)
    tx = jr.make_optimizer(jcfg, 10)
    jstate, jmon = jspecial.make_mkp_items_train_step(JTransformer(), tx, n_ants=A)(
        jr.TrainState(params, {}, tx.init(params), 0), jnp.asarray(prize), jnp.asarray(weight),
        jax.random.PRNGKey(0))
    (loss, mon), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_items_loss(JTransformer(), p, jnp.asarray(prize), jnp.asarray(weight),
                                  paths), has_aux=True))(params)
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(mean_obj.item(), float(jmon), rtol=1e-6)
    assert float(mon) == float(jmon)
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    after = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_tree(stepped.state_dict(), TransformerModel.jax_path)["params"]))
    ref_params = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(flat[path], np.asarray(g), rtol=1e-3, atol=1e-6, err_msg=key)
        signal = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(after[path][signal], np.asarray(ref_params[path])[signal],
                                   rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("arm", ["neural", "classic"])
def test_evaluate_family_matches_jax_in_law(arm):
    """evaluate_family on the first 30 golden MKP-items 300 instances cut to
    their first 100 items (the transformer is size-free), 10 ants, T=1 and
    4, seed 0 on each side: the means within 2%; each curve rises, the
    best is the curve's end, every best solution is feasible and scores
    it."""
    ds = golden.mkp_items_test(300, count=30)
    ds = {"prize": ds["prize"][:, :100], "weight": ds["weight"][:, :100]}
    t_values = (1, 4)
    variables = None
    if arm == "neural":
        variables = {"params": load_checkpoint(str(CKPT300))["params"]}
    ref, _ = jdrivers.evaluate_family(NAME, ds, n_nodes=100, variables=variables, n_ants=10,
                                      t_values=t_values, seed=0)
    fam = families.get_family(NAME)
    net = None if variables is None else drivers.family_model(fam, variables)
    got, curves, state = drivers.evaluate_family(NAME, ds, n_nodes=100, net=net, n_ants=10,
                                                 t_values=t_values, seed=0, device="cpu",
                                                 return_state=True)
    assert bool((curves[:, 1:] >= curves[:, :-1]).all())
    assert torch.equal(state.best_cost, curves[:, -1])
    assert state.phe.tau.shape == (30, 101)
    inst = fam.prepare(drivers.instance_tensors(ds, "cpu"))
    best = state.best_path[..., None]
    assert bool(validate_mkp(best, inst["weight"], 1.0).all())
    torch.testing.assert_close(fam.cost(best, inst)[:, 0], state.best_cost, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.02)


def test_facade_runs_and_matches_jax_in_law():
    """MKPItemsACO on one golden instance (100 items, the classic
    heuristic, 20 ants, 5 iterations, seeds 0-3 each side): a vector
    pheromone, a feasible best, and best costs within 2% of JAX's
    facade's."""
    ds = golden.mkp_items_test(300, count=1)
    price, weight = ds["prize"][0, :100], ds["weight"][0, :100]
    got, ref = [], []
    for seed in range(4):
        aco = MKPItemsACO(price, weight, n_ants=20, seed=seed, device="cpu")
        got.append(aco.run(5).item())
        assert aco.state.phe.tau.shape == (1, 101)
        best = aco.best_path[:, None]
        assert bool(validate_mkp(best, torch.from_numpy(weight), 1.0)[0])
        ref.append(float(JMKPItemsACO(price, weight, n_ants=20, seed=seed).run(5)))
    np.testing.assert_allclose(np.mean(got), np.mean(ref), rtol=0.02)


def test_cli_test_and_train(tmp_path, capsys, monkeypatch):
    """``test mkp_items -n 300`` with the committed checkpoint prints the
    JAX CLI's lines; ``train mkp_items`` (AdamW decay 1e-2) writes a
    checkpoint that ``test`` reads back."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(["test", NAME, "-n", "300", "--limit", "2", "-a", "4", "-t", "1",
                              "2", "-c", str(CKPT300)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1:-1] == [f"T={t}, average cost is {v:.6f}." for t, v in zip((1, 2), means)]
    assert curves.shape == (2, 2)
    out = tmp_path / "items.msgpack"
    state = cli.main(["train", NAME, "-n", "20", "-e", "1", "-s", "2", "-a", "4", "-o",
                      str(out)], device="cpu")
    assert state.step == 2 and state.optimizer.param_groups[0]["weight_decay"] == 1e-2
    tree = load_checkpoint(str(out))
    assert tree["batch_stats"] == {} and int(tree["step"]) == 2
    reread = drivers.family_model(families.get_family(NAME), tree)
    assert all(torch.equal(a, b) for a, b in zip(reread.state_dict().values(),
                                                 state.net.state_dict().values()))
    with pytest.raises(SystemExit, match=r"scales \(300, 500\)"):
        cli.main(["test", NAME, "-n", "50", "-c", str(out)], device="cpu")
