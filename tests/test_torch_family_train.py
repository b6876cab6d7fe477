"""Port parity: training over the family registry (train/drivers.py:
family_loss, make_family_train_step, init_family_state, train_family) and
the CVRP facade (aco/problems/cvrp.py: CVRPACO) against the JAX package."""
import functools
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu import families as jfamilies
from deepaco_tpu.aco.engine import path_log_probs as jpath_log_probs
from deepaco_tpu.aco.engine import rollout as jrollout
from deepaco_tpu.aco.problems.cvrp import CVRPACO as JCVRPACO
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.train import config as jconfig
from deepaco_tpu.train import drivers as jdrivers
from deepaco_tpu.train import reinforce as jr
from deepaco_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco.problems import cvrp
from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO, validate_routes
from deepaco_tpu_torch.aco.problems.op import validate_op
from deepaco_tpu_torch.aco.problems.pctsp import validate_pctsp
from deepaco_tpu_torch.aco.problems.smtwtp import validate_smtwtp
from deepaco_tpu_torch.models.gnn import Net, init_like_flax, jax_layout, to_jax_tree
from deepaco_tpu_torch.train import config, drivers
from deepaco_tpu_torch.train import reinforce as tr
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
from deepaco_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B, A, DEPTH = 2, 5, 2
SIZES = {"tsp": (20, 5), "cvrp": (12, 12), "op": (20, 5), "pctsp": (12, 12),
         "smtwtp": (12, 12), "sop": (12, 12), "mkp": (12, 12)}   # n_nodes, k_sparse
NAMES = ["tsp", "cvrp", "op", "pctsp", "smtwtp"]


def _cfg(mod, name, epochs=2, steps=5, batch=B):
    n, k = SIZES[name]
    return mod.ProblemConfig(name=name, n_nodes=n, k_sparse=k,
                             model=mod.ModelConfig(depth=DEPTH),
                             aco=mod.ACOSettings(n_ants=A),
                             train=mod.TrainConfig(epochs=epochs, steps_per_epoch=steps,
                                                   batch_size=batch))


def _assert_tree_close(got, ref, rtol, atol, what):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat_got) == {p for p, _ in flat_ref}, what
    for path, r in flat_ref:
        np.testing.assert_allclose(flat_got[path], np.asarray(r), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _replay_paths(name, jfamily, batch):
    """Feasible paths ``[B, horizon+1, A]`` of each instance in the JAX
    layout. TSP: from the start cities that JAX's ``path_log_probs`` takes
    (its spec's ``init`` at key 0), random orders of the other cities. CVRP:
    routes that JAX's rollout samples on ``1/d``; OP, PCTSP and SMTWTP: on
    a heuristic of ones."""
    if name == "tsp":
        n = batch["dist"].shape[-1]
        ones = jnp.ones((n, n))
        inst0 = {k: jnp.asarray(v[0]) for k, v in batch.items()}
        _, starts = jfamily.spec(ones, ones, inst0, A).init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(2)
        out = np.zeros((B, n, A), np.int64)
        for b in range(B):
            for a, s in enumerate(np.asarray(starts)):
                out[b, 0, a] = s
                out[b, 1:, a] = rng.permutation(np.setdiff1d(np.arange(n), [s]))
        return out

    m = jfamily.horizon_states(SIZES[name][0])[0]

    def sample(inst, key):
        inst = jfamily.prepare(inst)
        heu = 1.0 / inst["dist"] if name == "cvrp" else jnp.ones((m, m))
        return jrollout(jfamily.spec(jnp.ones((m, m)), heu, inst, A), key).paths

    keys = jax.random.split(jax.random.PRNGKey(3), B)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return np.asarray(jax.jit(jax.vmap(sample))(batch, keys), np.int64)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_step(jfamily, model, cfg, state, batch, paths):
    """JAX's train step (drivers.py:62-113) on given instances, the paths
    replayed through ``path_log_probs``; jitted, which keeps the
    interpret-mode Pallas layer from running op by op."""
    tx = jr.make_optimizer(cfg, cfg.train.epochs * cfg.train.steps_per_epoch)
    a = cfg.aco.n_ants
    sign = -1.0 if jfamily.aco.maximize else 1.0

    def per_instance(params, batch_stats, inst, p):
        with jax.default_matmul_precision("highest"):
            inst = jfamily.prepare(inst)
            heu, stats = jdrivers._forward_heu(jfamily, model, params, batch_stats, inst,
                                               cfg.k_sparse, True)
            spec = jfamily.spec(jnp.ones_like(heu), heu, inst, a)
            lp = jpath_log_probs(spec, p, alpha=jfamily.aco.alpha, beta=jfamily.aco.beta)
            costs = jfamily.cost(p, inst)
            adv = jax.lax.stop_gradient(sign * (costs - jnp.mean(costs)))
            loss = jnp.sum(adv * jnp.sum(lp, axis=0)) / a
        return loss, stats

    def loss_fn(params):
        losses, stats = jax.vmap(per_instance, in_axes=(None, None, 0, 0))(
            params, state.batch_stats, batch, paths)
        return jnp.mean(losses), jax.tree_util.tree_map(lambda s: s.mean(0), stats)

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    return loss, grads, stats, jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                                      updates)


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_jax(name):
    """B=2 instances from a numpy seed, 5 ants, a 2-layer net (TSP: the
    dual-head net on the k-NN graph; CVRP: demand as the node feature on the
    dense graph with self-loops, the heuristic transposed; OP: the k-NN
    graph, the extended instance, a maximized prize; PCTSP: the dense graph,
    the heuristic over its smallest entry; SMTWTP: the dense job graph, no
    node update, which leaves the node BatchNorms out of both trees), the
    same weights and the same replayed paths. JAX runs Net(use_pallas=True), the Pallas
    layer in interpret mode. Tolerances as tests/test_torch_train.py holds
    TSP: loss rtol 1e-4 (a sum of advantage-weighted log-probabilities that
    nearly cancels); gradients rtol 1e-3 / atol 1e-6 (deep sums in other
    orders); batch statistics rtol 1e-5 / atol 1e-6; parameters after AdamW
    rtol 1e-6 / atol 1e-7 wherever |gradient| > 1e-6, elsewhere moved by at
    most lr (a first Adam step moves an entry by about lr whatever g's
    size)."""
    jfamily = jfamilies.get_family(name)
    cfg, jcfg = _cfg(config, name), _cfg(jconfig, name)
    batch = drivers.gen_batch(families.get_family(name), np.random.default_rng(1),
                              cfg.n_nodes, B)
    kwargs = dict(jfamily.model_kwargs)
    inst0 = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    variables = JNet(depth=DEPTH, **kwargs).init(
        jax.random.PRNGKey(0), jfamily.graph(inst0, cfg.k_sparse), train=False)
    tx = jr.make_optimizer(jcfg, 10)
    jstate = jr.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]), 0)
    paths = _replay_paths(name, jfamily, batch)

    net = Net.from_jax_variables(variables)
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, False)
    out = drivers.family_loss(families.get_family(name), net,
                              drivers.instance_tensors(batch, "cpu"), cfg,
                              torch.Generator(), paths=torch.from_numpy(paths))
    assert net.training
    out.loss.backward()
    # copies: the update below clips the gradients in place (SMTWTP's norm
    # passes the clip of 3)
    grads = jax_layout({n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                        for n, p in net.named_parameters()}, net)
    state, _ = tr.optimizer_update(state, cfg)

    loss, jgrads, jstats, jparams = _jax_step(
        jfamily, JNet(depth=DEPTH, use_pallas=True, **kwargs), jcfg, jstate,
        {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(paths, jnp.int32))
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-4)
    _assert_tree_close(to_jax_tree(grads)["params"], jgrads, 1e-3, 1e-6, "grad")
    after = to_jax_tree(jax_layout(net.state_dict(), net))
    _assert_tree_close(after["batch_stats"], jstats, 1e-5, 1e-6, "batch_stats")
    lr = cfg.train.lr
    before = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    ref_params = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        signal = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(got[path][signal], np.asarray(ref_params[path])[signal],
                                   rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))
        step = np.abs(got[path] - np.asarray(before[path]))
        assert np.all(step <= lr * (1 + 1e-3)
                      + lr * cfg.train.weight_decay * np.abs(before[path]))
    assert state.step == 1


def _valid(name, paths, inst):
    if name == "cvrp":
        return bool(validate_routes(paths, inst["demand"], families.CVRP_CAPACITY).all())
    if name == "op":
        return bool(validate_op(paths, inst["dist"], inst["max_len"]).all())
    if name == "pctsp":
        gate = (inst["prizes"].shape[-1] - 1) / 4.0
        return bool(validate_pctsp(paths, inst["prizes"], gate).all())
    if name == "smtwtp":
        return bool(validate_smtwtp(paths).all())
    n = paths.shape[1]
    return bool((torch.sort(paths, dim=1).values == torch.arange(n)[:, None]).all())


@pytest.mark.parametrize("name", NAMES)
def test_sampled_step_runs_on_the_cpu(name, monkeypatch):
    """Two sampled steps of make_family_train_step: finite loss, cost and
    gradient norm, every sampled route valid and costing what the step
    reports, and every weight matrix and running statistic moved."""
    fam = families.get_family(name)
    cfg = _cfg(config, name)
    seen = []
    real = drivers.family_loss

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(drivers, "family_loss", spy)
    gen = torch.Generator().manual_seed(0)
    net = Net(depth=DEPTH, **dict(fam.model_kwargs))
    state = tr.init_train_state(net, cfg, gen)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    step = drivers.make_family_train_step(fam, cfg)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = drivers.gen_batch(fam, rng, cfg.n_nodes, B)
        state, info = step(state, batch, gen)
        assert all(math.isfinite(float(v)) for v in info)
        out, inst = seen[-1], fam.prepare(drivers.instance_tensors(batch, "cpu"))
        assert out.paths.shape == (B, fam.horizon_states(cfg.n_nodes)[1] + 1, A)
        assert _valid(name, out.paths, inst)
        torch.testing.assert_close(out.costs, fam.cost(out.paths, inst))
    assert state.step == 2
    moved = [not torch.equal(start[k], v)
             for k, v in jax_layout(state.net.state_dict(), state.net).items()
             if v.dim() == 2 or "running" in k]
    assert len(moved) > 4 * DEPTH and all(moved)


@pytest.mark.parametrize("name", NAMES)
def test_train_family_draws_the_jax_instance_stream(name, monkeypatch):
    """The same seed gives the same training batches in both packages:
    ``init_family_state`` consumes one instance first in each. The JAX step
    is stubbed out (only the batches it is handed are compared)."""
    seen = {"jax": [], "torch": []}

    def recorder(mod, key):
        real = mod.gen_batch

        def record(*args, **kw):
            seen[key].append(real(*args, **kw))
            return seen[key][-1]
        monkeypatch.setattr(mod, "gen_batch", record)

    recorder(jdrivers, "jax")
    recorder(drivers, "torch")
    monkeypatch.setattr(jdrivers, "make_family_train_step",
                        lambda *a: lambda state, batch, key: (state, jnp.float32(0.0)))
    jdrivers.train_family(name, _cfg(jconfig, name, epochs=1, steps=3))
    drivers.train_family(name, _cfg(config, name, epochs=1, steps=3), device="cpu")
    assert len(seen["jax"]) == len(seen["torch"]) == 3
    for j, t in zip(seen["jax"], seen["torch"]):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("name", ["cvrp", "smtwtp", "sop", "mkp"])
def test_train_family_writes_checkpoints_that_both_packages_read(tmp_path, name):
    """Two epochs of one step with validation: ``progress`` once an epoch
    with a validation cost, ``train_epoch`` and ``val`` events in the JSONL
    stream, ``-best`` and ``-last`` files; ``-last`` restores in the port
    (``restore_train_state``) and in JAX (``load_checkpoint`` into the
    template of JAX's ``init_family_state``), with the trained weights.
    SMTWTP's and SOP's nets have no node update, and their files no node
    BatchNorms, as JAX's have none; SOP's net reads one node feature, MKP's
    five."""
    cfg, jcfg = _cfg(config, name, epochs=2, steps=1), _cfg(jconfig, name, epochs=2, steps=1)
    calls = []
    logger = MetricsLogger(str(tmp_path / "metrics.jsonl"))
    state = drivers.train_family(name, cfg, progress=lambda *a: calls.append(a),
                                 val_instances=2, val_t=2,
                                 ckpt_path=str(tmp_path / "c.msgpack"), logger=logger,
                                 device="cpu")
    logger.close()
    assert [c[0] for c in calls] == [0, 1]
    assert all(len(c) == 3 and math.isfinite(c[1]) and math.isfinite(c[2]) for c in calls)
    assert (tmp_path / "c-best.msgpack").exists() and state.net.training
    events = [json.loads(line)["event"]
              for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert events == ["train_epoch", "val"] * 2
    last = str(tmp_path / "c-last.msgpack")
    fam = families.get_family(name)
    restored = tr.restore_train_state(load_checkpoint(last), drivers.family_model(fam), cfg)
    assert restored.step == 2
    kept = jax_layout(state.net.state_dict(), state.net)
    for k, v in jax_layout(restored.net.state_dict(), restored.net).items():
        assert torch.equal(v, kept[k])
    jfam = jfamilies.get_family(name)
    template = jdrivers.init_family_state(jfam, jdrivers.family_model(jfam), jcfg,
                                          np.random.default_rng(0))
    jstate = jload_checkpoint(last, template)
    assert int(jstate.step) == 2
    _assert_tree_close(to_jax_tree(kept)["params"], jstate.params, 0, 0, "params")


def test_validation_leaves_the_training_net_alone():
    """evaluate_family on a net in train mode: the net comes back in train
    mode with its running statistics unchanged."""
    fam = families.get_family("cvrp")
    net = init_like_flax(Net(feats=1, depth=DEPTH), torch.Generator().manual_seed(0))
    batch = drivers.gen_batch(fam, np.random.default_rng(0), 12, 2)
    inst = drivers.instance_tensors(batch, "cpu")
    with torch.no_grad():                   # move the running statistics off 0 / 1
        drivers._forward_heu(fam, net.train(), inst, 12)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    means, _ = drivers.evaluate_family("cvrp", batch, n_nodes=12, net=net, n_ants=4,
                                       t_values=(1,), device="cpu")
    assert net.training and bool(torch.isfinite(means).all())
    for k, v in stats.items():
        assert torch.equal(net.state_dict()[k], v), k


@pytest.fixture(scope="module")
def cvrp_instance():
    inst = families.gen_cvrp(np.random.default_rng(5), 12)
    heu = (np.random.default_rng(6).random((13, 13)) + 0.1).astype(np.float32)
    return inst, heu


def test_cvrpaco_sample_replays_in_jax(cvrp_instance):
    """The port's sample (the rollout, a pick a step) on a random heuristic
    and pheromone with alpha 2, beta 0.5: its log-probabilities equal JAX's
    ``path_log_probs`` of the same paths through JAX's CVRPACO spec (rtol
    1e-5, atol 1e-6: logsumexp order), they are differentiable in the
    heuristic, the routes are valid and cost what sample reports."""
    inst, heu = cvrp_instance
    tau = (np.random.default_rng(7).random((13, 13)) + 0.5).astype(np.float32)
    heu_t = torch.from_numpy(heu).requires_grad_(True)
    aco = CVRPACO(inst["dist"], inst["demand"], n_ants=A, alpha=2.0, beta=0.5,
                  heuristic=heu_t, pheromone=tau, device="cpu")
    costs, log_probs, paths = aco.sample()
    jaco = JCVRPACO(inst["dist"], inst["demand"], n_ants=A, alpha=2.0, beta=0.5,
                    heuristic=heu, pheromone=tau)
    ref = jpath_log_probs(jaco._spec_factory(jaco.state.phe.tau),
                          jnp.asarray(paths.numpy(), jnp.int32), alpha=2.0, beta=0.5)
    np.testing.assert_allclose(log_probs.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    demand = torch.from_numpy(inst["demand"])
    assert bool(validate_routes(paths, demand, 50.0).all())
    np.testing.assert_allclose(costs.numpy(), np.asarray(jaco._cost_fn(paths.numpy())),
                               rtol=1e-6)
    log_probs.sum().backward()
    assert heu_t.grad is not None and bool(heu_t.grad.abs().sum() > 0)


def test_cvrpaco_run_improves_and_passes_alpha_beta(cvrp_instance, monkeypatch):
    """run(1) five times: lowest_cost never rises, shortest_path is a valid
    route that costs lowest_cost; alpha=2 and beta=0.5 reach score_matrix
    (the construction's scores); under min_max and elitist, ported since,
    the best never rises either and MAX-MIN's tau stays within its bounds."""
    inst, heu = cvrp_instance
    seen = []
    real = cvrp.score_matrix

    def spy(phe, h, alpha, beta):
        seen.append((alpha, beta))
        return real(phe, h, alpha, beta)

    monkeypatch.setattr(cvrp, "score_matrix", spy)
    aco = CVRPACO(inst["dist"], inst["demand"], n_ants=A, alpha=2.0, beta=0.5,
                  heuristic=heu, seed=3, device="cpu")
    costs = [aco.run(1).item() for _ in range(5)]
    assert costs == sorted(costs, reverse=True) and math.isfinite(costs[-1])
    assert seen and set(seen) == {(2.0, 0.5)}
    best = aco.shortest_path
    demand = torch.from_numpy(inst["demand"])
    assert bool(validate_routes(best[:, None], demand, 50.0).all())
    np.testing.assert_allclose(cvrp.route_cost(aco.distances[0], best[:, None]).item(),
                               costs[-1], rtol=1e-6)
    for flag in ("min_max", "elitist"):
        flagged = CVRPACO(inst["dist"], inst["demand"], n_ants=A, heuristic=heu, seed=3,
                          device="cpu", **{flag: True})
        costs = [flagged.run(1).item() for _ in range(3)]
        assert costs == sorted(costs, reverse=True) and math.isfinite(costs[-1])
        if flag == "min_max":
            tau, bound = flagged.state.phe.tau, flagged.state.phe.tau_max.item()
            assert bound > 0 and bool((tau <= bound).all() and (tau >= 1e-10).all())


def test_step_phases_reach_the_metrics_stream_and_a_trace(tmp_path):
    """utils/metrics: inside ``trace`` the train step's spans are recorded,
    and ``report`` gives the four phases in order with their host times;
    ``trace`` writes a profile of the step, whose ranges carry the span
    names, into its directory."""
    from deepaco_tpu_torch.utils import metrics

    fam = families.get_family("cvrp")
    cfg = _cfg(config, "cvrp")
    gen = torch.Generator().manual_seed(0)
    state = tr.init_train_state(Net(feats=1, depth=DEPTH), cfg, gen)
    step = drivers.make_family_train_step(fam, cfg)
    metrics.reset()
    with metrics.trace(str(tmp_path / "prof")):
        step(state, drivers.gen_batch(fam, np.random.default_rng(0), cfg.n_nodes, B), gen)
    phases = ("heuristic", "rollout", "backward", "optimizer")
    report = metrics.report()
    metrics.reset()
    assert [name for name in report if name in phases] == list(phases)
    assert all(report[p]["count"] == 1 and report[p]["host_ms"] >= 0 for p in phases)
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1 and '"deepaco.rollout"' in files[0].read_text()
