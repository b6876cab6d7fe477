"""Port parity: RCPSP (core/rcpsp.py, core/builders.rcpsp_graph, the masked
neighbour mean and pad_feats of models/gnn.py, the engine's probs_fn,
aco/problems/rcpsp.py, eval/rcpsp.py, train/special.py's RCPSP trainer and
the CLI's test and train rcpsp) against the JAX package, on j30-shaped
instances (32 activities, 4 resources) that ``core.rcpsp.progen_rcp`` draws
from numpy seeds, written as a PSPLIB archive into the test's directory."""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import rcpsp as japr
from deepaco_tpu.core import builders as jbuilders
from deepaco_tpu.core import rcpsp as jcore
from deepaco_tpu.eval import rcpsp as jeval
from deepaco_tpu.models.gnn import EdgeBlock as JEdgeBlock
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.train import special as jspecial
from deepaco_tpu.train.reinforce import TrainState as JTrainState
from deepaco_tpu_torch import cli
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems import rcpsp as apr
from deepaco_tpu_torch.core import rcpsp as core
from deepaco_tpu_torch.core.builders import rcpsp_graph
from deepaco_tpu_torch.eval import rcpsp as ev
from deepaco_tpu_torch.models.gnn import (Net, init_like_flax, jax_layout, to_jax_tree,
                                          to_jax_variables)
from deepaco_tpu_torch.train import reinforce as tr
from deepaco_tpu_torch.train import special
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
CKPT30 = ROOT / "checkpoints" / "rcpsp30_selftrained.msgpack"
TEST_SIZE, TRAIN_SIZE = 30, 3


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A seeded j30 archive: 30 test instances, then 3 train instances."""
    rng = np.random.default_rng(17)
    path = tmp_path_factory.mktemp("rcpsp") / "psplib.tar.gz"
    core.write_psplib(str(path), [core.progen_rcp(rng) for _ in range(TEST_SIZE + TRAIN_SIZE)])
    return path


@pytest.fixture(scope="module")
def insts(archive):
    """``(port instances, JAX instances)`` of the test split."""
    return (core.load_psplib(str(archive), test_size=TEST_SIZE),
            jcore.load_psplib(str(archive), test_size=TEST_SIZE))


@pytest.fixture(scope="module")
def variables():
    tree = load_checkpoint(str(CKPT30))
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def _topo_orders(adj: np.ndarray, count: int, seed: int) -> np.ndarray:
    """``count`` random topological orders of ``adj``, each from 0."""
    rng, out = np.random.default_rng(seed), []
    for _ in range(count):
        indeg, order = adj.sum(0).copy(), []
        avail = [i for i in range(len(indeg)) if indeg[i] == 0]
        while avail:
            i = avail.pop(int(rng.integers(len(avail))))
            order.append(i)
            for k in np.nonzero(adj[i])[0]:
                indeg[k] -= 1
                if indeg[k] == 0:
                    avail.append(int(k))
        out.append(order)
    return np.array(out)


def _jdata(d, t_max=None):
    return d if t_max is None else d._replace(t_max=t_max)


def _jstack(ref):
    """JAX instances stacked on one horizon, the largest, for ``vmap``."""
    t_max = max(r.t_max for r in ref)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[r._replace(t_max=t_max)
                                                                for r in ref])


def test_parse_and_load_psplib_equal_jax(archive, insts):
    """Every array, ``t_max`` and the splits: the sorted members' first 30
    the test split, the rest the train split, ``limit`` after the split."""
    ours, ref = insts
    assert len(ours) == len(ref) == TEST_SIZE
    for o, r in zip(ours, ref):
        for a, b in zip(o[:6], r[:6]):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), np.asarray(b))
        assert o.t_max == r.t_max and (o.n, o.m) == (32, 4)
    train = core.load_psplib(str(archive), test_size=TEST_SIZE, split="train", limit=2)
    jtrain = jcore.load_psplib(str(archive), test_size=TEST_SIZE, split="train", limit=2)
    assert len(train) == 2
    for o, r in zip(train, jtrain):
        assert np.array_equal(o.adj.numpy(), np.asarray(r.adj))
    with pytest.raises(ValueError, match="trailing"):
        core.parse_rcp(core.progen_rcp(np.random.default_rng(0), jobs=3) + " 7")


def test_priors_and_graph_equal_jax(insts):
    """The four column priors at rtol 1e-6, batched or not, and the masked
    graph: node features, edge types and the mask (with the sink's
    self-loop) equal."""
    ours, ref = insts
    batch = core.stack_rcpsp(ours[:2])
    g = rcpsp_graph(batch)
    for i, (o, r) in enumerate(zip(ours[:2], ref[:2])):
        for name in ("nlft_heuristic", "ngrpwa_heuristic", "nwrup_heuristic",
                     "default_rcpsp_heuristic"):
            want = np.asarray(getattr(jcore, name)(r))
            np.testing.assert_allclose(getattr(core, name)(o).numpy(), want, rtol=1e-6)
            np.testing.assert_allclose(getattr(core, name)(batch)[i].numpy(), want, rtol=1e-6)
        x, (block,) = jbuilders.rcpsp_graph(r)
        assert np.array_equal(g.x[i].numpy(), np.asarray(x))
        assert np.array_equal(g.edge[i].numpy(), np.asarray(block.edge))
        assert np.array_equal(g.mask[i].numpy(), np.asarray(block.mask))
        assert np.array_equal(g.nbr[i].numpy(), np.asarray(block.nbr))
    assert g.mask[0, -1, -1] == 1.0 and g.edge[0, -1, -1].sum() == 0.0


@pytest.mark.parametrize("backfill", [False, True])
def test_ssgs_starts_and_validator_equal_jax(insts, backfill):
    """50 random topological orders of one instance, on its own horizon and
    on a padded one (``latest_finish`` unchanged): the starts bit-equal to
    JAX's scan, every schedule feasible, the makespans JAX's; the validator
    agrees on the starts and on broken copies of them."""
    o, r = insts[0][0], insts[1][0]
    seqs = _topo_orders(o.adj.numpy(), 50, seed=5)
    for t_max in (o.t_max, o.t_max + 23):
        data = core.stack_rcpsp([o], t_max)
        got = apr.ssgs_schedule(data, torch.from_numpy(seqs)[None], backfill)[0].numpy()
        jd = _jdata(r, t_max)
        want = np.asarray(jax.jit(jax.vmap(lambda s: japr.ssgs_schedule(jd, s, backfill)))(
            jnp.asarray(seqs)))
        assert np.array_equal(got, want), t_max
        spans = apr.makespans(data, torch.from_numpy(seqs.T)[None], backfill)[0]
        assert np.array_equal(spans.numpy(), want[:, -1].astype(np.float32))
    broken = got.copy()
    broken[:, 5] = 0
    for starts in list(got[:5]) + list(broken[:5]):
        assert core.check_schedule(o, starts) == jcore.check_schedule(r, starts)
    assert all(core.check_schedule(o, s) for s in got)


def _tau_heu(datas, seed):
    """Random pheromone in [0.5, 1.5) and the default prior times a random
    factor, ``[B, n, n]``."""
    heu = core.default_rcpsp_heuristic(core.stack_rcpsp(datas))
    b, n, _ = heu.shape
    rng = np.random.default_rng(seed)
    tau = torch.from_numpy((0.5 + rng.random((b, n, n))).astype(np.float32))
    return tau, heu * torch.from_numpy((0.5 + rng.random((b, n, n))).astype(np.float32))


@pytest.mark.parametrize("gamma,c", [(0.0, 0.6), (0.5, 0.0), (0.5, 0.6)],
                         ids=["direct", "summation", "blend"])
def test_greedy_paths_and_log_probs_equal_jax(insts, gamma, c):
    """Direct, summation and blended selection on random tau and heu: the
    greedy activity lists exact, and the log-probabilities of sampled lists
    replayed on both sides at 1e-5 (the scores are ``log(max(p, 1e-30))``,
    the mask ``p > 0``)."""
    ours, ref = insts[0][:3], insts[1][:3]
    tau, heu = _tau_heu(ours, seed=int(gamma * 10 + c * 10))
    cfg = apr.RCPSPConfig(n_ants=4, gamma=gamma, c=c)
    jcfg = japr.RCPSPConfig(n_ants=4, gamma=gamma, c=c)
    data = core.stack_rcpsp(ours)
    spec = apr.rcpsp_spec(tau, heu, data, cfg)
    greedy = engine.greedy_rollout(spec, torch.Generator()).paths
    sampled = engine.rollout(spec, torch.Generator().manual_seed(1)).paths
    logp = engine.path_log_probs(spec, sampled)
    def jax_side(t, h, d, p):
        jspec = japr.rcpsp_spec(t, h, d, jcfg)
        return (jengine.greedy_rollout(jspec, jax.random.PRNGKey(0)).paths,
                jengine.path_log_probs(jspec, p))

    jg, jl = jax.jit(jax.vmap(jax_side))(jnp.asarray(tau.numpy()), jnp.asarray(heu.numpy()),
                                         _jstack(ref), jnp.asarray(sampled.numpy(), jnp.int32))
    assert np.array_equal(greedy.numpy(), np.asarray(jg))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(logp).all())
    for i in range(len(ref)):
        assert (torch.sort(sampled[i], dim=0).values == torch.arange(32)[:, None]).all()


@pytest.mark.parametrize("elitist", [False, True])
@pytest.mark.parametrize("min_max", [False, True])
def test_iteration_update_on_given_paths_matches_jax(insts, monkeypatch, elitist, min_max):
    """Three iterations on given activity lists and their makespans (JAX's
    rollout and decoder replaced by them): tau at rtol 1e-6, tau_max, the
    best makespan and path equal."""
    ours, ref = insts[0][:2], insts[1][:2]
    cfg = apr.RCPSPConfig(n_ants=5, elitist=elitist, min_max=min_max)
    jcfg = japr.RCPSPConfig(n_ants=5, elitist=elitist, min_max=min_max)
    data = core.stack_rcpsp(ours)
    state = apr.init_rcpsp_search(2, 32, cfg)
    jstate = japr.RCPSPSearchState(tau=jnp.full((2, 32, 32), 0.1 if min_max else 1.0),
                                   tau_max=jnp.full(2, jnp.inf), best_cost=jnp.full(2, jnp.inf),
                                   best_path=jnp.zeros((2, 32), jnp.int32))

    def jax_iteration(d, st, p, c):
        # JAX's rollout and decoder are replaced, while the iteration is
        # traced, by the given lists and their makespans (the decoders are
        # held bit-equal in test_ssgs_starts_and_validator_equal_jax)
        with monkeypatch.context() as mp:
            mp.setattr(japr, "rollout", lambda spec, rng, require_prob=False:
                       jengine.Rollout(p, None, None))
            mp.setattr(japr, "makespans", lambda data, paths, backfill=False: c)
            return japr.rcpsp_iteration(d, jnp.ones((32, 32)), jcfg, st, jax.random.PRNGKey(0))

    step = jax.jit(jax.vmap(jax_iteration))
    jdata = _jstack(ref)
    for it in range(3):
        paths = np.stack([_topo_orders(o.adj.numpy(), 5, seed=10 * it + i).T
                          for i, o in enumerate(ours)])
        costs = apr.makespans(data, torch.from_numpy(paths))
        state = apr.rcpsp_update(cfg, state, torch.from_numpy(paths), costs)
        jstate = step(jdata, jstate, jnp.asarray(paths, jnp.int32), jnp.asarray(costs.numpy()))
    np.testing.assert_allclose(state.tau.numpy(), np.asarray(jstate.tau), rtol=1e-6)
    assert np.array_equal(state.tau_max.numpy(), np.asarray(jstate.tau_max))
    assert np.array_equal(state.best_cost.numpy(), np.asarray(jstate.best_cost))
    assert np.array_equal(state.best_path.numpy(), np.asarray(jstate.best_path))


def test_checkpoint_heuristic_matches_jax(insts, variables):
    """``rcpsp30_selftrained`` (12 layers, the masked mean, five node
    features) on three instances: the eval-mode heuristic at rtol 1e-5; in
    train mode the output and the running statistics after one forward at
    1e-4."""
    ours, ref = insts[0][:3], insts[1][:3]
    net = ev.rcpsp_net(variables)
    assert net.pad_feats == 5 and net.emb_net.e_lin0.in_features == 2
    with torch.no_grad():
        got = ev.rcpsp_heuristics(core.stack_rcpsp(ours), net)
    want = jeval.rcpsp_heuristics(ref, variables)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)
    net.train()
    g = rcpsp_graph(core.stack_rcpsp(ours[:1]))
    with torch.no_grad():
        out = net(g)
    x, nbr, edge, mask = jspecial.rcpsp_graph_arrays(ref[0])
    jout, upd = jax.jit(lambda v, *arrays: JNet(pad_feats=5).apply(
        v, (arrays[0], (JEdgeBlock(None, *arrays[1:]),)), train=True,
        mutable=["batch_stats"]))(variables, x, nbr, edge, mask)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), rtol=1e-4, atol=1e-6)
    stats = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(net)["batch_stats"]))
    for path, v in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        np.testing.assert_allclose(stats[path], np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_one_train_step_matches_jax_on_replayed_paths(insts):
    """A 2-layer net from the port's init, one instance, 6 ants whose lists
    the port samples on a heuristic of ones and both sides replay (JAX's
    step's loss with ``path_log_probs`` of them): loss rtol 1e-4,
    gradients rtol 1e-3 / atol 1e-6, the running statistics rtol 1e-5 /
    atol 1e-6, the weights after the clip and AdamW (decay 1e-4) rtol 1e-6
    / atol 1e-7 wherever |gradient| > 1e-6. The loss cancels terms far
    larger than itself, so it is held at 1e-4 of ``sum |adv| * 32 / A /
    n``, about its terms' size."""
    o, r = insts[0][1], insts[1][1]
    data = core.stack_rcpsp([o])
    net = init_like_flax(Net(edge_feats=2, depth=2, pad_feats=5),
                         torch.Generator().manual_seed(3))
    variables = to_jax_variables(net)
    cfg = special.rcpsp_config(32, n_ants=6, lr=1e-3)
    aco_cfg = apr.RCPSPConfig(n_ants=6)
    ones = torch.ones(1, 32, 32)
    paths = engine.rollout(apr.rcpsp_spec(ones, ones, data, aco_cfg),
                           torch.Generator().manual_seed(4)).paths
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, False)
    out = special.rcpsp_loss(net, data, aco_cfg, torch.Generator(), paths=paths)
    out.loss.backward()
    grads = jax_layout({n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                       for n, p in net.named_parameters()}, net)
    state, _ = tr.optimizer_update(state, cfg)

    # JAX's step (special.py:44-70) on the replayed paths, jitted once
    p0 = jnp.asarray(paths[0].numpy(), jnp.int32)
    x, nbr, edge, mask = jspecial.rcpsp_graph_arrays(r)
    model = JNet(depth=2, pad_feats=5)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))

    costs = jnp.asarray(out.costs[0].numpy())   # the decoders are bit-equal (SSGS test)

    @jax.jit
    def jax_step(params, batch_stats, opt_state):
        def loss_fn(params):
            g = (x, (JEdgeBlock(None, nbr, edge, mask),))
            outj, upd = model.apply({"params": params, "batch_stats": batch_stats}, g,
                                    train=True, mutable=["batch_stats"])
            heu = outj[0] * mask + 1e-10
            spec = japr.rcpsp_spec(jnp.ones_like(heu), heu, r, japr.RCPSPConfig(n_ants=6))
            adv = jax.lax.stop_gradient(costs - jnp.mean(costs))
            loss = jnp.sum(adv * jnp.sum(jengine.path_log_probs(spec, p0), axis=0)) / 6 / 32
            return loss, (upd["batch_stats"], jnp.mean(costs))

        (loss, (stats, mon)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return loss, mon, grads, stats, optax.apply_updates(params, updates)

    jloss, mon, jgrads, jstats, jparams = jax_step(
        variables["params"], variables["batch_stats"], tx.init(variables["params"]))
    new = JTrainState(jparams, jstats, None, None)
    np.testing.assert_allclose(out.mean_cost.item(), float(mon), rtol=1e-6)
    flat = dict(jax.tree_util.tree_leaves_with_path(to_jax_tree(grads)["params"]))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(flat[path], np.asarray(g), rtol=1e-3, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    after = to_jax_tree(jax_layout(net.state_dict(), net))
    stats = dict(jax.tree_util.tree_leaves_with_path(after["batch_stats"]))
    for path, v in jax.tree_util.tree_leaves_with_path(new.batch_stats):
        np.testing.assert_allclose(stats[path], np.asarray(v), rtol=1e-5, atol=1e-6)
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    ref_params = dict(jax.tree_util.tree_leaves_with_path(new.params))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        signal = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(got[path][signal], np.asarray(ref_params[path])[signal],
                                   rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arm", ["neural", "classic"])
def test_evaluate_rcpsp_matches_jax_in_law(insts, variables, arm):
    """The 30 test instances, 10 ants, T=1 and 3, elitist MAX-MIN, the same
    seed on each side: the mean best makespans within 2% (the sampling
    streams differ); the curves fall, the final best is the curve's end,
    and every best activity list decodes to a feasible schedule of that
    makespan."""
    ours, ref = insts
    v = variables if arm == "neural" else None
    want, _ = jeval.evaluate_rcpsp(ref, v, n_ants=10, t_values=(1, 3), b_chunk=None)
    net = None if v is None else ev.rcpsp_net(v)
    got, curves, data, state = ev.evaluate_rcpsp(ours, net, n_ants=10, t_values=(1, 3),
                                                 device="cpu", return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.02)
    assert bool((curves[:, 1:] <= curves[:, :-1]).all())
    assert torch.equal(state.best_cost, curves[:, -1])
    starts = apr.ssgs_schedule(data, state.best_path[:, None])[:, 0]
    for i, o in enumerate(ours):
        assert core.check_schedule(o, starts[i])
        assert starts[i, -1].item() == curves[i, -1].item()


def test_facade_samples_runs_and_keeps_feasible_schedules(insts):
    """``RCPSPACO`` on the CPU: ``sample`` gives permutations from 0 whose
    log-probabilities are differentiable in the heuristic; ``run`` never
    rises under MAX-MIN; the best solution's schedule is feasible and has
    the best makespan; the backfill decoder's is never longer here."""
    o = insts[0][2]
    heu = core.default_rcpsp_heuristic(o).requires_grad_(True)
    aco = apr.RCPSPACO(o, n_ants=6, heuristic=heu, elitist=True, min_max=True, device="cpu")
    costs, logp, paths = aco.sample()
    assert paths.shape == (32, 6) and bool((paths[0] == 0).all())
    logp.sum().backward()
    assert heu.grad is not None and bool(torch.isfinite(heu.grad).all())
    best = [aco.run(2).item() for _ in range(3)]
    assert best == sorted(best, reverse=True)
    route, schedule, cost = aco.best_solution
    assert core.check_schedule(o, schedule) and schedule[-1] == cost
    fill = apr.RCPSPACO(o, n_ants=6, backfill=True, seed=1, device="cpu")
    fill.run(3)
    assert core.check_schedule(o, fill.best_solution[1])


def _three_lines(lines, t_values, means):
    assert re.fullmatch(r"total duration: \d+\.\d\ds", lines[0])
    assert lines[1:-1] == [f"T={t}, average cost is {v:.6f}." for t, v in zip(t_values, means)]
    return json.loads(lines[-1])


def test_cli_test_and_train_rcpsp(archive, tmp_path, capsys, monkeypatch):
    """``train rcpsp -n 30 -e 1 -s 2`` on the train split writes a
    checkpoint that ``test rcpsp --ckpt`` reads; ``test rcpsp`` (neural and
    ``--backfill --classic``) prints the JAX CLI's lines; without
    ``DEEPACO_REFERENCE_ROOT`` both exit naming it."""
    monkeypatch.chdir(ROOT)
    monkeypatch.delenv("DEEPACO_REFERENCE_ROOT", raising=False)
    for argv in (["test", "rcpsp"], ["train", "rcpsp"]):
        with pytest.raises(SystemExit, match="DEEPACO_REFERENCE_ROOT"):
            cli.main(argv, device="cpu")
    root = tmp_path / "ref"
    (root / "data" / "rcpsp").mkdir(parents=True)
    big = root / "data" / "rcpsp" / "psplib.tar.gz"
    rng = np.random.default_rng(17)
    core.write_psplib(str(big), [core.progen_rcp(rng) for _ in range(102)])
    monkeypatch.setenv("DEEPACO_REFERENCE_ROOT", str(root))
    out = tmp_path / "rcpsp30.msgpack"
    capsys.readouterr()
    cli.main(["train", "rcpsp", "-n", "30", "-e", "1", "-s", "2", "-a", "4", "-o", str(out)],
             device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"epoch 0: mean makespan \d+\.\d\d \(\d+\.\ds\)", lines[0])
    assert lines[1] == f"saved {out}" and int(load_checkpoint(str(out))["step"]) == 2
    for arm in (["--ckpt", str(out)], ["--classic", "--backfill"]):
        means, curves = cli.main(["test", "rcpsp", "-n", "30", "--limit", "3", "-a", "4",
                                  "-t", "1", "2", *arm], device="cpu")
        rec = _three_lines(capsys.readouterr().out.strip().splitlines(), [1, 2], means)
        assert rec["problem"] == "rcpsp" and rec["instances"] == 3
        assert rec["backfill"] == ("--backfill" in arm) and curves.shape == (3, 2)
    with pytest.raises(SystemExit, match="b-chunk"):
        cli.main(["test", "rcpsp", "-n", "30", "--b-chunk", "4"], device="cpu")
