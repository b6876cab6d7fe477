"""Port parity: the SOP, BPP and MKP families (families.py, core/builders.py,
core/graph.py, models/gnn.py's masked BatchNorm, aco/problems/{sop,bpp,mkp}.py,
utils/golden.py, the CLI) and the runner's ``deposit_div_ants`` against the
JAX package, on inputs made from numpy seeds."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu import families as jfamilies
from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco import runner as jrunner
from deepaco_tpu.aco.problems import mkp as jmkp
from deepaco_tpu.aco.problems.bpp import BPPACO as JBPPACO
from deepaco_tpu.aco.problems.bpp import bpp_fitness as jbpp_fitness
from deepaco_tpu.aco.problems.mkp import MKPACO as JMKPACO
from deepaco_tpu.aco.problems.sop import SOPACO as JSOPACO
from deepaco_tpu.core import graph as jgraph
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.models.gnn import TorchBatchNorm as JBatchNorm
from deepaco_tpu.train import config as jconfig
from deepaco_tpu.train import drivers as jdrivers
from deepaco_tpu.train import reinforce as jr
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch import cli, families
from deepaco_tpu_torch.aco import engine, runner
from deepaco_tpu_torch.aco.problems.bpp import BPPACO, bpp_fitness, validate_bpp
from deepaco_tpu_torch.aco.problems.mkp import MKPACO, validate_mkp
from deepaco_tpu_torch.aco.problems.sop import SOPACO, validate_sop
from deepaco_tpu_torch.core.graph import gather_from_dense, knn_graph, scatter_to_dense
from deepaco_tpu_torch.models.gnn import (Net, TorchBatchNorm, init_like_flax, jax_layout,
                                          to_jax_tree, to_jax_variables)
from deepaco_tpu_torch.ops import fused_gnn
from deepaco_tpu_torch.train import config, drivers
from deepaco_tpu_torch.train import reinforce as tr
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
CKPT = ROOT / "checkpoints"
NAMES = ("sop", "bpp", "mkp")
SIZE = {"sop": 20, "bpp": 20, "mkp": 30}          # n of the generated instances
B, A, K = 3, 6, 5


def _batch(name, seed=3, b=B, n=None):
    """``(port instance [B, ...] prepared, JAX instances, each a prepared
    dict)`` from one numpy seed."""
    fam = families.get_family(name)
    batch = drivers.gen_batch(fam, np.random.default_rng(seed), n or SIZE[name], b)
    jfam = jfamilies.get_family(name)
    jinst = [jfam.prepare({k: jnp.asarray(v[i]) for k, v in batch.items()}) for i in range(b)]
    return fam.prepare(drivers.instance_tensors(batch, "cpu")), jinst


def _tau_heu(name, inst, seed):
    """Random pheromone in [0.5, 1.5) and the classic heuristic times a
    random factor, ``[B, M, M]``."""
    heu = families.get_family(name).classic_heu(inst, K)
    m = heu.shape[-1]
    rng = np.random.default_rng(seed)
    tau = torch.from_numpy((0.5 + rng.random((B, m, m))).astype(np.float32))
    return tau, heu * torch.from_numpy((0.5 + rng.random((B, m, m))).astype(np.float32))


def _jax_starts(name, tau, heu, jinst, key):
    """The start actions ``[B, A]`` that JAX's specs draw at ``key``: MKP's
    start is a uniform real item, the others' node 0."""
    starts = _jax_batched(name, lambda spec, _: spec.init(key)[1], tau, heu, jinst)
    return torch.from_numpy(np.array(starts)).long()


def _valid(name, paths, inst):
    if name == "sop":
        return validate_sop(paths, inst["prec"])
    if name == "bpp":
        return validate_bpp(paths, inst["demand"], families.BPP_CAPACITY)
    return validate_mkp(paths, inst["weight"], inst["prize"].shape[-1] // 2)


def _jax_batched(name, fn, tau, heu, jinst, *more):
    """``fn(spec, inst, *more)`` of every instance's JAX spec at once,
    jitted over ``vmap``, so that JAX's scans compile once."""
    jfam = jfamilies.get_family(name)
    stacked = {k: jnp.stack([ji[k] for ji in jinst]) for k in jinst[0]}
    run = jax.jit(jax.vmap(lambda t, h, inst, *m: fn(jfam.spec(t, h, inst, A), inst, *m)))
    return run(jnp.asarray(tau.numpy()), jnp.asarray(heu.numpy()), stacked, *more)


def test_masked_batchnorm_matches_jax_in_train_mode():
    """Train-mode statistics weighted by an edge mask, per instance as JAX's
    ``vmap`` takes them: the output and the running mean and variance
    (averaged over instances) at rtol 1e-5. The second instance masks every
    edge: its count is clamped to 1. Eval mode ignores the mask."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 7, 8)).astype(np.float32)
    mask = (rng.random((2, 7, 7)) < 0.6).astype(np.float32)
    mask[1] = 0.0
    bn = TorchBatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
        bn.running_var.fill_(2.0)
    got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.zeros(8)},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.full(8, 2.0)}}
    outs, stats = [], []
    for i in range(2):
        y, upd = JBatchNorm(use_running_average=False).apply(
            variables, jnp.asarray(x[i]), jnp.asarray(mask[i]), mutable=["batch_stats"])
        outs.append(np.asarray(y))
        stats.append(upd["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.stack(outs), rtol=1e-5, atol=1e-6)
    for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        ref = np.mean([np.asarray(s[key]) for s in stats], axis=0)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-7)
    bn.eval()
    torch.testing.assert_close(bn(torch.from_numpy(x), torch.from_numpy(mask)),
                               bn(torch.from_numpy(x)))


def test_masked_graph_with_the_node_update_raises(monkeypatch):
    """A masked graph with the node update no longer raises: it takes the
    masked neighbour mean (RCPSP's, gnn.py:216-228) in train and in eval
    mode, equal to JAX's at rtol 1e-5, and the eval route of
    ``drivers._forward_heu`` does not take K9 for it (it runs the plain
    layer, as the JAX package keeps it off its fused layer)."""
    inst, jinst = _batch("sop", b=1)
    g = families.get_family("sop").graph(inst, K)
    net = init_like_flax(Net(feats=1, depth=2, node_update=True),
                         torch.Generator().manual_seed(0))
    variables = to_jax_variables(net)
    jg = jfamilies.get_family("sop").graph(jinst[0], K)
    for training in (False, True):
        with torch.no_grad():
            got = net.train(training)(g)
        want = JNet(depth=2).apply(variables, jg, train=training,
                                   mutable=["batch_stats"] if training else False)
        want = (want[0] if training else want)[0]        # the one block's output
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    calls = []
    real = fused_gnn.net_forward_fast
    monkeypatch.setattr(drivers, "net_forward_fast",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    drivers._forward_heu(families.get_family("sop"), net.eval(), inst, K)
    assert not calls


def test_gather_from_dense_matches_jax_and_inverts_scatter():
    """``gather_from_dense`` on a k-NN graph: JAX's values exactly, and
    ``scatter_to_dense`` of them gives the matrix back on the support."""
    rng = np.random.default_rng(1)
    coords = rng.random((2, 12, 2)).astype(np.float32)
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1).astype(np.float32)
    dist[:, np.arange(12), np.arange(12)] = 1e9
    g = knn_graph(torch.from_numpy(coords), torch.from_numpy(dist), 4)
    mat = torch.from_numpy(rng.random((2, 12, 12)).astype(np.float32))
    got = gather_from_dense(g, mat)
    for i in range(2):
        jg = jgraph.knn_graph(jnp.asarray(coords[i]), jnp.asarray(dist[i]), 4)
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(jgraph.gather_from_dense(jg, jnp.asarray(
                                          mat[i].numpy()))))
    back = scatter_to_dense(g, got)
    support = scatter_to_dense(g, torch.ones_like(got)) > 0
    assert torch.equal(back[support], mat[support])


@pytest.mark.parametrize("name", NAMES)
def test_generators_and_golden_sets_equal_jax(name):
    """The registry's generator (two instances from one numpy seed) and the
    golden writer (SOP at 20, BPP at 120, MKP at 50 and 300) give JAX's
    arrays bit for bit; SOP refuses another scale."""
    ref = jdrivers.gen_batch(jfamilies.get_family(name), np.random.default_rng(7), 24, 2)
    got = drivers.gen_batch(families.get_family(name), np.random.default_rng(7), 24, 2)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"gen {k}")
    calls = {"sop": [(20,)], "bpp": [(120,)], "mkp": [(50,), (300,)]}[name]
    for args in calls:
        got, ref = golden.GOLDEN[name](*args), jgolden.GOLDEN[name](*args)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"golden {args} {k}")
    if name == "sop":
        with pytest.raises(ValueError, match="scale"):
            golden.sop_test(30)


@pytest.mark.parametrize("name", NAMES)
def test_graph_builders_equal_jax(name):
    """SOP's masked dense block (x the cost row of node 0, the mask the
    allowed successors), BPP's dense graph with unit attributes and MKP's
    dense graph with five node features and the source's prize: every field
    exactly equal."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    g = fam.graph(inst, K)
    for i in range(B):
        ref = jfam.graph(jinst[i], K)
        if name == "sop":
            x, (block,) = ref
            ref = dict(x=x, nbr=block.nbr, edge=block.edge, mask=block.mask)
        else:
            ref = dict(ref._asdict(), mask=None)
        for field, r in ref.items():
            if r is None:
                assert getattr(g, field) is None
            else:
                np.testing.assert_array_equal(getattr(g, field)[i].numpy(), np.asarray(r),
                                              err_msg=field)
    assert g.x.shape[-1] == {"sop": 1, "bpp": 1, "mkp": 5}[name]


@pytest.mark.parametrize("name", NAMES)
def test_classic_heuristic_and_greedy_paths_equal_jax(name):
    """The classic heuristic (MKP's extended with the dummy item) is exact,
    and greedy paths on random pheromone, from the starts JAX's greedy
    decode draws, equal JAX's exactly and are valid."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 4)
    starts = _jax_starts(name, tau, heu, jinst, jax.random.split(jax.random.PRNGKey(0))[0])
    spec = fam.spec(tau, heu, inst, A)._replace(start=lambda gen: starts)
    paths = engine.greedy_rollout(spec, torch.Generator()).paths
    assert bool(_valid(name, paths, inst).all())
    ref = _jax_batched(name, lambda spec, _: jengine.greedy_rollout(
        spec, jax.random.PRNGKey(0)).paths, tau, heu, jinst)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(ref))
    for i in range(B):
        np.testing.assert_array_equal(fam.classic_heu(inst, K)[i].numpy(),
                                      np.asarray(jfam.classic_heu(jinst[i], K)))


@pytest.mark.parametrize("name", NAMES)
def test_masks_log_probs_and_objectives_on_replayed_paths(name):
    """Paths the port samples (from the starts JAX's ``path_log_probs``
    takes; valid by the family's validator) replayed through both specs: the
    masks (SOP's precedence counts, BPP's capacity, MKP's knapsack in five
    dimensions) equal JAX's at every step, the log-probabilities agree
    within 1e-5 and the objective at rtol 1e-6 (the same terms summed in
    another order); BPP's paths park on the separator."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 5)
    starts = _jax_starts(name, tau, heu, jinst, jax.random.PRNGKey(0))
    spec = fam.spec(tau, heu, inst, A)._replace(start=lambda gen: starts)
    paths = engine.rollout(spec, torch.Generator().manual_seed(1)).paths
    assert bool(_valid(name, paths, inst).all())
    if name == "bpp":
        assert bool((paths[:, -2:] == 0).all())
    lp = engine.path_log_probs(spec, paths)
    costs = fam.cost(paths, inst)
    state = spec.init(paths[:, 0])
    masks = [spec.mask(state)]
    for t in range(1, paths.shape[1]):
        state = spec.step(state, paths[:, t])
        masks.append(spec.mask(state))

    def replay(spec, one, p):
        state, _ = spec.init(jax.random.PRNGKey(0))
        _, ms = jax.lax.scan(lambda st, act: (spec.step(st, act), spec.mask(st)), state, p[1:])
        return ms, jengine.path_log_probs(spec, p), jfam.cost(p, one)

    jmasks, jlp, jcosts = _jax_batched(name, replay, tau, heu, jinst,
                                       jnp.asarray(paths.numpy(), jnp.int32))
    for t in range(paths.shape[1] - 1):
        np.testing.assert_array_equal(masks[t].numpy(), np.asarray(jmasks[:, t]),
                                      err_msg=f"mask at step {t}")
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-6)


def test_bpp_fitness_on_parked_tails_matches_jax():
    """Falkenauer's fitness on hand-made paths: one closed by a single
    separator, one parked on a long tail of separators, one whose last bin is
    never closed (the JAX package's bin count still counts it, and the sum
    leaves it out), one bin an item; JAX's values at rtol 1e-6."""
    demand = np.array([0, 60, 70, 80, 90, 40, 100], np.float32)
    rows = [[0, 1, 2, 0, 3, 5, 0, 4, 6, 0, 0, 0, 0],
            [0, 6, 0, 5, 1, 0, 2, 3, 0, 4, 0, 0, 0],
            [0, 1, 0, 2, 0, 3, 5, 0, 4, 0, 0, 6, 0],
            [0, 1, 2, 0, 3, 4, 0, 5, 6, 0, 0, 0, 0]]
    paths = np.array(rows, np.int64).T                          # [L, A]
    got = bpp_fitness(torch.from_numpy(demand)[None], 150.0, torch.from_numpy(paths)[None])
    ref = jbpp_fitness(jnp.asarray(demand), 150.0, jnp.asarray(paths, jnp.int32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-6)
    unclosed = [0, 1, 2, 0, 3, 0, 4, 0, 5, 6]
    got = bpp_fitness(torch.from_numpy(demand)[None], 150.0,
                      torch.tensor(unclosed)[None, :, None])
    ref = jbpp_fitness(jnp.asarray(demand), 150.0, jnp.asarray(unclosed)[:, None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("name", ["bpp", "mkp"])
def test_search_update_div_ants_and_floor_match_jax(name):
    """One best-so-far and Ant System update with the family's flags on the
    same sampled paths: BPP deposits ``fitness / A`` (``deposit_div_ants``),
    MKP ``q * prize`` with ``q = 1 / sum(prize)``, both maximize and floor
    tau at 1e-10 (the pheromone starts at 1e-12 on a quarter of the
    entries, which the floor then lifts). tau at rtol 1e-6 (deposit sum
    order), best cost and path bit-equal."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 6)
    tau = torch.where(torch.from_numpy(np.random.default_rng(1).random(tau.shape) < 0.25),
                      torch.tensor(1e-12), tau)
    paths = engine.rollout(fam.spec(torch.ones_like(tau), heu, inst, A),
                           torch.Generator().manual_seed(2)).paths
    costs = fam.cost(paths, inst)
    best = costs.max(dim=-1).values + torch.tensor([-1.0, 0.0, 1.0])
    best_path = torch.from_numpy(np.random.default_rng(8).integers(0, 5, (B, paths.shape[1])))
    cfg = fam.aco._replace(n_ants=A)
    state = runner.init_search(tau.shape[-1], paths.shape[1] - 1, cfg, batch=(B,), device="cpu")
    state = state._replace(phe=state.phe._replace(tau=tau), best_cost=best, best_path=best_path)
    got = runner.search_update(cfg, state, paths, costs, **fam.extras(inst))
    assert bool((got.phe.tau >= 1e-10).all()) and bool((got.phe.tau == 1e-10).any())
    jcfg = jfam.aco._replace(n_ants=A)
    for i in range(B):
        st = jrunner.init_search(tau.shape[-1], paths.shape[1] - 1, jcfg)
        st = st._replace(phe=st.phe._replace(tau=jnp.asarray(tau[i].numpy())),
                         best_cost=jnp.float32(best[i].item()),
                         best_path=jnp.asarray(best_path[i].numpy(), jnp.int32))
        ref = jrunner.search_update(jcfg, st, jnp.asarray(paths[i].numpy(), jnp.int32),
                                    jnp.asarray(costs[i].numpy()), **jfam.extras(jinst[i]))
        np.testing.assert_allclose(got.phe.tau[i].numpy(), np.asarray(ref.phe.tau), rtol=1e-6)
        assert got.best_cost[i].item() == float(ref.best_cost)
        np.testing.assert_array_equal(got.best_path[i].numpy(), np.asarray(ref.best_path))


def test_check_ported_names_the_item_each_flag_waits_for():
    """No flag waits for an item any more: ``check_ported`` and its table
    are gone, and elitist and min_max (item 4, ported since) run an update
    with BPP's deposit_div_ants and floor."""
    assert not hasattr(runner, "check_ported") and not hasattr(runner, "_UNPORTED")
    paths = torch.stack([torch.randperm(6) for _ in range(3)], dim=1)[None]
    for flag in ("elitist", "min_max"):
        cfg = runner.ACOConfig(deposit_div_ants=True, maximize=True, floor=1e-10,
                               cyclic=False, symmetric=False, **{flag: True})
        state = runner.init_search(6, 5, cfg, batch=(1,))
        got = runner.search_update(cfg, state, paths, torch.tensor([[0.5, 0.9, 0.7]]))
        assert got.best_cost.item() == np.float32(0.9) and bool((got.phe.tau >= 1e-10).all())


@pytest.mark.parametrize("name,n,ckpt", [("sop", 20, "sop20"), ("sop", 50, "sop50"),
                                         ("bpp", 120, "bpp120"), ("mkp", 300, "mkp300")])
def test_checkpoint_heuristic_matches_jax(name, n, ckpt):
    """The committed checkpoint through ``family_model`` (SOP: one node
    feature, no node update, read from the family and from the tree; MKP:
    five node features) and ``_forward_heu``'s eval route (the folded layer
    stack; SOP's mask changes nothing there) on two golden instances,
    against JAX's ``_forward_heu`` with the same checkpoint: the net's
    output at rtol 1e-5 / atol 1e-6, and the heuristic at rtol 1e-5 /
    atol 1e-6, except MKP's, which divides by each instance's smallest
    output (about 1e-11, of relative error up to 1e-4 through 12 layers) and
    is held at rtol 2e-5."""
    v = load_checkpoint(str(CKPT / f"{ckpt}_selftrained.msgpack"))
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    ds = {k: a[:2] for k, a in golden.GOLDEN[name](n).items()}
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    k = fam.k_sparse(n)
    model = JNet(**dict(jfam.model_kwargs), use_pallas=False)
    jds = {kk: jnp.asarray(a) for kk, a in ds.items()}
    ref = np.asarray(jax.jit(jax.vmap(lambda inst: jdrivers._forward_heu(
        jfam, model, variables["params"], variables["batch_stats"], jfam.prepare(inst), k,
        False)[0]))(jds))
    jout = jax.jit(jax.vmap(lambda inst: model.apply(
        variables, jfam.graph(jfam.prepare(inst), k), train=False)))(jds)
    jout = np.asarray(jout[0] if isinstance(jout, list) else jout)
    net = drivers.family_model(fam, variables)
    assert net.emb_net.v_lin0.in_features == {"sop": 1, "bpp": 1, "mkp": 5}[name]
    assert net.emb_net.node_update == (name != "sop")
    assert Net.from_jax_variables(variables).emb_net.node_update == (name != "sop")
    inst = fam.prepare(drivers.instance_tensors(ds, "cpu"))
    g = fam.graph(inst, k)
    with torch.no_grad():
        out = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge)
        got = drivers._forward_heu(fam, net, inst, k).numpy()
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, fam.heu_matrix(g, out, inst).numpy())
    np.testing.assert_allclose(got, ref, rtol=2e-5 if name == "mkp" else 1e-5, atol=1e-6)


# ------------------------------------------------------------- training --
TRAIN_N = {"sop": 12, "bpp": 10, "mkp": 12}
DEPTH = 2


def _cfg(mod, name, epochs=2, steps=5, batch=2):
    n = TRAIN_N[name]
    return mod.ProblemConfig(name=name, n_nodes=n, k_sparse=n,
                             model=mod.ModelConfig(depth=DEPTH),
                             aco=mod.ACOSettings(n_ants=A),
                             train=mod.TrainConfig(epochs=epochs, steps_per_epoch=steps,
                                                   batch_size=batch))


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
            lp = jengine.path_log_probs(spec, p)
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


def _tree_close(got, ref, rtol, atol, what):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert set(flat_got) == {p for p, _ in flat_ref}, what
    for path, r in flat_ref:
        np.testing.assert_allclose(flat_got[path], np.asarray(r), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_jax(name):
    """B=2 instances from a numpy seed, 6 ants, a 2-layer net (SOP: the
    masked dense block, no node update, the masked edge BatchNorms; BPP:
    the CVRP graph at capacity 150; MKP: five node features, the dummy
    item), the same weights and the same paths, sampled by the port on a
    heuristic of ones from the starts JAX's ``path_log_probs`` takes and
    replayed on both sides. JAX runs Net(use_pallas=True) (BPP and MKP: the
    Pallas layer in interpret mode; SOP's masked graph stays off it, as in
    JAX). Loss rtol 1e-4, gradients rtol 1e-3 / atol 1e-6 (deep sums in
    other orders), the running statistics rtol 1e-5 / atol 1e-6 (SOP's
    moved by the masked statistics), the parameters after AdamW rtol 1e-6
    / atol 1e-7 wherever |gradient| > 1e-6."""
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    cfg, jcfg = _cfg(config, name), _cfg(jconfig, name)
    batch = drivers.gen_batch(fam, np.random.default_rng(1), cfg.n_nodes, 2)
    kwargs = dict(jfam.model_kwargs)
    jinst = [jfam.prepare({k: jnp.asarray(v[i]) for k, v in batch.items()}) for i in range(2)]
    variables = jax.jit(lambda one: JNet(depth=DEPTH, **kwargs).init(
        jax.random.PRNGKey(0), jfam.graph(one, cfg.k_sparse), train=False))(jinst[0])
    tx = jr.make_optimizer(jcfg, 10)
    jstate = jr.TrainState(variables["params"], variables["batch_stats"],
                           tx.init(variables["params"]), 0)
    inst = fam.prepare(drivers.instance_tensors(batch, "cpu"))
    m = fam.horizon_states(cfg.n_nodes)[0]
    ones = torch.ones(2, m, m)
    starts = _jax_starts(name, ones, ones, jinst, jax.random.PRNGKey(0))
    spec = fam.spec(ones, ones, inst, A)._replace(start=lambda gen: starts)
    paths = engine.rollout(spec, torch.Generator().manual_seed(3)).paths
    assert bool(_valid(name, paths, inst).all())

    net = Net.from_jax_variables(variables)
    assert net.emb_net.node_update == (name != "sop")
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, False)
    out = drivers.family_loss(fam, net, drivers.instance_tensors(batch, "cpu"), cfg,
                              torch.Generator(), paths=paths)
    out.loss.backward()
    grads = jax_layout({n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                        for n, p in net.named_parameters()}, net)
    state, _ = tr.optimizer_update(state, cfg)
    loss, jgrads, jstats, jparams = _jax_step(
        jfam, JNet(depth=DEPTH, use_pallas=True, **kwargs), jcfg, jstate,
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(paths.numpy(), jnp.int32))
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-4)
    _tree_close(to_jax_tree(grads)["params"], jgrads, 1e-3, 1e-6, "grad")
    after = to_jax_tree(jax_layout(net.state_dict(), net))
    _tree_close(after["batch_stats"], jstats, 1e-5, 1e-6, "batch_stats")
    assert not np.allclose(after["batch_stats"]["emb_net"]["e_bns_0"]["var"], 1.0)
    got = dict(jax.tree_util.tree_leaves_with_path(after["params"]))
    ref_params = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        signal = np.abs(np.asarray(g)) > 1e-6
        np.testing.assert_allclose(got[path][signal], np.asarray(ref_params[path])[signal],
                                   rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,n,ckpt,arm,seed", [
    ("sop", 20, "sop20", "neural", 0), ("sop", 20, None, "classic", 0),
    ("bpp", 50, "bpp120", "neural", 0), ("bpp", 50, None, "classic", 0),
    ("mkp", 50, "mkp300", "neural", 0), ("mkp", 50, None, "classic", 0)])
def test_evaluate_family_matches_jax_in_law(name, n, ckpt, arm, seed):
    """evaluate_family on the first 50 golden instances (SOP20; BPP and MKP
    at n=50 with the BPP120 and MKP300 checkpoints, the net being size-free)
    or the classic heuristic, 10 ants, T=1 and 4, the same seed on each side:
    the means agree within 2% (the sampling streams differ); each curve
    moves one way, the final state's best is the curve's end, and every
    best solution is valid and scores it."""
    ds = {k: v[:50] for k, v in golden.GOLDEN[name](n).items()}
    t_values = (1, 4)
    variables = None
    if arm == "neural":
        v = load_checkpoint(str(CKPT / f"{ckpt}_selftrained.msgpack"))
        variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    ref, _ = jdrivers.evaluate_family(name, ds, n_nodes=n, variables=variables, n_ants=10,
                                      t_values=t_values, seed=seed)
    fam = families.get_family(name)
    net = None if variables is None else drivers.family_model(fam, variables)
    got, curves, state = drivers.evaluate_family(name, ds, n_nodes=n, net=net, n_ants=10,
                                                 t_values=t_values, seed=seed, device="cpu",
                                                 return_state=True)
    sign = -1.0 if fam.aco.maximize else 1.0
    assert bool(torch.isfinite(curves).all())
    assert bool((sign * curves[:, 1:] <= sign * curves[:, :-1]).all())
    assert torch.equal(state.best_cost, curves[:, -1])
    inst = fam.prepare(drivers.instance_tensors(ds, "cpu"))
    best = state.best_path[..., None]
    assert bool(_valid(name, best, inst).all())
    torch.testing.assert_close(fam.cost(best, inst)[:, 0], state.best_cost, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.02)


@pytest.mark.parametrize("name,n,ckpt", [("sop", 20, "sop20"), ("bpp", 30, "bpp120"),
                                         ("mkp", 30, "mkp300")])
def test_cli_test_and_train(name, n, ckpt, tmp_path, capsys, monkeypatch):
    """``test <name>`` with the committed checkpoint (2 golden instances, 4
    ants, T=1 and 2) prints the JAX CLI's lines with a curve that moves one
    way; ``train <name>`` (1 epoch of 2 steps, batch 2, 4 ants) writes a
    checkpoint in JAX's layout that ``test -c`` reads back."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(["test", name, "-n", str(n), "--limit", "2", "-a", "4",
                              "-t", "1", "2", "-c",
                              f"checkpoints/{ckpt}_selftrained.msgpack"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1:3] == [f"T={t}, average cost is {v:.6f}." for t, v in zip((1, 2), means)]
    sign = -1.0 if families.get_family(name).aco.maximize else 1.0
    assert curves.shape == (2, 2) and bool((sign * curves[:, 1] <= sign * curves[:, 0]).all())
    out = tmp_path / f"{name}.msgpack"
    size = str(TRAIN_N[name])
    state = cli.main(["train", name, "-n", size, "-a", "4", "-e", "1", "-s", "2", "-b", "2",
                      "-o", str(out)], device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"saved {out}"
    assert state.step == 2
    tree = load_checkpoint(str(out))
    assert ("v_bns_0" in tree["params"]["emb_net"]) == (name != "sop")
    assert tree["params"]["emb_net"]["v_lin0"]["kernel"].shape[0] == (5 if name == "mkp" else 1)
    means, _ = cli.main(["test", name, "-n", str(n), "--limit", "2", "-a", "4", "-t", "1",
                         "-c", str(out)], device="cpu")
    assert np.isfinite(means).all()


def _facades(name):
    """One instance, its port facade and JAX's, with a random heuristic and
    alpha 2, beta 0.5."""
    inst, _ = _batch(name, b=1)
    raw = lambda k: inst[k][0].numpy()
    rng = np.random.default_rng(9)
    kw = dict(n_ants=A, alpha=2.0, beta=0.5)
    if name == "sop":
        heu = (rng.random((20, 20)) + 0.1).astype(np.float32)
        args = (raw("dist"), raw("prec"))
        return SOPACO(*args, heuristic=heu, device="cpu", **kw), JSOPACO(*args, heuristic=heu,
                                                                        **kw), inst
    if name == "bpp":
        heu = (rng.random((21, 21)) + 0.1).astype(np.float32)
        return (BPPACO(raw("demand"), heuristic=heu, device="cpu", **kw),
                JBPPACO(raw("demand"), heuristic=heu, **kw), inst)
    heu = (rng.random((30, 30)) + 0.1).astype(np.float32)
    args = (raw("prize"), raw("weight"))
    return MKPACO(*args, heuristic=heu, device="cpu", **kw), JMKPACO(*args, heuristic=heu,
                                                                    **kw), inst


@pytest.mark.parametrize("name", NAMES)
def test_facade_sample_replays_in_jax_and_run_improves(name):
    """The facades (SOPACO, BPPACO, MKPACO): ``sample``'s log-probabilities
    equal JAX's ``path_log_probs`` of its paths through JAX's facade spec
    (MKP's started from the port's first items through JAX's own knapsack
    update) at rtol 1e-5 / atol 1e-5, and its costs JAX's (rtol 1e-6);
    ``run(1)`` four times never gets worse (BPPACO through K7c's plain
    version), the best path is valid and scores the best; SOPACO and MKPACO
    under min_max (ported since) never get worse and keep tau under the
    bound (MKP's static 20)."""
    aco, jaco, inst = _facades(name)
    costs, log_probs, paths = aco.sample()
    jspec = jaco.spec_fn(jaco.state.phe.tau, jaco.data, jaco.cfg)
    if name == "mkp":
        start = jnp.asarray(paths[0].numpy(), jnp.int32)
        update, dummy = jmkp._knapsack_masks(jaco.data["weight"], jaco.data["capacity"], A,
                                             jnp.float32)
        m = jaco.data["weight"].shape[0]
        state = (start, *update(jnp.ones((A, m)), jnp.ones((A, m)).at[:, dummy].set(0.0),
                                jnp.zeros((A, 5)), start))
        jspec = jspec._replace(init=lambda rng: (state, start))
    ref = jengine.path_log_probs(jspec, jnp.asarray(paths.numpy(), jnp.int32), alpha=2.0,
                                 beta=0.5)
    np.testing.assert_allclose(log_probs.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jaco.cost_fn(
        jnp.asarray(paths.numpy(), jnp.int32), jaco.data)), rtol=1e-6)
    sign = -1.0 if aco.cfg.maximize else 1.0
    best = [sign * aco.run(1).item() for _ in range(4)]
    assert best == sorted(best, reverse=True)
    path = aco.best_path[None, :, None]
    assert bool(_valid(name, path, inst).all())
    np.testing.assert_allclose(aco.cost(path).item(), aco.best_cost.item(), rtol=1e-6)
    if name == "bpp":
        assert aco.best_fitness == aco.best_cost
    else:
        raw = lambda k: inst[k][0].numpy()
        flagged = (SOPACO(raw("dist"), raw("prec"), min_max=True, device="cpu") if name == "sop"
                   else MKPACO(raw("prize"), raw("weight"), min_max=True, device="cpu"))
        best = [sign * flagged.run(1).item() for _ in range(3)]
        assert best == sorted(best, reverse=True)
        bound = flagged.state.phe.tau_max.item()
        assert bound == (20.0 if name == "mkp" else bound) and bound > 0
        assert bool((flagged.state.phe.tau <= bound).all())
