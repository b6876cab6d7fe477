"""Port parity: the OP, PCTSP and SMTWTP families (families.py, core/builders.py,
aco/problems/{op,pctsp,smtwtp}.py, utils/golden.py) and the runner's
``maximize`` and ``cost_offset`` (aco/runner.py) against the JAX package, on
inputs made from numpy seeds."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu import families as jfamilies
from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco import runner as jrunner
from deepaco_tpu.aco.problems.op import OPACO as JOPACO
from deepaco_tpu.aco.problems.pctsp import PCTSPACO as JPCTSPACO
from deepaco_tpu.aco.problems.smtwtp import SMTWTPACO as JSMTWTPACO
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.train import drivers as jdrivers
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine, runner
from deepaco_tpu_torch.aco.problems.op import OPACO, validate_op
from deepaco_tpu_torch.aco.problems.pctsp import PCTSPACO, validate_pctsp
from deepaco_tpu_torch.aco.problems.smtwtp import SMTWTPACO, validate_smtwtp
from deepaco_tpu_torch.ops import fused_gnn
from deepaco_tpu_torch.train import drivers
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


CKPT = Path(__file__).resolve().parent.parent / "checkpoints"
NAMES = ("op", "pctsp", "smtwtp")
SIZE = {"op": 20, "pctsp": 20, "smtwtp": 30}          # n of the generated instances
B, A, K = 3, 6, 5


def _batch(name, seed=3, b=B):
    """``(port instance [B, ...] prepared, JAX instances, one a prepared dict)``
    from one numpy seed."""
    fam = families.get_family(name)
    batch = drivers.gen_batch(fam, np.random.default_rng(seed), SIZE[name], b)
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


def _valid(name, paths, inst):
    if name == "op":
        return validate_op(paths, inst["dist"], inst["max_len"])
    if name == "pctsp":
        return validate_pctsp(paths, inst["prizes"], (inst["prizes"].shape[-1] - 1) / 4.0)
    return validate_smtwtp(paths)


@pytest.mark.parametrize("name", NAMES)
def test_generators_and_golden_sets_equal_jax(name):
    """The registry's generator (two instances from one numpy seed) and the
    golden writer at its smallest scale (OP also its "val" split) give JAX's
    arrays bit for bit; another scale is refused."""
    ref = jdrivers.gen_batch(jfamilies.get_family(name), np.random.default_rng(7), 40, 2)
    got = drivers.gen_batch(families.get_family(name), np.random.default_rng(7), 40, 2)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"gen {k}")
    n = golden.SCALES[name][0]
    calls = [(n,), (n, "val")] if name == "op" else [(n,)]
    for args in calls:
        got, ref = golden.GOLDEN[name](*args), jgolden.GOLDEN[name](*args)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"golden {args} {k}")
    with pytest.raises(ValueError, match="scale"):
        golden.GOLDEN[name](n + 1)


@pytest.mark.parametrize("name", NAMES)
def test_graph_builders_equal_jax(name):
    """OP's k-NN graph with (distance to the depot, prize), PCTSP's dense
    graph with (prize, penalty), SMTWTP's dense job graph with the
    destination's processing time: x, nbr and edge exactly equal."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    g = fam.graph(inst, K)
    for i in range(B):
        ref = jfam.graph(jinst[i], K)
        for field in ("x", "nbr", "edge"):
            np.testing.assert_array_equal(getattr(g, field)[i].numpy(),
                                          np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_classic_heuristic_and_greedy_paths_equal_jax(name):
    """The classic heuristic (OP's extended with the dummy node) is exact,
    and greedy paths on random pheromone equal JAX's exactly and are valid."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 4)
    paths = engine.greedy_rollout(fam.spec(tau, heu, inst, A), torch.Generator()).paths
    assert bool(_valid(name, paths, inst).all())
    for i in range(B):
        np.testing.assert_array_equal(fam.classic_heu(inst, K)[i].numpy(),
                                      np.asarray(jfam.classic_heu(jinst[i], K)))
        spec = jfam.spec(jnp.asarray(tau[i].numpy()), jnp.asarray(heu[i].numpy()), jinst[i], A)
        ref = jengine.greedy_rollout(spec, jax.random.PRNGKey(0)).paths
        np.testing.assert_array_equal(paths[i].numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", NAMES)
def test_masks_log_probs_and_objectives_on_replayed_paths(name):
    """Paths the port samples (valid by the family's validator) replayed
    through both specs: the masks equal JAX's at every step, the
    log-probabilities of ``path_log_probs`` agree within 1e-5, and the
    objective agrees at rtol 1e-6: the same terms, summed in another order
    (XLA's CPU reduction against torch's)."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 5)
    spec = fam.spec(tau, heu, inst, A)
    paths = engine.rollout(spec, torch.Generator().manual_seed(1)).paths
    assert bool(_valid(name, paths, inst).all())
    lp = engine.path_log_probs(spec, paths)
    costs = fam.cost(paths, inst)
    state = spec.init(paths[:, 0])
    masks = [spec.mask(state)]
    for t in range(1, paths.shape[1]):
        state = spec.step(state, paths[:, t])
        masks.append(spec.mask(state))
    for i in range(B):
        jspec = jfam.spec(jnp.asarray(tau[i].numpy()), jnp.asarray(heu[i].numpy()),
                          jinst[i], A)
        p = jnp.asarray(paths[i].numpy(), jnp.int32)
        jstate, _ = jspec.init(jax.random.PRNGKey(0))
        for t in range(paths.shape[1] - 1):
            np.testing.assert_array_equal(masks[t][i].numpy(), np.asarray(jspec.mask(jstate)),
                                          err_msg=f"mask at step {t}")
            jstate = jspec.step(jstate, p[t + 1])
        np.testing.assert_allclose(lp[i].numpy(), np.asarray(jengine.path_log_probs(jspec, p)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(costs[i].numpy(), np.asarray(jfam.cost(p, jinst[i])),
                                   rtol=1e-6)


def test_op_feasibility_adds_in_jax_order_at_the_boundary():
    """An OP instance whose budget is exactly the length of the tour 0-1-2-0
    computed as JAX adds it: the mask keeps node 2 open after node 1 (the
    sum is not above max_len), as JAX's does; a budget one ulp lower shuts
    it."""
    coords = np.array([[0.1, 0.2], [0.7, 0.3], [0.4, 0.9], [0.95, 0.95]], np.float32)
    dist = np.linalg.norm(coords[:, None] - coords[None], axis=-1).astype(np.float32)
    np.fill_diagonal(dist, 1e9)
    exact = (np.float32(dist[0, 1]) + dist[1, 2]) + dist[2, 0]
    for budget, open_ in ((exact, 1.0), (np.nextafter(exact, np.float32(0)), 0.0)):
        prizes = np.ones(4, np.float32)
        inst = families.get_family("op").prepare(drivers.instance_tensors(
            {"coords": coords[None], "dist": dist[None], "prizes": prizes[None],
             "max_len": np.array([budget], np.float32)}, "cpu"))
        ones = torch.ones(1, 5, 5)
        spec = families.get_family("op").spec(ones, ones, inst, 1)
        state = spec.step(spec.init(torch.zeros(1, 1, dtype=torch.int64)), torch.ones(1, 1,
                                                                                     dtype=torch.int64))
        jinst = jfamilies.get_family("op").prepare(
            {"dist": jnp.asarray(dist), "prizes": jnp.asarray(prizes),
             "max_len": jnp.float32(budget)})
        jspec = jfamilies.get_family("op").spec(jnp.ones((5, 5)), jnp.ones((5, 5)), jinst, 1)
        jstate = jspec.step(jspec.init(jax.random.PRNGKey(0))[0], jnp.ones((1,), jnp.int32))
        assert spec.mask(state)[0, 0, 2].item() == open_
        np.testing.assert_array_equal(spec.mask(state)[0].numpy(), np.asarray(jspec.mask(jstate)))


@pytest.mark.parametrize("name", ["op", "smtwtp"])
def test_search_update_maximize_and_cost_offset_match_jax(name):
    """One best-so-far and Ant System update with the family's flags on the
    same sampled paths: OP maximizes (deposit ``q * prize``, ``q = 1/sum``
    of each instance's prizes, best = the largest), SMTWTP deposits ``1 /
    (cost + 1)``. tau at rtol 1e-6 (deposit sum order), best cost and path
    bit-equal. Instance 0 improves on its best through a tie between ants 1
    and 2 (the first wins, as JAX's argmin of ``sign * cost`` picks it),
    instance 1 ties its best (no change), instance 2 does not improve."""
    inst, jinst = _batch(name)
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    tau, heu = _tau_heu(name, inst, 6)
    paths = engine.rollout(fam.spec(torch.ones_like(tau), heu, inst, A),
                           torch.Generator().manual_seed(2)).paths
    costs = fam.cost(paths, inst)
    sign = -1.0 if fam.aco.maximize else 1.0
    best_ant = torch.argmin(sign * costs, dim=-1)
    costs[0, 1] = costs[0, 2] = costs[0, best_ant[0]] - sign * 1e-3     # a tie, better
    ibest = (sign * costs).min(dim=-1).values * sign
    best = torch.stack([ibest[0] + sign * 1.0, ibest[1], ibest[2] - sign * 1.0])
    best_path = torch.from_numpy(np.random.default_rng(8).integers(0, 5, (B, paths.shape[1])))
    cfg = fam.aco._replace(n_ants=A)
    state = runner.init_search(tau.shape[-1], paths.shape[1] - 1, cfg, batch=(B,), device="cpu")
    state = state._replace(phe=state.phe._replace(tau=tau), best_cost=best, best_path=best_path)
    got = runner.search_update(cfg, state, paths, costs, **fam.extras(inst))
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
    assert torch.equal(got.best_path[0], paths[0, :, 1])
    assert torch.equal(got.best_path[1], best_path[1]) and got.best_cost[2] == best[2]


def test_check_ported_takes_maximize_and_cost_offset_and_refuses_the_rest():
    """``check_ported`` is gone with the last unported flags: maximize,
    cost_offset and the vector pheromone start their search, and so do
    elitist and min_max (MAX-MIN's tau at tau_min, SMTWTP's static bound)."""
    assert not hasattr(runner, "check_ported")
    cfg = runner.ACOConfig(maximize=True, cost_offset=1.0)
    state = runner.init_search(5, 4, cfg, batch=(2,), device="cpu")
    assert bool((state.best_cost == -float("inf")).all())
    runner.init_search(5, 4, runner.ACOConfig(vector_pheromone=True, maximize=True), batch=(2,))
    for flag in ("elitist", "min_max"):
        runner.init_search(5, 4, runner.ACOConfig(**{flag: True}), batch=(2,))
    mm = runner.init_search(5, 4, runner.ACOConfig(min_max=True, mm_static_max=1.0), batch=(2,))
    assert torch.equal(mm.phe.tau, torch.full((2, 5, 5), 0.1))
    assert torch.equal(mm.phe.tau_max, torch.ones(2))


@pytest.mark.parametrize("name,n", [("op", 100), ("pctsp", 20), ("smtwtp", 50)])
def test_checkpoint_heuristic_matches_jax(name, n):
    """The committed checkpoint through ``family_model`` (2 node features;
    SMTWTP without the node update, read from the family) and
    ``_forward_heu``'s eval route (the folded layer stack) on two golden
    instances, against JAX's ``_forward_heu`` with the same checkpoint: the
    net's output at rtol 1e-5 / atol 1e-6. The heuristic is that output
    post-processed, exactly as JAX does it (OP: scattered and extended;
    SMTWTP: +1e-10), so it holds the same tolerance, except PCTSP's, which
    divides by each instance's smallest output (about 1e-15, of relative
    error up to 1e-4 through 12 layers), and is held at rtol 2e-5 (measured
    1.2e-5)."""
    v = load_checkpoint(str(CKPT / f"{name}{n}_selftrained.msgpack"))
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    ds = {k: a[:2] for k, a in golden.GOLDEN[name](n).items()}
    fam, jfam = families.get_family(name), jfamilies.get_family(name)
    k = fam.k_sparse(n)
    model = JNet(**dict(jfam.model_kwargs), use_pallas=False)
    jds = {kk: jnp.asarray(a) for kk, a in ds.items()}
    ref = np.asarray(jax.jit(jax.vmap(lambda inst: jdrivers._forward_heu(
        jfam, model, variables["params"], variables["batch_stats"], jfam.prepare(inst), k,
        False)[0]))(jds))
    jout = np.asarray(jax.jit(jax.vmap(lambda inst: model.apply(
        variables, jfam.graph(jfam.prepare(inst), k), train=False)))(jds))
    net = drivers.family_model(fam, variables)
    assert net.emb_net.v_lin0.in_features == 2
    assert net.emb_net.node_update == (name != "smtwtp")
    inst = fam.prepare(drivers.instance_tensors(ds, "cpu"))
    g = fam.graph(inst, k)
    with torch.no_grad():
        out = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge)
        got = drivers._forward_heu(fam, net, inst, k).numpy()
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, fam.heu_matrix(g, out, inst).numpy())
    np.testing.assert_allclose(got, ref, rtol=2e-5 if name == "pctsp" else 1e-5, atol=1e-6)


@pytest.mark.parametrize("name,arm,seed", [
    ("op", "neural", 0), ("op", "neural", 1), ("op", "classic", 0),
    ("pctsp", "neural", 0), ("pctsp", "neural", 1), ("pctsp", "classic", 0),
    ("smtwtp", "neural", 0), ("smtwtp", "neural", 1)])
def test_evaluate_family_matches_jax_in_law(name, arm, seed):
    """evaluate_family on golden instances of the smallest scale with its
    checkpoint (OP100, PCTSP20, SMTWTP50; the first 50 instances) or the
    classic heuristic (all 100), 10 ants, T=1 and 4, the same seed on each
    side: the means agree within 2% (the sampling streams differ); each
    curve moves one way (up for OP, which maximizes), the final state's best
    is the curve's end, and every best solution is valid and scores it.
    ``scripts/family_law_spread.py`` reads the same protocol over seeds 0-9:
    the neural means agree within 0.4% and the classic OP and PCTSP ones
    within 0.8%. SMTWTP's classic arm is not held here: its heavy-tailed
    tardiness spreads JAX's own T1 mean over 6.99-8.26 between seeds, so one
    seed's 2% says nothing (the means over ten seeds: 7.53 and 7.55)."""
    n = golden.SCALES[name][0]
    ds = {k: v[:50 if arm == "neural" else 100] for k, v in golden.GOLDEN[name](n).items()}
    t_values = (1, 4)
    variables = None
    if arm == "neural":
        v = load_checkpoint(str(CKPT / f"{name}{n}_selftrained.msgpack"))
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


def _facades(name):
    """One instance, its port facade and JAX's, with a random heuristic and
    alpha 2, beta 0.5."""
    inst, _ = _batch(name, b=1)
    rng = np.random.default_rng(9)
    kw = dict(n_ants=A, alpha=2.0, beta=0.5)
    if name == "op":
        raw = lambda t: t[0].numpy()
        heu = (rng.random((20, 20)) + 0.1).astype(np.float32)
        args = (raw(inst["dist"]), raw(inst["prizes"]), 4.0)
        return (OPACO(*args, heuristic=heu, device="cpu", **kw),
                JOPACO(*args, heuristic=heu, **kw), inst)
    if name == "pctsp":
        heu = (rng.random((21, 21)) + 0.1).astype(np.float32)
        args = tuple(inst[k][0].numpy() for k in ("dist", "prizes", "penalties"))
        return (PCTSPACO(*args, heuristic=heu, device="cpu", **kw),
                JPCTSPACO(*args, heuristic=heu, **kw), inst)
    heu = (rng.random((31, 31)) + 0.1).astype(np.float32)
    args = tuple(inst[k][0].numpy() for k in ("processing", "due", "weights"))
    return (SMTWTPACO(*args, heuristic=heu, device="cpu", **kw),
            JSMTWTPACO(*args, heuristic=heu, **kw), inst)


@pytest.mark.parametrize("name", NAMES)
def test_facade_sample_replays_in_jax_and_run_improves(name):
    """The facades (OPACO, PCTSPACO, SMTWTPACO): ``sample``'s log-probabilities
    equal JAX's ``path_log_probs`` of its paths through JAX's facade spec
    (rtol 1e-5, atol 1e-5) and its costs JAX's cost (rtol 1e-6); ``run(1)``
    four times never gets worse, and the best path is valid and scores the
    best; under min_max and elitist, ported since, the best never gets
    worse either."""
    aco, jaco, inst = _facades(name)
    costs, log_probs, paths = aco.sample()
    ref = jengine.path_log_probs(jaco.spec_fn(jaco.state.phe.tau, jaco.data, jaco.cfg),
                                 jnp.asarray(paths.numpy(), jnp.int32), alpha=2.0, beta=0.5)
    np.testing.assert_allclose(log_probs.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jaco.cost_fn(
        jnp.asarray(paths.numpy(), jnp.int32), jaco.data)), rtol=1e-6)
    sign = -1.0 if aco.cfg.maximize else 1.0
    best = [sign * aco.run(1).item() for _ in range(4)]
    assert best == sorted(best, reverse=True)
    path = aco.best_path[None, :, None]
    assert bool(_valid(name, path, inst).all())
    np.testing.assert_allclose(aco.cost(path).item(), aco.lowest_cost.item(), rtol=1e-6)
    for flag in ("min_max", "elitist"):
        flagged = _facades_flag(name, inst, flag)
        best = [sign * flagged.run(1).item() for _ in range(3)]
        assert best == sorted(best, reverse=True)


def _facades_flag(name, inst, flag):
    raw = lambda k: inst[k][0].numpy()
    if name == "op":
        return OPACO(raw("dist"), raw("prizes"), 4.0, k_sparse=5, device="cpu", **{flag: True})
    if name == "pctsp":
        return PCTSPACO(raw("dist"), raw("prizes"), raw("penalties"), device="cpu",
                        **{flag: True})
    return SMTWTPACO(raw("processing"), raw("due"), raw("weights"), device="cpu", **{flag: True})
