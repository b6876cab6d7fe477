"""Port parity: CVRP-NLS (core/graph.py's blocks, core/builders.cvrp_nls_graph,
models/gnn.py over blocks, ls/hgs.py and its native engine,
utils/golden.cvrp_nls_test, utils/convert.parse_cvrplib,
aco/problems/cvrp_nls.py, train/special.py and the CLI) against the JAX
package, on inputs made from numpy seeds and the golden writer."""
import functools
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco.problems import cvrp_nls as jcvrp_nls
from deepaco_tpu.aco.engine import Rollout as JRollout
from deepaco_tpu.aco.engine import rollout as jrollout
from deepaco_tpu.aco.problems.cvrp import cvrp_spec as jcvrp_spec
from deepaco_tpu.core.builders import cvrp_nls_graph as jcvrp_nls_graph
from deepaco_tpu.ls import hgs as jhgs
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu.train import special as jspecial
from deepaco_tpu.train.reinforce import TrainState as JTrainState
from deepaco_tpu.utils import checkpoint as jcheckpoint
from deepaco_tpu.utils import convert as jconvert
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch import cli
from deepaco_tpu_torch.aco.problems.cvrp import route_cost, validate_routes
from deepaco_tpu_torch.aco.problems.cvrp_nls import CVRPNLSACO, perturbation_metric
from deepaco_tpu_torch.core.builders import cvrp_nls_graph
from deepaco_tpu_torch.ls import hgs
from deepaco_tpu_torch.models.gnn import (Net, from_jax_variables, init_like_flax, to_jax_tree,
                                          to_jax_variables)
from deepaco_tpu_torch.train import drivers, special
from deepaco_tpu_torch.train import reinforce as tr
from deepaco_tpu_torch.utils import convert, golden
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
CKPT100 = ROOT / "checkpoints" / "cvrp_nls100_selftrained.msgpack"
N, A, DEPTH = 20, 8, 3


def _set(n=N, count=4):
    return golden.cvrp_nls_test(n, count=count)


@functools.cache
def _jax_heu_fn():
    """JAX's test-protocol heuristic (cli.py:398-410) for the committed
    cvrp_nls100 weights, jitted once."""
    tree = load_checkpoint(str(CKPT100))
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    model = JNet()

    @jax.jit
    def fn(dist, demand):
        g = jcvrp_nls_graph(demand, dist, k=5)
        outs = model.apply(variables, g, train=False)
        heu = jnp.zeros((dist.shape[0],) * 2)
        for blk, h in zip(g[1], outs):
            heu = heu.at[jnp.broadcast_to(blk.src[:, None], blk.nbr.shape), blk.nbr].set(h)
        return outs, heu + 1e-10

    return fn


@pytest.mark.parametrize("n,count", [(20, 10), (100, 10), (500, 2)])
def test_golden_writer_is_bit_equal(n, count):
    ref, got = jgolden.cvrp_nls_test(n, count=count), golden.cvrp_nls_test(n, count=count)
    assert set(ref) == set(got)
    for key in ref:
        assert np.asarray(got[key]).dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert golden.cvrp_nls_capacity(n) == [v for k, v in sorted(
        jspecial.CVRP_NLS_CAPACITY.items()) if k <= n][-1]


def test_two_block_graph_is_exact():
    """Three golden instances at n=20 and 50: the self-loop is among each
    customer's 5 nearest (the 1e-10 diagonal); ids, attributes and sources
    equal JAX's exactly."""
    for n in (20, 50):
        ds = _set(n, 3)
        x, blocks = cvrp_nls_graph(torch.from_numpy(ds["demand"]),
                                   torch.from_numpy(ds["dist"]), 5)
        for i in range(3):
            jx, jblocks = jcvrp_nls_graph(jnp.asarray(ds["demand"][i]),
                                          jnp.asarray(ds["dist"][i]), 5)
            np.testing.assert_array_equal(x[i].numpy(), np.asarray(jx))
            for b, jb in zip(blocks, jblocks):
                np.testing.assert_array_equal(b.src.numpy(), np.asarray(jb.src))
                np.testing.assert_array_equal(b.nbr[i].numpy(), np.asarray(jb.nbr))
                np.testing.assert_array_equal(b.edge[i].numpy(), np.asarray(jb.edge))
            assert (blocks[0].nbr[i, :, 0] == torch.arange(1, n + 1)).all()


def test_block_heuristics_of_the_committed_checkpoint_match_jax():
    """cvrp_nls100_selftrained (12 layers, eval mode) on four golden n=20
    instances: each block's output and the dense heuristic at rtol 1e-5 /
    atol 1e-7, the zeros off the support exact."""
    ds = _set()
    net = Net.from_jax_variables(load_checkpoint(str(CKPT100)))
    dist, demand = torch.from_numpy(ds["dist"]), torch.from_numpy(ds["demand"])
    with torch.no_grad():
        outs = net(cvrp_nls_graph(demand, dist, 5))
        heu = special.cvrp_nls_heuristic(net, demand, dist, 5, 1e-10)
    for i in range(4):
        jouts, jheu = _jax_heu_fn()(jnp.asarray(ds["dist"][i]), jnp.asarray(ds["demand"][i]))
        for o, jo in zip(outs, jouts):
            np.testing.assert_allclose(o[i].numpy(), np.asarray(jo), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(heu[i].numpy(), np.asarray(jheu), rtol=1e-5, atol=1e-7)
        assert np.array_equal(heu[i].numpy() == np.float32(1e-10),
                              np.asarray(jheu) == np.float32(1e-10))


def test_block_net_in_train_mode_matches_jax():
    """A 2-layer net from the port's init in train mode on one golden n=20
    instance's two blocks: one edge BatchNorm over both blocks' edges (the
    node BatchNorm over the nodes), so each block's output at rtol 1e-5 /
    atol 1e-6 and the running statistics after the step at rtol 1e-5 /
    atol 1e-7 equal JAX's ``apply(train=True)``; so they do with a random
    mask on the customer block (its mean over the valid edges, its edges
    weighted by the mask in the shared BatchNorm, gnn.py:216-246)."""
    ds = _set(N, 1)
    net = init_like_flax(Net(feats=1, depth=2), torch.Generator().manual_seed(2)).train()
    variables = to_jax_variables(net)
    g = cvrp_nls_graph(torch.from_numpy(ds["demand"]), torch.from_numpy(ds["dist"]), 5)
    with torch.no_grad():
        outs = net(g)
    jg = jcvrp_nls_graph(jnp.asarray(ds["demand"][0]), jnp.asarray(ds["dist"][0]), k=5)
    jouts, upd = JNet(depth=2).apply(variables, jg, train=True, mutable=["batch_stats"])
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o[0].numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    stats = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(net)["batch_stats"]))
    for path, v in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        np.testing.assert_allclose(stats[path], np.asarray(v), rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    x, (a, b) = g
    mask = (np.random.default_rng(4).random(tuple(a.nbr.shape)) < 0.7).astype(np.float32)
    net.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        outs = net((x, (a._replace(mask=torch.from_numpy(mask)), b)))
    jx, (ja, jb) = jg
    jouts, upd = JNet(depth=2).apply(variables, (jx, (ja._replace(mask=jnp.asarray(mask[0])), jb)),
                                     train=True, mutable=["batch_stats"])
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o[0].numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    stats = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(net)["batch_stats"]))
    for path, v in jax.tree_util.tree_leaves_with_path(upd["batch_stats"]):
        np.testing.assert_allclose(stats[path], np.asarray(v), rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_parse_cvrplib_equals_jax(tmp_path):
    text = """NAME : tiny
COMMENT : written by the test
TYPE : CVRP
DIMENSION : 6
EDGE_WEIGHT_TYPE : EUC_2D
CAPACITY : 10
NODE_COORD_SECTION
1 5 5
2 1 9
3 9 8
4 2 2
5 8 1
6 5 9
DEMAND_SECTION
1 3
2 4
3 2
4 5
5 3
6 0
DEPOT_SECTION
6
-1
EOF
"""
    got, ref = convert.parse_cvrplib(text), jconvert.parse_cvrplib(text)
    assert got["capacity"] == ref["capacity"] == 10.0
    for key in ("coords", "demands"):
        assert got[key].dtype == ref[key].dtype == np.float64
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(got["coords"][0], [5, 9])       # the depot first


@functools.cache
def _paths_and_metric(n=50, ants=6):
    """Routes K7c's plain version samples on ``1/d`` at n=50, the f64
    instance and the f32 neural metric of a golden heuristic."""
    from deepaco_tpu_torch.aco.problems.cvrp import cvrp_paths
    from deepaco_tpu_torch.ops.cvrp_construct import cvrp_construct_plain
    from deepaco_tpu_torch.ops.pick import fused_pick_plain

    ds = _set(n, 1)
    dist, dem = torch.from_numpy(ds["dist"]), torch.from_numpy(ds["demand"])
    paths = cvrp_paths(torch.ones_like(dist), 1.0 / dist, dem, 1.0, ants,
                       torch.Generator().manual_seed(0), construct=cvrp_construct_plain,
                       pick=fused_pick_plain)[0].numpy()
    heu = (1.0 / ds["dist"][0]).astype(np.float32)
    return (paths, ds["demand"][0].astype(np.float64), ds["dist"][0].astype(np.float64),
            perturbation_metric(heu))


@pytest.mark.parametrize("fn", ["swapstar", "neural_swapstar", "multiple_swap_star"])
def test_native_engine_routes_equal_jax(fn):
    """Equal routes, matrices and move budgets give equal routes in both
    packages (the engine has no random state in local search)."""
    paths, dem, dist, metric = _paths_and_metric()
    if fn == "multiple_swap_star":
        for count in (10, 100000):
            ref = jhgs.multiple_swap_star(dem, dist, paths, count=count, heu_dist=metric)
            got = hgs.multiple_swap_star(dem, dist, paths, count=count, heu_dist=metric)
            np.testing.assert_array_equal(got, ref)
        return
    for a in range(paths.shape[1]):
        routes = hgs.path_to_routes(paths[:, a])
        assert all(np.array_equal(r, s) for r, s in zip(routes, jhgs.path_to_routes(paths[:, a])))
        if fn == "swapstar":
            ref, got = jhgs.swapstar(dem, dist, routes, 50), hgs.swapstar(dem, dist, routes, 50)
        else:
            ref = jhgs.neural_swapstar(dem, dist, metric, routes, 50)
            got = hgs.neural_swapstar(dem, dist, metric, routes, 50)
        assert len(got) == len(ref)
        assert all(np.array_equal(r, s) for r, s in zip(got, ref))
        np.testing.assert_array_equal(hgs.routes_to_path(got, len(paths)),
                                      jhgs.routes_to_path(ref, len(paths)))


def test_solve_cvrp_equals_jax_and_corrupt_routes_raise():
    paths, dem, dist, _ = _paths_and_metric()
    ref = jhgs.solve_cvrp(dem, dist, max_iters=30, no_improve_limit=10, seed=3)
    got = hgs.solve_cvrp(dem, dist, max_iters=30, no_improve_limit=10, seed=3)
    assert got[1] == ref[1]
    assert all(np.array_equal(r, s) for r, s in zip(got[0], ref[0]))
    routes = hgs.path_to_routes(paths[:, 0])
    with pytest.raises(hgs.NativeLSError, match="lost or duplicated"):
        hgs._validate_output(dem, 1.0, routes, routes[1:])
    with pytest.raises(hgs.NativeLSError, match="capacity"):
        hgs._validate_output(dem, 0.05, routes, routes)


def test_native_source_is_a_byte_identical_copy_and_builds_apart(tmp_path):
    """The port's cvrp_ls.cpp is JAX's, byte for byte; its library builds
    into the port's own build/ (or any path given), never into
    deepaco_tpu/ls/native/, whose files the port's build, load and calls
    leave as they were (JAX's own libcvrpls.so, which JAX's get_library may
    be building from another test process, is only required to be another
    file than the port's); and the library the port loaded is its own."""
    jax_dir = ROOT / "deepaco_tpu" / "ls" / "native"
    jax_lib = "libcvrpls.so"
    assert hgs.SOURCE.read_bytes() == (jax_dir / "cvrp_ls.cpp").read_bytes()
    assert hgs.LIB_PATH.parent == ROOT / "build" / "native"

    def snapshot():
        return {p.name: (p.stat().st_mtime_ns, p.stat().st_size) for p in jax_dir.iterdir()
                if p.name != jax_lib}

    before = snapshot()
    lib = hgs.build_library(tmp_path / "libcvrpls.so")
    assert lib.exists() and not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    assert hgs.build_library(lib).stat().st_mtime_ns == lib.stat().st_mtime_ns   # not stale
    paths, dem, dist, metric = _paths_and_metric()
    hgs.multiple_swap_star(dem, dist, paths, count=10, heu_dist=metric)
    assert snapshot() == before
    loaded = Path(hgs.get_library()._name).resolve()
    assert loaded == hgs.LIB_PATH.resolve() and loaded != (jax_dir / jax_lib).resolve()


def test_run_refines_exactly_the_8_cheapest_ants():
    """As tests/test_cvrp_nls.py:78 pins JAX's: each iteration hands the
    engine the 8 ants of lowest construction cost, as a set, and leaves the
    other ants' paths untouched; the best route is valid."""
    ds = _set(30, 1)
    aco = CVRPNLSACO(ds["dist"][0], ds["demand"][0], n_ants=12, seed=11, device="cpu")
    seen, costs = [], []
    orig_ls, orig_cost = aco._ls, aco.cost

    def spy_ls(paths, indexes=None, **kw):
        pre = paths.copy()
        out = orig_ls(paths, indexes=indexes, **kw)
        seen.append((pre, list(indexes), out.copy()))
        return out

    def spy_cost(paths):
        c = orig_cost(paths)
        costs.append(c[0].numpy().copy())
        return c

    aco._ls, aco.cost = spy_ls, spy_cost
    aco.run(3)
    assert len(seen) == 3
    for i, (pre, idx, out) in enumerate(seen):
        ref = torch.as_tensor(costs[2 * i]).topk(8, largest=False).indices
        assert set(idx) == {int(j) for j in ref}
        rest = [a for a in range(12) if a not in idx]
        np.testing.assert_array_equal(pre[:, rest], out[:, rest])
        assert not np.array_equal(pre[:, idx], out[:, idx])
    best = aco.best_path[:, None]
    assert bool(validate_routes(best, torch.from_numpy(ds["demand"][0]), 1.0)[0])


def test_one_train_step_on_replayed_paths_matches_jax_grad_fn():
    """A 3-layer net from the port's init, one golden n=20 instance, paths
    the port samples (K7c's plain version) and refines on the host: the
    port's gradient equals JAX's ``grad_fn``'s within 1e-3 of its largest
    entry, the weights after clip + AdamW (decay 1e-4) at rtol 1e-5, and
    the BatchNorms' running statistics stay where they were (eval mode on
    both sides)."""
    ds = _set(N, 1)
    dist, demand = torch.from_numpy(ds["dist"][:1]), torch.from_numpy(ds["demand"][:1])
    cfg = special.cvrp_nls_config(N, n_ants=A, k_sparse=5)
    net = init_like_flax(Net(feats=1, depth=DEPTH), torch.Generator().manual_seed(0))
    variables = to_jax_variables(net)
    state = tr.TrainState(net, tr.make_optimizer(net, cfg), 0, False)
    fns = special.make_cvrp_nls_train_fns(cfg, ops=drivers.PLAIN_OPS)
    _, paths, _ = fns[0](net, demand, dist, torch.Generator().manual_seed(5))
    improved = hgs.multiple_swap_star(ds["demand"][0].astype(np.float64),
                                      ds["dist"][0].astype(np.float64), paths[0].numpy(),
                                      count=N)
    ls = route_cost(dist, torch.from_numpy(improved)[None])
    adv = ls - ls.mean(dim=-1, keepdim=True)
    running = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}

    loss = special.cvrp_nls_loss(net, demand, dist, paths, adv, k_sparse=5, n_ants=A)
    loss.backward()
    grads = to_jax_tree({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                         for n, p in net.named_parameters()})["params"]
    state, _ = tr.optimizer_update(state, cfg)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in running.items())

    model = JNet(depth=DEPTH)
    jdemand, jdist = jnp.asarray(ds["demand"][0]), jnp.asarray(ds["dist"][0])
    jpaths, jadv = jnp.asarray(paths[0].numpy(), jnp.int32), jnp.asarray(adv[0].numpy())

    def step(tx):
        _, grad_fn = jspecial.make_cvrp_nls_train_fns(model, tx, k_sparse=5, n_ants=A)
        js = JTrainState(variables["params"], variables["batch_stats"],
                         tx.init(variables["params"]), jnp.zeros((), jnp.int32))
        return grad_fn(js, jdemand, jdist, jpaths, jadv)

    # an identity optimizer makes JAX's update its gradient
    moved = step(optax.identity()).params
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), moved,
                                    variables["params"])
    scale = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(jgrads))
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(flat[path], g, rtol=0, atol=1e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    jnew = step(optax.chain(optax.clip_by_global_norm(3.0), optax.adamw(cfg.train.lr)))
    after = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(net)["params"]))
    for path, w in jax.tree_util.tree_leaves_with_path(jnew.params):
        np.testing.assert_allclose(after[path], np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
        jnew.batch_stats, variables["batch_stats"]))


def test_trainer_instance_stream_equals_jax(monkeypatch):
    """Both trainers draw one template instance and drop it, then one
    instance a step from default_rng(seed): equal arrays, step for step."""
    seen = {"jax": [], "port": []}

    def jax_step(state, sample_fn, grad_fn, demand, dist, rng, **kw):
        seen["jax"].append((np.asarray(demand), np.asarray(dist)))
        return state, 0.0, 0.0

    def port_step(state, fns, demand, dist, generator, **kw):
        seen["port"].append((demand[0].numpy(), dist[0].numpy()))
        zero = torch.zeros(())
        return state, zero, zero

    monkeypatch.setattr(jspecial, "cvrp_nls_train_step", jax_step)
    monkeypatch.setattr(special, "cvrp_nls_train_step", port_step)
    jspecial.train_cvrp_nls(12, epochs=2, steps_per_epoch=2, seed=7)
    special.train_cvrp_nls(12, epochs=2, steps_per_epoch=2, seed=7, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 4
    for (jd, jm), (pd, pm) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pm, jm)


def test_checkpoints_cross_read(tmp_path, capsys, monkeypatch):
    """The port's train cvrp --local-search swapstar (1 step, n=12) writes a
    file that JAX's _cmd_test_cvrp_ls template reads (cli.py:374-387) with
    the same weights, and that the port's test reads back; the port's test
    reads the committed, JAX-written cvrp_nls100 checkpoint."""
    monkeypatch.chdir(ROOT)
    out = tmp_path / "nls.msgpack"
    state = cli.main(["train", "cvrp", "--local-search", "swapstar", "-n", "12", "-e", "1",
                      "-s", "1", "-a", "4", "-o", str(out)], device="cpu")
    assert state.step == 1
    from deepaco_tpu.train.reinforce import TrainState

    g0 = jcvrp_nls_graph(jnp.ones(13), jnp.ones((13, 13)), k=5)
    v0 = JNet().init(jax.random.PRNGKey(0), g0, train=False)
    tx = optax.chain(optax.clip_by_global_norm(3.0), optax.adamw(1e-4))
    template = TrainState(params=v0["params"], batch_stats=v0["batch_stats"],
                          opt_state=tx.init(v0["params"]), step=jnp.zeros((), jnp.int32))
    restored = jcheckpoint.load_checkpoint(str(out), template)
    mine = to_jax_variables(state.net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(restored.params),
                                 jax.tree_util.tree_leaves_with_path(mine["params"])):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    assert int(restored.step) == 1
    for ckpt in (str(out), str(CKPT100)):
        means, curves = cli.main(["test", "cvrp", "--local-search", "swapstar", "-n", "20",
                                  "--limit", "2", "-a", "4", "-t", "1", "--ckpt", ckpt],
                                 device="cpu")
        assert curves.shape == (2, 1) and np.isfinite(means).all()


@functools.cache
def _jax_protocol(seed: int, b: int, ts: tuple):
    """JAX's _cmd_test_cvrp_ls loop (cli.py:411-430) on the first ``b``
    golden n=20 instances with the cvrp_nls100 weights: its CVRPNLSACO, with
    each iteration's construction jitted once for the shape (JAX's facade
    traces a new scan every iteration, minutes on the CPU)."""
    ds = _set(N, b)

    @functools.partial(jax.jit, static_argnums=(3,))
    def construct(tau, heu, demand, n_ants, key):
        return jrollout(jcvrp_spec(tau, heu, demand, 1.0, n_ants), key,
                        require_prob=False).paths

    curves = []
    for i in range(b):
        dist, demand = jnp.asarray(ds["dist"][i]), jnp.asarray(ds["demand"][i])
        heu = _jax_heu_fn()(dist, demand)[1]
        aco = jcvrp_nls.CVRPNLSACO(dist, demand, capacity=1.0, n_ants=20, heuristic=heu,
                                   seed=seed + i)
        aco._spec_factory = lambda tau: tau
        fast = lambda tau, key, **kw: JRollout(construct(tau, heu, demand, 20, key), None, None)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcvrp_nls, "rollout", fast)
            curve, done = [], 0
            for t in ts:
                aco.run(t - done)
                done = t
                curve.append(float(aco.lowest_cost))
        curves.append(curve)
    return np.asarray(curves)


def test_cli_costs_match_jax_in_law(capsys, monkeypatch):
    """test cvrp --local-search swapstar at n=20 (the committed cvrp_nls100
    weights, 10 golden instances, 20 ants, T=1 and 10, seeds 0 and 100 on
    each side): the means over both seeds agree within 2% (the sampling
    streams differ; the engine is the same), every best route is valid and
    each curve falls."""
    monkeypatch.chdir(ROOT)
    ts, b = (1, 10), 10
    got, ref = [], []
    for seed in (0, 100):
        stats = {}
        args = cli.build_parser().parse_args(
            ["test", "cvrp", "--local-search", "swapstar", "-n", str(N), "--limit", str(b),
             "-t", *map(str, ts), "--seed", str(seed)])
        _, curves = cli._cmd_test_cvrp_ls(args, device="cpu", stats=stats)
        assert bool((curves[:, 1:] <= curves[:, :-1]).all())
        ds = _set(N, b)
        for i in range(b):
            assert bool(validate_routes(stats["best"][i][:, None],
                                        torch.from_numpy(ds["demand"][i]), 1.0)[0])
        got.append(curves.numpy())
        ref.append(_jax_protocol(seed, b, ts))
    np.testing.assert_allclose(np.concatenate(got).mean(0), np.concatenate(ref).mean(0),
                               rtol=0.02)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-4].startswith("total duration:") and lines[-2].startswith("T=10, average")
