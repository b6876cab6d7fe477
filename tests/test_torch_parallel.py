"""The port's multi-device paths (``deepaco_tpu_torch/parallel/``) on the CPU.

The port runs in two gloo worker processes a mesh (2 x 1 and 1 x 2, all four
started together), meeting through a ``file://`` store, so no port number
can race; the inputs are made here from numpy seeds and written to a
temporary directory. The JAX package's ``parallel/`` runs in this process on
the virtual CPU devices ``tests/conftest.py`` sets up. Tolerances:

- the sharded forward against JAX's ``sharded_embnet_forward``: rtol 2e-3 /
  atol 2e-5 in eval mode and rtol 2e-4 / atol 2e-5 in train mode (JAX's own
  tests between its sharded and single-device forward);
- the sharded train step against the port's unsharded step on the same
  instances and replayed tours: loss, gradients (atol 1e-5 of the whole
  gradient's largest entry), running statistics and gradient norm within rtol 1e-5;
  the weights bit-equal across ranks;
- its running statistics against JAX's sharded step on the same instances:
  rtol 1e-4 / atol 1e-5 (12 layers of BatchNorm in two frameworks);
- ``evaluate_family(mesh=)`` and the island search without migration:
  equal bits to their blocks and colonies run alone.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


FWD_N, FWD_K = 64, 8
STEP = dict(n_nodes=12, k_sparse=6, n_ants=8, batch=4)
FAMILY = dict(n=16, b=8, k_sparse=6, n_ants=6, t_values=(1, 4), seed=3)
ISLAND = dict(n=14, n_ants=6, n_rounds=3, sync_every=2, seed=9)

WORKER = textwrap.dedent(r"""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(2)

    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.models.gnn import EmbNet, Net
    from deepaco_tpu_torch.parallel import (make_mesh, make_sharded_tsp_train_step,
                                            shard_colony_search, sharded_embnet_forward)
    from deepaco_tpu_torch.parallel.mesh import multi_colony_tsp_search
    from deepaco_tpu_torch.parallel.multihost import (all_processes_mean, host_local_batch,
                                                      hybrid_mesh, init_distributed)
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
    from deepaco_tpu_torch.train.drivers import evaluate_family, family_model
    from deepaco_tpu_torch.train.reinforce import make_optimizer, TrainState

    mode, rank, data = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    inp = np.load(os.path.join(data, "inputs.npz"))
    out = {}
    if mode == "instance":
        # the DEEPACO_* variables the parent set
        init_distributed(device="cpu")
        mesh = hybrid_mesh()
    else:
        init_distributed(f"file://{data}/store_ant", 2, rank, device="cpu")
        mesh = make_mesh(1, 2)
    out["mesh"] = np.array(mesh.shape)

    def step_net():
        net = Net()
        net.load_state_dict(torch.load(os.path.join(data, "step_net.pt")))
        cfg = ProblemConfig(n_nodes=int(inp["step_n"]), k_sparse=int(inp["step_k"]),
                            aco=ACOSettings(n_ants=int(inp["step_a"])),
                            train=TrainConfig(epochs=1, steps_per_epoch=1,
                                              batch_size=int(inp["step_b"])))
        return net, cfg

    # (b, c): one step on replayed tours, this rank's instances and ants
    net, cfg = step_net()
    state = TrainState(net, make_optimizer(net, cfg), 0, cfg.train.cosine_schedule)
    grads = {}
    state.optimizer.register_step_pre_hook(lambda opt, *_: grads.update(
        {n: p.grad.clone() for n, p in net.named_parameters()}))
    i, a = mesh.get_coordinate()
    n_i, n_a = mesh.shape
    b, ants = int(inp["step_b"]) // n_i, int(inp["step_a"]) // n_a
    coords = inp["step_coords"][i * b:(i + 1) * b]
    paths = torch.as_tensor(inp["step_paths"][i * b:(i + 1) * b, :, a * ants:(a + 1) * ants])
    step = make_sharded_tsp_train_step(net, cfg, mesh)
    state, info = step(state, coords, torch.Generator().manual_seed(rank), paths=paths)
    out.update(loss=info.loss.numpy(), mean_cost=info.mean_cost.numpy(),
               norm=info.grad_norm.numpy())
    out.update({"grad." + n: g.numpy() for n, g in grads.items()})
    out.update({"state." + n: t.numpy() for n, t in net.state_dict().items()})

    if mode == "instance":
        # (a) the row-sharded forward, eval and train mode
        emb = EmbNet()
        emb.load_state_dict(torch.load(os.path.join(data, "emb_net.pt")))
        before = {k: v.clone() for k, v in emb.state_dict().items()}
        for train in (False, True):
            out[f"fwd_{train}"] = sharded_embnet_forward(
                emb, inp["fwd_x"], inp["fwd_nbr"], inp["fwd_edge"], mesh,
                train=train).numpy()
        out["fwd_stats_kept"] = np.array(all(torch.equal(v, emb.state_dict()[k])
                                             for k, v in before.items()))
        # (d) evaluate_family over the instance axis
        tnet = family_model(get_family("tsp"))
        tnet.load_state_dict(torch.load(os.path.join(data, "tsp_net.pt")))
        means, curves = evaluate_family(
            "tsp", {"coords": inp["family_coords"], "dist": inp["family_dist"]}, n_nodes=int(inp["family_n"]),
            net=tnet, k_sparse=int(inp["family_k"]), n_ants=int(inp["family_a"]),
            t_values=tuple(int(t) for t in inp["family_t"]), seed=int(inp["family_seed"]),
            device="cpu", mesh=mesh)
        out.update(family_means=means.numpy(), family_curves=curves.numpy())
        # (e) the island search, migration and blend off, then on
        cfg_i = ACOConfig(n_ants=int(inp["island_a"]))
        for key, w, bl in (("off", 0.0, 0.0), ("on", 1.0, 0.25)):
            out["island_" + key] = multi_colony_tsp_search(
                mesh, inp["island_heu"], inp["island_dist"], cfg_i,
                int(inp["island_seed"]), n_rounds=int(inp["island_rounds"]),
                sync_every=int(inp["island_sync"]), migrate_weight=w, blend=bl,
                device="cpu").numpy()
        shards = shard_colony_search(mesh)
        out["colony_rows"] = np.array([shards["instances"].rows(8).start,
                                       shards["instances"].rows(8).stop])
        # (g) each rank feeds its half of the instances; one sampled step
        net, cfg = step_net()
        state = TrainState(net, make_optimizer(net, cfg), 0, cfg.train.cosine_schedule)
        local = host_local_batch(mesh, {"coords": inp["step_coords"][i * b:(i + 1) * b]})
        step = make_sharded_tsp_train_step(net, cfg, mesh)
        state, info = step(state, local["coords"], torch.Generator().manual_seed(7 + rank))
        out["host_mean"] = np.array(all_processes_mean(info.mean_cost))
        out.update({"host_state." + n: t.numpy() for n, t in net.state_dict().items()})
        try:
            host_local_batch(mesh, {"coords": inp["step_coords"][:1 + rank]})
        except ValueError:
            out["host_refused_uneven"] = np.array(True)
    np.savez(os.path.join(data, f"out_{mode}_{rank}.npz"), **out)
    print("done", mode, rank, flush=True)
""")


def _jax_setup():
    """The JAX side's networks and inputs, from fixed seeds."""
    import jax
    import jax.numpy as jnp

    from deepaco_tpu.core.graph import knn_graph
    from deepaco_tpu.models.gnn import EmbNet as JaxEmbNet
    from deepaco_tpu.models.gnn import Net as JaxNet
    from deepaco_tpu.train.config import ACOSettings, ProblemConfig, TrainConfig
    from deepaco_tpu.train.reinforce import init_train_state
    from deepaco_tpu.utils.datasets import distance_matrix, uniform_coords

    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.random((FWD_N, 2)), jnp.float32)
    g = knn_graph(coords, distance_matrix(coords), FWD_K)
    emb_vars = jax.device_get(JaxEmbNet().init(jax.random.PRNGKey(0), g, train=False))
    # running statistics away from (0, 1), so that eval mode reads them
    emb_vars = {"params": emb_vars["params"], "batch_stats": jax.tree_util.tree_map(
        lambda s: np.asarray(s), emb_vars["batch_stats"])}
    for st in emb_vars["batch_stats"].values():
        st["mean"] = rng.normal(0.0, 0.1, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)

    cfg = ProblemConfig(n_nodes=STEP["n_nodes"], k_sparse=STEP["k_sparse"],
                        aco=ACOSettings(n_ants=STEP["n_ants"]),
                        train=TrainConfig(epochs=1, steps_per_epoch=1,
                                          batch_size=STEP["batch"]))
    model = JaxNet()
    state = init_train_state(model, cfg, jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.PRNGKey(1), STEP["batch"])
    step_coords = np.stack([np.asarray(uniform_coords(jax.random.split(k)[0], cfg.n_nodes))
                            for k in keys])
    return {"g": g, "emb_vars": emb_vars, "cfg": cfg, "model": model, "state": state,
            "keys": keys, "step_coords": step_coords}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Writes the inputs, starts the four workers, runs the JAX references
    meanwhile, and returns them with the workers' outputs by ``(mode,
    rank)``."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.models.gnn import EmbNet, Net, from_jax_variables, init_like_flax
    from deepaco_tpu_torch.train.drivers import family_model, gen_batch
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    data = tmp_path_factory.mktemp("parallel")
    jx = _jax_setup()
    emb_sd = from_jax_variables({"params": {"emb_net": jx["emb_vars"]["params"]},
                                 "batch_stats": {"emb_net": jx["emb_vars"]["batch_stats"]}})
    emb = EmbNet()
    emb.load_state_dict({k.removeprefix("emb_net."): v for k, v in emb_sd.items()})
    torch.save(emb.state_dict(), data / "emb_net.pt")
    import jax

    net = Net.from_jax_variables(jax.device_get({"params": jx["state"].params,
                                                 "batch_stats": jx["state"].batch_stats}))
    torch.save(net.state_dict(), data / "step_net.pt")
    rng = np.random.default_rng(1)
    n, b, a = STEP["n_nodes"], STEP["batch"], STEP["n_ants"]
    step_paths = np.stack([np.stack([rng.permutation(n) for _ in range(a)], axis=1)
                           for _ in range(b)])
    tnet = family_model(get_family("tsp"))
    init_like_flax(tnet, torch.Generator().manual_seed(4))
    torch.save(tnet.state_dict(), data / "tsp_net.pt")
    fam = FAMILY
    family = gen_batch(get_family("tsp"), np.random.default_rng(0), fam["n"], fam["b"])
    island_coords = torch.as_tensor(np.random.default_rng(5).random((ISLAND["n"], 2)),
                                    dtype=torch.float32)
    island_dist = distance_matrix(island_coords).numpy()
    g = jx["g"]
    np.savez(data / "inputs.npz", fwd_x=np.asarray(g.x), fwd_nbr=np.asarray(g.nbr),
             fwd_edge=np.asarray(g.edge), step_n=n, step_k=STEP["k_sparse"], step_a=a,
             step_b=b, step_coords=jx["step_coords"], step_paths=step_paths,
             family_coords=family["coords"], family_dist=family["dist"], family_n=fam["n"], family_k=fam["k_sparse"],
             family_a=fam["n_ants"], family_t=np.array(fam["t_values"]),
             family_seed=fam["seed"], island_heu=1.0 / island_dist,
             island_dist=island_dist, island_a=ISLAND["n_ants"], island_seed=ISLAND["seed"],
             island_rounds=ISLAND["n_rounds"], island_sync=ISLAND["sync_every"])
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2",
           "DEEPACO_COORDINATOR": f"file://{data}/store_instance",
           "DEEPACO_NUM_PROCESSES": "2"}
    procs = {(mode, r): subprocess.Popen(
        [sys.executable, "-c", WORKER, mode, str(r), str(data)], cwd=ROOT,
        env={**env, "DEEPACO_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for mode in ("instance", "ant") for r in range(2)}
    # JAX's references while the workers run
    jx["fwd"] = {train: _jax_sharded_forward(jx, train) for train in (False, True)}
    jx["step_stats"] = _jax_sharded_step_stats(jx)
    logs = {key: p.communicate(timeout=300)[0] for key, p in procs.items()}
    failed = [f"{key}:\n{logs[key]}" for key, p in procs.items() if p.returncode != 0]
    if failed:
        pytest.fail("\n".join(failed), pytrace=False)
    outs = {key: dict(np.load(data / f"out_{key[0]}_{key[1]}.npz")) for key in procs}
    return {**jx, "outs": outs, "step_paths": step_paths, "family": family,
            "island_dist": island_dist, "data": data}


def _jax_sharded_forward(jx, train):
    import functools

    import jax
    from jax.sharding import Mesh

    from deepaco_tpu.parallel.gnn_shard import sharded_embnet_forward

    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("instance",))
    g, v = jx["g"], jx["emb_vars"]
    fn = jax.jit(functools.partial(sharded_embnet_forward, mesh=mesh, train=train))
    return np.asarray(fn(v["params"], v["batch_stats"], g.x, g.nbr, g.edge))


@pytest.mark.parametrize("train,rtol", [(False, 2e-3), (True, 2e-4)])
def test_sharded_forward_matches_jax(setup, train, rtol):
    """(a) 2 ranks against JAX's ``sharded_embnet_forward`` on a 2-device
    mesh, the same arrays and weights; both ranks hold the whole result and
    the running statistics are untouched."""
    want = setup["fwd"][train]
    for r in range(2):
        got = setup["outs"][("instance", r)]
        assert got[f"fwd_{train}"].shape == (FWD_N, FWD_K, 32)
        np.testing.assert_allclose(got[f"fwd_{train}"], want, rtol=rtol, atol=2e-5)
        assert bool(got["fwd_stats_kept"])


def _unsharded_step(setup):
    """The port's unsharded step on all instances and replayed tours:
    ``tsp_loss`` + backward + ``optimizer_update``, as ``make_tsp_train_step``
    runs it."""
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
    from deepaco_tpu_torch.train.reinforce import (TrainState, make_optimizer,
                                                   optimizer_update, tsp_loss)

    net = Net()
    net.load_state_dict(torch.load(setup["data"] / "step_net.pt"))
    cfg = ProblemConfig(n_nodes=STEP["n_nodes"], k_sparse=STEP["k_sparse"],
                        aco=ACOSettings(n_ants=STEP["n_ants"]),
                        train=TrainConfig(epochs=1, steps_per_epoch=1,
                                          batch_size=STEP["batch"]))
    state = TrainState(net, make_optimizer(net, cfg), 0, cfg.train.cosine_schedule)
    grads = {}
    state.optimizer.register_step_pre_hook(lambda opt, *_: grads.update(
        {n: p.grad.clone() for n, p in net.named_parameters()}))
    out = tsp_loss(net, torch.as_tensor(setup["step_coords"]), cfg, torch.Generator(),
                   paths=torch.as_tensor(setup["step_paths"]))
    out.loss.backward()
    state, norm = optimizer_update(state, cfg)
    return {"loss": out.loss.item(), "mean_cost": out.mean_cost.item(), "norm": norm.item(),
            "grads": grads, "stats": dict(net.named_buffers())}


@pytest.fixture(scope="module")
def unsharded(setup):
    return _unsharded_step(setup)


@pytest.mark.parametrize("mode", ["instance", "ant"])
def test_sharded_step_matches_unsharded_step(setup, unsharded, mode):
    """(b) meshes 2 x 1 and 1 x 2 against the unsharded step on the same
    instances and tours: loss, mean cost, gradient norm, every gradient
    (atol 1e-5 of the largest entry of the whole gradient: the biases ahead
    of a BatchNorm have a zero gradient, which both steps round to noise of
    1e-8) and the running statistics."""
    scale = max(float(g.abs().max()) for g in unsharded["grads"].values())
    for r in range(2):
        got = setup["outs"][(mode, r)]
        for key in ("loss", "mean_cost", "norm"):
            np.testing.assert_allclose(float(got[key]), unsharded[key], rtol=1e-5)
        for name, g in unsharded["grads"].items():
            np.testing.assert_allclose(got["grad." + name], g.numpy(), rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)
        for name, s in unsharded["stats"].items():
            np.testing.assert_allclose(got["state." + name], s.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=name)


@pytest.mark.parametrize("mode", ["instance", "ant"])
def test_sharded_step_keeps_the_weights_equal_across_ranks(setup, mode):
    """(b) after the step every rank holds the same weights and statistics,
    bit for bit, and the mesh has the asked shape."""
    a, b = setup["outs"][(mode, 0)], setup["outs"][(mode, 1)]
    assert list(a["mesh"]) == ([2, 1] if mode == "instance" else [1, 2])
    keys = [k for k in a if k.startswith("state.")]
    assert keys
    for k in keys:
        assert np.array_equal(a[k], b[k]), k


def _jax_sharded_step_stats(jx):
    """The running statistics after one step of JAX's
    ``make_sharded_tsp_train_step`` on a 4 x 2 mesh."""
    import jax

    from deepaco_tpu.parallel.mesh import make_mesh, make_sharded_tsp_train_step

    mesh = make_mesh(n_instance=4, n_ant=2)
    with mesh:
        step = make_sharded_tsp_train_step(jx["model"], jx["cfg"], mesh)
        new_state, _ = step(jx["state"], jx["keys"])
    return jax.device_get(new_state.batch_stats)["emb_net"]


def test_sharded_step_statistics_match_jax_sharded_step(setup):
    """(c) the running statistics after one step against JAX's
    ``make_sharded_tsp_train_step`` on a 4 x 2 mesh: the port gets JAX's
    instances (``uniform_coords`` of the same keys) as numpy arrays; the
    statistics do not depend on the sampled tours."""
    stats = setup["step_stats"]
    got = setup["outs"][("instance", 0)]
    checked = 0
    for name, st in stats.items():
        base, _, idx = name.rpartition("_")
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(got[f"state.emb_net.{base}.{idx}.{key}"],
                                       np.asarray(st[leaf]), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            checked += 1
    assert checked == 2 * 2 * 12


def test_evaluate_family_over_a_mesh_equals_its_blocks_run_alone(setup):
    """(d) ``evaluate_family("tsp", mesh=)`` on 2 ranks: every rank returns
    the curves of the two blocks run alone with ``block_seed``,
    concatenated, bit for bit."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.parallel._axes import block_seed
    from deepaco_tpu_torch.train.drivers import evaluate_family, family_model

    fam = FAMILY
    net = family_model(get_family("tsp"))
    net.load_state_dict(torch.load(setup["data"] / "tsp_net.pt"))
    half = fam["b"] // 2
    blocks = [evaluate_family("tsp", {k: v[i * half:(i + 1) * half]
                                      for k, v in setup["family"].items()},
                              n_nodes=fam["n"], net=net, k_sparse=fam["k_sparse"],
                              n_ants=fam["n_ants"], t_values=fam["t_values"],
                              seed=block_seed(fam["seed"], i), device="cpu")[1]
              for i in range(2)]
    want = torch.cat(blocks).numpy()
    assert block_seed(fam["seed"], 0) == fam["seed"]
    for r in range(2):
        got = setup["outs"][("instance", r)]
        assert got["family_curves"].shape == (fam["b"], max(fam["t_values"]))
        assert np.array_equal(got["family_curves"], want)
        idx = [t - 1 for t in fam["t_values"]]
        np.testing.assert_allclose(got["family_means"], want[:, idx].mean(0), rtol=1e-6)


def test_island_search_without_migration_equals_its_colonies_run_alone(setup):
    """(e) with ``migrate_weight=0, blend=0`` the curve is, round by round,
    the best of the two colonies run alone with ``colony_seed``."""
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost, tsp_spec
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.runner import ACOConfig, init_search, run_anytime
    from deepaco_tpu_torch.parallel.mesh import colony_seed

    isl = ISLAND
    dist = torch.as_tensor(setup["island_dist"])[None]
    heu = 1.0 / dist
    cfg = ACOConfig(n_ants=isl["n_ants"])
    curves = []
    for c in range(2):
        gen = torch.Generator().manual_seed(colony_seed(isl["seed"], c))
        state = init_search(isl["n"], isl["n"] - 1, cfg, batch=(1,))
        _, curve = run_anytime(
            lambda tau, g: rollout(tsp_spec(tau, heu, cfg.n_ants, None, cfg.alpha, cfg.beta),
                                   g).paths,
            lambda p: tour_cost(dist, p), cfg, state, gen, isl["n_rounds"] * isl["sync_every"])
        curves.append(curve[0])
    ends = [(r + 1) * isl["sync_every"] - 1 for r in range(isl["n_rounds"])]
    want = torch.stack(curves).min(dim=0).values[ends].numpy()
    for r in range(2):
        assert np.array_equal(setup["outs"][("instance", r)]["island_off"], want)


def test_island_search_with_migration_and_blend_is_monotone(setup):
    """(e) with migration and blend on, every rank returns the same curve
    of ``n_rounds`` finite costs, never rising."""
    a, b = (setup["outs"][("instance", r)]["island_on"] for r in range(2))
    assert a.shape == (ISLAND["n_rounds"],)
    assert np.array_equal(a, b)
    assert np.all(np.isfinite(a)) and np.all(np.diff(a) <= 0)


@pytest.mark.parametrize("weight,blend,min_max", [
    (1.0, 0.0, False), (1.0, 0.25, False), (0.0, 0.5, False), (2.0, 0.25, True)])
def test_migration_matches_jax_operations(weight, blend, min_max):
    """(f) ``migrate`` on four colonies' pheromones against JAX's
    ``pheromone.deposit`` of the global best, the blend with the colonies'
    mean and ``min_max_clamp``, colony by colony; the global best is the
    first of two tied minima. rtol 1e-6 (sums of two or three terms)."""
    import jax.numpy as jnp

    from deepaco_tpu.aco import pheromone as jph
    from deepaco_tpu_torch.aco import pheromone as ph
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.parallel.mesh import migrate

    rng = np.random.default_rng(3)
    c, n = 4, 10
    tau = rng.uniform(0.1, 2.0, (c, n, n)).astype(np.float32)
    tau_max = np.array([1.5, -1.0, 0.8, 1.2], np.float32)
    costs = np.array([5.0, 3.5, 4.0, 3.5], np.float32)
    paths = np.stack([rng.permutation(n) for _ in range(c)])
    cfg = ACOConfig(min_max=min_max, tau_min=0.2)
    phe, gcost, gpath = migrate(ph.PheromoneState(torch.as_tensor(tau), torch.as_tensor(tau_max)),
                                torch.as_tensor(costs), torch.as_tensor(paths), cfg, weight, blend,
                                lambda t: t.mean(dim=0, keepdim=True))
    assert float(gcost) == 3.5 and np.array_equal(gpath.numpy(), paths[1])
    taus = []
    for i in range(c):
        t = jnp.asarray(tau[i])
        if weight > 0:
            t = jph.deposit(t, jnp.asarray(paths[1])[:, None], jnp.atleast_1d(weight / 3.5))
        taus.append(t)
    mean = jnp.mean(jnp.stack(taus), axis=0)
    for i in range(c):
        t = (1.0 - blend) * taus[i] + blend * mean if blend > 0 else taus[i]
        state = jph.PheromoneState(t, jnp.asarray(tau_max[i]))
        if min_max:
            state = jph.min_max_clamp(state, cfg.tau_min)
        np.testing.assert_allclose(phe.tau[i].numpy(), np.asarray(state.tau), rtol=1e-6)


def test_multihost_runtime_two_processes(setup):
    """(g) ``init_distributed`` from the ``DEEPACO_*`` variables,
    ``hybrid_mesh`` (2 x 1: the instance axis spans the processes),
    ``host_local_batch`` with each rank's half of 4 instances (a block of
    another size refused), one sampled step, ``all_processes_mean`` equal on
    both ranks, the weights bit-equal across ranks and moved by the step."""
    a, b = setup["outs"][("instance", 0)], setup["outs"][("instance", 1)]
    assert list(a["mesh"]) == [2, 1]
    assert float(a["host_mean"]) == float(b["host_mean"])
    assert np.isfinite(float(a["host_mean"]))
    keys = [k for k in a if k.startswith("host_state.")]
    for k in keys:
        assert np.array_equal(a[k], b[k]), k
    start = torch.load(setup["data"] / "step_net.pt")
    assert not np.array_equal(a["host_state.emb_net.v_lin0.weight"],
                              start["emb_net.v_lin0.weight"].numpy())
    assert bool(a["host_refused_uneven"]) and bool(b["host_refused_uneven"])
    assert list(a["colony_rows"]) == [0, 4] and list(b["colony_rows"]) == [4, 8]


def test_instance_blocks_split_a_batch_and_refuse_an_uneven_one():
    """A rank's rows are its contiguous block (``P("instance")``'s layout);
    a batch the axis does not divide is refused; block 0's seed is the seed
    itself and the other blocks' differ from it and from each other."""
    from deepaco_tpu_torch.parallel._axes import InstanceBlock, block_seed
    from deepaco_tpu_torch.parallel.mesh import colony_seed

    assert [InstanceBlock(i, 4).rows(8) for i in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split"):
        InstanceBlock(0, 3).rows(8)
    assert block_seed(7, 0) == 7 and colony_seed(7, 0) == 7
    seeds = {block_seed(7, i) for i in range(64)} | {block_seed(8, i) for i in range(64)}
    assert len(seeds) == 128 and all(0 <= s < 2**63 for s in seeds)


def test_make_mesh_without_a_group_raises():
    """(h) no process group, no mesh: ``make_mesh`` never builds a group of
    its own."""
    import torch.distributed as dist

    from deepaco_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1)
    assert not dist.is_initialized()


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    """(h) the new entry points run on ``cuda`` unless ``device="cpu"`` is
    passed; without a card they raise and start nothing."""
    import torch.distributed as dist

    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.parallel.mesh import multi_colony_tsp_search
    from deepaco_tpu_torch.parallel.multihost import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("DEEPACO_COORDINATOR", "DEEPACO_NUM_PROCESSES", "DEEPACO_PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed(num_processes=1)
    assert not dist.is_initialized()
    assert init_distributed() is None               # no configuration: one process
    heu = torch.ones(5, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        multi_colony_tsp_search(None, heu, heu, ACOConfig(), 0, n_rounds=1, sync_every=1)


@pytest.mark.parametrize("b,r0,r", [(1, 0, 64), (2, 16, 16), (3, 56, 8)])
def test_row_shard_layer_on_the_cpu_is_the_full_layers_rows(b, r0, r):
    """The K6 row-shard entry on CPU tensors runs the plain layer on the
    shard: its ``agg`` and ``pre`` are the rows ``[r0, r0 + r)`` of the
    whole layer's (within 1e-6: the same products on fewer rows)."""
    from deepaco_tpu_torch.ops import gnn_layer

    n, k, u = 64, 8, 32
    g = torch.Generator().manual_seed(b * 100 + r)
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    x2, x3, x4 = rnd(b, n, u), rnd(b, n, u), rnd(b, n, u)
    nbr = torch.randint(0, n, (b, n, k), generator=g)
    w, ew, eb = rnd(b, n, k, u), rnd(u, u) * 0.1, rnd(u) * 0.1
    agg, pre = gnn_layer.fused_gnn_layer_plain(x2, x3, x4, nbr, w, ew, eb)
    rows = slice(r0, r0 + r)
    before = gnn_layer.fused_gnn_layer_rows.launches
    got_agg, got_pre = gnn_layer.fused_gnn_layer_rows(x2, x3[:, rows], x4, nbr[:, rows],
                                                      w[:, rows], ew, eb)
    assert gnn_layer.fused_gnn_layer_rows.launches == before      # no kernel on the CPU
    torch.testing.assert_close(got_agg, agg[:, rows], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_pre, pre[:, rows], rtol=1e-6, atol=1e-6)


STUB_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
sleep 0.5
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


def test_concurrent_first_builds_run_the_compiler_once(tmp_path, monkeypatch):
    """Two callers that find no library at once compile each source once and
    link once: the second waits on the lock file and finds the library
    built (``nvcc`` is a stub that logs its calls and writes its output)."""
    import threading

    from deepaco_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text("// source\n")
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC.format(log=log))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "LIB_PATH", build_dir / "libdeepaco_kernels.so")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    barrier = threading.Barrier(2)
    results = []

    def caller():
        barrier.wait()
        results.append(_build.ensure_built())

    threads = [threading.Thread(target=caller) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    calls = log.read_text().splitlines()
    assert sum(" -c " in f" {c} " for c in calls) == 3
    assert sum("-shared" in c for c in calls) == 1
    assert sorted(r is None for r in results) == [False, True]
    assert (build_dir / "libdeepaco_kernels.so").exists()
    assert (build_dir / "build.log").exists()
