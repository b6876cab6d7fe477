"""Port parity: the elitist and MAX-MIN updates (aco/pheromone.py,
aco/runner.search_update), the reference-style TSP facade (aco/runner.ACO),
eval/anytime.tsp_instance_curve, the golden TSP reader (utils/datasets.py,
utils/golden.tsp_test) and the CLI's test tsp, against the JAX package, on
inputs made from numpy seeds; the golden files are written into the test's
directory."""
import functools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import runner as jrunner
from deepaco_tpu.core import graph as jgraph
from deepaco_tpu.eval import anytime as janytime
from deepaco_tpu.utils import datasets as jdatasets
from deepaco_tpu.utils import golden as jgolden
from deepaco_tpu_torch import cli
from deepaco_tpu_torch.aco import runner
from deepaco_tpu_torch.aco.problems.tsp import tour_cost
from deepaco_tpu_torch.core.graph import sparse_distance_matrix
from deepaco_tpu_torch.eval.anytime import tsp_instance_curve
from deepaco_tpu_torch.utils import golden
from deepaco_tpu_torch.utils.datasets import distance_matrix


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
B, N, A = 2, 12, 5

CONFIGS = {
    "elitist": dict(elitist=True),
    "min_max": dict(min_max=True),
    "elitist_min_max_open": dict(elitist=True, min_max=True, cyclic=False, symmetric=False,
                                 mm_scale=7.0),
    "min_max_maximize": dict(min_max=True, maximize=True, cyclic=False, symmetric=False),
    "min_max_static": dict(min_max=True, mm_static_max=1.0, cost_offset=1.0, cyclic=False,
                           symmetric=False),
    "vector_elitist_min_max": dict(vector_pheromone=True, elitist=True, maximize=True,
                                   min_max=True, mm_static_max=20.0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_elitist_and_min_max_updates_match_jax(name):
    """Three updates on given permutations and costs, two instances against
    JAX's ``search_update`` per instance (OP's per-instance ``q`` and
    ``mm_scale`` where maximizing): tau and tau_max at rtol 1e-6 (XLA may
    divide by a reciprocal), the best cost and path equal. The first
    improvement rescales tau to the bound, the clamp holds it in
    ``[tau_min, tau_max]``."""
    kw = CONFIGS[name]
    cfg, jcfg = runner.ACOConfig(n_ants=A, **kw), jrunner.ACOConfig(n_ants=A, **kw)
    rng = np.random.default_rng(len(name))
    extra = {}
    if kw.get("maximize") and not kw.get("mm_static_max"):
        q = (0.05 + rng.random(B)).astype(np.float32)
        extra = {"q": q, "mm_scale": (N - 1) * q}
    state = runner.init_search(N, N - 1, cfg, batch=(B,))
    jstep = jax.jit(functools.partial(jrunner.search_update, jcfg))
    jstates = [jrunner.init_search(N, N - 1, jcfg) for _ in range(B)]
    if cfg.vector_pheromone:       # JAX's facade sets the vector (runner.py:333-338)
        jstates = [js._replace(phe=js.phe._replace(tau=jnp.full(N, cfg.tau_min)))
                   for js in jstates]
    for it in range(3):
        paths = np.stack([np.stack([rng.permutation(N) for _ in range(A)], axis=1)
                          for _ in range(B)])
        costs = (1.0 + 5.0 * rng.random((B, A))).astype(np.float32)
        state = runner.search_update(cfg, state, torch.from_numpy(paths), torch.from_numpy(costs),
                                     **{k: torch.from_numpy(v) for k, v in extra.items()})
        jstates = [jstep(js, jnp.asarray(paths[i], jnp.int32), jnp.asarray(costs[i]),
                         **{k: jnp.asarray(v[i]) for k, v in extra.items()})
                   for i, js in enumerate(jstates)]
    for i, js in enumerate(jstates):
        np.testing.assert_allclose(state.phe.tau[i].numpy(), np.asarray(js.phe.tau), rtol=1e-6)
        np.testing.assert_allclose(state.phe.tau_max[i].item(), float(js.phe.tau_max),
                                   rtol=1e-6)
        assert state.best_cost[i].item() == float(js.best_cost)
        assert np.array_equal(state.best_path[i].numpy(), np.asarray(js.best_path))
    if cfg.min_max:
        tau = state.phe.tau
        assert bool((tau >= cfg.tau_min).all())
        assert bool((tau <= state.phe.tau_max.reshape(B, *[1] * (tau.dim() - 1))).all())


def _instances(count, n, seed):
    coords = np.random.default_rng(seed).random((count, n, 2)).astype(np.float32)
    return coords, distance_matrix(torch.from_numpy(coords)).numpy()


def test_sparsify_and_sample_match_jax():
    """``sparsify(k)``'s heuristic equals JAX's facade's; ``sample`` gives permutations
    whose costs are their tour lengths and whose log-probabilities are
    finite; ``sample_2opt`` never lengthens them."""
    coords, dist = _instances(1, 30, seed=1)
    aco = runner.ACO(dist[0], n_ants=6, seed=2, device="cpu")
    for k in (3, 7):
        aco.sparsify(k)        # JAX's facade: 1 / sparse_distance_matrix (runner.py:204-206)
        want = 1.0 / jgraph.sparse_distance_matrix(jnp.asarray(dist[0]), k)
        assert np.array_equal(aco.heuristic[0].numpy(), np.asarray(want))
    costs, logp, paths = aco.sample()
    assert (torch.sort(paths, dim=0).values == torch.arange(30)[:, None]).all()
    torch.testing.assert_close(costs, tour_cost(aco.distances, paths[None])[0])
    assert logp.shape == (29, 6) and bool(torch.isfinite(logp).all())
    ls = runner.ACO(dist[0], n_ants=6, local_search="2opt", coords=coords[0], device="cpu")
    assert ls.fixed_start == 0
    better, tours = ls.sample_2opt(paths)
    assert bool((better <= costs + 1e-5).all())
    assert (torch.sort(tours, dim=0).values == torch.arange(30)[:, None]).all()


@pytest.fixture(scope="module")
def plain_law():
    """100 instances of 20 cities, the classic heuristic on each row's 5
    nearest, and JAX's best-so-far curves over 2 iterations of 10 ants
    (``tsp_instance_curve``, the law of its facade's ``run`` without local
    search: the same spec, update and random starts), vmapped and jitted."""
    coords, dist = _instances(100, 20, seed=3)
    jcfg = jrunner.ACOConfig(n_ants=10)
    curves = jax.jit(jax.vmap(lambda d, key: janytime.tsp_instance_curve(
        1.0 / jgraph.sparse_distance_matrix(d, 5), d, jcfg, key, 2)))(
        jnp.asarray(dist), jax.random.split(jax.random.PRNGKey(0), 100))
    return coords, dist, np.asarray(curves)


@pytest.mark.parametrize("ls,kw,count", [(None, {}, 100), ("2opt", {"min_max": True}, 20)])
def test_facade_run_matches_jax_in_law(ls, kw, count, request):
    """``ACO.run`` over ``count`` instances of 20 cities (the classic
    sparsified heuristic, 10 ants, T=1 and 2, seeds ``i``): without local
    search against JAX's law of its facade (``plain_law``), with 2-opt from
    city 0 on the coordinates under MAX-MIN against JAX's facade run an
    instance at a time; the mean best within 2% at both T, each best a
    permutation that costs the best, the curves falling."""
    if ls is None:
        coords, dist, want = request.getfixturevalue("plain_law")
    else:
        coords, dist = _instances(count, 20, seed=3)
        want = []
    got = []
    for i in range(count):
        aco = runner.ACO(dist[i], n_ants=10, seed=i, local_search=ls, coords=coords[i],
                         device="cpu", **kw)
        aco.sparsify(5)
        got.append([aco.run(1).item(), aco.run(1).item()])
        if ls is not None:
            jaco = jrunner.ACO(dist[i], n_ants=10, seed=i, local_search=ls, coords=coords[i],
                               **kw)
            jaco.sparsify(5)
            want.append([float(jaco.run(1)), float(jaco.run(1))])
        best = aco.shortest_path
        assert torch.equal(torch.sort(best).values, torch.arange(20))
        np.testing.assert_allclose(tour_cost(aco.distances, best[None, :, None]).item(),
                                   got[-1][1], rtol=1e-6)
    got, want = np.array(got), np.array(want)
    assert (got[:, 1] <= got[:, 0]).all()
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=0.02)


def test_tsp_instance_curve_matches_jax_in_law(plain_law):
    """``tsp_instance_curve`` on ``plain_law``'s 100 instances (the
    sparsified heuristic, 10 ants, 2 iterations, seeds ``i``): the mean
    curve within 2% of JAX's, each curve non-increasing."""
    coords, dist, want = plain_law
    cfg = runner.ACOConfig(n_ants=10)
    got = torch.stack([
        tsp_instance_curve(1.0 / sparse_distance_matrix(torch.from_numpy(d), 5),
                           torch.from_numpy(d), cfg, torch.Generator().manual_seed(i), 2)
        for i, d in enumerate(dist)])
    assert bool((got[:, 1:] <= got[:, :-1]).all())
    np.testing.assert_allclose(got.mean(dim=0).numpy(), want.mean(axis=0), rtol=0.02)


@pytest.fixture
def reference_data(tmp_path, monkeypatch):
    """``$DEEPACO_REFERENCE_DATA`` with ``tsp/testDataset-20.pt`` (6
    instances, one tensor) and ``tsp/valDataset-20.pt`` (a list of 3),
    written by ``torch.save``; JAX's import-time root points there too."""
    (tmp_path / "tsp").mkdir()
    gen = torch.Generator().manual_seed(5)
    torch.save(torch.rand(6, 20, 2, generator=gen), tmp_path / "tsp" / "testDataset-20.pt")
    torch.save([torch.rand(20, 2, generator=gen) for _ in range(3)],
               tmp_path / "tsp" / "valDataset-20.pt")
    monkeypatch.setenv("DEEPACO_REFERENCE_DATA", str(tmp_path))
    monkeypatch.setattr(jdatasets, "REFERENCE_DATA", str(tmp_path))
    return tmp_path


def test_golden_tsp_test_equals_jax(reference_data, monkeypatch):
    """Both splits' coordinates and distances equal JAX's; without the
    variable, or without the file, the reader names what is missing."""
    for split in ("test", "val"):
        got, want = golden.tsp_test(20, split), jgolden.tsp_test(20, split)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == np.float32 and np.array_equal(got[key], want[key]), key
    with pytest.raises(FileNotFoundError, match="testDataset-21.pt"):
        golden.tsp_test(21)
    monkeypatch.delenv("DEEPACO_REFERENCE_DATA")
    with pytest.raises(FileNotFoundError, match="DEEPACO_REFERENCE_DATA"):
        golden.tsp_test(20)


def test_cli_test_tsp_prints_the_jax_cli_lines(reference_data, capsys, monkeypatch):
    """``test tsp`` on the golden set: the family path with
    ``tsp20_selftrained``, ``--local-search nls`` batched and
    ``--per-instance`` with ``tsp_nls100_selftrained`` (the same instances;
    per instance the facade, seeds ``--seed + i``), and ``--local-search
    2opt --classic --per-instance``: the JAX CLI's three lines, curves that
    fall, and the NLS arms within 2% of each other."""
    monkeypatch.chdir(ROOT)
    base = ["test", "tsp", "-n", "20", "--limit", "4", "-a", "4", "-t", "1", "2"]
    nls = ["--local-search", "nls", "-c", "checkpoints/tsp_nls100_selftrained.msgpack"]
    runs = {"tsp": ["-c", "checkpoints/tsp20_selftrained.msgpack"], "tsp_nls": nls,
            "tsp_nls_per": nls + ["--per-instance"],
            "tsp_2opt": ["--local-search", "2opt", "--classic", "--per-instance"]}
    means = {}
    for key, arm in runs.items():
        capsys.readouterr()
        means[key], curves = cli.main(base + arm, device="cpu")
        lines = capsys.readouterr().out.strip().splitlines()
        assert re.fullmatch(r"total duration: \d+\.\d\ds", lines[0])
        assert lines[1:3] == [f"T={t}, average cost is {v:.6f}."
                              for t, v in zip((1, 2), means[key])]
        rec = json.loads(lines[3])
        assert rec["problem"] == key.replace("_per", "") and rec["n"] == 20
        assert set(rec) == {"problem", "n", "t_aco", "means", "duration_s"}
        assert curves.shape[0] == 4 and bool((curves[:, -1] <= curves[:, 0]).all())
    np.testing.assert_allclose(means["tsp_nls_per"], means["tsp_nls"], rtol=0.02)
