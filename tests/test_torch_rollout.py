"""Port parity: the one-launch rollout with log-probabilities (ops/rollout.py,
kernel K7r on the card) and the engine's route to it, on the CPU.

- the routed ``engine.rollout(require_prob=True)`` against the per-step loop
  (the same plug-in without its ``fused`` field), bit for bit: paths,
  log-probabilities and the generator's next draw;
- its log-probabilities against JAX's ``path_log_probs`` on the same paths,
  and ``rollout_backward_plain`` and autograd through ``fused_rollout``
  against ``jax.grad`` of ``sum(g * path_log_probs)`` in the score;
- one ``tsp_loss`` and one ``family_loss`` step against the same step with
  the per-step route forced: equal loss and gradients, bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import cvrp as jcvrp
from deepaco_tpu.aco.problems import tsp as jtsp
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec
from deepaco_tpu_torch.aco.problems.tsp import tsp_spec
from deepaco_tpu_torch.families import BPP_CAPACITY, CVRP_CAPACITY
from deepaco_tpu_torch.models.gnn import Net, init_like_flax
from deepaco_tpu_torch.ops import rollout as ro
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain
from deepaco_tpu_torch.train import config, drivers
from deepaco_tpu_torch.train import reinforce as tr


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B = 3
# case -> (N nodes, ants, capacity or None for TSP, fixed start)
CASES = {"tsp_uniform": (30, 6, None, None), "tsp_start0": (30, 6, None, 0),
         "cvrp": (41, 5, CVRP_CAPACITY, None), "bpp": (31, 8, BPP_CAPACITY, None)}


def _inputs(case, seed=0):
    """A heuristic in (0.05, 1.05) and, for the capacity cases, demands:
    CVRP's 1-9 (depot 0), BPP's item sizes 20-100 (node 0 at 0), so that
    routes return to node 0 many times and park there."""
    n, _, cap, _ = CASES[case]
    rng = np.random.default_rng(seed)
    heu = (rng.random((B, n, n)) + 0.05).astype(np.float32)
    demand = None
    if cap is not None:
        lo, hi = (1, 10) if case == "cvrp" else (20, 101)
        demand = np.concatenate([np.zeros((B, 1)), rng.integers(lo, hi, (B, n - 1))],
                                axis=1).astype(np.float32)
    return heu, demand


def _spec(case, heu, demand):
    _, a, cap, start = CASES[case]
    ones = torch.ones_like(heu)
    if cap is None:
        return tsp_spec(ones, heu, a, start)
    return cvrp_spec(ones, heu, torch.from_numpy(demand), cap, a)


@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
@pytest.mark.parametrize("case", list(CASES))
def test_routed_rollout_equals_the_step_loop(case, pick):
    """The fused route draws the noise of all steps in one call: on a CPU
    generator the very numbers of a call a step, so paths, log-probabilities
    and the generator's next draw are bit-equal to the per-step loop's."""
    heu, demand = _inputs(case)
    spec = _spec(case, torch.from_numpy(heu), demand)
    assert spec.fused is not None
    runs = []
    for s in (spec, spec._replace(fused=None)):
        gen = torch.Generator().manual_seed(7)
        out = engine.rollout(s, gen, require_prob=True, pick=pick)
        runs.append((out, torch.rand(4, generator=gen)))
    (fused, next_f), (step, next_s) = runs
    assert fused.state is None and step.state is not None
    assert torch.equal(fused.paths, step.paths)
    assert torch.equal(fused.log_probs, step.log_probs)
    assert torch.equal(next_f, next_s)


def _jax_log_probs_fn(case, n, a):
    """``(score [n, n], paths [L, A], start [A]) -> log_probs [L-1, A]``,
    JAX's path_log_probs on the JAX plug-in with its score rows read from
    ``score`` and its start from ``start``, jitted (one instance)."""
    cap = CASES[case][2]
    ones = jnp.ones((n, n), jnp.float32)

    def fn(score, paths, start, demand):
        if cap is None:
            spec = jtsp.tsp_spec(ones, ones, a, 0)

            def init(_rng):
                return (start, jtsp.clear_onehot(jnp.ones((a, n), jnp.float32), start)), start
            spec = spec._replace(init=init)
        else:
            spec = jcvrp.cvrp_spec(ones, ones, demand, cap, a)
        spec = spec._replace(score_rows=lambda state: score[state[0]])
        return jengine.path_log_probs(spec, paths)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _sampled(case):
    """One routed rollout on the plain route: score, paths, log-probs."""
    heu, demand = _inputs(case, seed=1)
    spec = _spec(case, torch.from_numpy(heu), demand)
    out = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True,
                         pick=fused_pick_plain)
    return spec.fused[0].detach(), out.paths, out.log_probs.detach(), demand


@pytest.mark.parametrize("case", list(CASES))
def test_log_probs_equal_jax_path_log_probs(case):
    """The routed rollout's log-probabilities against JAX's path_log_probs
    on its own paths: rtol 1e-5, atol 1e-6 (log and logsumexp rounding;
    the parked steps' 0)."""
    score, paths, log_probs, demand = _sampled(case)
    n, a = score.shape[-1], paths.shape[-1]
    fn = _jax_log_probs_fn(case, n, a)
    for i in range(B):
        ref = fn(jnp.asarray(score[i].numpy()), jnp.asarray(paths[i].numpy(), jnp.int32),
                 jnp.asarray(paths[i, 0].numpy(), jnp.int32),
                 None if demand is None else jnp.asarray(demand[i]))
        np.testing.assert_allclose(log_probs[i].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["backward_plain", "autograd"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradient_equals_jax_grad(case, route):
    """``d score`` of ``sum(g * log_probs)``: rollout_backward_plain on the
    paths, or autograd through fused_rollout (K7's PyTorch backward a step
    on the CPU), against ``jax.grad`` of ``sum(g * path_log_probs)``;
    rtol 1e-4 and atol 1e-5 of the largest entry (softmax and sum order)."""
    score, paths, _, demand = _sampled(case)
    n, a = score.shape[-1], paths.shape[-1]
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, paths.shape[1] - 1, a)).astype(np.float32))
    shape = (ro.TSP_SHAPE if demand is None
             else ro.RolloutShape("cvrp", torch.from_numpy(demand), CASES[case][2]))
    if route == "backward_plain":
        got = ro.rollout_backward_plain(score, paths, g, shape)
    else:
        leaf = score.clone().requires_grad_(True)
        # replay the sampled paths: a noise that makes each recorded action win
        noise = 1e4 * torch.nn.functional.one_hot(paths[:, 1:].permute(1, 0, 2), n).float()
        again, logp = ro.fused_rollout(leaf, paths[:, 0], noise, shape)
        assert torch.equal(again, paths)
        (logp * g).sum().backward()
        got = leaf.grad
    fn = _jax_log_probs_fn(case, n, a)
    for i in range(B):
        def loss(s, i=i):
            lp = fn(s, jnp.asarray(paths[i].numpy(), jnp.int32),
                    jnp.asarray(paths[i, 0].numpy(), jnp.int32),
                    None if demand is None else jnp.asarray(demand[i]))
            return jnp.sum(jnp.asarray(g[i].numpy()) * lp)
        ref = np.asarray(jax.grad(loss)(jnp.asarray(score[i].numpy())))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def _forced_per_step(monkeypatch):
    """Strip ``fused`` from every TSP and CVRP plug-in the steps build."""
    def strip(fn):
        return lambda *args, **kw: fn(*args, **kw)._replace(fused=None)

    monkeypatch.setattr(tr, "tsp_spec", strip(tr.tsp_spec))
    for name in ("cvrp", "bpp"):
        fam = families.FAMILIES[name]
        monkeypatch.setitem(families.FAMILIES, name, fam._replace(spec=strip(fam.spec)))


def _grads(net):
    return {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("name", ["tsp", "tsp_nls", "cvrp", "bpp"])
def test_train_step_equals_the_per_step_route(name, monkeypatch):
    """One sampled loss (``tsp_loss``; ``family_loss`` for CVRP and BPP) and
    its backward at a fixed seed: the routed step and the step with the
    per-step route forced give equal loss and gradients, bit for bit."""
    outs = []
    for forced in (False, True):
        with monkeypatch.context() as m:
            if forced:
                _forced_per_step(m)
            gen = torch.Generator().manual_seed(4)
            if name.startswith("tsp"):
                nls = name == "tsp_nls"
                cfg = config.ProblemConfig(n_nodes=20, k_sparse=5,
                                           aco=config.ACOSettings(n_ants=6))
                net = init_like_flax(Net(feats=1 if nls else 2, depth=2, dual_heads=not nls),
                                     torch.Generator().manual_seed(0))
                coords = torch.rand((2, 20, 2), generator=torch.Generator().manual_seed(5))
                ls = (lambda dist, heu, paths, c: torch.rand(paths.shape[0], paths.shape[2],
                      generator=torch.Generator().manual_seed(6))) if nls else None
                out = tr.tsp_loss(net, coords, cfg, gen, local_search=ls)
            else:
                fam = families.get_family(name)
                cfg = config.ProblemConfig(name=name, n_nodes=20, k_sparse=5,
                                           model=config.ModelConfig(depth=2),
                                           aco=config.ACOSettings(n_ants=6))
                net = init_like_flax(Net(depth=2, **dict(fam.model_kwargs)),
                                     torch.Generator().manual_seed(0))
                batch = drivers.gen_batch(fam, np.random.default_rng(0), 20, 2)
                out = drivers.family_loss(fam, net, drivers.instance_tensors(batch, "cpu"),
                                          cfg, gen)
            out.loss.backward()
            outs.append((out, _grads(net)))
    (routed, g_routed), (per_step, g_per_step) = outs
    assert torch.equal(routed.paths, per_step.paths)
    assert torch.equal(routed.loss, per_step.loss)
    assert g_routed.keys() == g_per_step.keys() and g_routed
    for k in g_routed:
        assert torch.equal(g_routed[k], g_per_step[k]), k


def test_fused_rollout_supported_and_unrouted_cases():
    """K7r's range of N, and the rollouts that keep the step loop: a pick
    other than K7 or its plain version, a spec without ``fused``; with or
    without ``require_prob`` the rest take the one-launch route."""
    assert not ro.fused_rollout_supported(1)
    assert ro.fused_rollout_supported(2) and ro.fused_rollout_supported(4096)
    assert not ro.fused_rollout_supported(4097)
    heu, _ = _inputs("tsp_uniform")
    spec = _spec("tsp_uniform", torch.from_numpy(heu), None)
    other = lambda s, m, g: fused_pick_plain(s, m, g)
    for require_prob in (True, False):
        assert engine.rollout(spec, torch.Generator(), require_prob=require_prob,
                              pick=other).state is not None
        assert engine.rollout(spec._replace(fused=None), torch.Generator(),
                              require_prob=require_prob).state is not None
        assert engine.rollout(spec, torch.Generator(), require_prob=require_prob).state is None
