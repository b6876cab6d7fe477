"""Port parity: RCPSP's summation blend (``gamma >= 0.05``, ``c < 1``) on
the one-launch rollout (ops/rollout.py, K7r's ``"blend"`` kind on the
card), on the CPU, for ``(gamma, c, alpha)`` in CONFIGS:

- the routed ``engine.rollout`` against the per-step loop (the same plug-in
  without its ``fused`` field: ``probs_fn`` a step), with and without
  ``require_prob``, bit for bit: paths, log-probabilities and the
  generator's next draw; also on a heuristic with zero entries and with
  rows at 0 (every open activity at p = 0: the pick takes column 0 again);
- its log-probabilities against JAX's ``path_log_probs`` on the JAX
  ``rcpsp_spec`` for the same paths;
- ``rollout_backward_plain`` and autograd through ``fused_rollout``
  against ``jax.grad`` in the pheromone and the heuristic;
- ``rcpsp_loss`` and three ``rcpsp_iteration`` calls against the forced
  per-step route;
- ``alpha = 0`` keeping the per-step route, and why.

The instances are seeded ProGen instances (``core.rcpsp.progen_rcp``) of N
activities; the JAX plug-in is jitted, one instance a call.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import rcpsp as japr
from deepaco_tpu.core import rcpsp as jcore
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems import rcpsp as apr
from deepaco_tpu_torch.core import rcpsp as core
from deepaco_tpu_torch.ops import rollout as ro
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain
from deepaco_tpu_torch.train import special


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs (the tier-1
    command runs six pytest workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B, A, N = 2, 5, 20      # instances, ants, activities
CONFIGS = [(0.5, 0.6, 1.0), (0.9, 0.0, 1.0), (0.5, 0.6, 0.5)]
IDS = ["blend", "summation", "alpha_half"]


@functools.lru_cache(maxsize=None)
def _instances(seed: int = 0):
    """B seeded ProGen instances of N activities: the port's stacked and
    JAX's, one a call."""
    rng = np.random.default_rng(seed)
    texts = [core.progen_rcp(rng, jobs=N - 2) for _ in range(B)]
    return core.stack_rcpsp([core.parse_rcp(t) for t in texts]), [jcore.parse_rcp(t)
                                                                   for t in texts]


def _inputs(seed=0, zeros=0.0, dead=False):
    """The pheromone in (0.5, 1.5) and a heuristic in (0.05, 1.05), ``[B, N,
    N]``; ``zeros``: that share of the heuristic's entries set to 0;
    ``dead``: the rows of activities 3-8 at 0, so that an ant on one has
    every open activity at p = 0."""
    rng = np.random.default_rng(seed)
    phe = torch.from_numpy((0.5 + rng.random((B, N, N))).astype(np.float32))
    heu = torch.from_numpy((0.05 + rng.random((B, N, N))).astype(np.float32))
    if zeros:
        heu = heu * torch.from_numpy(np.random.default_rng(seed + 1).random(heu.shape) >= zeros)
    if dead:
        heu[:, 3:9, :] = 0.0
    return phe, heu


def _cfg(config, a=A):
    gamma, c, alpha = config
    return apr.RCPSPConfig(n_ants=a, gamma=gamma, c=c, alpha=alpha)


def _runs(spec, seed, require_prob, pick):
    """``[(rollout, next draw)]`` of the routed spec and of the per-step one
    on one seed."""
    out = []
    for s in (spec, spec._replace(fused=None)):
        gen = torch.Generator().manual_seed(seed)
        r = engine.rollout(s, gen, require_prob=require_prob, pick=pick)
        out.append((r, torch.rand(4, generator=gen)))
    return out


def _assert_equal_runs(runs, require_prob):
    (fused, next_f), (step, next_s) = runs
    assert fused.state is None and step.state is not None
    assert torch.equal(fused.paths, step.paths)
    assert torch.equal(fused.log_probs, step.log_probs)
    assert fused.log_probs.any() == require_prob
    assert torch.equal(next_f, next_s)


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_routed_blend_equals_the_step_loop(config, pick, require_prob):
    """The blend's spec carries the ``"blend"`` kind; its routed rollout
    (the noise of all steps in one draw) equals the per-step loop's bit for
    bit: paths, log-probabilities (zeros without ``require_prob``) and the
    generator's next draw."""
    spec = apr.rcpsp_spec(*_inputs(), _instances()[0], _cfg(config))
    assert spec.fused is not None and spec.fused[1].kind == "blend"
    _assert_equal_runs(_runs(spec, 7, require_prob, pick), require_prob)


@pytest.mark.parametrize("case", ["zero_heu", "dead_rows"])
def test_routed_blend_with_zero_probabilities(case):
    """A heuristic with 40% zero entries (open activities at p = 0, shut by
    the mask ``p > 0``), and one whose rows of activities 3-8 are 0 (every
    open activity at p = 0: every logit -1e30, the pick takes column 0
    again and subtracts its successors once more): the routed rollout
    equals the step loop bit for bit with and without log-probabilities,
    and the dead rows bring column 0 back on some ant."""
    phe, heu = _inputs(seed=4, zeros=0.4) if case == "zero_heu" else _inputs(seed=6, dead=True)
    spec = apr.rcpsp_spec(phe, heu, _instances()[0], _cfg(CONFIGS[0], a=16))
    for require_prob in (True, False):
        runs = _runs(spec, 12, require_prob, fused_pick)
        _assert_equal_runs(runs, require_prob)
    if case == "dead_rows":
        assert bool((runs[0][0].paths[:, 1:] == 0).any())


def _jax_log_probs_fn(config, a, safe=False):
    """``(phe, heu, inst, paths [L, A]) -> log_probs [L-1, A]``, JAX's
    path_log_probs on the JAX plug-in of one instance, jitted. ``safe``:
    its ``probs_fn`` with ``x ** alpha`` taken at ``where(mask, S, 1)``, the
    same values (0 where shut) whose gradient is 0 where the column is
    shut, not the ``0 * inf`` that ``x ** alpha`` at 0 gives for alpha < 1."""
    cfg = japr.RCPSPConfig(n_ants=a, gamma=config[0], c=config[1], alpha=config[2])

    def fn(phe, heu, inst, paths):
        spec = japr.rcpsp_spec(phe, heu, inst, cfg)
        if safe:
            probmat = (phe ** cfg.alpha) * (heu ** cfg.beta)

            def probs(state):
                cur, _, _, s_sum = state
                mask = spec.mask(state)
                base = jnp.where(mask > 0, s_sum, 1.0)
                summation = ((base ** cfg.alpha) * mask) * (heu[cur] ** cfg.beta)
                if cfg.c == 0.0:
                    return summation
                return cfg.c * (probmat[cur] * mask) + (1.0 - cfg.c) * summation

            spec = spec._replace(probs_fn=probs)
        return jengine.path_log_probs(spec, paths)

    return jax.jit(fn)


def _jax_args(i, phe, heu, paths):
    return (jnp.asarray(phe[i].numpy()), jnp.asarray(heu[i].numpy()), _instances()[1][i],
            jnp.asarray(paths[i].numpy(), jnp.int32))


@functools.lru_cache(maxsize=None)
def _sampled(config):
    """One routed rollout on the plain route: the pheromone, heuristic,
    paths and log-probs."""
    phe, heu = _inputs(seed=1)
    spec = apr.rcpsp_spec(phe, heu, _instances()[0], _cfg(config))
    out = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True,
                         pick=fused_pick_plain)
    return phe, heu, out.paths, out.log_probs.detach()


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_blend_log_probs_equal_jax_path_log_probs(config):
    """The routed rollout's log-probabilities against JAX's path_log_probs
    on its own paths: rtol 1e-5, atol 1e-6 (log and logsumexp rounding)."""
    phe, heu, paths, log_probs = _sampled(config)
    fn = _jax_log_probs_fn(config, A)
    for i in range(B):
        ref = fn(*_jax_args(i, phe, heu, paths))
        np.testing.assert_allclose(log_probs[i].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _port_grads(config, phe, heu, paths, g, route):
    """``(d phe, d heu)`` of ``sum(g * log_probs)`` on the recorded paths:
    ``rollout_backward_plain`` (the gradients in the score, ``heu **
    beta`` and the running sum's ``phe``) chained by autograd, or autograd
    through ``fused_rollout`` on a noise that replays them."""
    phe, heu = phe.clone().requires_grad_(True), heu.clone().requires_grad_(True)
    score, shape = apr.rcpsp_spec(phe, heu, _instances()[0], _cfg(config)).fused
    if route == "backward_plain":
        d = ro.rollout_backward_plain(score.detach(), paths, g, shape)
        return torch.autograd.grad((score, heu ** shape.beta, phe), (phe, heu), d)
    # each recorded action wins: a finite logit + 1e4 above every other
    noise = 1e4 * torch.nn.functional.one_hot(paths[:, 1:].permute(1, 0, 2), N).float()
    again, logp = ro.fused_rollout(score, paths[:, 0], noise, shape)
    assert torch.equal(again, paths)
    return torch.autograd.grad((logp * g).sum(), (phe, heu))


@functools.lru_cache(maxsize=None)
def _jax_grads(config):
    """The cotangent ``g [B, T, A]`` and, an instance each, ``jax.grad`` of
    ``sum(g * path_log_probs)`` in the pheromone and the heuristic on
    ``_sampled(config)``'s paths; at alpha < 1 the pheromone's from the
    ``safe`` plug-in (``_jax_log_probs_fn``), after checking that the
    plug-in's own is NaN there and that the two give equal
    log-probabilities."""
    phe, heu, paths, _ = _sampled(config)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, paths.shape[1] - 1, A)).astype(np.float32))
    fn, safe = _jax_log_probs_fn(config, A), _jax_log_probs_fn(config, A, safe=True)
    grad = jax.jit(jax.grad(lambda ph, hu, inst, p, gi: jnp.sum(gi * fn(ph, hu, inst, p)),
                            argnums=(0, 1)))
    grad_safe = jax.jit(jax.grad(lambda ph, hu, inst, p, gi: jnp.sum(gi * safe(ph, hu, inst, p))))
    refs = []
    for i in range(B):
        ph, hu, inst, p = _jax_args(i, phe, heu, paths)
        gi = jnp.asarray(g[i].numpy())
        ref = grad(ph, hu, inst, p, gi)
        if config[2] < 1.0:
            assert bool(jnp.isnan(ref[0]).any()) and not bool(jnp.isnan(ref[1]).any())
            np.testing.assert_array_equal(np.asarray(safe(ph, hu, inst, p)),
                                          np.asarray(fn(ph, hu, inst, p)))
            ref = (grad_safe(ph, hu, inst, p, gi), ref[1])
        refs.append(tuple(np.asarray(r) for r in ref))
    return g, refs


@pytest.mark.parametrize("route", ["backward_plain", "autograd"])
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_blend_gradient_equals_jax_grad(config, route):
    """The gradient of ``sum(g * log_probs)`` in the pheromone and the
    heuristic against ``jax.grad`` of ``sum(g * path_log_probs)``, rtol
    1e-4 and atol 1e-5 of the largest entry (softmax and sum order). At
    alpha < 1 JAX's gradient in the pheromone is NaN (autograd through
    ``(S m) ** alpha`` multiplies a 0 cotangent by ``alpha 0^(alpha - 1) =
    inf`` at every shut column, and the running sum spreads it); the port
    gives the derivative of the same function, held there against
    ``jax.grad`` of the JAX plug-in with that power taken at ``where(m, S,
    1)``, whose log-probabilities equal the plug-in's."""
    phe, heu, paths, _ = _sampled(config)
    g, refs = _jax_grads(config)
    got = _port_grads(config, phe, heu, paths, g, route)
    for i in range(B):
        for mine, want in zip(got, refs[i]):
            np.testing.assert_allclose(mine[i].numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())


def test_blend_at_alpha_zero_keeps_the_per_step_route(monkeypatch):
    """At alpha = 0 ``(S m) ** 0`` is 1 at a shut column (``0 ** 0 = 1``),
    so ``probs_fn`` gives a visited activity p > 0 and the step loop may
    pick it again, a state K7r's kind does not keep: the spec carries no
    ``fused`` and its rollouts step through ``fused_pick`` (K7 on the card)
    with and without log-probabilities, the one-launch routes never called;
    on these inputs some step has a visited activity open."""
    phe, heu = _inputs()
    spec = apr.rcpsp_spec(phe, heu, _instances()[0], _cfg((0.5, 0.6, 0.0)))
    assert spec.fused is None
    assert not ro.fused_rollout_supported(N, ro.RolloutShape("blend", alpha=0.0))
    taken = []
    traced, untraced = engine._FUSED[fused_pick]
    monkeypatch.setitem(engine._FUSED, fused_pick,
                        (lambda *a: taken.append(1) or traced(*a),
                         lambda *a: taken.append(1) or untraced(*a)))
    for require_prob in (True, False):
        out = engine.rollout(spec, torch.Generator().manual_seed(2), require_prob=require_prob)
        assert out.state is not None
    assert not taken
    paths = out.paths
    state, reopened = spec.init(paths[:, 0]), False
    for t in range(1, paths.shape[1]):
        reopened |= bool(((spec.probs_fn(state) > 0) & state[1]).any())
        state = spec.step(state, paths[:, t])
    assert reopened


def _strip(fn):
    return lambda *args, **kw: fn(*args, **kw)._replace(fused=None)


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_blend_rcpsp_iteration_equals_the_per_step_route(config, monkeypatch):
    """Three ``rcpsp_iteration`` calls (the classic heuristic, 8 ants,
    elitist MAX-MIN) on the routed spec (K7r's untraced forward once an
    iteration on the card) and on the per-step one from the same seed:
    equal tau, best makespans and best lists, bit for bit."""
    data = _instances()[0]
    heu = core.default_rcpsp_heuristic(data)
    cfg = _cfg(config, a=8)._replace(elitist=True, min_max=True)
    traced, untraced = engine._FUSED[fused_pick]
    states, taken = [], []
    for forced in (False, True):
        with monkeypatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (traced, lambda *a: taken.append(forced)
                                                   or untraced(*a)))
            if forced:
                mp.setattr(apr, "rcpsp_spec", _strip(apr.rcpsp_spec))
            state = apr.init_rcpsp_search(B, N, cfg)
            gen = torch.Generator().manual_seed(5)
            for _ in range(3):
                state = apr.rcpsp_iteration(data, heu, cfg, state, gen)
        states.append(state)
    assert taken == [False] * 3
    for x, y in zip(*states):
        assert torch.equal(x, y)


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_blend_rcpsp_loss_equals_the_per_step_route(config, monkeypatch):
    """``rcpsp_loss`` under the blend (a 2-layer net from the seed's init,
    one instance, 6 ants) on the routed spec (K7r once each way on the
    card) and on the per-step one from the same weights and seed: paths,
    log-probabilities, costs and loss bit for bit; the gradients, which sum
    the same terms in another order, at rtol 1e-5 and atol 1e-6 of the
    largest entry."""
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax

    data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(np.random.default_rng(7),
                                                            jobs=N - 2))])
    net = init_like_flax(Net(edge_feats=2, depth=2, pad_feats=5),
                         torch.Generator().manual_seed(3))
    traced, untraced = engine._FUSED[fused_pick]
    runs, taken = [], []
    for forced in (False, True):
        copy_net = copy.deepcopy(net)
        with monkeypatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (lambda *a: taken.append(forced)
                                                   or traced(*a), untraced))
            if forced:
                mp.setattr(special, "rcpsp_spec", _strip(special.rcpsp_spec))
            out = special.rcpsp_loss(copy_net, data, _cfg(config, a=6),
                                     torch.Generator().manual_seed(8))
        out.loss.backward()
        runs.append((out, {k: p.grad for k, p in copy_net.named_parameters()}))
    assert taken == [False]
    (out_r, g_r), (out_s, g_s) = runs
    for x, y in zip(out_r[:5], out_s[:5]):
        assert torch.equal(x, y)
    scale = max(v.abs().max().item() for v in g_s.values() if v is not None)
    for k, v in g_s.items():
        if v is not None:
            assert bool(torch.isfinite(g_r[k]).all()), k
            torch.testing.assert_close(g_r[k], v, rtol=1e-5, atol=1e-6 * scale)
