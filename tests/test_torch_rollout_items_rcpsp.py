"""Port parity: the one-launch rollout (ops/rollout.py, kernel K7r on the
card) for MKP's PH_items plug-in (K7r's ``"items"`` kind: one score row an
instance, MKP's knapsack, the dummy start that is no pick) and RCPSP's
direct evaluation (SOP's kind on ``prec = adj^T`` and the score
``where(p > 0, log(max(p, 1e-30)), -1e30)``), on the CPU.

- the routed ``engine.rollout`` against the per-step loop (the same plug-in
  without its ``fused`` field), with and without ``require_prob``, bit for
  bit: paths, log-probabilities and the generator's next draw;
- one noise draw ``[T, B, A, N]`` against T draws ``[B, A, N]`` from a CPU
  generator at MKP-items 500's width (T = N = 501);
- its log-probabilities against JAX's ``path_log_probs`` on the same paths,
  and ``rollout_backward_plain`` and autograd through ``fused_rollout``
  against ``jax.grad`` of ``sum(g * path_log_probs)`` in the pheromone and
  the heuristic;
- RCPSP with a heuristic with zero entries (an open activity with p = 0)
  and with steps where every open activity has p = 0 (the pick takes
  column 0 again, as the step loop and JAX's pick do);
- RCPSP's blend (gamma 0.5) and its summation (c 0) taking the one-launch
  route too, on K7r's ``"blend"`` kind (``tests/test_torch_rollout_blend.py``
  holds it to the step loop and to JAX);
- MKP-items' parked steps on the dummy with log-probability exactly 0;
- a ``make_mkp_items_train_step`` step, ``evaluate_family("mkp_items")``,
  ``rcpsp_iteration`` and ``rcpsp_loss`` against the same with the
  per-step route forced.

The instances come from numpy generators with fixed seeds (the family's
``gen_mkp_items``, ``core.rcpsp.progen_rcp``); the JAX plug-ins are jitted,
one instance a call.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import engine as jengine
from deepaco_tpu.aco.problems import mkp as jmkp
from deepaco_tpu.aco.problems import rcpsp as japr
from deepaco_tpu.core import rcpsp as jcore
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems import rcpsp as apr
from deepaco_tpu_torch.aco.problems.mkp import extend_mkp, mkp_items_spec, validate_mkp
from deepaco_tpu_torch.core import rcpsp as core
from deepaco_tpu_torch.ops import rollout as ro
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain
from deepaco_tpu_torch.train import config, drivers, special


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs (the tier-1
    command runs six pytest workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B, A, N = 2, 5, 20      # instances, ants, items (MKP-items) or activities (RCPSP)
KINDS = ("items", "rcpsp")


@functools.lru_cache(maxsize=None)
def _rcpsp_instances(seed: int = 0):
    """B seeded ProGen instances of N activities: the port's stacked and
    JAX's, one a call."""
    rng = np.random.default_rng(seed)
    texts = [core.progen_rcp(rng, jobs=N - 2) for _ in range(B)]
    return core.stack_rcpsp([core.parse_rcp(t) for t in texts]), [jcore.parse_rcp(t)
                                                                   for t in texts]


def _inputs(kind, seed=0):
    """The pheromone in (0.5, 1.5), a heuristic in (0.05, 1.05) and the
    instance: MKP-items' vectors ``[B, N+1]`` and ``weight_e [B, N+1, m]``;
    RCPSP's matrices ``[B, N, N]`` and its stacked instances."""
    rng = np.random.default_rng(seed)
    if kind == "items":
        insts = [families.gen_mkp_items(rng, N) for _ in range(B)]
        prize = torch.from_numpy(np.stack([i["prize"] for i in insts]))
        weight = torch.from_numpy(np.stack([i["weight"] for i in insts]))
        extra = extend_mkp(prize, weight)[1]
        shape = (B, N + 1)
    else:
        extra = _rcpsp_instances()[0]
        shape = (B, N, N)
    phe = torch.from_numpy((0.5 + rng.random(shape)).astype(np.float32))
    heu = torch.from_numpy((0.05 + rng.random(shape)).astype(np.float32))
    return phe, heu, extra


def _spec(kind, phe, heu, extra, a=A, cfg=None):
    if kind == "items":
        return mkp_items_spec(phe, heu, extra, 1.0, a)
    return apr.rcpsp_spec(phe, heu, extra, cfg or apr.RCPSPConfig(n_ants=a))


def _routed_and_stepped(spec, seed, require_prob, pick):
    """``[(rollout, next draw)]`` of the routed spec and of the per-step one
    on one seed."""
    runs = []
    for s in (spec, spec._replace(fused=None)):
        gen = torch.Generator().manual_seed(seed)
        out = engine.rollout(s, gen, require_prob=require_prob, pick=pick)
        runs.append((out, torch.rand(4, generator=gen)))
    return runs


def _assert_equal_runs(runs, require_prob):
    (fused, next_f), (step, next_s) = runs
    assert fused.state is None and step.state is not None
    assert torch.equal(fused.paths, step.paths)
    assert torch.equal(fused.log_probs, step.log_probs)
    assert fused.log_probs.any() == require_prob
    assert torch.equal(next_f, next_s)


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
@pytest.mark.parametrize("kind", KINDS)
def test_routed_rollout_equals_the_step_loop(kind, pick, require_prob):
    """The fused route draws the noise of all steps in one call: paths,
    log-probabilities (zeros without ``require_prob``) and the generator's
    next draw bit-equal to the per-step loop's."""
    spec = _spec(kind, *_inputs(kind))
    assert spec.fused is not None
    assert spec.fused[1].kind == ("items" if kind == "items" else "sop")
    _assert_equal_runs(_routed_and_stepped(spec, 7, require_prob, pick), require_prob)


def test_one_noise_draw_is_the_steps_draws():
    """``gumbel((T, B, A, N))`` from a CPU generator gives the very numbers
    of T calls ``gumbel((B, A, N))`` at MKP-items 500's width (T = N =
    501)."""
    t, b, a, n = 501, 1, 2, 501
    one = engine.gumbel((t, b, a, n), torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    steps = torch.stack([engine.gumbel((b, a, n), gen, "cpu") for _ in range(t)])
    assert torch.equal(one, steps)


def _jax_log_probs_fn(kind, a):
    """``(phe, heu, own, paths [L, A]) -> log_probs [L-1, A]``, JAX's
    path_log_probs on the JAX plug-in of one instance, jitted (``own``:
    MKP-items' ``weight_e``, RCPSP's instance)."""
    def fn(phe, heu, own, paths):
        if kind == "items":
            spec = jmkp.mkp_items_spec(phe, heu, own, 1.0, a)
        else:
            spec = japr.rcpsp_spec(phe, heu, own, japr.RCPSPConfig(n_ants=a))
        return jengine.path_log_probs(spec, paths)

    return jax.jit(fn)


def _jax_args(kind, i, phe, heu, extra, paths):
    own = jnp.asarray(extra[i].numpy()) if kind == "items" else _rcpsp_instances()[1][i]
    return (jnp.asarray(phe[i].numpy()), jnp.asarray(heu[i].numpy()), own,
            jnp.asarray(paths[i].numpy(), jnp.int32))


@functools.lru_cache(maxsize=None)
def _sampled(kind, zeros: float = 0.0):
    """One routed rollout on the plain route (``zeros``: the share of the
    heuristic's entries set to 0): the pheromone, heuristic, paths,
    log-probs, instance and shape."""
    phe, heu, extra = _inputs(kind, seed=1)
    if zeros:
        heu = heu * torch.from_numpy(np.random.default_rng(9).random(heu.shape) >= zeros)
    spec = _spec(kind, phe, heu, extra)
    out = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True,
                         pick=fused_pick_plain)
    return phe, heu, out.paths, out.log_probs.detach(), extra, spec.fused[1]


@pytest.mark.parametrize("kind,zeros", [("items", 0.0), ("rcpsp", 0.0), ("rcpsp", 0.4)],
                         ids=["items", "rcpsp", "rcpsp_zero_heu"])
def test_log_probs_equal_jax_path_log_probs(kind, zeros):
    """The routed rollout's log-probabilities against JAX's path_log_probs
    on its own paths: rtol 1e-5, atol 1e-6 (log and logsumexp rounding;
    the parked steps' 0)."""
    phe, heu, paths, log_probs, extra, _ = _sampled(kind, zeros)
    fn = _jax_log_probs_fn(kind, paths.shape[-1])
    for i in range(B):
        ref = fn(*_jax_args(kind, i, phe, heu, extra, paths))
        np.testing.assert_allclose(log_probs[i].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _port_grads(kind, phe, heu, extra, paths, g, route):
    """``(d phe, d heu)`` of ``sum(g * log_probs)`` on the recorded paths:
    ``rollout_backward_plain`` chained through the score, or autograd
    through ``fused_rollout`` on a noise that replays them."""
    phe, heu = phe.clone().requires_grad_(True), heu.clone().requires_grad_(True)
    score, shape = _spec(kind, phe, heu, extra).fused
    if route == "backward_plain":
        d = ro.rollout_backward_plain(score.detach(), paths, g, shape)
        return torch.autograd.grad(score, (phe, heu), d)
    n = score.shape[-1]
    # each recorded action wins: a finite logit + 1e4 above every other
    noise = 1e4 * torch.nn.functional.one_hot(paths[:, 1:].permute(1, 0, 2), n).float()
    again, logp = ro.fused_rollout(score, paths[:, 0], noise, shape)
    assert torch.equal(again, paths)
    return torch.autograd.grad((logp * g).sum(), (phe, heu))


@pytest.mark.parametrize("route", ["backward_plain", "autograd"])
@pytest.mark.parametrize("kind,zeros", [("items", 0.0), ("rcpsp", 0.0), ("rcpsp", 0.4)],
                         ids=["items", "rcpsp", "rcpsp_zero_heu"])
def test_gradient_equals_jax_grad(kind, zeros, route):
    """The gradient of ``sum(g * log_probs)`` in the pheromone and the
    heuristic (MKP-items' vectors, RCPSP's matrices): rollout_backward_plain
    on the paths chained through the score, or autograd through
    fused_rollout (K7's PyTorch backward a step on the CPU), against
    ``jax.grad`` of ``sum(g * path_log_probs)``; rtol 1e-4 and atol 1e-5 of
    the largest entry (softmax and sum order)."""
    phe, heu, paths, _, extra, _ = _sampled(kind, zeros)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, paths.shape[1] - 1, paths.shape[-1])).astype(np.float32))
    got = _port_grads(kind, phe, heu, extra, paths, g, route)
    fn = _jax_log_probs_fn(kind, paths.shape[-1])
    for i in range(B):
        ph, hu, own, p = _jax_args(kind, i, phe, heu, extra, paths)
        loss = lambda ph, hu: jnp.sum(jnp.asarray(g[i].numpy()) * fn(ph, hu, own, p))
        for mine, ref in zip(got, jax.grad(loss, argnums=(0, 1))(ph, hu)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine[i].numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max())


def _logits_per_step(spec, paths):
    """``(the engine's probs_fn logits, the routed score's rows under the
    open set K7r keeps, that open set)`` at every step of ``paths``."""
    score, shape = spec.fused
    rows = ro._rows_of(score, shape, paths.shape[-1])
    state, walk, out = spec.init(paths[:, 0]), ro._Walk(paths[:, 0], score.shape[-1], shape), []
    for t in range(1, paths.shape[1]):
        open_ = walk.open()
        out.append((engine._step_logits(spec, state, 1.0, 1.0),
                    torch.where(open_, rows(score, paths[:, t - 1]), ro.NEG_INF), open_))
        state = spec.step(state, paths[:, t])
        walk.step(paths[:, t])
    return out


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
def test_rcpsp_zero_heuristic_entries(pick, require_prob):
    """A heuristic with 40% zero entries: open activities with p = 0 take
    the score -1e30 where the step loop's mask shuts them, so every step's
    logits are the engine's bit for bit (on 64 ants some step has such an
    activity open), and the routed rollout equals the step loop."""
    phe, heu, extra = _inputs("rcpsp", seed=4)
    heu = heu * torch.from_numpy(np.random.default_rng(5).random(heu.shape) >= 0.4)
    spec = _spec("rcpsp", phe, heu, extra, a=64)
    runs = _routed_and_stepped(spec, 11, require_prob, pick)
    _assert_equal_runs(runs, require_prob)
    hit = False
    for engine_logits, routed, open_ in _logits_per_step(spec, runs[0][0].paths):
        assert torch.equal(engine_logits, routed)
        hit |= bool((open_ & (routed == ro.NEG_INF)).any())
    assert hit


def _dead_rows(seed=6):
    """RCPSP inputs whose heuristic rows of activities 3-8 are all 0: an ant
    standing on one of them has every open activity at p = 0."""
    phe, heu, extra = _inputs("rcpsp", seed=seed)
    heu = heu.clone()
    heu[:, 3:9, :] = 0.0
    return phe, heu, extra


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
def test_rcpsp_step_with_every_open_activity_at_zero(pick, require_prob):
    """Where every open activity has p = 0 every logit is -1e30, and the
    pick takes the first column, 0, already visited, and subtracts its
    successors once more (the step loop's and JAX's rule): the routed
    rollout's paths, log-probabilities and next draw equal the step loop's,
    and column 0 comes back on some ant."""
    phe, heu, extra = _dead_rows()
    spec = _spec("rcpsp", phe, heu, extra, a=16)
    runs = _routed_and_stepped(spec, 12, require_prob, pick)
    _assert_equal_runs(runs, require_prob)
    assert bool((runs[0][0].paths[:, 1:] == 0).any())


def test_rcpsp_step_with_every_open_activity_at_zero_log_probs_and_gradient():
    """On those degenerate paths: the log-probabilities (``-log n`` at an
    all -1e30 step) against JAX's path_log_probs at rtol 1e-5 / atol 1e-6,
    and the gradient in the heuristic by rollout_backward_plain (the
    softmax 1/N at such a step, row 0 left again at each repeat) against
    autograd through the plain step loop and against ``jax.grad``, rtol
    1e-4 and atol 1e-5 of the largest entry."""
    phe, heu, extra = _dead_rows()
    spec = _spec("rcpsp", phe, heu, extra, a=16)
    out = engine.rollout(spec, torch.Generator().manual_seed(12), require_prob=True,
                         pick=fused_pick_plain)
    paths = out.paths
    assert bool((paths[:, 1:] == 0).any())
    fn = _jax_log_probs_fn("rcpsp", 16)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        out.log_probs.shape).astype(np.float32))
    score, shape = spec.fused
    d_plain = ro.rollout_backward_plain(score.detach(), paths, g, shape)
    leaf = score.detach().clone().requires_grad_(True)
    noise = 1e4 * torch.nn.functional.one_hot(paths[:, 1:].permute(1, 0, 2), N).float()
    again, logp = ro.fused_rollout_plain(leaf, paths[:, 0], noise, shape)
    assert torch.equal(again, paths)
    d_auto, = torch.autograd.grad((logp * g).sum(), leaf)
    scale = d_auto.abs().max().item()
    torch.testing.assert_close(d_plain, d_auto, rtol=1e-4, atol=1e-5 * scale)
    got = _port_grads("rcpsp", phe, heu, extra, paths, g, "backward_plain")[1]
    for i in range(B):
        ph, hu, own, p = _jax_args("rcpsp", i, phe, heu, extra, paths)
        np.testing.assert_allclose(out.log_probs[i].detach().numpy(), np.asarray(fn(ph, hu, own, p)),
                                   rtol=1e-5, atol=1e-6)
        loss = lambda hu: jnp.sum(jnp.asarray(g[i].numpy()) * fn(ph, hu, own, p))
        ref = np.asarray(jax.grad(loss)(hu))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("gamma,c", [(0.5, 0.6), (0.5, 0.0), (0.5, 1.0), (0.04, 0.6)],
                         ids=["blend", "summation", "c1", "gamma_below"])
def test_rcpsp_blend_keeps_the_per_step_route(gamma, c, monkeypatch):
    """(Named for the route the blend took before K7r's ``"blend"`` kind.)
    The spec carries ``fused`` under every evaluation at alpha 1: SOP's
    kind under ``direct_only`` (gamma < 0.05 or c == 1), the ``"blend"``
    kind for the blend and the summation; each rollout takes the one-launch
    route once, with and without log-probabilities, and no pick a step."""
    phe, heu, extra = _inputs("rcpsp")
    cfg = apr.RCPSPConfig(n_ants=A, gamma=gamma, c=c)
    spec = _spec("rcpsp", phe, heu, extra, cfg=cfg)
    assert spec.fused[1].kind == ("sop" if cfg.direct_only else "blend")
    taken = []
    traced, untraced = engine._FUSED[fused_pick]
    monkeypatch.setitem(engine._FUSED, fused_pick,
                        (lambda *a: taken.append(1) or traced(*a),
                         lambda *a: taken.append(1) or untraced(*a)))
    for require_prob in (True, False):
        out = engine.rollout(spec, torch.Generator().manual_seed(2), require_prob=require_prob)
        assert out.state is None
    assert len(taken) == 2


def test_items_parked_steps_are_certain():
    """Every pick of the dummy (the last open column) and every step parked
    on it has log-probability exactly 0, every ant ends on the dummy, and
    the real picks have log-probabilities at most 0 (the last item that fits
    is certain too), most below; an instance where no item fits parks
    every ant from step 0 (the start, the dummy, is no pick), on the route
    as in the step loop."""
    phe, heu, paths, log_probs, extra, shape = _sampled("items")
    dummy = shape.dummy
    at = paths[:, 1:] == dummy
    assert bool(at[:, -1].all()) and bool(validate_mkp(paths, extra[..., :-1, :], 1.0).all())
    assert bool((log_probs[at] == 0.0).all()) and bool((log_probs[~at] <= 0.0).all())
    assert bool((log_probs[~at] < 0.0).any())
    heavy = extra.clone()
    heavy[..., :-1, :] += 1.5
    runs = _routed_and_stepped(_spec("items", phe, heu, heavy), 4, True, fused_pick)
    (fused, _), (step, _) = runs
    assert bool((fused.paths == dummy).all()) and bool((fused.log_probs == 0.0).all())
    assert torch.equal(fused.paths, step.paths) and torch.equal(fused.log_probs, step.log_probs)


def _per_step_items():
    """MKP-items with its ``fused`` field stripped: training and inference
    step through the plug-in a pick at a time (K7 on the card)."""
    fam = families.FAMILIES["mkp_items"]
    spec = lambda *args: fam.spec(*args)._replace(fused=None)
    return fam._replace(spec=spec, construct=lambda tau, heu, inst, a, generator, ops:
                        engine.rollout(spec(tau, heu, inst, a), generator,
                                       pick=ops.pick).paths)


def test_mkp_items_train_step_equals_the_per_step_route():
    """One ``make_mkp_items_train_step`` step (the transformer from the
    seed's init, one instance of 20 items, 6 ants) on the routed spec (one
    K7r each way on the card) and on the per-step one from the same weights
    and seed: equal mean objective and updated weights, bit for bit."""
    cfg = config.ProblemConfig(name="mkp_items", n_nodes=N, k_sparse=3,
                               aco=config.ACOSettings(n_ants=6),
                               train=config.TrainConfig(epochs=1, steps_per_epoch=10))
    rng = np.random.default_rng(0)
    fam = families.get_family("mkp_items")
    state = drivers.init_family_state(fam, cfg, rng, torch.Generator().manual_seed(0))
    inst = fam.gen(rng, N)
    traced, untraced = engine._FUSED[fused_pick]
    outs, taken = [], []
    for forced in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (lambda *a: taken.append(forced)
                                                   or traced(*a), untraced))
            if forced:
                mp.setitem(families.FAMILIES, "mkp_items", _per_step_items())
            s, mean_obj = special.make_mkp_items_train_step(cfg)(
                copy.deepcopy(state), inst["prize"], inst["weight"],
                torch.Generator().manual_seed(4))
        outs.append((mean_obj, s.net.state_dict()))
    assert taken == [False]
    (obj_r, w_r), (obj_s, w_s) = outs
    assert torch.equal(obj_r, obj_s)
    assert w_r.keys() == w_s.keys()
    for k in w_r:
        assert torch.equal(w_r[k], w_s[k]), k


def test_mkp_items_inference_route_equals_the_per_step_route(monkeypatch):
    """``evaluate_family("mkp_items", device="cpu")`` (classic heuristic, 3
    instances of 20 items, 8 ants, T=1 and 3) on the one-launch route (the
    untraced route taken once an iteration) equals the per-step route's
    costs and curves to the digit: the CPU's noise stream did not change."""
    fam = families.get_family("mkp_items")
    rng = np.random.default_rng(1)
    insts = [fam.gen(rng, N) for _ in range(3)]
    ds = {k: np.stack([i[k] for i in insts]) for k in insts[0]}
    traced, untraced = engine._FUSED[fused_pick]
    runs, taken = [], []
    for forced in (False, True):
        with monkeypatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (traced, lambda *a: taken.append(forced)
                                                   or untraced(*a)))
            if forced:
                mp.setitem(families.FAMILIES, "mkp_items", _per_step_items())
            runs.append(drivers.evaluate_family("mkp_items", ds, n_nodes=N, n_ants=8,
                                                t_values=(1, 3), device="cpu"))
    assert taken == [False] * 3
    (means_r, curves_r), (means_s, curves_s) = runs
    assert torch.equal(curves_r, curves_s) and torch.equal(means_r, means_s)


def _strip_rcpsp(fn):
    return lambda *args, **kw: fn(*args, **kw)._replace(fused=None)


def test_rcpsp_iteration_equals_the_per_step_route(monkeypatch):
    """Three ``rcpsp_iteration`` calls (the classic heuristic, 8 ants,
    elitist MAX-MIN) on the routed spec and on the per-step one from the
    same seed: equal tau, best makespans and best lists, bit for bit."""
    data = _rcpsp_instances()[0]
    heu = core.default_rcpsp_heuristic(data)
    cfg = apr.RCPSPConfig(n_ants=8, elitist=True, min_max=True)
    traced, untraced = engine._FUSED[fused_pick]
    states, taken = [], []
    for forced in (False, True):
        with monkeypatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (traced, lambda *a: taken.append(forced)
                                                   or untraced(*a)))
            if forced:
                mp.setattr(apr, "rcpsp_spec", _strip_rcpsp(apr.rcpsp_spec))
            state = apr.init_rcpsp_search(B, N, cfg)
            gen = torch.Generator().manual_seed(5)
            for _ in range(3):
                state = apr.rcpsp_iteration(data, heu, cfg, state, gen)
        states.append(state)
    assert taken == [False] * 3
    for x, y in zip(*states):
        assert torch.equal(x, y)


def test_rcpsp_loss_equals_the_per_step_route(monkeypatch):
    """``rcpsp_loss`` (a 2-layer net from the seed's init, one instance, 6
    ants) on the routed spec and on the per-step one from the same weights
    and seed: the paths, log-probabilities, costs and loss bit for bit.
    Their gradients sum the same terms in another order (the route adds
    each score entry's terms, then divides by p once; the step loop divides
    each step's), so they are held at rtol 1e-5 and atol 1e-6 of the
    largest entry."""
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax

    data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(np.random.default_rng(7),
                                                            jobs=N - 2))])
    net = init_like_flax(Net(edge_feats=2, depth=2, pad_feats=5),
                         torch.Generator().manual_seed(3))
    runs = []
    for forced in (False, True):
        copy_net = copy.deepcopy(net)
        with monkeypatch.context() as mp:
            if forced:
                mp.setattr(special, "rcpsp_spec", _strip_rcpsp(special.rcpsp_spec))
            out = special.rcpsp_loss(copy_net, data, apr.RCPSPConfig(n_ants=6),
                                     torch.Generator().manual_seed(8))
        out.loss.backward()
        runs.append((out, {k: p.grad for k, p in copy_net.named_parameters()}))
    (out_r, g_r), (out_s, g_s) = runs
    for x, y in zip(out_r[:5], out_s[:5]):
        assert torch.equal(x, y)
    scale = max(v.abs().max().item() for v in g_s.values() if v is not None)
    for k, v in g_s.items():
        if v is not None:
            torch.testing.assert_close(g_r[k], v, rtol=1e-5, atol=1e-6 * scale)
