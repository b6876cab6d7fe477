"""Port parity: the one-launch rollout (ops/rollout.py, kernel K7r on the
card) for the SMTWTP, SOP and MKP plug-ins, and the engine's route to it
without log-probabilities (inference), on the CPU.

- the routed ``engine.rollout`` against the per-step loop (the same plug-in
  without its ``fused`` field), with and without ``require_prob``, bit for
  bit: paths, log-probabilities and the generator's next draw;
- one noise draw ``[T, B, A, N]`` against T draws ``[B, A, N]`` from a CPU
  generator at SMTWTP500's, SOP100's and MKP300's shapes (odd N included);
- its log-probabilities against JAX's ``path_log_probs`` on the same paths,
  and ``rollout_backward_plain`` and autograd through ``fused_rollout``
  against ``jax.grad`` of ``sum(g * path_log_probs)`` in the score;
- MKP's open set recomputed from the running knapsack against the plug-in's
  cumulative mask, on an instance whose items stop fitting one dimension at
  a time;
- one ``make_family_train_step`` step and ``evaluate_family``'s inference
  route against the same with the per-step route forced: equal bits.

The instances come from numpy generators with fixed seeds (the families'
``gen_*``); the JAX plug-ins are jitted, one instance a call.
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
from deepaco_tpu.aco.problems import smtwtp as jsmtwtp
from deepaco_tpu.aco.problems import sop as jsop
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems.mkp import extend_mkp, mkp_spec
from deepaco_tpu_torch.aco.problems.smtwtp import smtwtp_spec
from deepaco_tpu_torch.aco.problems.sop import sop_spec
from deepaco_tpu_torch.ops import rollout as ro
from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain
from deepaco_tpu_torch.train import config, drivers


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs (the tier-1
    command runs six pytest workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


B, A = 2, 5
N_ITEMS = {"smtwtp": 20, "sop": 20, "mkp": 30}    # jobs, nodes, items


def _inputs(kind, seed=0):
    """A heuristic in (0.05, 1.05) over the plug-in's states and the
    instance's own array: SOP's precedence matrix ``[B, n, n]``, MKP's
    dummy-extended weights ``[B, n+1, 5]`` (capacity n // 2)."""
    n = N_ITEMS[kind]
    rng = np.random.default_rng(seed)
    states = n + 1 if kind in ("smtwtp", "mkp") else n
    heu = (rng.random((B, states, states)) + 0.05).astype(np.float32)
    extra = None
    if kind == "sop":
        extra = np.stack([families.gen_sop(rng, n)["prec"] for _ in range(B)])
    elif kind == "mkp":
        insts = [families.gen_mkp(rng, n) for _ in range(B)]
        weight = torch.from_numpy(np.stack([i["weight"] for i in insts]))
        extra = extend_mkp(torch.zeros(weight.shape[:2]), weight)[1].numpy()
    return heu, extra


def _spec(kind, heu, extra, a=A):
    ones = torch.ones_like(heu)
    if kind == "smtwtp":
        return smtwtp_spec(ones, heu, a)
    if kind == "sop":
        return sop_spec(ones, heu, torch.from_numpy(extra), a)
    return mkp_spec(ones, heu, torch.from_numpy(extra), N_ITEMS["mkp"] // 2, a)


def _shape(kind, extra):
    if kind == "smtwtp":
        return ro.TSP_SHAPE
    if kind == "sop":
        return ro.RolloutShape("sop", prec=torch.from_numpy(extra))
    return ro.RolloutShape("mkp", capacity=N_ITEMS["mkp"] // 2, weight=torch.from_numpy(extra),
                           dummy=extra.shape[1] - 1)


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
@pytest.mark.parametrize("kind", list(N_ITEMS))
def test_routed_rollout_equals_the_step_loop(kind, pick, require_prob):
    """The fused route draws the noise of all steps in one call (MKP's start
    first): paths, log-probabilities (zeros without ``require_prob``) and the
    generator's next draw bit-equal to the per-step loop's."""
    heu, extra = _inputs(kind)
    spec = _spec(kind, torch.from_numpy(heu), extra)
    assert spec.fused is not None
    runs = []
    for s in (spec, spec._replace(fused=None)):
        gen = torch.Generator().manual_seed(7)
        out = engine.rollout(s, gen, require_prob=require_prob, pick=pick)
        runs.append((out, torch.rand(4, generator=gen)))
    (fused, next_f), (step, next_s) = runs
    assert fused.state is None and step.state is not None
    assert torch.equal(fused.paths, step.paths)
    assert torch.equal(fused.log_probs, step.log_probs)
    assert fused.log_probs.any() == require_prob
    assert torch.equal(next_f, next_s)


@pytest.mark.parametrize("t,b,a,n", [(500, 1, 2, 501), (99, 3, 2, 100), (301, 2, 3, 301)],
                         ids=["smtwtp500", "sop100", "mkp300"])
def test_one_noise_draw_is_the_steps_draws(t, b, a, n):
    """``gumbel((T, B, A, N))`` from a CPU generator gives the very numbers
    of T calls ``gumbel((B, A, N))``, at the new shapes' widths."""
    one = engine.gumbel((t, b, a, n), torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    steps = torch.stack([engine.gumbel((b, a, n), gen, "cpu") for _ in range(t)])
    assert torch.equal(one, steps)


def _jax_log_probs_fn(kind, n, a):
    """``(score [n, n], paths [L, A], start [A], extra) -> log_probs [L-1,
    A]``, JAX's path_log_probs on the JAX plug-in with its score rows read
    from ``score`` (MKP: its start from ``start``), jitted."""
    ones = jnp.ones((n, n), jnp.float32)
    cap = N_ITEMS["mkp"] // 2

    def fn(score, paths, start, extra):
        if kind == "smtwtp":
            spec = jsmtwtp.smtwtp_spec(ones, ones, a)
        elif kind == "sop":
            spec = jsop.sop_spec(ones, ones, extra, a)
        else:
            spec = jmkp.mkp_spec(ones, ones, extra, cap, a)
            update, dummy = jmkp._knapsack_masks(extra, cap, a, jnp.float32)

            def init(_rng):
                mask = jnp.ones((a, n), jnp.float32)
                knap = jnp.zeros((a, extra.shape[-1]), jnp.float32)
                return (start, *update(mask, mask.at[:, dummy].set(0.0), knap, start)), start
            spec = spec._replace(init=init)
        spec = spec._replace(score_rows=lambda state: score[state[0]])
        return jengine.path_log_probs(spec, paths)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _sampled(kind):
    """One routed rollout on the plain route: score, paths, log-probs and
    the instance's array."""
    heu, extra = _inputs(kind, seed=1)
    spec = _spec(kind, torch.from_numpy(heu), extra)
    out = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True,
                         pick=fused_pick_plain)
    return spec.fused[0].detach(), out.paths, out.log_probs.detach(), extra


def _jax_args(i, score, paths, extra):
    return (jnp.asarray(score[i].numpy()), jnp.asarray(paths[i].numpy(), jnp.int32),
            jnp.asarray(paths[i, 0].numpy(), jnp.int32),
            None if extra is None else jnp.asarray(extra[i]))


@pytest.mark.parametrize("kind", list(N_ITEMS))
def test_log_probs_equal_jax_path_log_probs(kind):
    """The routed rollout's log-probabilities against JAX's path_log_probs
    on its own paths: rtol 1e-5, atol 1e-6 (log and logsumexp rounding;
    MKP's parked steps' 0)."""
    score, paths, log_probs, extra = _sampled(kind)
    if kind == "mkp":
        assert bool((paths[:, -1] == score.shape[-1] - 1).all())    # every ant parked
    fn = _jax_log_probs_fn(kind, score.shape[-1], paths.shape[-1])
    for i in range(B):
        ref = fn(*_jax_args(i, score, paths, extra))
        np.testing.assert_allclose(log_probs[i].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["backward_plain", "autograd"])
@pytest.mark.parametrize("kind", list(N_ITEMS))
def test_gradient_equals_jax_grad(kind, route):
    """``d score`` of ``sum(g * log_probs)``: rollout_backward_plain on the
    paths, or autograd through fused_rollout (K7's PyTorch backward a step
    on the CPU), against ``jax.grad`` of ``sum(g * path_log_probs)``;
    rtol 1e-4 and atol 1e-5 of the largest entry (softmax and sum order)."""
    score, paths, _, extra = _sampled(kind)
    n, a = score.shape[-1], paths.shape[-1]
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, paths.shape[1] - 1, a)).astype(np.float32))
    shape = _shape(kind, extra)
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
    fn = _jax_log_probs_fn(kind, n, a)
    for i in range(B):
        def loss(s, i=i):
            return jnp.sum(jnp.asarray(g[i].numpy()) * fn(s, *_jax_args(i, score, paths,
                                                                      extra)[1:]))
        ref = np.asarray(jax.grad(loss)(jnp.asarray(score[i].numpy())))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_mkp_recomputed_mask_is_the_cumulative_mask():
    """Twelve items in three dimensions, four heavy in each (0.3 of a
    capacity of 1, the others 0.01-0.05): as the knapsack fills, the heavy
    items of one dimension close while the others still fit, then the next
    dimension's. Along 64 ants' routed rollouts the open set that K7r
    recomputes from the running knapsack (``_Walk``) equals the plug-in's
    cumulative mask at every step, the dummy opens only once no real item
    does, and the routed rollout equals the step loop."""
    rng = np.random.default_rng(4)
    n, m = 12, 3
    weight = (0.01 + 0.04 * rng.random((1, n, m))).astype(np.float32)
    for d in range(m):
        weight[0, 4 * d:4 * d + 4, d] = 0.3
    weight_e = extend_mkp(torch.zeros((1, n)), torch.from_numpy(weight))[1]
    heu = torch.from_numpy((rng.random((1, n + 1, n + 1)) + 0.05).astype(np.float32))
    spec = mkp_spec(torch.ones_like(heu), heu, weight_e, 1.0, 64)
    out = engine.rollout(spec, torch.Generator().manual_seed(6), require_prob=True)
    step = engine.rollout(spec._replace(fused=None), torch.Generator().manual_seed(6),
                          require_prob=True)
    assert torch.equal(out.paths, step.paths) and torch.equal(out.log_probs, step.log_probs)
    state = spec.init(out.paths[:, 0])
    walk = ro._Walk(out.paths[:, 0], n + 1, spec.fused[1])
    one_at_a_time = False
    for t in range(spec.horizon):
        want = spec.mask(state) > 0
        got = walk.open()
        assert torch.equal(got, want), t
        assert bool((got[..., n] == ~got[..., :n].any(dim=-1)).all())
        # an ant with a dimension's heavy items shut by the knapsack while
        # another's still fit
        shut = ((~walk.closed[..., :n]) & ~got[..., :n]).reshape(1, 64, m, 4).any(dim=-1)
        fit = got[..., :n].reshape(1, 64, m, 4).any(dim=-1)
        one_at_a_time |= bool((shut.any(dim=-1) & fit.any(dim=-1)).any())
        act = out.paths[:, t + 1]
        state = spec.step(state, act)
        walk.step(act)
    assert one_at_a_time
    assert bool((out.paths[:, -1] == n).all())


def _strip(fn):
    return lambda *args, **kw: fn(*args, **kw)._replace(fused=None)


def _per_step_family(name):
    """The family with its ``fused`` field stripped: training and inference
    step through the plug-in a pick at a time, the parent tree's route."""
    fam = families.FAMILIES[name]
    spec = _strip(fam.spec)
    return fam._replace(spec=spec, construct=lambda tau, heu, inst, a, generator, ops:
                        engine.rollout(spec(tau, heu, inst, a), generator,
                                       pick=ops.pick).paths)


@pytest.mark.parametrize("name", ["smtwtp", "sop", "mkp"])
def test_train_step_equals_the_per_step_route(name):
    """One ``make_family_train_step`` step at n=20 (2-layer net, 2 instances,
    6 ants) from the same weights, batch and seed: the routed step (one K7r
    each way on the card) and the per-step one give equal loss, mean cost,
    gradient norm and updated weights, bit for bit."""
    fam = families.get_family(name)
    cfg = config.ProblemConfig(name=name, n_nodes=20, k_sparse=5,
                               model=config.ModelConfig(depth=2),
                               aco=config.ACOSettings(n_ants=6),
                               train=config.TrainConfig(batch_size=2))
    rng = np.random.default_rng(0)
    state = drivers.init_family_state(fam, cfg, rng, torch.Generator().manual_seed(0))
    batch = drivers.gen_batch(fam, rng, 20, 2)
    traced, untraced = engine._FUSED[fused_pick]
    outs, taken = [], []
    for family in (fam, _per_step_family(name)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (lambda *a, f=family: taken.append(f is fam)
                                                   or traced(*a), untraced))
            s, info = drivers.make_family_train_step(family, cfg)(
                copy.deepcopy(state), batch, torch.Generator().manual_seed(4))
        outs.append((info, s.net.state_dict()))
    assert taken == [True]
    (info_r, w_r), (info_s, w_s) = outs
    assert all(torch.equal(x, y) for x, y in zip(info_r, info_s))
    assert w_r.keys() == w_s.keys()
    for k in w_r:
        assert torch.equal(w_r[k], w_s[k]), k


@pytest.mark.parametrize("name,n", [("tsp", 20), ("smtwtp", 20), ("sop", 20), ("mkp", 20)])
def test_inference_route_equals_the_per_step_route(name, n, monkeypatch):
    """``evaluate_family(name, device="cpu")`` (classic heuristic, 3
    instances, 8 ants, T=1 and 3) on the one-launch route (the untraced
    route taken once an iteration) equals the per-step route's costs and
    curves to the digit: the CPU's noise stream did not change."""
    fam = families.get_family(name)
    rng = np.random.default_rng(1)
    insts = [fam.gen(rng, n) for _ in range(3)]
    ds = {k: np.stack([i[k] for i in insts]) for k in insts[0]}
    traced, untraced = engine._FUSED[fused_pick]
    runs, taken = [], []
    for forced in (False, True):
        with monkeypatch.context() as mp:
            mp.setitem(engine._FUSED, fused_pick, (traced, lambda *a: taken.append(forced)
                                                   or untraced(*a)))
            if forced:
                mp.setitem(families.FAMILIES, name, _per_step_family(name))
            runs.append(drivers.evaluate_family(name, ds, n_nodes=n, n_ants=8,
                                                t_values=(1, 3), device="cpu"))
    assert taken == [False] * 3
    (means_r, curves_r), (means_s, curves_s) = runs
    assert torch.equal(curves_r, curves_s) and torch.equal(means_r, means_s)
