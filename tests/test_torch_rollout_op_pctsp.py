"""Port parity: the one-launch rollout (ops/rollout.py, kernel K7r on the
card) for the OP and PCTSP plug-ins, on the CPU.

- the routed ``engine.rollout`` against the per-step loop (the same plug-in
  without its ``fused`` field), with and without ``require_prob``, bit for
  bit: paths, log-probabilities and the generator's next draw;
- one noise draw ``[T, B, A, N]`` against T draws ``[B, A, N]`` from a CPU
  generator at OP300's and PCTSP500's widths;
- its log-probabilities against JAX's ``path_log_probs`` on the same paths,
  and ``rollout_backward_plain`` and autograd through ``fused_rollout``
  against ``jax.grad`` of ``sum(g * path_log_probs)`` in the score;
- OP's cumulative mask on a distance that is no metric, where recomputing
  the budget from the running tour length alone would reopen a column;
- PCTSP's depot gate opening by prize and by visiting every customer;
- parked steps (OP on the dummy, PCTSP back at the depot) with
  log-probability exactly 0;
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
from deepaco_tpu.aco.problems import op as jop
from deepaco_tpu.aco.problems import pctsp as jpctsp
from deepaco_tpu_torch import families
from deepaco_tpu_torch.aco import engine
from deepaco_tpu_torch.aco.problems.op import extend_op_instance, op_spec, validate_op
from deepaco_tpu_torch.aco.problems.pctsp import pctsp_spec, validate_pctsp
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


B, A, N = 2, 5, 20                      # instances, ants, real nodes (OP) or customers (PCTSP)
KINDS = ("op", "pctsp")
OP_BUDGETS = (2.0, 3.0)                 # a budget an instance, so that ants reach the dummy


def _inputs(kind, seed=0):
    """A heuristic in (0.05, 1.05) over the plug-in's nodes and the
    instance's own arrays: OP's dummy-extended distances ``[B, N+1, N+1]``
    and budgets ``[B]``; PCTSP's prizes ``[B, N+1]`` (the depot first)."""
    rng = np.random.default_rng(seed)
    if kind == "op":
        dist = torch.from_numpy(np.stack([families.gen_op(rng, N)["dist"] for _ in range(B)]))
        extra = (extend_op_instance(dist, dist[..., 0], dist)[0].numpy(),
                 np.asarray(OP_BUDGETS, np.float32))
    else:
        extra = np.stack([families.gen_pctsp(rng, N)["prizes"] for _ in range(B)])
    heu = (rng.random((B, N + 1, N + 1)) + 0.05).astype(np.float32)
    return heu, extra


def _spec(kind, heu, extra, a=A):
    ones = torch.ones_like(heu)
    if kind == "op":
        return op_spec(ones, heu, torch.from_numpy(extra[0]), torch.from_numpy(extra[1]), a)
    return pctsp_spec(ones, heu, torch.from_numpy(extra), N / 4.0, a)


@pytest.mark.parametrize("require_prob", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("pick", [fused_pick_plain, fused_pick], ids=["plain", "k7"])
@pytest.mark.parametrize("kind", KINDS)
def test_routed_rollout_equals_the_step_loop(kind, pick, require_prob):
    """The fused route draws the noise of all steps in one call: paths,
    log-probabilities (zeros without ``require_prob``) and the generator's
    next draw bit-equal to the per-step loop's."""
    heu, extra = _inputs(kind)
    spec = _spec(kind, torch.from_numpy(heu), extra)
    assert spec.fused is not None and spec.fused[1].kind == kind
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


@pytest.mark.parametrize("t,b,a,n", [(301, 1, 2, 301), (502, 1, 2, 501)],
                         ids=["op300", "pctsp500"])
def test_one_noise_draw_is_the_steps_draws(t, b, a, n):
    """``gumbel((T, B, A, N))`` from a CPU generator gives the very numbers
    of T calls ``gumbel((B, A, N))``, at OP300's and PCTSP500's widths."""
    one = engine.gumbel((t, b, a, n), torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    steps = torch.stack([engine.gumbel((b, a, n), gen, "cpu") for _ in range(t)])
    assert torch.equal(one, steps)


def _jax_log_probs_fn(kind, a):
    """``(score [M, M], paths [L, A], extra) -> log_probs [L-1, A]``, JAX's
    path_log_probs on the JAX plug-in with its score rows read from
    ``score``, jitted (OP: ``extra`` the extended distances and the budget;
    PCTSP: the prizes, the gate n / 4 in f32)."""
    ones = jnp.ones((N + 1, N + 1), jnp.float32)

    def fn(score, paths, extra):
        if kind == "op":
            spec = jop.op_spec(ones, ones, extra[0], extra[1], a)
        else:
            spec = jpctsp.pctsp_spec(ones, ones, extra, jnp.asarray(N / 4.0, jnp.float32), a)
        spec = spec._replace(score_rows=lambda state: score[state[0]])
        return jengine.path_log_probs(spec, paths)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _sampled(kind):
    """One routed rollout on the plain route: score, paths, log-probs and
    the instance's arrays."""
    heu, extra = _inputs(kind, seed=1)
    spec = _spec(kind, torch.from_numpy(heu), extra)
    out = engine.rollout(spec, torch.Generator().manual_seed(3), require_prob=True,
                         pick=fused_pick_plain)
    return spec.fused[0].detach(), out.paths, out.log_probs.detach(), extra, spec.fused[1]


def _jax_args(i, score, paths, kind, extra):
    own = ((jnp.asarray(extra[0][i]), jnp.asarray(extra[1][i])) if kind == "op"
           else jnp.asarray(extra[i]))
    return jnp.asarray(score[i].numpy()), jnp.asarray(paths[i].numpy(), jnp.int32), own


@pytest.mark.parametrize("kind", KINDS)
def test_log_probs_equal_jax_path_log_probs(kind):
    """The routed rollout's log-probabilities against JAX's path_log_probs
    on its own paths: rtol 1e-5, atol 1e-6 (log and logsumexp rounding;
    the parked steps' 0)."""
    score, paths, log_probs, extra, _ = _sampled(kind)
    fn = _jax_log_probs_fn(kind, paths.shape[-1])
    for i in range(B):
        ref = fn(*_jax_args(i, score, paths, kind, extra))
        np.testing.assert_allclose(log_probs[i].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["backward_plain", "autograd"])
@pytest.mark.parametrize("kind", KINDS)
def test_gradient_equals_jax_grad(kind, route):
    """``d score`` of ``sum(g * log_probs)``: rollout_backward_plain on the
    paths, or autograd through fused_rollout (K7's PyTorch backward a step
    on the CPU), against ``jax.grad`` of ``sum(g * path_log_probs)``;
    rtol 1e-4 and atol 1e-5 of the largest entry (softmax and sum order)."""
    score, paths, _, extra, shape = _sampled(kind)
    n, a = score.shape[-1], paths.shape[-1]
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, paths.shape[1] - 1, a)).astype(np.float32))
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
    fn = _jax_log_probs_fn(kind, a)
    for i in range(B):
        def loss(s, i=i):
            return jnp.sum(jnp.asarray(g[i].numpy())
                           * fn(s, *_jax_args(i, score, paths, kind, extra)[1:]))
        ref = np.asarray(jax.grad(loss)(jnp.asarray(score[i].numpy())))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_parked_steps_are_certain(kind):
    """Every step taken from the park (OP: the dummy; PCTSP: the depot
    after a depot pick) has log-probability exactly 0, and every ant parks
    before the horizon ends."""
    score, paths, log_probs, _, shape = _sampled(kind)
    park = shape.dummy if kind == "op" else 0
    at = paths[:, :-1] == park
    if kind == "pctsp":
        at[:, 0] = False                          # the start is no pick
    assert bool(at[:, -1].all())
    assert bool((log_probs[at] == 0.0).all()) and bool((log_probs[~at] < 0.0).any())


def test_op_mask_is_cumulative_on_a_distance_that_is_no_metric():
    """Six real nodes at random distances (no metric) and a budget of 3.
    Node 2 is out of reach from the depot (2.9 out, 0.5 back) and within
    reach from node 1 (0.2 to node 1, 0.3 on, 0.5 back): the plug-in keeps
    it shut once it failed. Along 64 ants' routed rollouts (the heuristic
    sends most to node 1 first) the open set that K7r keeps (``_Walk``)
    equals the plug-in's mask at every step, the mask recomputed from the
    tour length alone differs from it on some ant and step, and the routed
    rollout equals the step loop."""
    rng = np.random.default_rng(4)
    n, ants = 6, 64
    dist = (0.3 + 0.4 * rng.random((1, n, n))).astype(np.float32)
    dist[0, 0, 1] = dist[0, 1, 0] = 0.2
    dist[0, 0, 2], dist[0, 2, 0], dist[0, 1, 2] = 2.9, 0.5, 0.3
    heu = (rng.random((1, n, n)) + 0.05).astype(np.float32)
    heu[0, 0, 1] = 50.0
    dist_e, _, heu_e = extend_op_instance(torch.from_numpy(dist), torch.ones((1, n)),
                                          torch.from_numpy(heu))
    spec = op_spec(torch.ones_like(heu_e), heu_e, dist_e, 3.0, ants)
    out = engine.rollout(spec, torch.Generator().manual_seed(6), require_prob=True)
    step = engine.rollout(spec._replace(fused=None), torch.Generator().manual_seed(6),
                          require_prob=True)
    assert torch.equal(out.paths, step.paths) and torch.equal(out.log_probs, step.log_probs)
    state = spec.init(out.paths[:, 0])
    walk = ro._Walk(out.paths[:, 0], n + 1, spec.fused[1])
    visited = torch.zeros((1, ants, n + 1), dtype=torch.bool)
    visited[..., 0] = True
    differs = False
    for t in range(spec.horizon):
        want = spec.mask(state) > 0
        assert torch.equal(walk.open(), want), t
        cur = out.paths[:, t]
        trails = walk.travel[..., None] + dist_e[0, cur] + dist_e[..., :, 0][:, None]
        again = ~visited[..., :n] & (trails[..., :n] <= 3.0)
        differs |= bool(((again != want[..., :n]) & (cur != n)[..., None]).any())
        act = out.paths[:, t + 1]
        state = spec.step(state, act)
        walk.step(act)
        visited.scatter_(-1, act[..., None], True)
    assert differs
    assert bool(validate_op(out.paths, dist_e[..., :n, :n], 3.0).all())


def test_pctsp_gate_opens_by_prize_and_by_visiting_every_customer():
    """Eight customers, the gate 8 / 4 = 2. Instance 0's prizes (0.6-1.0)
    pass the gate after a few customers; instance 1's (0.01) sum to 0.08,
    so its depot opens only once every customer is visited. Along 64 ants'
    routed rollouts (equal to the step loop) instance 0's gates open by
    prize with customers left, instance 1's by the last customer with the
    prize below the gate; every path meets the gate and parks."""
    rng = np.random.default_rng(5)
    n, ants = 8, 64
    prizes = np.zeros((2, n + 1), np.float32)
    prizes[0, 1:] = 0.6 + 0.4 * rng.random(n)
    prizes[1, 1:] = 0.01
    heu = torch.from_numpy((rng.random((2, n + 1, n + 1)) + 0.05).astype(np.float32))
    prizes = torch.from_numpy(prizes)
    spec = pctsp_spec(torch.ones_like(heu), heu, prizes, n / 4.0, ants)
    out = engine.rollout(spec, torch.Generator().manual_seed(8), require_prob=True)
    step = engine.rollout(spec._replace(fused=None), torch.Generator().manual_seed(8),
                          require_prob=True)
    assert torch.equal(out.paths, step.paths) and torch.equal(out.log_probs, step.log_probs)
    walk = ro._Walk(out.paths[:, 0], n + 1, spec.fused[1])
    by_prize = torch.zeros((2, ants), dtype=torch.bool)
    by_all = torch.zeros((2, ants), dtype=torch.bool)
    for t in range(spec.horizon):
        was = walk.gate.clone()
        walk.step(out.paths[:, t + 1])
        opened = walk.gate & ~was
        left = ~walk.closed[..., 1:].all(dim=-1)
        by_prize |= opened & left & (walk.collected > n / 4.0)
        by_all |= opened & ~left & (walk.collected <= n / 4.0)
    assert bool(by_prize[0].all()) and not bool(by_all[0].any())
    assert bool(by_all[1].all()) and not bool(by_prize[1].any())
    assert bool(validate_pctsp(out.paths, prizes, n / 4.0).all())


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


@pytest.mark.parametrize("name", KINDS)
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


@pytest.mark.parametrize("name", KINDS)
def test_inference_route_equals_the_per_step_route(name, monkeypatch):
    """``evaluate_family(name, device="cpu")`` (classic heuristic, 3
    instances of 20 nodes, 8 ants, T=1 and 3) on the one-launch route (the
    untraced route taken once an iteration) equals the per-step route's
    costs and curves to the digit: the CPU's noise stream did not change."""
    fam = families.get_family(name)
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
                mp.setitem(families.FAMILIES, name, _per_step_family(name))
            runs.append(drivers.evaluate_family(name, ds, n_nodes=N, n_ants=8,
                                                t_values=(1, 3), device="cpu"))
    assert taken == [False] * 3
    (means_r, curves_r), (means_s, curves_s) = runs
    assert torch.equal(curves_r, curves_s) and torch.equal(means_r, means_s)
