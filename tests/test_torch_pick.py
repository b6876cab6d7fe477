"""Port parity: one construction step (ops/pick.py) against the JAX fused
pick kernel in interpret mode and the engine step's math, with the same
noise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.ops.pallas_kernels import NEG_INF, fused_pick_pallas
from deepaco_tpu_torch.ops import pick

A, N = 6, 30


def _inputs(seed):
    """Score rows, a mask with about a third of each row visited (one column
    always open), and Gumbel noise by jax.random.gumbel's f32 law."""
    rng = np.random.default_rng(seed)
    score = rng.standard_normal((A, N)).astype(np.float32) * 2
    mask = (rng.random((A, N)) > 0.35).astype(np.float32)
    mask[np.arange(A), rng.integers(0, N, A)] = 1.0
    u = np.maximum(rng.random((A, N)), np.finfo(np.float32).tiny)
    gumbel = (-np.log(-np.log(u))).astype(np.float32)
    return score, mask, gumbel


def _xla_math(score, mask, gumbel):
    """fused_pick_xla's math (pallas_kernels.py:83-90) with given noise."""
    logits = jnp.where(mask > 0, score, NEG_INF)
    actions = jnp.argmax(logits + gumbel, axis=-1)
    logp = jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1),
                               actions[:, None], axis=-1)[:, 0]
    return actions, logp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_matches_jax_kernel_and_engine_math(seed):
    """Actions exactly equal; logp within rtol 1e-6 / atol 1e-6 (the
    logsumexp's sum order)."""
    score, mask, gumbel = _inputs(seed)
    act, logp = pick.fused_pick(*(torch.from_numpy(a) for a in (score, mask, gumbel)))
    assert act.dtype == torch.int64
    for ref_act, ref_logp in (fused_pick_pallas(score, mask, gumbel),
                              _xla_math(score, mask, gumbel)):
        np.testing.assert_array_equal(act.numpy(), np.asarray(ref_act))
        np.testing.assert_allclose(logp.numpy(), np.asarray(ref_logp), rtol=1e-6, atol=1e-6)
    assert np.all(mask[np.arange(A), act.numpy()] > 0)


def test_pick_backward_matches_jax_grad():
    """d/d score of sum(c * logp) at the sampled actions, against jax.grad
    of the masked log-softmax at those actions (rtol 1e-5 / atol 1e-6);
    zero on masked columns. The wrapper's backward and autograd through
    the plain version agree."""
    score, mask, gumbel = _inputs(3)
    c = np.random.default_rng(4).standard_normal(A).astype(np.float32)
    act, _ = _xla_math(score, mask, gumbel)

    def jloss(s):
        logits = jnp.where(mask > 0, s, NEG_INF)
        lp = jnp.take_along_axis(jax.nn.log_softmax(logits, axis=-1),
                                 act[:, None], axis=-1)[:, 0]
        return jnp.sum(lp * c)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(score)))
    for fn in (pick.fused_pick, pick.fused_pick_plain):
        s = torch.from_numpy(score).requires_grad_(True)
        a, logp = fn(s, torch.from_numpy(mask), torch.from_numpy(gumbel))
        (logp * torch.from_numpy(c)).sum().backward()
        np.testing.assert_allclose(s.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
        assert np.all(s.grad.numpy()[mask == 0] == 0)


def test_pick_takes_the_first_of_equal_maxima_and_nan_first():
    """torch.argmax's order, which K7 repeats: the lowest index among equal
    values, NaN above every number."""
    score = np.zeros((2, 8), np.float32)
    score[1, 5] = np.nan
    mask = np.ones((2, 8), np.float32)
    mask[0, 0] = 0.0
    act, _ = pick.fused_pick(torch.from_numpy(score), torch.from_numpy(mask),
                             torch.zeros(2, 8))
    assert act.tolist() == [1, 5]
