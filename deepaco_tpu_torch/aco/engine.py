"""The Gumbel-max construction engine (counterpart of
``deepaco_tpu/aco/engine.py:30-171``), batched over instances.

A problem plugs in through :class:`RolloutSpec`; all ants of all instances
move together, one step per loop iteration over rows ``[B*A, N]``. Sampling
takes the Gumbel-max of ``alpha*log(phe) + beta*log(heu)`` under the
feasibility mask, the same law as the reference's
``Categorical(phe**alpha * heu**beta * mask)`` (tsp/aco.py:165-177).
``rollout(require_prob=True)`` also returns the log-probability of each
sampled action, differentiable in the plug-in's score matrix: each step is
one :func:`~deepaco_tpu_torch.ops.pick.fused_pick` (kernel K7 on the card).

Gumbel noise follows ``jax.random.gumbel``'s f32 law, ``-log(-log U)`` with
``U`` uniform on ``[tiny, 1)``, drawn from the caller's ``torch.Generator``;
the streams differ from JAX's, so the two agree in law, not draw for draw.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from deepaco_tpu_torch.ops.pick import fused_pick

NEG_INF = -1e30
_TINY = 1.1754944e-38            # smallest normal f32


class RolloutSpec(NamedTuple):
    """Problem plug-in, over ``B`` instances and ``A`` ants:

    horizon:    construction steps after the start action;
    start:      ``generator -> start actions [B, A]``;
    init:       ``start [B, A] -> state``;
    prob_rows:  ``state -> (phe_rows, heu_rows) [B, A, M]``;
    mask:       ``state -> [B, A, M]`` feasibility (> 0 allowed), at least
                one open action per ant;
    step:       ``(state, actions [B, A]) -> state``;
    score_rows: optional ``state -> [B, A, M]`` pre-combined scores
                (alpha, beta already applied); the engine then ignores its
                own alpha and beta.
    """

    horizon: int
    start: Callable[[torch.Generator], torch.Tensor]
    init: Callable[[torch.Tensor], Any]
    prob_rows: Callable[[Any], tuple[torch.Tensor, torch.Tensor]]
    mask: Callable[[Any], torch.Tensor]
    step: Callable[[Any, torch.Tensor], Any]
    score_rows: Callable[[Any], torch.Tensor] | None = None


class Rollout(NamedTuple):
    """paths ``[B, horizon+1, A]`` int64, row 0 the start; log_probs
    ``[B, horizon, A]`` (zeros unless ``require_prob``); the final state."""

    paths: torch.Tensor
    log_probs: torch.Tensor
    state: Any


def _log_scores(phe_rows, heu_rows, alpha, beta):
    """``alpha*log(phe) + beta*log(heu)``, both floored at 1e-30, a normal
    f32, so that the backward of ``log`` stays finite."""
    return (alpha * torch.log(torch.clamp(phe_rows, min=1e-30))
            + beta * torch.log(torch.clamp(heu_rows, min=1e-30)))


def masked_logits(phe_rows, heu_rows, mask, alpha, beta):
    """Log-space scores with masked entries at -1e30."""
    return torch.where(mask > 0, _log_scores(phe_rows, heu_rows, alpha, beta), NEG_INF)


def _step_scores(spec: RolloutSpec, state, alpha, beta) -> torch.Tensor:
    """The step's scores ``[B, A, M]`` before the mask, through whichever
    interface the plug-in provides (engine.py:93-103). The pick applies the
    mask itself, so the rollout launches no masking pass of its own."""
    if spec.score_rows is not None:
        return spec.score_rows(state)
    return _log_scores(*spec.prob_rows(state), alpha, beta)


def _step_logits(spec: RolloutSpec, state, alpha, beta) -> torch.Tensor:
    """The step's masked logits ``[B, A, M]``."""
    return torch.where(spec.mask(state) > 0, _step_scores(spec, state, alpha, beta),
                       NEG_INF)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """f32 Gumbel noise by ``jax.random.gumbel``'s law."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (-torch.log(-torch.log(u.clamp_(min=_TINY)))).to(device)


def rollout(spec: RolloutSpec, generator: torch.Generator, *, alpha: float = 1.0,
            beta: float = 1.0, require_prob: bool = False) -> Rollout:
    """Construct every ant's solution (``ACO.gen_path``, tsp/aco.py:134-163),
    one :func:`fused_pick` a step (K7 on the card)."""
    start = spec.start(generator)
    state = spec.init(start)
    b, a = start.shape
    actions, log_probs = [start], []
    for _ in range(spec.horizon):
        scores = _step_scores(spec, state, alpha, beta)
        m = scores.shape[-1]
        noise = gumbel(scores.shape, generator, scores.device)
        with torch.set_grad_enabled(require_prob and torch.is_grad_enabled()):
            act, logp = fused_pick(scores.reshape(b * a, m),
                             spec.mask(state).reshape(b * a, m),
                             noise.reshape(b * a, m))
        act = act.reshape(b, a)
        log_probs.append(logp.reshape(b, a) if require_prob
                         else torch.zeros((b, a), device=scores.device))
        state = spec.step(state, act)
        actions.append(act)
    return Rollout(torch.stack(actions, dim=1), torch.stack(log_probs, dim=1),
                   state)


def path_log_probs(spec: RolloutSpec, paths: torch.Tensor, *,
                   alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """Log-probabilities ``[B, horizon, A]`` of the given ``paths [B,
    horizon+1, A]`` (teacher-forced, from ``paths[:, 0]``), differentiable,
    in plain PyTorch as the JAX package leaves it to XLA."""
    state = spec.init(paths[:, 0])
    out = []
    for t in range(1, paths.shape[1]):
        act = paths[:, t]
        logp = torch.log_softmax(_step_logits(spec, state, alpha, beta), dim=-1)
        out.append(logp.gather(-1, act[..., None])[..., 0])
        state = spec.step(state, act)
    return torch.stack(out, dim=1)


@torch.no_grad()
def greedy_rollout(spec: RolloutSpec, generator: torch.Generator, *,
                   alpha: float = 1.0, beta: float = 1.0) -> Rollout:
    """Deterministic argmax construction, no noise (greedy decode)."""
    start = spec.start(generator)
    state = spec.init(start)
    actions = [start]
    for _ in range(spec.horizon):
        act = torch.argmax(_step_logits(spec, state, alpha, beta), dim=-1)
        state = spec.step(state, act)
        actions.append(act)
    paths = torch.stack(actions, dim=1)
    return Rollout(paths, torch.zeros((start.shape[0], spec.horizon, start.shape[1]),
                                      device=paths.device), state)
