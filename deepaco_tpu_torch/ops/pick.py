"""One sampling step of the construction: masked logits, Gumbel-max action and
the log-softmax at it (counterpart of ``deepaco_tpu/ops/pallas_kernels.py:50-90``,
``fused_pick_pallas``, whose math is that of ``engine.rollout``'s step).

Over rows ``score_rows, mask, gumbel [R, N]`` f32 (``mask > 0`` is open):

    logits = where(mask > 0, score_rows, -1e30)
    action = argmax(logits + gumbel)            first index on ties, NaN highest
    logp   = logits[action] - logsumexp(logits)

- :func:`fused_pick_plain`: that math in PyTorch (autograd differentiates it);
- :func:`fused_pick`: the wrapper, a :class:`FusedPick`. A CPU tensor takes
  the plain forward; a CUDA tensor launches kernel K7 (``csrc/pick.cu``) or
  raises. Its backward is PyTorch on both, ``d_rows = g * (onehot(action) -
  softmax(logits))``, zero on masked columns: XLA differentiates the JAX
  step, and the TPU kernel has no backward either.
"""
from __future__ import annotations

import torch

from deepaco_tpu_torch.ops import _build

NEG_INF = -1e30


def _masked(score_rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, score_rows, NEG_INF)


def fused_pick_plain(score_rows: torch.Tensor, mask: torch.Tensor,
                     gumbel: torch.Tensor):
    """``(action [R] int64, logp [R])`` in PyTorch."""
    logits = _masked(score_rows, mask)
    action = torch.argmax(logits.detach() + gumbel, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
    return action, logp


def _launch(score_rows, mask, gumbel):
    """Allocate the outputs and call K7's entry point."""
    r, n = score_rows.shape
    dev = score_rows.device
    action = torch.empty((r,), dtype=torch.int64, device=dev)
    logp = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return action, logp
    P, I = _build.P, _build.I
    fn = _build.function("deepaco_pick", [P] * 5 + [I] * 2 + [P])
    rc = fn(score_rows.data_ptr(), mask.data_ptr(), gumbel.data_ptr(),
            action.data_ptr(), logp.data_ptr(), r, n, _build.stream_ptr(dev))
    _build.check(rc, "deepaco_pick")
    return action, logp


class FusedPick(torch.autograd.Function):
    """K7 forward on CUDA tensors, the plain forward on CPU tensors; the
    backward of ``logp`` in PyTorch on both."""

    @staticmethod
    def forward(ctx, score_rows, mask, gumbel):
        if score_rows.device.type == "cpu":
            action, logp = fused_pick_plain(score_rows, mask, gumbel)
        else:
            _build.require_cuda("fused_pick", score_rows, mask, gumbel)
            if score_rows.dim() != 2 or mask.shape != score_rows.shape \
                    or gumbel.shape != score_rows.shape:
                raise ValueError("fused_pick: expected score_rows, mask and "
                                 "gumbel of one shape [R, N]")
            if not all(t.dtype == torch.float32 for t in (score_rows, mask, gumbel)):
                raise ValueError("fused_pick: K7 takes f32 score_rows, mask and gumbel")
            action, logp = _launch(score_rows.contiguous(), mask.contiguous(),
                                   gumbel.contiguous())
            fused_pick.launches += 1
        ctx.save_for_backward(score_rows, mask, action)
        ctx.mark_non_differentiable(action)
        return action, logp

    @staticmethod
    def backward(ctx, _d_action, d_logp):
        score_rows, mask, action = ctx.saved_tensors
        d = -torch.softmax(_masked(score_rows, mask), dim=-1)
        d.scatter_add_(-1, action[:, None], torch.ones_like(d[:, :1]))
        d = torch.where(mask > 0, d * d_logp[:, None], 0.0)
        return d, None, None


def fused_pick(score_rows: torch.Tensor, mask: torch.Tensor,
               gumbel: torch.Tensor):
    """``(action [R] int64, logp [R])`` of one construction step, ``logp``
    differentiable in ``score_rows``; on CUDA one launch of K7."""
    return FusedPick.apply(score_rows, mask, gumbel)


fused_pick.launches = 0
