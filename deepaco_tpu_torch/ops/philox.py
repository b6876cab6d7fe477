"""The noise that kernels K2 and K7c draw, in PyTorch: the counterpart of
``csrc/common.cuh``'s ``philox4x32_10`` and ``philox_word``, and the laws
that turn a word into Gumbel noise.

Each call of K2 (``aco/batched_tsp.dense_sweep_fused``) or K7c
(``ops/cvrp_construct.cvrp_construct``) draws one key with
:func:`draw_seed` from the caller's generator. The word of column ``c`` at
step ``s`` for ant row ``r`` is word ``c % 4`` of Philox4x32-10 at the
counter ``(c // 4, s, r, 0)`` under that key (:func:`philox_bits`). K2
turns it into noise by :func:`gumbel_bf16_from_bits` (through a table) or
:func:`gumbel_f32_from_bits`, K7c by :func:`gumbel_f32_from_bits`. The
plain versions of both kernels draw their noise here.
"""
from __future__ import annotations

import torch

_TINY = 1.1754944e-38      # smallest normal f32 = finfo(bfloat16).tiny
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One call's Philox key for K2 or K7c: an int64 in [0, 2^62) drawn from
    ``generator``, on ``device``."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device).to(device)


def gumbel_bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The bf16 Gumbel law of the JAX sweep (``jax.random.gumbel(dtype=bf16)``
    and pallas_kernels.py:489-495), from 32 random bits per draw: a 7-bit
    uniform ``u = max(((bits >> 13) & 0x7F) * 2^-7, tiny)``, then
    ``g = bf16(-log(f32(bf16(-log u))))``. It takes 128 values and truncates
    the right tail near +4.85."""
    k = (bits >> 13) & 0x7F
    u = torch.clamp(k.float() * (2.0 ** -7), min=_TINY)
    inner = (-torch.log(u)).to(torch.bfloat16)
    return (-torch.log(inner.float())).to(torch.bfloat16)


def gumbel_f32_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Full-width f32 Gumbel noise: ``u = ((bits >> 9) + 0.5) * 2^-23`` in
    (0, 1), ``g = -log(-log u)``."""
    u = ((bits >> 9) & 0x7FFFFF).float().add(0.5).mul(2.0 ** -23)
    return -torch.log(-torch.log(u))


def _mulhilo(m: int, x: torch.Tensor):
    """``(m * x) >> 32`` and ``(m * x) & 0xFFFFFFFF`` for 32-bit ``m`` and
    int64 ``x`` in [0, 2^32), in int64 by 16-bit halves of ``x`` (``m * x``
    itself overflows int64)."""
    p_lo = (x & 0xFFFF) * m                      # < 2^48
    p_hi = (x >> 16) * m                         # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)         # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of the counters ``(c0, c1, c2, c3)`` (int64 tensors of
    one shape, each in [0, 2^32)) under the 64-bit ``key`` (low word first),
    as ``csrc/common.cuh`` computes it: the four output words, int64."""
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_bits(key: int, step0: int, steps: int, ants: int, n: int,
                device) -> torch.Tensor:
    """The random words ``[steps, ants, n]`` (int64 in [0, 2^32)) of steps
    ``step0 ..`` for ant rows ``0 .. ants-1`` and columns ``0 .. n-1``: word
    ``c % 4`` of the counter ``(c // 4, step, ant, 0)``, as K2 and K7c draw
    them."""
    groups = (n + 3) // 4
    shape = (steps, ants, groups)
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)
    c0 = ar(groups).expand(shape)
    c1 = (ar(steps) + step0)[:, None, None].expand(shape)
    c2 = ar(ants)[None, :, None].expand(shape)
    words = philox4x32_10(c0, c1, c2, torch.zeros(shape, dtype=torch.int64, device=device), key)
    return torch.stack(words, dim=-1).reshape(steps, ants, 4 * groups)[..., :n]


def philox_gumbel(key: int, step0: int, steps: int, ants: int, n: int,
                  device) -> torch.Tensor:
    """The noise ``[steps, ants, n]`` f32 of :func:`philox_bits`' words."""
    return gumbel_f32_from_bits(philox_bits(key, step0, steps, ants, n, device))
