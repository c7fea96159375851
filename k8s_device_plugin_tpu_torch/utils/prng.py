"""jax's threefry PRNG in PyTorch, bit for bit.

The port's own copy of what the serving engine draws from
``jax.random`` (jax 0.9.0, ``jax_default_prng_impl = threefry2x32``,
``jax_threefry_partitionable = True``): the Threefry-2x32 hash, legacy
``PRNGKey`` keys, ``split``, ``fold_in``, 32-bit ``random_bits``,
float32 ``uniform``, ``gumbel`` (mode "low") and ``categorical``.  With the
same key and shapes, ``split``, ``fold_in``, ``random_bits`` and
``uniform`` give jax's exact bits; ``gumbel`` takes two logarithms, whose
last bit may differ between libraries, so a categorical draw equals jax's
wherever the top two of logits + gumbel are not within an ulp.

A key is an int64 tensor ``[2]`` holding the two uint32 words (torch's
``uint32`` lacks most operations): every value stays in [0, 2^32), sums
are masked back to 32 bits, and everything is a tensor operation on the
key's device, so draws run inside a captured CUDA graph.

Partitionable layout: the hash of element i of a shape (row-major) takes
the 64-bit counter i as its two words (high, low), and 32-bit random bits
are the two output words xor-ed; ``split(key, n)`` takes the two output
words of counter i as new key i.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32 as jax draws it: 23 mantissa bits under the exponent of 1.0.
_NMANT = 23
_ONE_BITS = 0x3F800000
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``x1``, ``x2``
    under key words ``k1``, ``k2`` (broadcastable int64 tensors of uint32
    values); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax builds it without x64: the seed
    as a 32-bit integer (the high word dropped), so the words are (0,
    seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _counters(n: int, device):
    """The partitionable counters of n elements: (high, low) words of
    0..n-1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    data = torch.full((), int(data) & _M32, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([b1, b2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2^32)."""
    shape = tuple(shape)
    n = 1
    for dim in shape:
        n *= dim
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top 23
    bits as the mantissa of a number in [1, 2), minus 1, scaled to
    [minval, maxval) and clamped at minval, in float32.  XLA compiles the
    scale and shift to one fused multiply-add: here the product of two
    24-bit mantissas is exact in float64 and the sum rounds to float32
    (through float64 first, which can differ only where that rounding lands
    on a float32 tie; with [tiny, 1), gumbel's range, the sum is exact)."""
    bits = random_bits(key, shape)
    floats = ((bits >> (32 - _NMANT)) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # The bounds as float32 values (Python floats hold them exactly): no
    # tensor is made from host data, so the draw captures in a graph.
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (floats.double() * scale + lo).float().clamp_min(lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in mode "low":
    -log(-log(u)) with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: argmax over ``axis`` of
    logits + gumbel noise of the logits' shape (float32 logits)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=axis)
