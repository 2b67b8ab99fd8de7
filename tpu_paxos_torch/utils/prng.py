"""Deterministic randomness: threefry2x32, bit-exact with ``jax.random``.

The JAX package draws every coin from counter-based ``jax.random`` keys
with ``jax_threefry_partitionable=True`` pinned
(``tpu_paxos/utils/prng.py``): each consumer folds a static stream tag
and the round number into the root key, so randomness is a pure
function of (seed, tag, round).  The port reproduces those bits
exactly, which is what lets a decision log match the reference byte
for byte.

Keys are ``(k1, k2)`` tuples of Python ints in ``[0, 2**32)``: every
key operation the engine needs (seed, ``fold_in``, ``split``) acts on
one key, and Python ints make those cheap and device-free.  Bit draws
are torch ``int64`` tensors on the CPU holding uint32 words, masked
with ``& 0xFFFFFFFF`` after every op that can overflow (torch's
``uint32`` has too few ops to rely on).  The one hash,
:func:`_threefry2x32`, is written with operators only, so the same code
runs on Python ints and on int64 tensors.

Followed from ``jax/_src/prng.py`` (``threefry_2x32``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and
``jax/_src/random.py::_randint`` (two bit draws, a span multiplier,
unsigned arithmetic).
"""

from __future__ import annotations

import torch

# Stable stream tags (fold_in indices), as in the JAX package.
STREAM_PREPARE_DELAY = 0
STREAM_NET_DROP = 1
STREAM_NET_DUP = 2
STREAM_NET_DELAY = 3
STREAM_CRASH = 4
STREAM_WORKLOAD = 5

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 words carried in Python
    ints or int64 tensors (the unrolled lowering in jax/_src/prng.py)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for step in range(5):
        for r in _ROT[step % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(step + 1) % 3]) & _M
        x2 = (x2 + ks[(step + 2) % 3] + step + 1) & _M
    return x1, x2


def root_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit ints disabled: the seed
    becomes an int32, whose logical shift by 32 is 0."""
    s = int(seed)
    if not _I32_MIN <= s <= _I32_MAX:
        raise ValueError(f"seed {seed} does not fit int32")
    return 0, s & _M


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: hash the count pair (0, data) under key."""
    return _threefry2x32(key[0], key[1], 0, int(data) & _M)


def stream(key: tuple[int, int], tag: int, round_idx: int) -> tuple[int, int]:
    """Key for one (stream, round) — pure function of its inputs."""
    return fold_in(fold_in(key, tag), round_idx)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (fold-like, partitionable): key j hashes the
    count pair (0, j)."""
    return [_threefry2x32(key[0], key[1], 0, j) for j in range(num)]


def _bits_many(keys: list[tuple[int, int]], sizes: list[int]) -> torch.Tensor:
    """32-bit draws for several keys in one hash pass: request r gives
    ``sizes[r]`` words hashed from counts 0..n-1 under ``keys[r]``
    (partitionable bits: ``bits1 ^ bits2``), concatenated."""
    n = torch.tensor(sizes, dtype=torch.int64)
    total = int(n.sum())
    k1 = torch.repeat_interleave(torch.tensor([k[0] for k in keys], dtype=torch.int64), n)
    k2 = torch.repeat_interleave(torch.tensor([k[1] for k in keys], dtype=torch.int64), n)
    starts = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    counts = torch.arange(total, dtype=torch.int64) - starts
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return b1 ^ b2


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """uint32 words (in int64) of the given shape, as
    ``jax.random.bits(key, shape, uint32)``."""
    size = 1
    for d in shape:
        size *= int(d)
    return _bits_many([key], [size]).reshape(shape)


def _mulmod32(a, b):
    """(a * b) mod 2**32 for words < 2**32 without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def _span_offset(hi_bits, lo_bits, lo, hi):
    """``_randint``'s unsigned combination of two draws into
    ``[lo, hi)`` (span 1 when ``hi <= lo``), returned as int32."""
    lo = torch.clamp(torch.as_tensor(lo, dtype=torch.int64), _I32_MIN, _I32_MAX)
    hi = torch.clamp(torch.as_tensor(hi, dtype=torch.int64), _I32_MIN, _I32_MAX)
    span = (hi - lo) & _M
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = (1 << 16) % span
    mult = _mulmod32(mult, mult) % span
    off = (_mulmod32(hi_bits % span, mult) + lo_bits % span) & _M
    off = off % span
    val = (lo + off) & _M
    return torch.where(val > _I32_MAX, val - (1 << 32), val).to(torch.int32)


def randint_many(requests) -> list[torch.Tensor]:
    """Several ``jax.random.randint(key, shape, lo, hi)`` draws (int32)
    from ONE batched hash pass.  ``requests`` is a list of
    ``(key, shape, lo, hi)``; ``lo``/``hi`` are ints or int tensors
    broadcastable to ``shape``.  Each draw is bit-identical to its own
    ``jax.random.randint`` call: it splits its key in two and combines
    a high and a low 32-bit draw exactly as ``_randint`` does."""
    keys, sizes, shapes = [], [], []
    for key, shape, _, _ in requests:
        shape = tuple(int(d) for d in shape)
        size = 1
        for d in shape:
            size *= d
        k_hi, k_lo = split(key, 2)
        keys += [k_hi, k_lo]
        sizes += [size, size]
        shapes.append(shape)
    bits = torch.split(_bits_many(keys, sizes), sizes) if keys else []
    out = []
    for r, (_, _, lo, hi) in enumerate(requests):
        shape = shapes[r]
        out.append(
            _span_offset(
                bits[2 * r].reshape(shape), bits[2 * r + 1].reshape(shape), lo, hi
            ).reshape(shape)
        )
    return out


def randint(key: tuple[int, int], shape, lo, hi) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` with int32 output."""
    return randint_many([(key, shape, lo, hi)])[0]
