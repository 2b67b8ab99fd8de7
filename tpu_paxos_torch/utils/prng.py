"""Deterministic randomness: threefry2x32, bit-exact with ``jax.random``.

The JAX package draws every coin from counter-based ``jax.random`` keys
with ``jax_threefry_partitionable=True`` pinned
(``tpu_paxos/utils/prng.py``): each consumer folds a static stream tag
and the round number into the root key, so randomness is a pure
function of (seed, tag, round).  The port reproduces those bits
exactly, which is what lets a decision log match the reference byte
for byte.

A key is a ``(k1, k2)`` tuple of Python ints in ``[0, 2**32)``, or, for
the lanes of a fleet, a numpy uint64 array ``[..., 2]`` (one key per
lane); key operations (seed, ``fold_in``, ``split``) run on the host.
Bit draws are torch ``int64`` tensors holding uint32 words, masked with
``& 0xFFFFFFFF`` after every op that can overflow (torch's ``uint32``
has too few ops to rely on), hashed on the device that uses them.  The
one hash, :func:`_threefry2x32`, is written with operators only, so the
same code runs on Python ints, numpy arrays and int64 tensors.

Followed from ``jax/_src/prng.py`` (``threefry_2x32``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and
``jax/_src/random.py::_randint`` (two bit draws, a span multiplier,
unsigned arithmetic).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_paxos_torch.utils import device as devm

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


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """uint32 words (in int64) of the given shape, as
    ``jax.random.bits(key, shape, uint32)``."""
    size = int(np.prod(shape, dtype=np.int64))
    keys = np.asarray([key], np.uint64)
    return _bits_many_arr(keys, np.asarray([size], np.int64), torch.device("cpu")).reshape(shape)


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
    """Several ``jax.random.randint(key, shape, lo, hi)`` draws (int32,
    on the CPU) from ONE batched hash pass: :func:`randint_lanes` with
    one lane.  ``requests`` is a list of ``(key, shape, lo, hi)``;
    ``lo``/``hi`` are ints or int tensors broadcastable to ``shape``."""
    out = randint_lanes([
        (np.asarray([key], np.uint64), shape, lo, hi) for key, shape, lo, hi in requests
    ])
    return [x[0] for x in out]


def randint(key: tuple[int, int], shape, lo, hi) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` with int32 output."""
    return randint_many([(key, shape, lo, hi)])[0]


# ------------------------------------------------------------ lane keys
#
# A round draws every lane's coins together: keys are then numpy uint64
# arrays of shape [..., 2] (k1, k2 in the last axis), one key per lane,
# and the same operator-only hash runs on them; the words themselves are
# hashed on the device that uses them.


def root_keys(seeds) -> np.ndarray:
    """:func:`root_key` of every seed: ``[L, 2]`` uint64."""
    return np.asarray([root_key(s) for s in seeds], np.uint64).reshape(-1, 2)


def fold_in_keys(keys: np.ndarray, data: int) -> np.ndarray:
    """:func:`fold_in` of every key in ``[..., 2]``."""
    zero = np.zeros(keys.shape[:-1], np.uint64)
    x1, x2 = _threefry2x32(keys[..., 0], keys[..., 1], zero, zero + (int(data) & _M))
    return np.stack([x1, x2], axis=-1)


def stream_keys(keys: np.ndarray, tag: int, round_idx: int) -> np.ndarray:
    """:func:`stream` of every key in ``[..., 2]``."""
    return fold_in_keys(fold_in_keys(keys, tag), round_idx)


def split_keys(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """:func:`split` of every key in ``[..., 2]``: ``[..., num, 2]``."""
    k1 = keys[..., 0, None]
    k2 = keys[..., 1, None]
    j = np.arange(num, dtype=np.uint64)
    x1, x2 = _threefry2x32(k1, k2, np.zeros_like(j), j)
    return np.stack(np.broadcast_arrays(x1, x2), axis=-1)


def randint_lanes(requests, device=None) -> list[torch.Tensor]:
    """Several per-lane ``jax.random.randint`` draws from ONE hash pass
    on ``device`` (the CPU by default).  Each request is ``(keys [L, 2],
    shape, lo, hi)`` with the same ``L``: lane ``l`` draws
    ``randint(keys[l], shape, lo, hi)``, bit-identical to its own call;
    ``lo``/``hi`` are ints or int tensors broadcastable to ``[L,
    *shape]``.  Returns one ``[L, *shape]`` int32 tensor per request."""
    if not requests:
        return []
    dev = torch.device("cpu") if device is None else torch.device(device)
    lanes = requests[0][0].shape[0]
    shapes, sizes = [], []
    for keys, shape, _, _ in requests:
        if keys.shape[0] != lanes:
            raise ValueError("every request of one pass has the same lanes")
        shape = tuple(int(d) for d in shape)
        shapes.append(shape)
        sizes.append(int(np.prod(shape, dtype=np.int64)))
    # every request's hi and lo key per lane: [R, L, 2 (hi, lo), 2]
    subs = split_keys(np.stack([r[0] for r in requests]), 2)
    per_key = np.repeat(np.asarray(sizes, np.int64), 2 * lanes)
    bits = _bits_many_arr(subs.reshape(-1, 2), per_key, dev)
    hi_b, lo_b, lo_v, hi_v, pos = [], [], [], [], 0
    for shape, size, (_, _, lo, hi) in zip(shapes, sizes, requests):
        b = bits[pos:pos + lanes * 2 * size].view(lanes, 2, size)
        pos += lanes * 2 * size
        hi_b.append(b[:, 0].reshape(-1))
        lo_b.append(b[:, 1].reshape(-1))
        for v, out in ((lo, lo_v), (hi, hi_v)):
            v = torch.as_tensor(v, dtype=torch.int64)
            if v.device != dev:
                v = devm.to_device(v, dev)
            out.append(v.expand(lanes, *shape).reshape(-1))
    vals = _span_offset(torch.cat(hi_b), torch.cat(lo_b), torch.cat(lo_v), torch.cat(hi_v))
    return [
        v.view(lanes, *shape)
        for v, shape in zip(torch.split(vals, [lanes * n for n in sizes]), shapes)
    ]


def _bits_many_arr(keys: np.ndarray, sizes: np.ndarray, device) -> torch.Tensor:
    """:func:`_bits_many` with the keys as a ``[K, 2]`` uint64 array and
    ``sizes`` a ``[K]`` int64 array, hashed on ``device``: only the keys
    and sizes cross to a card, which expands them itself."""
    total = int(sizes.sum())
    k = keys.astype(np.int64)
    if device.type == "cpu":
        k1 = torch.from_numpy(np.repeat(k[:, 0], sizes))
        k2 = torch.from_numpy(np.repeat(k[:, 1], sizes))
        starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
        counts = torch.from_numpy(np.arange(total, dtype=np.int64) - starts)
    else:
        kd = devm.to_device(torch.from_numpy(k), device)
        n = devm.to_device(torch.from_numpy(sizes), device)
        k1 = torch.repeat_interleave(kd[:, 0], n, output_size=total)
        k2 = torch.repeat_interleave(kd[:, 1], n, output_size=total)
        starts = torch.repeat_interleave(torch.cumsum(n, 0) - n, n, output_size=total)
        counts = torch.arange(total, dtype=torch.int64, device=device) - starts
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return b1 ^ b2
