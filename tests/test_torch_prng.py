"""The port's threefry (tpu_paxos_torch/utils/prng.py) against
``jax.random`` with partitionable threefry: keys, splits and randint
draws must be equal bit for bit — every decision log rests on it."""

import jax
import numpy as np
import pytest

from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch.utils import prng as tprng


def _jkey(seed):
    return jprng.root_key(seed)


def _tuple(k):
    return tuple(int(x) for x in np.asarray(k))


SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -77]


@pytest.mark.parametrize("seed", SEEDS)
def test_root_key_and_fold_in(seed):
    jk = _jkey(seed)
    tk = tprng.root_key(seed)
    assert _tuple(jk) == tk
    for data in (0, 1, 5, 1000, 2**31 - 1):
        assert _tuple(jax.random.fold_in(jk, data)) == tprng.fold_in(tk, data)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(seed, num):
    jk = _jkey(seed)
    got = tprng.split(tprng.root_key(seed), num)
    want = [tuple(int(x) for x in row) for row in np.asarray(jax.random.split(jk, num))]
    assert got == want


@pytest.mark.parametrize("tag", [0, 1, 4])
@pytest.mark.parametrize("t", [0, 3, 977])
def test_stream(tag, t):
    jk = _jkey(11)
    assert _tuple(jprng.stream(jk, tag, t)) == tprng.stream(tprng.root_key(11), tag, t)


DRAWS = [
    ((4, 2, 5), 0, 10_000),  # drop / dup coins
    ((3, 5, 2), 0, 10_000),
    ((4, 2, 5), 0, 3),  # delay span [0, 2]
    ((4, 5, 2), 0, 1),  # delay span [0, 0] samples 0
    ((4, 5, 2), 0, 0),  # empty span returns minval
    ((5,), 0, 1_000_000),  # crash coins
    ((2,), 0, 5),  # prepare backoff
    ((2,), 3, 8),
    ((7, 3), -7, 2**31 - 1),
    ((6,), -(2**31), 2**31 - 1),
]


@pytest.mark.parametrize("seed", [0, 3, 2**20 + 1])
@pytest.mark.parametrize("shape,lo,hi", DRAWS)
def test_randint_bit_exact(seed, shape, lo, hi):
    jk = jax.random.fold_in(_jkey(seed), 17)
    tk = tprng.fold_in(tprng.root_key(seed), 17)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = tprng.randint(tk, shape, lo, hi).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 9])
def test_zero_rate_coins_are_all_false(seed):
    tk = tprng.root_key(seed)
    coins = tprng.randint(tk, (3, 4, 5), 0, 10_000) < 0
    assert not bool(coins.any())
    np.testing.assert_array_equal(
        coins.numpy(),
        np.asarray(jax.random.randint(_jkey(seed), (3, 4, 5), 0, 10_000) < 0),
    )


def test_randint_many_equals_single_draws():
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(12):
        key = tprng.fold_in(tprng.root_key(int(rng.integers(0, 1000))), int(rng.integers(0, 99)))
        shape = tuple(int(x) for x in rng.integers(1, 6, size=int(rng.integers(1, 4))))
        lo = int(rng.integers(-5, 5))
        reqs.append((key, shape, lo, lo + int(rng.integers(0, 10_000))))
    many = tprng.randint_many(reqs)
    for req, got in zip(reqs, many):
        np.testing.assert_array_equal(got.numpy(), tprng.randint(*req).numpy())


def test_random_bits_match_jax():
    jk = _jkey(4)
    want = np.asarray(jax.random.bits(jk, (3, 7), np.uint32)).astype(np.int64)
    got = tprng.random_bits(tprng.root_key(4), (3, 7)).numpy()
    np.testing.assert_array_equal(got, want)


def test_root_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        tprng.root_key(2**31)
