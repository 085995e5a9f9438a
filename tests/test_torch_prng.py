"""The port's replay of jax.random's threefry stream (utils/prng.py) against
``jax.random`` itself (JAX's default partitionable threefry, x64 off).

Keys, ``split(·, n)`` for n ≤ 5, ``fold_in``, 32-bit ``bits``, ``uniform``
over every range the textures draw from and ``randint`` over (0, 10000)
and (0, 7) are held bitwise, over a hypothesis sweep of seeds in [0, 2^31)
and the edge seeds 2^31, 2^32 + 5, 2^31 - 1 and texture_gen's
seed·100003 + i; ``normal`` within 2 ulp, and ``normal_affine`` bitwise
as a jitted JAX function computes ``shift + scale · normal``.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from arap_flow_tpu_torch.utils import prng

# the texture draws' ranges (arap_flow_tpu/ops/textures.py), with the
# render's light ranges at 1280x720 and 96x72
UNIFORM_RANGES = [(0.0, 1.0), (20.0, 200.0), (40.0, 300.0), (20.0, 120.0),
                  (20.0, 60.0), (1.5, 3.5), (40.0, 160.0), (30.0, 150.0),
                  (0.0, 8.0), (60.0, 250.0), (1.0, 3.0), (0.4, 1.2),
                  (0.0, 1280.0), (0.0, 720.0), (0.0, 96.0), (0.0, 72.0)]
EDGE_SEEDS = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5] + [
    s * 100003 + i for s in (0, 5, 21474) for i in (0, 1, 99)]
SWEEP = settings(max_examples=40, deadline=None, database=None,
                 derandomize=True)


def _pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _bits32(x) -> int:
    return int(np.asarray(x, np.float32).view(np.uint32))


def _check_key_ops(seed: int) -> None:
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    assert _pair(jk) == k
    for n in range(1, 6):
        assert [_pair(s) for s in jax.random.split(jk, n)] == prng.split(k, n)
    for d in (0, 1, 2, 3, 7, 2 ** 31 + 9):
        assert _pair(jax.random.fold_in(jk, d)) == prng.fold_in(k, d)
    assert int(jax.random.bits(jk, (), np.uint32)) == prng.bits(k)


def _check_draws(seed: int) -> None:
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    for lo, hi in UNIFORM_RANGES:
        want = jax.random.uniform(jk, (), minval=lo, maxval=hi)
        got = prng.uniform(k, lo, hi)
        assert got.dtype == np.float32 and lo <= got < hi
        assert _bits32(got) == _bits32(want), (seed, lo, hi)
    for lo, hi in ((0, 10000), (0, 7)):
        assert prng.randint(k, lo, hi) == int(jax.random.randint(jk, (), lo,
                                                                 hi))


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_keys_split_fold_in_bits_edge_seeds(seed):
    _check_key_ops(seed)


@pytest.mark.parametrize("seed", EDGE_SEEDS)
def test_uniform_randint_edge_seeds(seed):
    _check_draws(seed)


@SWEEP
@given(st.integers(0, 2 ** 31 - 1))
def test_keys_split_fold_in_bits_sweep(seed):
    _check_key_ops(seed)


@SWEEP
@given(st.integers(0, 2 ** 31 - 1))
def test_uniform_randint_sweep(seed):
    _check_draws(seed)


@SWEEP
@given(st.integers(0, 2 ** 31 - 1))
def test_draws_from_split_and_folded_keys(seed):
    """The draws from the render's derived keys, as the textures take them."""
    jk, k = jax.random.PRNGKey(seed), prng.key(seed)
    for jd, d in zip(jax.random.split(jk, 4), prng.split(k, 4)):
        for jf, f in ((jd, d), (jax.random.fold_in(jd, 3),
                                prng.fold_in(d, 3))):
            assert _bits32(prng.uniform(f, 0.4, 1.2)) == _bits32(
                jax.random.uniform(jf, (), minval=0.4, maxval=1.2))
            assert prng.randint(f, 0, 10000) == int(
                jax.random.randint(jf, (), 0, 10000))


def test_normal_within_two_ulp():
    seeds = list(np.random.default_rng(0).integers(0, 2 ** 31, 400))
    for seed in [int(s) for s in seeds] + EDGE_SEEDS:
        want = jax.random.normal(jax.random.PRNGKey(seed), ())
        got = prng.normal(prng.key(seed))
        assert got.dtype == np.float32
        assert _ulps(got, want) <= 2, (seed, got, want)


def test_normal_affine_equals_jitted_jax():
    """``shift + scale · normal`` as a jitted JAX function computes it
    (XLA's folded constant and fused multiply-add), bitwise."""
    seeds = [int(s) for s in np.random.default_rng(1).integers(
        0, 2 ** 31, 400)] + EDGE_SEEDS
    for scale, shift in ((0.25, 0.35), (1.5, -2.0)):
        f = jax.jit(jax.vmap(
            lambda k, a=scale, b=shift: b + a * jax.random.normal(k, ())))
        want = np.asarray(f(np.stack([jax.random.PRNGKey(s)
                                      for s in seeds])))
        got = np.array([prng.normal_affine(prng.key(s), scale, shift)
                        for s in seeds], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_erf_inv_within_two_ulp():
    """The polynomial over the whole open interval and its ends."""
    x = np.concatenate([
        np.linspace(-1, 1, 20001, dtype=np.float32)[1:-1],
        1 - np.logspace(-7, -1, 200).astype(np.float32),
        np.float32([0.0, -1e-30, 1e-8])])
    want = np.asarray(jax.lax.erf_inv(x))
    got = prng.erf_inv(x)
    d = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert d.max() <= 2
    ends = np.float32([-1.0, 1.0])
    np.testing.assert_array_equal(prng.erf_inv(ends),
                                  np.asarray(jax.lax.erf_inv(ends)))
