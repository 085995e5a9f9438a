"""jax.random's threefry stream on the host, for the few scalars a
texture draws (the JAX package's ``jax.random`` keys, replayed bitwise).

A key is an immutable pair of uint32 words, ``(k0, k1)``, and every draw
takes one as its argument; nothing here holds state. The functions follow
JAX's default implementation (``jax_threefry_partitionable`` on, x64 off):

- ``key(seed)``: ``jax.random.PRNGKey(seed)``, ``(0, seed mod 2^32)``;
- ``split(key, n)``: ``_threefry_split_foldlike``, the hash of the
  counters ``(0, i)``;
- ``fold_in(key, data)``: ``_threefry_fold_in``, the hash of ``(0, data)``;
- ``bits(key)``: one 32-bit word, ``bits1 ^ bits2`` of the hash of
  ``(0, 0)`` (``_threefry_random_bits_partitionable``);
- ``uniform(key, lo, hi)``, ``randint(key, lo, hi)`` and ``normal(key)``:
  scalar float32 / int draws as ``jax.random.uniform``, ``randint`` and
  ``normal`` make them. ``normal`` is ``sqrt(2) · erf_inv(u)`` with XLA's
  float32 ``erf_inv`` polynomial, and the float32 ``log1p`` and ``log``
  that XLA's CPU code emits, evaluated in float32: equal to JAX's on 2·10^4
  seeds, and held within 2 ulp (the log is 1 ulp from XLA's on 0.04% of
  inputs).

XLA's CPU code fuses a multiply and an add into one rounding, so uniform's
``u · (hi - lo) + lo`` and the polynomials' Horner steps are evaluated so.
``normal_affine(key, scale, shift)`` is ``shift + scale · normal(key)`` as
a jitted JAX function computes it: XLA folds ``scale · sqrt(2)`` into one
constant and fuses its product with ``erf_inv(u)`` and the add.

The hash is Threefry-2x32 with 20 rounds (Salmon et al., SC 2011), on
Python ints masked to 32 bits.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k: tuple, x0: int, x1: int) -> tuple:
    """Threefry-2x32 of the counter pair (x0, x1) under key k."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` with x64 off: ``(0, seed mod 2^32)``."""
    return (0, int(seed) & _M32)


def split(k: tuple, n: int = 2) -> list:
    """``jax.random.split(k, n)``: n keys."""
    return [threefry2x32(k, 0, i) for i in range(n)]


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32(k, 0, int(data) & _M32)


def bits(k: tuple) -> int:
    """One 32-bit word of ``jax.random.bits(k, (), uint32)``."""
    b1, b2 = threefry2x32(k, 0, 0)
    return b1 ^ b2


def _unit(k: tuple) -> np.float32:
    """The float32 in [0, 1) that JAX's uniform makes from the key's bits."""
    word = np.uint32((bits(k) >> 9) | 0x3F800000)
    return word.view(np.float32) - np.float32(1.0)


def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a · b + c in float32 with one rounding (to nearest, ties to even),
    as XLA's CPU code computes uniform's scale and shift."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                    int(v.view(np.uint32)) & 1))


def uniform(k: tuple, lo: float = 0.0, hi: float = 1.0) -> np.float32:
    """``jax.random.uniform(k, (), minval=lo, maxval=hi)``: a float32 in
    [lo, hi)."""
    lo, hi = np.float32(lo), np.float32(hi)
    return np.maximum(lo, _fma32(_unit(k), hi - lo, lo))


def randint(k: tuple, lo: int, hi: int) -> int:
    """``jax.random.randint(k, (), lo, hi)`` (int32 bounds): an int in
    [lo, hi)."""
    k1, k2 = split(k)
    higher, lower = bits(k1), bits(k2)
    span = (hi - lo) & _M32 if hi > lo else 1
    multiplier = (1 << 16) % span
    multiplier = (multiplier * multiplier) % span
    offset = ((higher % span) * multiplier + lower % span) & _M32
    return lo + offset % span


def _mad(a, b, c) -> np.ndarray:
    """float32 a · b + c as a fused multiply-add: the product of two
    float32 values is exact in float64, and the sum is rounded once more."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    return (a * b + c).astype(np.float32)


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner's scheme, highest degree first, each step fused."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _mad(p, x, c)
    return p


# XLA's float32 log (Cephes' logf): x = m · 2^e with m in [sqrt(1/2),
# sqrt(2)), then a degree-8 polynomial in m - 1 in three streams
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log of positive normal x (Cephes' logf), in float32."""
    f = np.float32
    m, e = np.frexp(np.asarray(x, f))
    m, e = m.astype(f), e.astype(f)
    low = m < f(0.707106781186547524)
    e = e - np.where(low, f(1), f(0))
    z = (m - f(1)) + np.where(low, m, f(0))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y0, y1, y2 = (_mad(_mad(z, p[i], p[i + 1]), z, p[i + 2])
                  for i in (0, 3, 6))
    y = _mad(_mad(y0, z3, y1), z3, y2) * z3
    y = y + e * f(-2.12194440e-4)
    z = z - z2 * f(0.5)
    return (z + y) + e * f(0.693359375)


# XLA's float32 log1p below |x| = sqrt(2) - 1 (a Cephes rational
# function): x - x²/2 + x³ · num(x) / den(x)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p for x in (-1, 0], in float32."""
    f = np.float32
    x = np.asarray(x, f)
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + _mad(f(-0.5), x2, small)
    with np.errstate(divide="ignore"):
        large = _log(np.maximum(x + f(1), f(np.finfo(f).tiny)))
    return np.where(np.abs(x) < f(0.41421356237309504880), small, large)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): one
# 9-term polynomial in w - 2.5 below w = 5 and one in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x) -> np.ndarray:
    """XLA's float32 erf_inv, evaluated in float32 (elementwise)."""
    f = np.float32
    x = np.asarray(x, f)
    w = -_log1p(-(x * x))
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.zeros_like(x)
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = _mad(p, w, np.where(lt, f(a), f(b)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * f(np.inf), p * x)


_SQRT2 = np.float32(np.sqrt(2))


def _normal_erf_inv(k: tuple) -> np.float32:
    """erf_inv(u) of ``jax.random.normal``, u uniform on [nextafter(-1, 0),
    1)."""
    u = uniform(k, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    return np.float32(erf_inv(u))


def normal(k: tuple) -> np.float32:
    """``jax.random.normal(k, ())``: sqrt(2) · erf_inv(u)."""
    return np.float32(_SQRT2 * _normal_erf_inv(k))


def normal_affine(k: tuple, scale: float, shift: float) -> np.float32:
    """``shift + scale * jax.random.normal(k, ())`` inside ``jax.jit``:
    fma(erf_inv(u), float32(scale · sqrt(2)), shift)."""
    c = np.float32(np.float32(scale) * _SQRT2)
    return _fma32(_normal_erf_inv(k), c, np.float32(shift))
