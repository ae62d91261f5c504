"""Bit-exact stand-ins for the ``jax.random`` draws the port needs.

The JAX package draws its Lloyd seeds and random centers with
``jax.random.permutation`` and its power-iteration start vector with
``jax.random.normal``; a seed that differs changes an aggregation outright.
This module repeats those draws on the host in numpy, for jax's default
``threefry2x32`` generator in its *partitionable* mode
(``jax_threefry_partitionable=True``, the default since jax 0.5):

- a key is a ``(2,)`` uint32 array (:func:`PRNGKey`);
- :func:`split` and :func:`random_bits` hash the 64-bit iota of the output
  shape, split into (hi, lo) uint32 words, with the key; :func:`fold_in`
  hashes the pair (0, data);
- :func:`permutation` is jax's ``_shuffle``: ``ceil(3 ln n / ln(2^32-1))``
  rounds, each a stable sort on fresh 32-bit keys;
- :func:`normal` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``, and :func:`erf_inv` is XLA's lowering of it,
  M. Giles' polynomials ("Approximating the erfinv function", GPU Computing
  Gems, 2011): the single-precision set for float32, the double-precision
  set for float64.

Everything returns numpy arrays; callers move them to their device.
"""

from __future__ import annotations

import math

import numpy as np

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the seed's 64 bits as (hi, lo) uint32."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & _MASK32], np.uint32)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(size: int):
    idx = np.arange(size, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(_MASK32)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_iota_2x32(num))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data): the key hashed with the counter pair
    (0, data mod 2^32)."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & _MASK32], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, bit_width: int, shape) -> np.ndarray:
    """jax.random.bits(key, shape) for 32- or 64-bit words."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = threefry2x32(key, *_iota_2x32(math.prod(shape)))
    if bit_width == 32:
        bits = b0 ^ b1
    elif bit_width == 64:
        bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    else:
        raise ValueError(f"random_bits: bit_width {bit_width} is not 32 or 64")
    return bits.reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """jax.random.permutation(key, n) as int64."""
    x = np.arange(int(n), dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, 32, (n,))
        x = x[np.argsort(sort_keys, kind="stable")]
    return x


def uniform(key: np.ndarray, shape, dtype=np.float32, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform: the mantissa of [1, 2) filled with random bits,
    minus one, scaled to [minval, maxval)."""
    dtype = np.dtype(dtype)
    finfo = np.finfo(dtype)
    nbits = finfo.bits
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = random_bits(key, nbits, shape).astype(uint)
    one_bits = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - finfo.nmant)) | one_bits).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# Giles' coefficients as XLA lowers erf_inv, highest degree first.
_ERFINV_F32 = (
    # w < 5: w - 2.5
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    # else: sqrt(w) - 3
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV_F64 = (
    # w < 6.25: w - 3.125
    (-3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
     1.1157877678025181e-17, -1.3331716628546209e-16, 2.0972767875968562e-17,
     6.6376381343583238e-15, -4.0545662729752069e-14, -8.1519341976054722e-14,
     2.6335093153082323e-12, -1.2975133253453532e-11, -5.4154120542946279e-11,
     1.0512122733215323e-09, -4.1126339803469837e-09, -2.9070369957882005e-08,
     4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
     0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
     0.24015818242558962, 1.6536545626831027),
    # w < 16: sqrt(w) - 3.25
    (2.2137376921775787e-09, 9.0756561938885391e-08, -2.7517406297064545e-07,
     1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
     2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
     6.8284851459573175e-05, 2.4031110387097894e-05, -0.00035503752036284748,
     0.0009532893797373805, -0.0016882755560235047, 0.0024914420961078508,
     -0.0037512085075692412, 0.0053709145535900636, 1.0052589676941592,
     3.0838856104922208),
    # else: sqrt(w) - 5
    (-2.7109920616438573e-11, -2.5556418169965252e-10, 1.5076572693500548e-09,
     -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
     2.9147953450901081e-08, -6.7711997758452339e-08, 2.2900482228026655e-07,
     -9.9298272942317e-07, 4.5260625972231537e-06, -1.9681778105531671e-05,
     7.5995277030017761e-05, -0.00021503011930044477, -0.00013871931833623122,
     1.0103004648645344, 4.8499064014085844),
)


def _horner(coeffs, w: np.ndarray) -> np.ndarray:
    p = np.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = w.dtype.type(c) + p * w
    return p


def erf_inv(x: np.ndarray) -> np.ndarray:
    """Inverse error function in XLA's arithmetic (see module docstring)."""
    x = np.asarray(x)
    t = x.dtype.type
    with np.errstate(divide="ignore", invalid="ignore"):  # |x| = 1: set at the end
        w = -np.log1p(-(x * x))
        s = np.sqrt(w)
        if x.dtype == np.float32:
            p = np.where(w < t(5.0), _horner(_ERFINV_F32[0], w - t(2.5)),
                         _horner(_ERFINV_F32[1], s - t(3.0)))
        elif x.dtype == np.float64:
            p = np.where(w < 6.25, _horner(_ERFINV_F64[0], w - 3.125),
                         np.where(w < 16.0, _horner(_ERFINV_F64[1], s - 3.25),
                                  _horner(_ERFINV_F64[2], s - 5.0)))
        else:
            raise TypeError(f"erf_inv: unsupported dtype {x.dtype}")
        return np.where(np.abs(x) == t(1.0), x * t(np.inf), p * x)


def normal(key: np.ndarray, shape, dtype=np.float32) -> np.ndarray:
    """jax.random.normal(key, shape, dtype)."""
    dtype = np.dtype(dtype)
    lo = np.nextafter(dtype.type(-1.0), dtype.type(0.0))
    u = uniform(key, shape, dtype, lo, 1.0)
    return dtype.type(np.sqrt(2)) * erf_inv(u)
