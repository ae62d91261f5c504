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
  set for float64.  In float32 its ``log1p`` is XLA's CPU one
  (:func:`log1p_f32`), so float32 normals and flax's initial weights
  (:func:`lecun_normal`) are JAX's bit for bit; float64 uses numpy's
  ``log1p`` and lands within a few ulps.

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


def _two_sum(a: np.ndarray, b: np.ndarray):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: np.ndarray, b: np.ndarray):
    """(p, e) with a * b = p + e exactly (Dekker's product, float64)."""
    split = np.float64(134217729.0)  # 2^27 + 1
    p = a * b

    def halves(v):
        c = split * v
        hi = c - (c - v)
        return hi, v - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a: np.ndarray, b, c) -> np.ndarray:
    """a * b + c rounded once, as XLA's CPU backend contracts a multiply
    and an add.  float32: the product of two float32 is exact in float64,
    and so is its sum with a float32 of comparable size, so one rounding
    to float32 is the fused result.  float64: Boldo and Melquiond's
    emulation ("Emulation of a FMA and correctly rounded sums: proved
    algorithms using rounding to odd", IEEE TC 2008): an exact product and
    sum, their low parts added with rounding to odd, then one rounding to
    nearest."""
    a = np.asarray(a)
    t = a.dtype.type
    if a.dtype == np.float32:
        # the product is exact in float64; their sum rounded to odd in
        # float64 (53 >= 24 + 2 bits) then to float32 rounds once
        p = a.astype(np.float64) * np.asarray(b, np.float32).astype(np.float64)
        th, tl = _two_sum(np.asarray(c, np.float32).astype(np.float64) + 0.0 * p, p)
        return _round_to_odd(th, tl).astype(np.float32)
    if a.dtype != np.float64:
        raise TypeError(f"fma: unsupported dtype {a.dtype}")
    b = np.broadcast_to(np.float64(b), a.shape)
    c = np.broadcast_to(np.float64(c), a.shape)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    return th + _round_to_odd(v, err)


def _round_to_odd(v: np.ndarray, err: np.ndarray) -> np.ndarray:
    """v + err (float64, err below v's last place) rounded to odd: where
    err is not 0 and v's last bit is even, v stepped one ulp toward it."""
    even = (v.view(np.int64) & 1) == 0
    return np.where((err != 0) & even, np.nextafter(v, np.where(err > 0, np.inf, -np.inf)), v)


# XLA's CPU float32 log1p: the Cephes rational for |x| < sqrt(2) - 1
# (numerator and denominator, highest degree first), else log(1 + x)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's CPU float32 log: Cephes' logf polynomial on the mantissa in
# [sqrt(1/2), sqrt(2)) - 1, split in three interleaved Horner chains
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
           1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
           3.3333331174E-1)


def log_f32(y: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` for positive normal ``y``, bit for bit:
    the Cephes polynomial, its multiply-adds fused where the backend fuses
    them."""
    f32 = np.float32
    m, e = np.frexp(np.asarray(y, f32))
    m, e = m.astype(f32), e.astype(f32)
    low = m < f32(0.707106781186547524)
    x = (m - f32(1.0)) + np.where(low, m, f32(0.0))
    e = e - np.where(low, f32(1.0), f32(0.0))
    p = [f32(c) for c in _LOGF_P]
    x2 = x * x
    x3 = x2 * x
    y0 = fma(fma(np.full_like(x, p[0]), x, p[1]), x, p[2])
    y1 = fma(fma(np.full_like(x, p[3]), x, p[4]), x, p[5])
    y2 = fma(fma(np.full_like(x, p[6]), x, p[7]), x, p[8])
    y0 = fma(fma(y0, x3, y1), x3, y2)
    y0 = fma(y0, x3, e * f32(-2.12194440e-4))
    x = fma(-x2, f32(0.5), x) + y0
    return fma(e, f32(0.693359375), x)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p``, bit for bit (numpy's differs in ~16%
    of the values by an ulp): for |x| < sqrt(2) - 1, x - x^2/2 + x^3
    num(x)/den(x) with fused Horner steps, else :func:`log_f32` of 1 + x."""
    f32 = np.float32
    x = np.asarray(x, f32)
    x2 = x * x

    def horner(coeffs):
        p = np.zeros_like(x)
        for c in coeffs:
            p = fma(p, x, f32(c))
        return p

    with np.errstate(divide="ignore", invalid="ignore"):
        small = x + fma(f32(-0.5), x2, (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN)))
        large = log_f32(np.maximum(x + f32(1.0), np.finfo(f32).tiny))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def uniform(key: np.ndarray, shape, dtype=np.float32, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform: the mantissa of [1, 2) filled with random bits,
    minus one, scaled to [minval, maxval) with one fused multiply-add."""
    dtype = np.dtype(dtype)
    finfo = np.finfo(dtype)
    nbits = finfo.bits
    uint = np.uint32 if nbits == 32 else np.uint64
    bits = random_bits(key, nbits, shape).astype(uint)
    one_bits = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - finfo.nmant)) | one_bits).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, fma(floats, hi - lo, lo))


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
    """The polynomial by Horner's rule, each step one fused multiply-add
    as XLA's CPU backend contracts it."""
    p = np.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, w, w.dtype.type(c))
    return p


def erf_inv(x: np.ndarray) -> np.ndarray:
    """Inverse error function in XLA's arithmetic (see module docstring)."""
    x = np.asarray(x)
    t = x.dtype.type
    with np.errstate(divide="ignore", invalid="ignore"):  # |x| = 1: set at the end
        w = -(log1p_f32(-(x * x)) if x.dtype == np.float32 else np.log1p(-(x * x)))
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


# XLA's float32 erf(-2/sqrt(2)) and erf(2/sqrt(2)): the bounds of the
# uniform draw of truncated_normal(-2, 2) (tests recompute them with JAX)
ERF_NEG_SQRT2_F32 = np.float32(-0.9544997)
ERF_POS_SQRT2_F32 = np.float32(0.9544997)


def truncated_normal_2(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, -2, 2, shape, float32): u uniform
    on (erf(-sqrt 2), erf(sqrt 2)), sqrt(2) erf_inv(u), clipped to the
    float32 neighbours of -2 and 2 inside the interval."""
    f32 = np.float32
    u = uniform(key, shape, f32, ERF_NEG_SQRT2_F32, ERF_POS_SQRT2_F32)
    out = f32(np.sqrt(2)) * erf_inv(u)
    return np.clip(out, np.nextafter(f32(-2), f32(np.inf)), np.nextafter(f32(2), f32(-np.inf)))


LECUN_TRUNC = 0.87962566103423978  # std of the standard normal truncated to [-2, 2]


def lecun_normal(key: np.ndarray, shape) -> np.ndarray:
    """jax.nn.initializers.lecun_normal()(key, shape, float32) of a Dense
    kernel (in, out): truncated_normal_2 times sqrt(1 / in) / 0.8796...,
    each factor rounded to float32 as JAX rounds it."""
    f32 = np.float32
    stddev = np.sqrt(f32(1.0 / shape[0])) / f32(LECUN_TRUNC)
    return truncated_normal_2(key, shape) * stddev


def flax_param_key(root: np.ndarray, scope_path, counter: int) -> np.ndarray:
    """The key flax's ``init`` hands the ``counter``-th parameter (1-based,
    in the order the module creates them) of the module at ``scope_path``
    (module names below the root): the SHA-1 of the names and the counter
    (big-endian, no leading zero bytes) concatenated without separators
    (flax's ``flax_fix_rng_separator`` is off by default), its first 4
    bytes big-endian folded into the root key."""
    import hashlib

    m = hashlib.sha1()
    for name in scope_path:
        m.update(str(name).encode("utf-8"))
    m.update(int(counter).to_bytes((int(counter).bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def bernoulli(key: np.ndarray, p: float, shape, dtype=np.float64) -> np.ndarray:
    """jax.random.bernoulli(key, p, shape) ('low' mode): uniform < p, the
    uniform drawn in ``dtype``, p's type in JAX (a Python float is float64
    with 64-bit mode on, float32 without)."""
    return uniform(key, shape, dtype) < np.dtype(dtype).type(p)


def rademacher(key: np.ndarray, shape, dtype=np.int64, p_dtype=np.float64) -> np.ndarray:
    """jax.random.rademacher(key, shape, dtype): 2 bernoulli(key, 0.5) - 1."""
    b = bernoulli(key, 0.5, shape, p_dtype).astype(dtype)
    return (2 * b - 1).astype(dtype)


def randint(key: np.ndarray, shape, minval: int, maxval: int, dtype=np.int64) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval, dtype) for 32- and
    64-bit integers: two words of random bits (from the two halves of
    ``split(key)``) reduced modulo the span, high word times 2^nbits mod
    span plus low word, in unsigned arithmetic."""
    dtype = np.dtype(dtype)
    nbits = dtype.itemsize * 8
    if nbits not in (32, 64):
        raise ValueError(f"randint: {dtype} is not a 32- or 64-bit integer type")
    uint = np.uint32 if nbits == 32 else np.uint64
    k1, k2 = split(key)
    higher, lower = random_bits(k1, nbits, shape), random_bits(k2, nbits, shape)
    span = uint(maxval - minval) if maxval > minval else uint(1)
    multiplier = uint(2 ** (nbits // 2)) % span
    multiplier = uint((int(multiplier) * int(multiplier)) % (1 << nbits)) % span
    with np.errstate(over="ignore"):
        offset = ((higher % span) * multiplier + (lower % span)) % span
    return (dtype.type(minval) + offset.astype(dtype)).astype(dtype)
