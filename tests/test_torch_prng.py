"""``mlamg_torch.utils.prng`` against ``jax.random`` (threefry2x32,
partitionable mode): keys, splits and bits bit for bit, ``permutation`` for
every grid size the repository's datasets hold, ``uniform`` bit for bit
(with XLA's fused multiply-add), the truncated normal's bounds and flax's
parameter keys bit for bit, and ``erf_inv``/``normal``/``lecun_normal``
within a few ulps (XLA's CPU ``log1p`` is its own, not numpy's)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlamg_torch.data.grid import Grid
from mlamg_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ["2d_iso/test", "2d_iso/train", "2d_aniso/test", "2d_aniso/train",
            "3d_iso/test", "3d_iso/train"]
# largest ulp gaps against jax 0.9 on the CPU over the 800k draws below
# (printed with -s): erf_inv 2 (float32) and 21 (float64), normal 3 and
# 30; the bounds leave a margin
ULP_GAP = {np.float32: 2, np.float64: 24}
NORMAL_ULP_GAP = {np.float32: 4, np.float64: 40}
DRAWS = 200_000  # per key, keys 0-3


def dataset_sizes(name):
    return sorted({Grid.load(os.path.join(REPO, "data_out", name, f)).n
                   for f in os.listdir(os.path.join(REPO, "data_out", name))
                   if f.endswith(".grid")})


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 7, 2**31 + 5, 2**40 + 3])
def test_key_and_split_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(k))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                      np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("width", [32, 64])
def test_random_bits_match_jax(width):
    for seed in (0, 3):
        want = jax.random.bits(jax.random.PRNGKey(seed), (7, 33), getattr(jnp, f"uint{width}"))
        np.testing.assert_array_equal(prng.random_bits(prng.PRNGKey(seed), width, (7, 33)),
                                      np.asarray(want))


@pytest.mark.parametrize("key", [0, 42])
@pytest.mark.parametrize("dataset", DATASETS)
def test_permutation_matches_jax_for_every_grid_size(dataset, key):
    for n in dataset_sizes(dataset):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(key), n))
        np.testing.assert_array_equal(prng.permutation(prng.PRNGKey(key), n), want)


@pytest.mark.parametrize("n", [1, 2, 1625, 1626, 5000])
def test_permutation_rounds_match_jax(n):
    """1626 is the first size that sorts twice."""
    for key in (1, 5):
        np.testing.assert_array_equal(
            prng.permutation(prng.PRNGKey(key), n),
            np.asarray(jax.random.permutation(jax.random.PRNGKey(key), n)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_matches_jax(dtype):
    lo = np.nextafter(dtype(-1.0), dtype(0.0))
    for seed in (0, 1):
        want = jax.random.uniform(jax.random.PRNGKey(seed), (4096,), dtype, lo, 1.0)
        np.testing.assert_array_equal(prng.uniform(prng.PRNGKey(seed), (4096,), dtype, lo, 1.0),
                                      np.asarray(want))


def ulp_gap(a, b):
    it = np.int32 if a.dtype == np.float32 else np.int64
    return int(np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64)).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_erf_inv_within_a_few_ulps_of_jax(dtype):
    lo = np.nextafter(dtype(-1), dtype(0))
    x = np.concatenate([prng.uniform(prng.PRNGKey(s), (DRAWS,), dtype, lo, 1.0) for s in range(4)]
                       + [np.array([0.0, 0.5, -0.999, 0.9999999, 1.0, -1.0], dtype)])
    got, want = prng.erf_inv(x), np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    gap = ulp_gap(got[fin], want[fin])
    print(f"erf_inv {dtype.__name__}: largest gap {gap} ulp, {(got == want).mean():.3f} equal")
    assert gap <= ULP_GAP[dtype]
    assert (got == want).mean() > 0.85


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_within_a_few_ulps_of_jax(dtype):
    gap = 0
    for key, n in [(s, DRAWS) for s in range(4)] + [(1, 80), (1, 512), (1, 1872)]:
        got = prng.normal(prng.PRNGKey(key), (n,), dtype)
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(key), (n,), dtype))
        assert got.dtype == want.dtype
        gap = max(gap, ulp_gap(got, want))
    print(f"normal {dtype.__name__}: largest gap {gap} ulp")
    assert gap <= NORMAL_ULP_GAP[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_with_any_bounds_matches_jax(dtype):
    """XLA contracts ``floats * (max - min) + min`` into one fused
    multiply-add; bounds whose difference is not a power of two show it."""
    for seed, (lo, hi) in enumerate([(-0.05, 0.05), (-0.5, 0.5), (0.3, 7.1), (-1e-3, 2.0)]):
        want = jax.random.uniform(jax.random.PRNGKey(seed), (50_000,), dtype, lo, hi)
        np.testing.assert_array_equal(prng.uniform(prng.PRNGKey(seed), (50_000,), dtype, lo, hi),
                                      np.asarray(want))


def test_truncated_normal_bounds_match_jax():
    """The float32 literals of erf(-+2 / sqrt 2) are XLA's."""
    from jax._src.lax import special

    sqrt2 = np.float32(np.sqrt(2))
    for bound, want in ((-2, prng.ERF_NEG_SQRT2_F32), (2, prng.ERF_POS_SQRT2_F32)):
        got = np.asarray(special.erf(jnp.float32(bound) / sqrt2))
        assert got.dtype == np.float32 and got.view(np.uint32) == want.view(np.uint32)


def test_lecun_normal_within_a_few_ulps_of_jax():
    """jax.nn.initializers.lecun_normal on Dense kernel shapes: inside the
    truncation, within erf_inv's ulps (scaled by two multiplications) and
    equal for almost all values."""
    unequal = total = 0
    for seed in range(6):
        for shape in [(1, 4), (4, 16), (16, 64), (17, 8), (64, 1), (300, 300)]:
            want = np.asarray(jax.nn.initializers.lecun_normal()(
                jax.random.PRNGKey(seed), shape, jnp.float32))
            got = prng.lecun_normal(prng.PRNGKey(seed), shape)
            assert got.dtype == np.float32 and got.shape == shape
            assert ulp_gap(got, want) <= 4
            unequal += int((got != want).sum())
            total += got.size
    print(f"lecun_normal: {unequal} of {total} unequal")
    assert unequal <= 0.02 * total


@pytest.mark.parametrize("seed", [0, 3])
def test_flax_param_key_matches_flax(seed):
    """The key flax's init hands a parameter: a module that records the
    key its initialiser receives, nested two levels deep."""
    import flax.linen as nn

    seen = {}

    def record(name):
        def init(key, shape, dtype=jnp.float32):
            seen[name] = np.asarray(jax.random.key_data(key) if jnp.issubdtype(
                key.dtype, jax.dtypes.prng_key) else key)
            return jnp.zeros(shape, dtype)
        return init

    class Leaf(nn.Module):
        @nn.compact
        def __call__(self, x):
            a = self.param("a", record(self.name + "/a"), (2,))
            b = self.param("b", record(self.name + "/b"), (2,))
            return x + a + b

    class Mid(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Leaf(name="Dense_0")(x) + Leaf(name="LayerNorm_12")(x)

    class Top(nn.Module):
        def setup(self):
            self.AggNetM = Mid()

        def __call__(self, x):
            return self.AggNetM(x)

    Top().init(jax.random.PRNGKey(seed), jnp.zeros(2))
    root = prng.PRNGKey(seed)
    for leaf in ("Dense_0", "LayerNorm_12"):
        for counter, name in ((1, "a"), (2, "b")):
            np.testing.assert_array_equal(
                prng.flax_param_key(root, ("AggNetM", leaf), counter), seen[f"{leaf}/{name}"])
