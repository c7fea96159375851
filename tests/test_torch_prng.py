"""The port's threefry (``utils/prng.py``) against jax.random, on the CPU.

Same keys and shapes through jax 0.9.0 and the port.  ``split``,
``fold_in``, ``random_bits`` and ``uniform`` must agree bit for bit.
``gumbel`` takes two logarithms whose last bit may differ between XLA's and
PyTorch's CPU kernels (a few 1e-7 absolute), so categorical draws are held
exactly where the top-2 margin of logits + gumbel clears MARGIN, and the
tests check that margin on their own inputs, so the comparisons cannot
flake.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models.engine_sampling import filter_top_k_top_p as jax_filter
from k8s_device_plugin_tpu_torch.models.engine_sampling import filter_top_k_top_p
from k8s_device_plugin_tpu_torch.utils import prng

SHAPES = [(1,), (7,), (8, 32000), (3, 5, 2)]
MARGIN = 1e-4  # top-2 gap of logits + gumbel; the two gumbels differ by < 1e-6


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _words(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -5, 2**32 + 7])
def test_prng_key_equals_jax(seed):
    jkey, tkey = _keys(seed)
    np.testing.assert_array_equal(tkey.numpy(), _words(jkey))


@pytest.mark.parametrize("num", [1, 2, 7, 16])
def test_split_equals_jax(num):
    jkey, tkey = _keys(7)
    want = _words(jax.random.split(jkey, num))
    np.testing.assert_array_equal(prng.split(tkey, num).numpy(), want)
    # Splitting a split key (the engine's schedule: key, sub = split(key)).
    jsub, tsub = jax.random.split(jkey)[1], prng.split(tkey)[1]
    want = _words(jax.random.split(jsub, num))
    np.testing.assert_array_equal(prng.split(tsub, num).numpy(), want)


@pytest.mark.parametrize("data", [0, 1, 12345, 2**32 - 1])
def test_fold_in_equals_jax(data):
    jkey, tkey = _keys(3)
    np.testing.assert_array_equal(prng.fold_in(tkey, data).numpy(),
                                  _words(jax.random.fold_in(jkey, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_equal_jax(shape):
    jkey, tkey = _keys(11)
    want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tkey, shape).numpy(), want)
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-3.0, 5.5)):
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=hi))
        got = prng.uniform(tkey, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_an_ulp_of_jax(shape):
    jkey, tkey = _keys(12)
    want = np.asarray(jax.random.gumbel(jkey, shape))
    got = prng.gumbel(tkey, shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _margin(noisy):
    top2 = np.sort(noisy, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_equals_jax(seed):
    """Batch 8 x vocab 32000, float32 logits from numpy."""
    jkey, tkey = _keys(seed)
    logits = (np.random.RandomState(seed).randn(8, 32000) * 3).astype(np.float32)
    want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
    got = prng.categorical(tkey, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert _margin(prng.gumbel(tkey, logits.shape).numpy() + logits) > MARGIN


def test_categorical_of_one_row_equals_jax():
    """The first-token draw: one [vocab] row (counters 0..vocab-1)."""
    jkey, tkey = _keys(5)
    logits = np.random.RandomState(5).randn(512).astype(np.float32)
    want = int(jax.random.categorical(jkey, jnp.asarray(logits)))
    assert int(prng.categorical(tkey, torch.from_numpy(logits))) == want


@pytest.mark.parametrize("seed", [3, 4])
def test_filtered_categorical_equals_jax(seed):
    """The engine's sampled pick: temperature, the top-k/top-p filter, then
    categorical, per row, against engine_sampling.filter_top_k_top_p and
    jax.random.categorical."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(8, 32000).astype(np.float32) * 4
    temps = np.array([0.8, 1.0, 1.5, 0.7, 1.2, 0.9, 2.0, 1.1], np.float32)
    top_k = np.array([50, 32000, 1, 200, 32000, 10, 40, 32000], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 0.3, 1.0], np.float32)
    jkey, tkey = _keys(seed)
    scaled = logits / temps[:, None]
    want = np.asarray(jax.random.categorical(
        jkey, jax_filter(jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p))))
    filtered = filter_top_k_top_p(torch.from_numpy(scaled), torch.from_numpy(top_k),
                                  torch.from_numpy(top_p))
    got = prng.categorical(tkey, filtered).numpy()
    np.testing.assert_array_equal(got, want)
    assert _margin(prng.gumbel(tkey, scaled.shape).numpy() + filtered.numpy()) > MARGIN
