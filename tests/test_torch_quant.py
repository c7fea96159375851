"""The port's ops/quant.py against the JAX package's ops/quant.py.

Every input is made with numpy from a fixed seed and handed to both.

Tolerances: quantized codes, scales, packed bytes and the int4 unpack are
compared bit for bit (both compute ``x / scale`` in float32 and round half
to even, so any difference is a fault, not noise).  ``int8_dot_general``:
``w8a8`` within 1e-6 (an exact int32 product rescaled by the same float32
multiplications); ``w8`` within 2e-5 (float32 products of 64..128 terms of
magnitude ~1 summed in another order, ~1e-6).
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.models import transformer as jtf
from k8s_device_plugin_tpu.ops import quant as jq
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.ops import quant as tq

W8A8_TOL = 1e-6
W8_TOL = 2e-5


def _np(x):
    return np.asarray(x)


def _same(got: torch.Tensor, want) -> None:
    want = _np(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _slab(seed, shape=(2, 5, 3, 16)):
    """Random values with an all-zero row (the zero-amax guard) and exact
    half-way quotients (round half to even)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1] = np.arange(shape[-1], dtype=np.float32) - shape[-1] / 2 + 0.5
    return x


@pytest.mark.parametrize("contract", [1, 2])
def test_quantize_int8_codes_and_scales_equal_jax(contract):
    w = _slab(0, (4, 8, 6))
    w[..., 0] = 0.0  # an all-zero output channel: scale 1
    q, scale = tq.quantize_int8(torch.from_numpy(w), contract)
    jqw, jscale = jq.quantize_int8(jnp.asarray(w), contract)
    _same(q, jqw)
    _same(scale, jscale)
    deq = tq.dequantize_int8(q, scale, torch.float32)
    _same(deq, jq.dequantize_int8(jqw, jscale, jnp.float32))


def test_quantize_kv_and_pair_equal_jax():
    k, v = _slab(1), _slab(2)
    for got, want in zip(tq.quantize_kv(torch.from_numpy(k)), jq.quantize_kv(jnp.asarray(k))):
        _same(got, want)
    pair = tq.quantize_kv_pair(torch.from_numpy(k), torch.from_numpy(v))
    jpair = jq.quantize_kv_pair(jnp.asarray(k), jnp.asarray(v))
    for got, want in zip(pair, jpair):
        _same(got, want)
    # The pair is two quantize_kv calls, bit for bit.
    for got, want in zip(pair, (tq.quantize_kv(torch.from_numpy(k))[0],
                                tq.quantize_kv(torch.from_numpy(v))[0],
                                tq.quantize_kv(torch.from_numpy(k))[1],
                                tq.quantize_kv(torch.from_numpy(v))[1])):
        assert torch.equal(got, want)
    codes, scale = pair[0], pair[2]
    _same(tq.dequantize_kv(codes, scale, torch.float32),
          jq.dequantize_kv(jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()), jnp.float32))


def test_quantize_kv4_and_pack_int4_equal_jax():
    x = _slab(3)
    packed, scale = tq.quantize_kv4(torch.from_numpy(x))
    jpacked, jscale = jq.quantize_kv4(jnp.asarray(x))
    _same(packed, jpacked)
    _same(scale, jscale)
    assert packed.shape == (2, 5, 3, 8) and int(packed.view(torch.uint8).max()) > 127
    codes = np.random.RandomState(4).randint(-8, 8, size=(3, 7, 10)).astype(np.int8)
    _same(tq.pack_int4(torch.from_numpy(codes)), jq.pack_int4(jnp.asarray(codes)))
    _same(tq.dequantize_kv4(packed, scale, torch.float32),
          jq.dequantize_kv4(jpacked, jscale, jnp.float32))
    with pytest.raises(ValueError, match="even last dim"):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


def test_unpack_int4_is_exact_on_every_byte():
    """All 256 byte values: element 2i is the low nibble, both nibbles
    sign-extend, and pack_int4 inverts the unpack."""
    every = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = tq.unpack_int4(torch.from_numpy(every))
    _same(got, jq.unpack_int4(jnp.asarray(every)))
    b = every.astype(np.int64) & 0xFF
    lo, hi = b & 0xF, b >> 4
    want = np.stack([np.where(lo > 7, lo - 16, lo), np.where(hi > 7, hi - 16, hi)], -1)
    np.testing.assert_array_equal(got.numpy(), want.reshape(4, 128))
    assert torch.equal(tq.pack_int4(got), torch.from_numpy(every))
    assert tq.unpack_int4(torch.from_numpy(every), torch.float32).dtype == torch.float32


@pytest.mark.parametrize("mode, tol", [("w8", W8_TOL), ("w8a8", W8A8_TOL)])
@pytest.mark.parametrize(
    "x_shape, w_shape, axis, contract",
    [
        ((2, 5, 64), (64, 4, 16), -1, 1),  # query/key/value: one contracted axis
        ((2, 5, 4, 16), (4, 16, 64), (-2, -1), 2),  # attn out: two contracted axes
        ((3, 128), (128, 64), -1, 1),  # MLP / lm_head
    ],
    ids=["qkv", "out-two-axes", "mlp"],
)
def test_int8_dot_general_matches_jax(mode, tol, x_shape, w_shape, axis, contract):
    rs = np.random.RandomState(5)
    x = rs.randn(*x_shape).astype(np.float32)
    x[0, 0] = 0.0  # a zero activation row: scale 1, codes 0
    w_q, w_scale = jq.quantize_int8(jnp.asarray(rs.randn(*w_shape).astype(np.float32)), contract)
    want = jq.int8_dot_general(jnp.asarray(x), w_q, w_scale, axis=axis, mode=mode,
                               dtype=jnp.float32)
    got = tq.int8_dot_general(torch.from_numpy(x), torch.from_numpy(_np(w_q)),
                              torch.from_numpy(_np(w_scale)), axis=axis, mode=mode,
                              dtype=torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="w8\\|w8a8"):
        tq.int8_dot_general(torch.from_numpy(x), torch.from_numpy(_np(w_q)),
                            torch.from_numpy(_np(w_scale)), axis=axis, mode="w4")


def test_int8_dense_general_matches_jax_module():
    """The dense site: buffers under the flax names, the same output."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 3, 4, 16).astype(np.float32)
    w_q, w_scale = jq.quantize_int8(jnp.asarray(rs.randn(4, 16, 32).astype(np.float32)), 2)
    jmod = jq.Int8DenseGeneral(features=32, axis=(-2, -1), mode="w8a8", dtype=jnp.float32)
    want = jmod.apply({"params": {"kernel_q": w_q, "kernel_scale": w_scale}}, jnp.asarray(x))
    mod = tq.Int8DenseGeneral((4, 16), (32,), "w8a8", torch.float32)
    assert {n: b.dtype for n, b in mod.named_buffers()} == {
        "kernel_q": torch.int8, "kernel_scale": torch.float32}
    assert not list(mod.parameters())
    mod.load_state_dict({"kernel_q": torch.from_numpy(_np(w_q)),
                         "kernel_scale": torch.from_numpy(_np(w_scale))})
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=W8A8_TOL, atol=W8A8_TOL)


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jtf.GPTConfig.tiny()
    params = jtf.TransformerLM(cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def test_quantize_lm_params_equals_jax_leaf_for_leaf(tiny_tree):
    want = convert.flax_to_state_dict(jq.quantize_lm_params(tiny_tree))
    got = tq.quantize_lm_params(convert.flax_to_state_dict(tiny_tree))
    assert set(got) == set(want)
    assert "layer_0.attn.out.kernel_scale" in got and "lm_head.kernel_q" in got
    assert not [n for n in got if n.endswith(".kernel")]
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    # Integer leaves keep their type through the converter, both ways.
    back = convert.state_dict_to_flax(got)
    assert back["layer_1"]["mlp"]["down"]["kernel_q"].dtype == np.int8
    assert convert.flax_to_state_dict(back)["lm_head.kernel_q"].dtype == torch.int8


def test_unknown_3d_site_raises():
    w = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="unknown 3-D kernel site 'experts'"):
        tq.quantize_lm_params({"layer_0.moe.experts.kernel": w})
    with pytest.raises(ValueError, match="unknown 3-D kernel site 'experts'"):
        jq.quantize_lm_params({"layer_0": {"moe": {"experts": {"kernel": jnp.zeros((2, 3, 4))}}}})
    out = tq.quantize_lm_params({"x.out.kernel": w, "embed.embedding": w, "n.scale": w[0, 0]})
    assert out["x.out.kernel_scale"].shape == (4,)
    assert out["embed.embedding"] is w
