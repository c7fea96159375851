"""The port's attention ops against the JAX package's Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version; here that
version is held against the real Pallas kernel run through the Pallas
interpreter (``interpret=True``, as the JAX package's own parity tests run
it).  Inputs come from numpy with a fixed seed and go to both sides.

Tolerances (float32 unless a test says otherwise): 2e-5 absolute/relative.  Both sides
compute the same split-K / online-softmax math in float32; they differ
only in summation order over at most a few hundred terms of magnitude
~1, which moves results by ~1e-6.  The flash backward is held to the
interpreted Pallas backward (kernels 3 and 4) within 5e-4, the JAX
package's own tolerance for that pair, and to its chunked XLA backward
within 5e-5: gradients of sum(out^2) sum a few hundred terms of magnitude
~10 twice over.

The CUDA kernels themselves build and run only on the card: their tests
are in ``tests/test_torch_cuda.py``, which imports no JAX so that it runs
on the card's machine too (``chip_smoke.py`` runs the same comparisons at
full width).
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu.ops.flash_attention import _flash_impl
from k8s_device_plugin_tpu.ops.flash_attention import flash_attention as jax_flash
from k8s_device_plugin_tpu.ops.flash_attention import mha_reference as jax_mha
from k8s_device_plugin_tpu.ops import quant as jax_quant
from k8s_device_plugin_tpu.ops.paged_attention import paged_attention as jax_paged
from k8s_device_plugin_tpu_torch.ops import _build, tuning
from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa

TOL = 2e-5
BWD_TOL_PALLAS = 5e-4
BWD_TOL_XLA = 5e-5


def _paged_inputs(seed, batch=3, heads=8, kv_heads=2, head_dim=64, ps=8, n_pool=32, mpp=4):
    rs = np.random.RandomState(seed)
    q = rs.randn(batch, heads, head_dim).astype(np.float32)
    pk = rs.randn(n_pool, ps, kv_heads, head_dim).astype(np.float32)
    pv = rs.randn(n_pool, ps, kv_heads, head_dim).astype(np.float32)
    table = rs.permutation(n_pool)[: batch * mpp].reshape(batch, mpp).astype(np.int32)
    # A full row, a partial last page, and a single token.
    lens = np.array([ps * mpp, ps + 3, 1][:batch], np.int32)
    return q, pk, pv, table, lens


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "window, splits, kv_heads",
    [(None, 2, 2), (9, 2, 4)],
    ids=["gqa4-split2", "window9-gqa2-split2"],
)
def test_paged_plain_matches_interpreted_pallas(window, splits, kv_heads):
    inputs = _paged_inputs(0, kv_heads=kv_heads)
    want = np.asarray(
        jax_paged(*map(jnp.asarray, inputs), window=window, num_splits=splits, interpret=True)
    )
    pa.reset_launches()
    got = pa.paged_attention(*_torch(*inputs), window=window, num_splits=splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert pa.paged_attention.launches_by_format["f"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("window", [None, 5, 20])
def test_paged_plain_matches_jax_xla_lane_every_split(window):
    """Every split count (the uneven 3 pads the table) computes the same
    attention as the JAX package's XLA lane of the kernel."""
    inputs = _paged_inputs(1)
    for splits in (1, 2, 3, 4):
        want = np.asarray(jax_paged(*map(jnp.asarray, inputs), window=window, num_splits=splits))
        got = pa.paged_attention(*_torch(*inputs), window=window, num_splits=splits)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL, err_msg=f"S={splits}")


def test_paged_combine_handles_empty_splits_and_masked_rows():
    """A row whose live pages all sit in split 0 leaves later splits empty
    (m = -inf); a row with len 0 sees nothing and returns 0, not NaN."""
    q, pk, pv, table, lens = _paged_inputs(2)
    lens = np.array([3, 1, 0], np.int32)
    got = pa.paged_attention(*_torch(q, pk, pv, table, lens), num_splits=4).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], 0.0)
    one = pa.paged_attention(*_torch(q, pk, pv, table, lens), num_splits=1).numpy()
    np.testing.assert_allclose(got, one, rtol=TOL, atol=TOL)


def test_paged_bf16_plain_matches_jax():
    """bf16 pools: probabilities round to bf16 before p.v on both sides;
    outputs are bf16, so the tolerance is one bf16 ulp at |x| < 1 (2**-8)."""
    q, pk, pv, table, lens = _paged_inputs(3)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_paged(bf(q), bf(pk), bf(pv), jnp.asarray(table), jnp.asarray(lens),
                                num_splits=2)).astype(np.float32)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = pa.paged_attention(tb(q), tb(pk), tb(pv), *_torch(table, lens), num_splits=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -8)


@pytest.mark.parametrize(
    "bad, match",
    [
        ({"pool_k": torch.zeros(4, 8, 2, 64, dtype=torch.int8)}, "pools must match|int8"),
        ({"q": torch.zeros(3, 5, 64)}, "multiple of kv_heads"),
        ({"window": 0}, "window"),
    ],
)
def test_paged_rejects_unsupported_inputs(bad, match):
    q, pk, pv, table, lens = _torch(*_paged_inputs(4))
    args = {"q": q, "pool_k": pk, "pool_v": pv}
    window = bad.pop("window", None)
    args.update(bad)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        pa.paged_attention(args["q"], args["pool_k"], args["pool_v"], table, lens,
                           window=window, num_splits=1)


def _quantized_inputs(seed, fmt, **kw):
    """Float inputs with the pools quantized by the JAX package (codes and
    scale pools as numpy): ``(q, pool_k, pool_v, table, lens, scale_k,
    scale_v)``."""
    q, pk, pv, table, lens = _paged_inputs(seed, **kw)
    quantize = jax_quant.quantize_kv if fmt == "int8" else jax_quant.quantize_kv4
    (ck, sk), (cv, sv) = (map(np.array, quantize(jnp.asarray(p))) for p in (pk, pv))
    return q, ck, cv, table, lens, sk, sv


def _paged_both(inputs, **kw):
    """(JAX, port) on the same quantized inputs; ``kw`` goes to both, with
    JAX-only keys (``interpret``, ``use_pallas``) kept from the port."""
    q, ck, cv, table, lens, sk, sv = inputs
    want = jax_paged(*map(jnp.asarray, (q, ck, cv, table, lens)), scale_k=jnp.asarray(sk),
                     scale_v=jnp.asarray(sv), **kw)
    port_kw = {k: v for k, v in kw.items() if k not in ("interpret", "use_pallas")}
    got = pa.paged_attention(*_torch(q, ck, cv, table, lens), scale_k=torch.from_numpy(sk),
                             scale_v=torch.from_numpy(sv), **port_kw)
    return np.asarray(want), got


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize(
    "window, splits, kv_heads",
    [(None, 1, 2), (9, 3, 4), (None, 3, 2)],
    ids=["gqa4-split1", "window9-gqa2-split3", "gqa4-split3"],
)
def test_paged_quantized_plain_matches_interpreted_pallas(fmt, window, splits, kv_heads):
    """The int8 and int4 branches of the plain version against the
    reference's kernel branches run in the Pallas interpreter."""
    inputs = _quantized_inputs(20, fmt, kv_heads=kv_heads)
    pa.reset_launches()
    want, got = _paged_both(inputs, window=window, num_splits=splits, interpret=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert pa.paged_attention.launches_by_format[fmt] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("window", [None, 5, 20])
def test_paged_quantized_plain_matches_jax_xla_lane(fmt, window):
    """Every split count, against the reference's XLA lane (_decode_xla);
    the format is inferred from the pools on both sides."""
    inputs = _quantized_inputs(21, fmt)
    for splits in (1, 3):
        want, got = _paged_both(inputs, window=window, num_splits=splits, use_pallas=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL, err_msg=f"S={splits}")


def test_paged_quantized_bf16_query_matches_jax():
    """A bf16 query over int8 pools: the probabilities take V's scale and
    round to bf16 before p.v on both sides; one bf16 ulp at |x| < 1."""
    q, ck, cv, table, lens, sk, sv = _quantized_inputs(22, "int8")
    want = jax_paged(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (ck, cv, table, lens)),
                     scale_k=jnp.asarray(sk), scale_v=jnp.asarray(sv), num_splits=2)
    got = pa.paged_attention(torch.from_numpy(q).to(torch.bfloat16),
                             *_torch(ck, cv, table, lens), scale_k=torch.from_numpy(sk),
                             scale_v=torch.from_numpy(sv), num_splits=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=0, atol=2 ** -8)


def test_paged_scale_pool_errors_mirror_the_reference():
    """Format inference and the scale-pool checks raise as the reference's
    wrapper does, message for message."""
    q, ck, cv, table, lens, sk, sv = _quantized_inputs(23, "int8")
    q4, ck4, cv4, *_ = _quantized_inputs(23, "int4")
    cases = [
        ((q, ck, cv), {}, "int8 pools require scale_k and scale_v"),
        ((q, ck4, cv4), {"scale_k": sk}, "int4 pools require scale_k and scale_v"),
        ((q, ck.astype(np.float32), cv.astype(np.float32)), {"scale_k": sk, "scale_v": sv},
         "scale pools passed with"),
        ((q, ck.astype(np.float32), cv.astype(np.float32)), {"kv_format": "int8"},
         "int8 pools must be int8 storage"),
        ((q, ck, cv), {"scale_k": sk, "scale_v": sv, "kv_format": "int4"},
         "pool head_dim 64 != expected 32"),
        ((q, ck, cv), {"scale_k": sk, "scale_v": sv, "kv_format": "fp8"}, "kv_format must be"),
    ]
    for (qq, kk, vv), extra, match in cases:
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in extra.items()}
        with pytest.raises(ValueError, match=match):
            jax_paged(*map(jnp.asarray, (qq, kk, vv, table, lens)), **jkw)
        with pytest.raises(ValueError, match=match):
            pa.paged_attention(*_torch(qq, kk, vv, table, lens), **tkw)
    # The port also checks the scale pools' type and shape before a launch.
    with pytest.raises(ValueError, match="scale_v must be float32"):
        pa.paged_attention(*_torch(q, ck, cv, table, lens), scale_k=torch.from_numpy(sk),
                           scale_v=torch.from_numpy(sv)[:, :4])


def _flash_inputs(seed, b=1, h=4, hk=2, s=128, d=64):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(b, h, s, d).astype(np.float32),
        rs.randn(b, hk, s, d).astype(np.float32),
        rs.randn(b, hk, s, d).astype(np.float32),
    )


@pytest.mark.parametrize("window", [None, 40], ids=["causal", "window40"])
def test_flash_plain_matches_interpreted_pallas(window):
    """Output and log-sum-exp against the interpreted Pallas forward
    (``_flash_impl``, whose lse is lane-replicated [b*h, s, 128])."""
    q, k, v = _flash_inputs(0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = _flash_impl(jq, jk, jv, True, window, 64 ** -0.5, 128, 128, True)
    fa.flash_attention.launches = 0
    out, lse = fa.flash_forward(*_torch(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse)[:, :, 0].reshape(lse.shape), rtol=TOL, atol=TOL
    )
    # The public wrapper agrees too, and nothing counted as a launch.
    got = fa.flash_attention(*_torch(q, k, v), causal=True, window=window)
    want = jax_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("causal, window", [(False, None), (True, None), (True, 7)])
def test_mha_reference_matches_jax(causal, window):
    q, k, v = _flash_inputs(1, s=24)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    got = fa.mha_reference(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seq", [256, 200], ids=["s256", "s200-ragged"])
@pytest.mark.parametrize("block_kv", [32, 128])
def test_flash_plain_matches_mha_reference_any_tile(block_kv, seq):
    """The online-softmax loop is exact whatever its tile (the CUDA kernel
    runs 64-column tiles, the plain default 128), a ragged last one too."""
    q, k, v = _torch(*_flash_inputs(2, s=seq))
    out, lse = fa.flash_attention_reference(q, k, v, causal=True, sm_scale=0.125, window=50,
                                            block_kv=block_kv)
    ref = fa.mha_reference(q, k, v, causal=True, sm_scale=0.125, window=50)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("seq, window", [(24, None), (24, 7), (200, 50)])
def test_flash_any_length_matches_jax_reference(seq, window):
    """Lengths that do not tile by 128 still go through the flash wrapper
    (the reference hands them to its plain mha_reference)."""
    q, k, v = _flash_inputs(8, s=seq)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), causal=True, window=window)
    fa.flash_attention.launches = 0
    got = fa.flash_attention(*_torch(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert fa.flash_attention.launches == 0


def test_flash_rejects_bad_arguments():
    q, k, v = _torch(*_flash_inputs(3))
    with pytest.raises(ValueError, match="requires causal"):
        fa.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="window must be"):
        fa.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(q[:, :3], k, v, causal=True)


def _grads(q, k, v, *, causal, window):
    """The port's dq, dk, dv of sum(out^2) through its autograd Function."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal, window=window) ** 2).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(q, k, v, *, causal, window, **kw):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, window=window, **kw) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


CASES = [(True, None), (True, 40), (False, None)]
CASE_IDS = ["causal", "window40", "full"]


@pytest.mark.parametrize("kv_heads", [2, 4], ids=["gqa2", "mha"])
@pytest.mark.parametrize("causal, window", CASES, ids=CASE_IDS)
def test_flash_backward_matches_interpreted_pallas(causal, window, kv_heads):
    """The plain backward against the JAX package's kernels 3 and 4
    (``bwd_impl="pallas"``) run in the Pallas interpreter."""
    q, k, v = _flash_inputs(9, h=4, hk=kv_heads, s=128, d=16)
    want = _jax_grads(q, k, v, causal=causal, window=window, bwd_impl="pallas",
                      interpret=True, block_q=64, block_kv=64)
    fa.flash_backward.dq_launches = fa.flash_backward.dkv_launches = 0
    got = _grads(q, k, v, causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=BWD_TOL_PALLAS, atol=BWD_TOL_PALLAS,
                                   err_msg=f"d{name}")
    assert fa.flash_backward.dq_launches == fa.flash_backward.dkv_launches == 0


@pytest.mark.parametrize(
    "seq, kv_heads", [(128, 2), (128, 4), (200, 2)], ids=["s128-gqa2", "s128-mha", "s200-ragged"]
)
@pytest.mark.parametrize("causal, window", CASES, ids=CASE_IDS)
def test_flash_backward_matches_chunked_xla(causal, window, seq, kv_heads):
    """The plain backward against ``_mha_bwd_chunked`` (``bwd_impl="xla"``);
    s = 200 leaves a ragged last kv block on the port's side."""
    q, k, v = _flash_inputs(10, h=4, hk=kv_heads, s=seq, d=16)
    want = _jax_grads(q, k, v, causal=causal, window=window, bwd_impl="xla")
    got = _grads(q, k, v, causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=BWD_TOL_XLA, atol=BWD_TOL_XLA,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("block_kv", [32, 128, 200])
def test_flash_backward_plain_is_exact_for_any_tile(block_kv):
    """The chunked plain backward (banded under a window) equals autograd
    through ``mha_reference``, whatever its kv tile."""
    q, k, v = _torch(*_flash_inputs(11, s=200, d=16))
    out, lse = fa.flash_forward(q, k, v, causal=True, window=50)
    dout = torch.from_numpy(np.random.RandomState(12).randn(*out.shape).astype(np.float32))
    got = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, causal=True,
                                                sm_scale=0.25, window=50, block_kv=block_kv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.mha_reference(*leaves, causal=True, window=50).backward(dout)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=TOL, atol=TOL)


def test_flash_attention_is_differentiable_only_when_asked():
    q, k, v = _torch(*_flash_inputs(13, s=24, d=16))
    assert not fa.flash_attention(q, k, v, causal=True).requires_grad
    out = fa.flash_attention(q.requires_grad_(), k, v, causal=True)
    assert out.requires_grad
    (dq,) = torch.autograd.grad(out.sum(), [q])
    assert dq.shape == q.shape and torch.isfinite(dq).all()


def test_kernel_inputs_are_checked_before_a_launch():
    """What the CUDA kernels refuse is refused in Python, before a launch."""
    q = torch.zeros(1, 2, 8, 64)
    assert fa._check_kernel_inputs("dkv", q=q, k=q) == fa.variant("dkv", torch.float32)
    bad = [
        ({"k": q.double()}, "match q"),
        ({"k": q[:, :, ::2]}, "contiguous"),
        ({"k": torch.zeros(2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)}, "16-byte"),
    ]
    for extra, match in bad:
        with pytest.raises(ValueError, match=match):
            fa._check_kernel_inputs("forward", q=q, **extra)
    for kernel in fa.VARIANTS:
        with pytest.raises(ValueError, match="float32"):
            fa._check_kernel_inputs(kernel, q=q.half())
    # Every head_dim is taken: the multiples of 8 as they are, any other
    # zero-padded to the next (and cut back after the launch).
    for head_dim in (1, 4, 8, 20, 44, 64, 100, 128, 136, 192, 256, 384):
        q_d = torch.ones(1, 2, 8, head_dim)
        assert fa._check_kernel_inputs("forward", q=q_d) == fa.variant("forward", torch.float32)
        (padded,) = fa._pad8(q_d)
        assert padded.shape[-1] == -(-head_dim // 8) * 8 and padded.is_contiguous()
        assert torch.equal(padded[..., :head_dim], q_d) and not padded[..., head_dim:].any()
        assert torch.equal(fa._unpad(padded, head_dim), q_d)
    # A wrapper refuses a type no kernel takes before it builds anything.
    with pytest.raises(ValueError, match="float32"):
        fa._launch(q.half(), q.half(), q.half(), causal=True, sm_scale=0.125, window=None)
    rows = torch.zeros(1, 2, 8)
    fa._check_row_stats(q, lse=rows, delta=rows)
    for bad_rows in (rows.double(), torch.zeros(1, 2, 7), torch.zeros(1, 2, 16)[..., ::2]):
        with pytest.raises(ValueError, match="delta must be a contiguous float32"):
            fa._check_row_stats(q, lse=rows, delta=bad_rows)
    # launch_dkv refuses a bad delta before it builds or launches anything.
    with pytest.raises(ValueError, match="delta"):
        fa.launch_dkv(q, q, q, rows, rows[..., :4], q, causal=True, sm_scale=0.125, window=None)


def test_resolve_blocks():
    assert fa.resolve_blocks(512, 512) == (128, 128)
    assert fa.resolve_blocks(512, 512, on_cuda=True) == fa.CUDA_TILE
    assert fa.resolve_blocks(192, 200) == (128, 128)  # the last tile is ragged
    assert fa.resolve_blocks(24, 40) == (24, 40)  # clamped to the sequence


def test_pick_num_splits_rows():
    assert tuning.pick_num_splits(32) == 1  # CPU: no parallel blocks to fill
    assert tuning.pick_num_splits(32, "NVIDIA H100 80GB HBM3") == 8
    assert tuning.pick_num_splits(8, "NVIDIA H100 80GB HBM3") == 2
    assert tuning.pick_num_splits(2, "NVIDIA H100 80GB HBM3") == 1
    row, exact = tuning.decode_row("Some Other GPU")
    assert not exact and row is tuning.FALLBACK_ROW
    assert tuning.pick_num_splits(32, "Some Other GPU") == 2
    assert "provisional" in tuning.decode_row("NVIDIA H100 PCIe")[0].source
    with pytest.raises(ValueError):
        tuning.pick_num_splits(0)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build._nvcc()


def test_build_path_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    a = _build.library_path("paged_attention")
    b = _build.library_path("flash_attention")
    assert a.parent != b.parent and a.name == "libpaged_attention.so"
    assert "flash_attention_bwd" in _build.SOURCES
    assert a.parent.parent == _build.BUILD_ROOT
    assert a == _build.library_path("paged_attention")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    # A shared header is part of every source's key: editing it (in a copy
    # of csrc/) builds anew instead of loading a stale library.
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert list(csrc.glob("*.cuh"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before["flash_attention_wgmma"] == _build.library_path("flash_attention_wgmma")
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    for name in _build.SOURCES:
        assert _build.library_path(name) != before[name]


def _c_declaration(source: str, symbol: str) -> str:
    """The parameter list of ``extern "C" int symbol(...)`` in csrc/<source>.cu."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    head = f'extern "C" int {symbol}('
    assert text.count(head) == 1, f"{symbol} is not declared once in csrc/{source}.cu"
    start = text.index(head) + len(head)
    return text[start:text.index(")", start)]


def _wrapper_entries():
    """Every (source, symbol, argtypes) that the wrappers bind."""
    entries = {v[1:] for table in fa.VARIANTS.values() for v in table.values()}
    paged = {(source, symbol, tuple(argtypes)) for source, symbol, argtypes in
             (pa.C_ENTRY, pa.EMPTY_ENTRY)}
    return sorted(entries | paged, key=lambda e: e[1])


@pytest.mark.parametrize("entry", _wrapper_entries(), ids=lambda e: e[1])
def test_c_entries_match_their_declarations(entry):
    """Each C entry a wrapper binds is declared in its source with as many
    parameters as the wrapper passes, pointers where it passes pointers."""
    source, symbol, argtypes = entry
    assert source in _build.SOURCES
    params = [p.strip() for p in _c_declaration(source, symbol).split(",")]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is ctypes.c_void_p), (symbol, param, argtype)
        if argtype is ctypes.c_float:
            assert param.startswith("float ")


def test_kernel_variant_follows_the_dtype():
    """bf16 runs the tensor-core (wgmma) kernels 2, 3 and 4, float32 the FMA
    ones, each from its own source; any other type raises."""
    for kernel in ("forward", "dq", "dkv"):
        bf16, f32 = fa.variant(kernel, torch.bfloat16), fa.variant(kernel, torch.float32)
        assert bf16.design == "wgmma" and bf16.source.endswith("_wgmma")
        assert bf16.symbol.endswith("_wgmma") and f32.symbol.endswith("_fma")
        assert f32.design == "fma" and bf16.source != f32.source
    assert fa.variant("dq", torch.bfloat16).source == "flash_attention_bwd_dq_wgmma"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="float32|bfloat16"):
            fa.variant("forward", dtype)
    fa.flash_attention.launches_by_design["wgmma"] = 3
    fa.flash_backward.dq_launches_by_design["fma"] = 2
    fa.reset_launches()
    assert fa.flash_attention.launches_by_design == {"wgmma": 0, "fma": 0}
    assert fa.flash_backward.dq_launches_by_design == {"wgmma": 0, "fma": 0}
    assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 0, "fma": 0}


@pytest.mark.parametrize("fmt", pa.FORMATS)
@pytest.mark.parametrize("splits", [1, 8])
def test_paged_launch_passes_what_the_c_entry_declares(monkeypatch, fmt, splits):
    """The paged wrapper hands its C entry exactly the arguments declared
    in csrc/paged_attention.cu (no partial buffers: the splits merge inside
    the launch), pointers where it takes pointers, and counts one launch."""
    calls = []

    def fake_entry(source, symbol, argtypes):
        def fn(*args):
            calls.append((source, symbol, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(pa._build, "entry", fake_entry)
    monkeypatch.setattr(pa, "_stream", lambda device: 12345)
    geo = dict(kv_heads=2, ps=16, n_pool=64, mpp=8)
    if fmt == "f":
        q, pk, pv, table, lens = _torch(*_paged_inputs(21, **geo))
        sk = sv = None
    else:
        q, pk, pv, table, lens, sk, sv = _torch(*_quantized_inputs(21, fmt, **geo))
    pa.reset_launches()
    out = pa._launch(q, pk, pv, table, lens, sk, sv, sm_scale=0.125, window=None,
                     num_splits=splits, kv_format=fmt)
    assert out.shape == q.shape and pa.paged_attention.launches_by_format[fmt] == 1
    ((source, symbol, argtypes, args),) = calls
    assert (source, symbol, argtypes) == pa.C_ENTRY
    params = [p.strip() for p in _c_declaration(source, symbol).split(",")]
    assert len(args) == len(argtypes) == len(params) == 20
    for arg, argtype, param in zip(args, argtypes, params):
        if argtype is ctypes.c_void_p:
            assert "*" in param and (arg is None or isinstance(arg, int)), param
        else:
            assert isinstance(arg, float if argtype is ctypes.c_float else int), param
    named = dict(zip([p.split()[-1].lstrip("*") for p in params], args))
    assert named["splits"] == splits and named["mpp"] == 8 and named["stream"] == 12345
    assert named["kv_format"] == pa.FORMATS.index(fmt)
    assert (named["scale_k"] is None) == (fmt == "f")
    assert named["out"] == out.data_ptr()


def test_paged_splits_are_capped_at_the_cluster_size():
    """More splits than a cluster holds (or than the table has entries)
    compute what the cap computes; every tuning row stays within it."""
    inputs = _torch(*_paged_inputs(22, ps=16, n_pool=64, mpp=16))
    capped = pa.paged_attention(*inputs, num_splits=tuning.MAX_SPLITS)
    assert torch.equal(pa.paged_attention(*inputs, num_splits=16), capped)
    assert torch.equal(pa.paged_attention(*inputs, num_splits=64), capped)
    assert all(row.max_splits <= tuning.MAX_SPLITS
               for row in (*tuning.DECODE_ROWS, tuning.CPU_ROW, tuning.FALLBACK_ROW))


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    log = _build.library_path("flash_attention_wgmma").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fwdv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fwdv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 384 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3dkvv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3dkvv\n"
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 33280 bytes smem, 384 bytes cmem[0]\n"
    )
    assert _build.ptxas_report("flash_attention_wgmma") == {
        "_Z3fwdv": {"registers": 128, "spill_stores": 0, "spill_loads": 0, "smem": 0},
        "_Z3dkvv": {"registers": 255, "spill_stores": 8, "spill_loads": 4, "smem": 33280},
    }


def test_nonzero_launch_status_raises():
    _build.check(0, "ok")
    with pytest.raises(_build.KernelError, match="CUDA error 9"):
        _build.check(9, "paged_attention_fwd")


@pytest.mark.parametrize("fmt", ["f", "int8", "int4"])
@pytest.mark.parametrize(
    "head_dim, ps, mpp, heads, kv_heads",
    [(80, 8, 4, 8, 2), (96, 8, 4, 8, 2), (64, 1, 24, 8, 2), (64, 128, 2, 8, 2),
     (20, 8, 4, 8, 2), (256, 8, 3, 8, 1), (64, 12, 3, 8, 2), (32, 8, 3, 48, 1)],
    ids=["d80", "d96", "page1", "page128", "d20", "d256-group8", "page12", "group48"],
)
def test_paged_plain_matches_jax_at_new_widths_and_pages(fmt, head_dim, ps, mpp, heads,
                                                         kv_heads):
    """Kernel 1's plain version at head_dim 80 and 96 (Phi-2's and
    Phi-3-mini's), 20 (no multiple of 8) and 256 (Gemma-2B's, one kv head
    for 8), at page sizes 1, 12 and 128, and at a kv group of 48
    (StarCoder's), in every pool format, against the reference's kernel run
    in the Pallas interpreter and its XLA lane, 1 and 2 splits."""
    kw = dict(head_dim=head_dim, ps=ps, mpp=mpp, n_pool=3 * mpp + 2, heads=heads,
              kv_heads=kv_heads)
    if fmt == "f":
        inputs = _paged_inputs(30 + head_dim + ps, **kw)
    else:
        inputs = _quantized_inputs(30 + head_dim + ps, fmt, **kw)
    for splits in (1, 2):
        for jax_kw in ({"interpret": True}, {"use_pallas": False}):
            if fmt == "f":
                want = np.asarray(jax_paged(*map(jnp.asarray, inputs), num_splits=splits,
                                            **jax_kw))
                got = pa.paged_attention(*_torch(*inputs), num_splits=splits)
            else:
                want, got = _paged_both(inputs, num_splits=splits, **jax_kw)
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                       err_msg=f"S={splits} {jax_kw}")


@pytest.mark.parametrize("head_dim", [80, 96, 20, 256, 384])
@pytest.mark.parametrize("causal, window", CASES, ids=CASE_IDS)
def test_flash_plain_matches_interpreted_pallas_at_new_widths(causal, window, head_dim):
    """Kernels 2, 3 and 4's plain versions at head_dim 80 and 96, 20 (no
    multiple of 8), 256 (Gemma-2B's) and 384 (past every build) against
    the reference's forward and backward kernels in the Pallas
    interpreter (lse, output and dq/dk/dv of sum(out^2))."""
    q, k, v = _flash_inputs(40 + head_dim, h=4, hk=2, s=128, d=head_dim)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, want_lse = _flash_impl(jq, jk, jv, causal, window, head_dim ** -0.5, 64, 64, True)
    out, lse = fa.flash_forward(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse)[:, :, 0].reshape(lse.shape), rtol=TOL, atol=TOL
    )
    want = _jax_grads(q, k, v, causal=causal, window=window, bwd_impl="pallas",
                      interpret=True, block_q=64, block_kv=64)
    got = _grads(q, k, v, causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=BWD_TOL_PALLAS, atol=BWD_TOL_PALLAS,
                                   err_msg=f"d{name}")
