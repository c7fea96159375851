"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider

Tolerances: forward outputs within 2e-2 in bf16 (bf16 output rounding plus
float32 sum order) and 2e-5 in float32 (sum order), lse within 1e-3;
backward gradients within 2e-2 of max |plain| in bf16 (bf16 rounding of dS,
P and the gradients) and 1e-4 in float32 (sum order).  The int4 unpack and
the int8 x int8 -> int32 products are exact.  ``chip_smoke.py`` runs the
same comparisons at full width.
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa
from k8s_device_plugin_tpu_torch.ops import quant


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def _paged_inputs(seed, batch=3, heads=8, kv_heads=2, head_dim=64, ps=8, n_pool=32, mpp=4):
    rs = np.random.RandomState(seed)
    q = rs.randn(batch, heads, head_dim).astype(np.float32)
    pk = rs.randn(n_pool, ps, kv_heads, head_dim).astype(np.float32)
    pv = rs.randn(n_pool, ps, kv_heads, head_dim).astype(np.float32)
    table = rs.permutation(n_pool)[: batch * mpp].reshape(batch, mpp).astype(np.int32)
    lens = np.array([ps * mpp, ps + 3, 1][:batch], np.int32)
    return q, pk, pv, table, lens


def _flash_inputs(seed, b=1, h=4, hk=2, s=128, d=64):
    rs = np.random.RandomState(seed)
    return (
        rs.randn(b, h, s, d).astype(np.float32),
        rs.randn(b, hk, s, d).astype(np.float32),
        rs.randn(b, hk, s, d).astype(np.float32),
    )


@pytest.mark.cuda
def test_cuda_kernels_match_plain(dev):
    """Kernels 1 and 2 against their plain versions, bf16."""
    q, pk, pv, table, lens = _paged_inputs(6, kv_heads=2, ps=16, n_pool=64, mpp=4)
    tq, tk, tv = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, pk, pv))
    tt, tl = (torch.from_numpy(a).to(dev) for a in (table, lens))
    for splits in (1, 2):
        got = pa.paged_attention(tq, tk, tv, tt, tl, num_splits=splits)
        want = pa.paged_attention_reference(
            tq.reshape(3, 2, 4, 64), tk, tv, tt, tl, sm_scale=0.125, window=None,
            num_splits=splits,
        ).reshape(got.shape)
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
    for seq in (128, 200):  # 200: ragged last q and kv tiles
        fq, fk, fv = (torch.from_numpy(a).to(dev, torch.bfloat16)
                      for a in _flash_inputs(7, s=seq))
        out, lse = fa.flash_forward(fq, fk, fv, causal=True)
        ref, ref_lse = fa.flash_attention_reference(fq, fk, fv, causal=True, sm_scale=0.125,
                                                    window=None, block_kv=128)
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)],
                         ids=["bf16", "f32"])
def test_cuda_backward_kernels_match_plain(dev, dtype, tol):
    """Kernels 3 and 4 against the plain backward: max |kernel - plain| /
    max |plain| per gradient, with one launch of each counted."""
    for seq, kv_heads, causal, window in ((128, 2, True, None), (200, 4, True, 40),
                                          (200, 2, False, None)):
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in _flash_inputs(14, h=4, hk=kv_heads, s=seq))
        out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        dout = torch.randn(out.shape, device=dev).to(dtype)
        fa.flash_backward.dq_launches = fa.flash_backward.dkv_launches = 0
        got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
        assert fa.flash_backward.dq_launches == fa.flash_backward.dkv_launches == 1
        want = fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, sm_scale=0.125, window=window, block_kv=128,
        )
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err.item() <= tol, (seq, kv_heads, causal, window)


@pytest.mark.cuda
def test_cuda_autograd_runs_the_kernels(dev):
    """Autograd through flash_attention on the card launches kernels 2, 3
    and 4 once each and agrees with the plain versions' gradients."""
    q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in _flash_inputs(15, s=200))
    fa.flash_attention.launches = 0
    fa.flash_backward.dq_launches = fa.flash_backward.dkv_launches = 0
    (fa.flash_attention(q, k, v, causal=True) ** 2).sum().backward()
    assert fa.flash_attention.launches == 1
    assert fa.flash_backward.dq_launches == fa.flash_backward.dkv_launches == 1
    leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True) ** 2).sum().backward()
    for t, leaf in zip((q, k, v), leaves):
        err = (t.grad.cpu() - leaf.grad).abs().max() / leaf.grad.abs().max()
        assert err.item() <= 1e-4


def _quantized(fmt, *pools):
    """Codes and scale pools of float pools in ``fmt`` (int8 or int4)."""
    quantize = quant.quantize_kv if fmt == "int8" else quant.quantize_kv4
    (pk, sk), (pv, sv) = (quantize(p) for p in pools)
    return dict(pool_k=pk, pool_v=pv, scale_k=sk, scale_v=sv)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)],
                         ids=["bf16", "f32"])
def test_cuda_quantized_pools_match_plain(dev, fmt, dtype, tol):
    """Kernel 1's int8 and int4 branches against the plain version, with
    one launch counted under the format per call."""
    q, pk, pv, table, lens = _paged_inputs(16, kv_heads=2, ps=16, n_pool=64, mpp=4)
    pools = {k: v.to(dev) for k, v in _quantized(fmt, torch.from_numpy(pk),
                                                 torch.from_numpy(pv)).items()}
    tq = torch.from_numpy(q).to(dev, dtype)
    tt, tl = (torch.from_numpy(a).to(dev) for a in (table, lens))
    for splits, window in ((1, None), (3, None), (2, 20)):
        pa.reset_launches()
        got = pa.paged_attention(tq, page_table=tt, lens=tl, window=window, num_splits=splits,
                                 **pools)
        assert pa.paged_attention.launches_by_format == {"f": 0, fmt: 1, **{
            f: 0 for f in ("int8", "int4") if f != fmt}}
        want = pa.paged_attention_reference(
            tq.reshape(3, 2, 4, 64), pools["pool_k"], pools["pool_v"], tt, tl, sm_scale=0.125,
            window=window, num_splits=splits, scale_k=pools["scale_k"],
            scale_v=pools["scale_v"], kv_format=fmt,
        ).reshape(got.shape)
        assert (got.float() - want.float()).abs().max().item() <= tol, (splits, window)


@pytest.mark.cuda
def test_cuda_int4_unpack_is_exact_on_every_byte(dev):
    """Every byte value in both nibbles: with one live token, unit scales
    and float32, the output is V's row unpacked, exactly; with the bytes in
    K and V over many tokens the kernel agrees with the plain version."""
    n_pool, ps, hk, d = 5, 16, 2, 64
    every = (torch.arange(256) - 128).to(torch.int8)  # all 256 byte values
    pv = torch.zeros((n_pool, ps, hk, d // 2), dtype=torch.int8)
    pv[1:5, 0] = every.reshape(4, hk, d // 2)  # position 0 of pages 1..4
    ones = torch.ones((n_pool, ps, hk))
    q = torch.zeros((4, hk * 4, d))
    table = torch.arange(1, 5, dtype=torch.int32)[:, None]  # row r reads page r + 1
    lens = torch.ones(4, dtype=torch.int32)
    args = [t.to(dev) for t in (q, torch.zeros_like(pv), pv, table, lens)]
    got = pa.paged_attention(*args, scale_k=ones.to(dev), scale_v=ones.to(dev), num_splits=1)
    want = quant.unpack_int4(pv[1:5, 0], torch.float32)  # [row, kv head, d]
    assert torch.equal(got.cpu().reshape(4, hk, 4, d), want[:, :, None].expand(4, hk, 4, d))
    rs = np.random.RandomState(17)
    codes = every[torch.from_numpy(rs.randint(0, 256, size=(2, 8, ps, hk, d // 2)))]
    scales = torch.from_numpy(rs.uniform(0.01, 0.2, size=(2, 8, ps, hk)).astype(np.float32))
    q = torch.from_numpy(rs.randn(2, hk * 4, d).astype(np.float32))
    table = torch.from_numpy(rs.permutation(8)[:6].reshape(2, 3).astype(np.int32))
    lens = torch.tensor([40, 17], dtype=torch.int32)
    args = [t.to(dev) for t in (q, codes[0], codes[1], table, lens)]
    got = pa.paged_attention(*args, scale_k=scales[0].to(dev), scale_v=scales[1].to(dev),
                             num_splits=2)
    want = pa.paged_attention(q, codes[0], codes[1], table, lens, scale_k=scales[0],
                              scale_v=scales[1], num_splits=2)
    assert (got.cpu() - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 40], ids=["decode-rows", "prefill-rows"])
def test_cuda_w8a8_products_match_cpu(dev, rows):
    """int8_dot_general in w8a8 on the card (torch._int_mm, rows padded to
    its minimum) equals the CPU's exact int32 product, at the width of the
    down projection (k = 3072, where a float32 sum would not be exact)."""
    rs = np.random.RandomState(18)
    x = torch.from_numpy(rs.randn(rows, 3072).astype(np.float32))
    w_q, w_scale = quant.quantize_int8(torch.from_numpy(rs.randn(3072, 1024).astype(np.float32)), 1)
    want = quant.int8_dot_general(x, w_q, w_scale, mode="w8a8", dtype=torch.float32)
    got = quant.int8_dot_general(x.to(dev), w_q.to(dev), w_scale.to(dev), mode="w8a8",
                                 dtype=torch.float32)
    assert torch.equal(got.cpu(), want)
