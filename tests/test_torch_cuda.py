"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider

Tolerances: forward outputs within 2e-2 in bf16 (bf16 output rounding plus
float32 sum order) and lse within 1e-3; backward gradients within 2e-2 of
max |plain| in bf16 (bf16 rounding of dS, P and the gradients) and 1e-4 in
float32 (sum order).  ``chip_smoke.py`` runs the same comparisons at full
width.
"""

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
from k8s_device_plugin_tpu_torch.ops import paged_attention as pa


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
