"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider

bf16 runs the tensor-core (wgmma) variants of kernels 2, 3 and 4 and
float32 their FMA variants; each test checks which one launched.  Kernel 1
is one launch per call in every pool format and split count (its splits
merge inside a thread-block cluster).

Tolerances: forward outputs within 2e-2 in bf16 (bf16 output rounding plus
float32 sum order) and 2e-5 in float32 (sum order), lse within 1e-3;
backward gradients within 2e-2 of max |plain| in bf16 (bf16 rounding of dS,
P and the gradients) and 1e-4 in float32 (sum order).  The int4 unpack and
the int8 x int8 -> int32 products are exact.  ``chip_smoke.py`` runs the
same comparisons at full width.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

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
        fa.reset_launches()
        got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
        assert fa.flash_backward.dq_launches == fa.flash_backward.dkv_launches == 1
        assert fa.flash_backward.dq_launches_by_design[_DESIGN[dtype]] == 1
        assert fa.flash_backward.dkv_launches_by_design[_DESIGN[dtype]] == 1
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
    fa.reset_launches()
    (fa.flash_attention(q, k, v, causal=True) ** 2).sum().backward()
    assert fa.flash_attention.launches == 1
    assert fa.flash_backward.dq_launches == fa.flash_backward.dkv_launches == 1
    # float32 leaves: the FMA variants of kernels 2, 3 and 4.
    assert fa.flash_attention.launches_by_design == {"wgmma": 0, "fma": 1}
    assert fa.flash_backward.dq_launches_by_design == {"wgmma": 0, "fma": 1}
    assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 0, "fma": 1}
    leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True) ** 2).sum().backward()
    for t, leaf in zip((q, k, v), leaves):
        err = (t.grad.cpu() - leaf.grad).abs().max() / leaf.grad.abs().max()
        assert err.item() <= 1e-4


_DESIGN = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_BF16 = dict(atol=2e-2, lse=1e-3, rel=2e-2)


def _case(dev, seed, *, s, group, dtype, s_kv=None, heads=4, batch=2):
    """q, k, v, dout on the card for one case, made with numpy."""
    rs = np.random.RandomState(seed)
    s_kv = s if s_kv is None else s_kv
    shapes = ((batch, heads, s, 64), (batch, heads // group, s_kv, 64),
              (batch, heads // group, s_kv, 64), (batch, heads, s, 64))
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)
            for shape in shapes]


_MASKS = [(True, None), (True, 40), (False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("seq", [64, 128, 200, 1024])
def test_cuda_tensor_core_forward_matches_plain(dev, seq, group):
    """Kernel 2's wgmma variant (bf16) against the plain forward: one tile,
    several, a ragged last tile and the training length; kv group 1, 2, 4;
    causal, window 40 and non-causal."""
    q, k, v, _ = _case(dev, 20 + seq + group, s=seq, group=group, dtype=torch.bfloat16)
    for causal, window in _MASKS:
        fa.reset_launches()
        out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        assert fa.flash_attention.launches_by_design == {"wgmma": 1, "fma": 0}
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, sm_scale=0.125,
                                                    window=window, block_kv=128)
        assert (out.float() - ref.float()).abs().max().item() <= _BF16["atol"], (causal, window)
        assert (lse - ref_lse).abs().max().item() <= _BF16["lse"], (causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("seq", [64, 128, 200, 1024])
def test_cuda_tensor_core_backward_matches_plain(dev, seq, group):
    """Kernels 3 and 4's wgmma variants (bf16) against the plain backward,
    over the same cases as the forward (the non-causal backward included):
    max |kernel - plain| / max |plain| per gradient."""
    q, k, v, dout = _case(dev, 40 + seq + group, s=seq, group=group, dtype=torch.bfloat16)
    for causal, window in _MASKS:
        out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        fa.reset_launches()
        got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
        assert fa.flash_backward.dq_launches_by_design == {"wgmma": 1, "fma": 0}
        assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 1, "fma": 0}
        want = fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, sm_scale=0.125, window=window, block_kv=128,
        )
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err.item() <= _BF16["rel"], (causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16-wgmma", "f32-fma"])
def test_cuda_fully_masked_rows_give_zero(dev, dtype):
    """Rows that see no column (s_q 200 over s_kv 64 with window 40: rows
    from 103 on) get lse = -inf and output 0, and the backward stays finite
    and equal to the plain one, in both variants."""
    q, k, v, dout = _case(dev, 60, s=200, s_kv=64, group=2, dtype=dtype)
    fa.reset_launches()
    out, lse = fa.flash_forward(q, k, v, causal=True, window=40)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, dout, causal=True, window=40)
    assert fa.flash_attention.launches_by_design[_DESIGN[dtype]] == 1
    assert fa.flash_backward.dq_launches_by_design[_DESIGN[dtype]] == 1
    assert fa.flash_backward.dkv_launches_by_design[_DESIGN[dtype]] == 1
    assert torch.isinf(lse[:, :, 103:]).all() and (lse[:, :, 103:] < 0).all()
    assert torch.isfinite(lse[:, :, :103]).all()
    assert (out[:, :, 103:] == 0).all() and (dq[:, :, 103:] == 0).all()
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t.float()).all()
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, causal=True,
                                                 sm_scale=0.125, window=40, block_kv=128)
    tol = _BF16["rel"] if dtype == torch.bfloat16 else 1e-4
    for g, w in zip((dq, dk, dv), want):
        assert ((g.float() - w.float()).abs().max() / w.float().abs().max()).item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16-wgmma", "f32-fma"])
def test_cuda_dq_kernel_writes_delta(dev, dtype):
    """Kernel 3 writes D = rowsum(dO o O) for kernel 4, for every real row
    of a ragged last tile, in both variants."""
    q, k, v, dout = _case(dev, 61, s=200, group=2, dtype=dtype)
    out, lse = fa.flash_forward(q, k, v, causal=True)
    _, delta = fa.launch_dq(q, k, v, out, lse, dout, causal=True, sm_scale=0.125, window=None)
    want = (dout.float() * out.float()).sum(dim=-1)
    assert (delta - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


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


def _pools(fmt, dtype, dev, rs, shape):
    """Pool keyword arguments in ``fmt`` from seeded float pools."""
    k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32)) for _ in range(2))
    if fmt == "f":
        return {"pool_k": k.to(dev, dtype), "pool_v": v.to(dev, dtype)}
    return {name: t.to(dev) for name, t in _quantized(fmt, k, v).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["f", "int8", "int4"])
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)],
                         ids=["bf16", "f32"])
def test_cuda_paged_kernel_over_splits_lens_and_windows(dev, fmt, dtype, tol):
    """Kernel 1 against its plain version over 1, 2 and 8 splits (8: one
    full cluster), lens 0, 1, page edges (15, 16, 17, 32, 33) and a full
    table, windows none, 1, 20 and 100, group 4; one launch counted per
    call, rows with len 0 give 0."""
    rs = np.random.RandomState(19)
    batch, heads, kv_heads, d, ps, mpp, n_pool = 8, 16, 4, 64, 16, 8, 80
    pools = _pools(fmt, dtype, dev, rs, (n_pool, ps, kv_heads, d))
    q = torch.from_numpy(rs.randn(batch, heads, d).astype(np.float32)).to(dev, dtype)
    table = torch.from_numpy(rs.permutation(n_pool)[: batch * mpp].reshape(batch, mpp)
                             .astype(np.int32)).to(dev)
    lens = torch.tensor([0, 1, 15, 16, 17, 32, 33, ps * mpp], dtype=torch.int32, device=dev)
    for splits in (1, 2, 8):
        for window in (None, 1, 20, 100):
            pa.reset_launches()
            got = pa.paged_attention(q, page_table=table, lens=lens, window=window,
                                     num_splits=splits, **pools)
            assert pa.paged_attention.launches_by_format == {
                f: int(f == fmt) for f in pa.FORMATS}
            want = pa.paged_attention_reference(
                q.reshape(batch, kv_heads, heads // kv_heads, d), pools["pool_k"],
                pools["pool_v"], table, lens, sm_scale=d ** -0.5, window=window,
                num_splits=splits, scale_k=pools.get("scale_k"), scale_v=pools.get("scale_v"),
                kv_format=fmt,
            ).reshape(got.shape)
            assert (got[0] == 0).all(), (splits, window)
            assert (got.float() - want.float()).abs().max().item() <= tol, (splits, window)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 8])
def test_cuda_paged_kernel_replays_in_a_graph(dev, splits):
    """The one-launch kernel (a cluster launch at 8 splits) is captured in
    a CUDA graph, and its replay gives the eager call's output."""
    rs = np.random.RandomState(23)
    pools = _pools("f", torch.bfloat16, dev, rs, (64, 16, 4, 64))
    q = torch.from_numpy(rs.randn(4, 16, 64).astype(np.float32)).to(dev, torch.bfloat16)
    table = torch.from_numpy(rs.permutation(64)[:32].reshape(4, 8).astype(np.int32)).to(dev)
    lens = torch.tensor([5, 40, 100, 128], dtype=torch.int32, device=dev)
    call = lambda: pa.paged_attention(q, page_table=table, lens=lens,  # noqa: E731
                                      num_splits=splits, **pools)
    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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


def _flash_case(dev, seed, *, d, dtype, s=200, heads=4, group=2, batch=1):
    rs = np.random.RandomState(seed)
    shapes = ((batch, heads, s, d), (batch, heads // group, s, d),
              (batch, heads // group, s, d), (batch, heads, s, d))
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev, dtype)
            for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(8, 129, 8)) + [1, 4, 20, 100, 136, 192, 256, 384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16-wgmma", "f32-fma"])
def test_cuda_flash_kernels_at_every_head_dim(dev, d, dtype):
    """Kernels 2, 3 and 4 at every multiple of 8 from 8 to 128 (the padded
    builds at all but 16, 32, 64 and 128 for FMA, 64 and 128 for wgmma),
    at head_dims that are no multiple of 8 (zero-padded by the wrapper), at
    256 (the bf16 forward's own build) and past 128 (the wide kernels)
    against their plain versions, causal, window 40 and non-causal, one
    launch of the dtype's variant each; forward tolerances as above, the
    backward's relative to max |plain|."""
    q, k, v, dout = _flash_case(dev, 70 + d, d=d, dtype=dtype)
    fwd_tol = _BF16["atol"] if dtype == torch.bfloat16 else 2e-5
    bwd_tol = _BF16["rel"] if dtype == torch.bfloat16 else 1e-4
    for causal, window in _MASKS:
        fa.reset_launches()
        out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
        design = _DESIGN[dtype]
        assert fa.flash_attention.launches_by_design[design] == 1
        assert fa.flash_backward.dq_launches_by_design[design] == 1
        assert fa.flash_backward.dkv_launches_by_design[design] == 1
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal, sm_scale=d ** -0.5,
                                                    window=window, block_kv=128)
        assert (out.float() - ref.float()).abs().max().item() <= fwd_tol, (causal, window)
        assert (lse - ref_lse).abs().max().item() <= _BF16["lse"], (causal, window)
        want = fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal, sm_scale=d ** -0.5, window=window,
            block_kv=128,
        )
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err.item() <= bwd_tol, (causal, window)


# int4 packs two values a byte: an even head_dim, as the reference's.
_PAGED_D_FMT = [(d, fmt) for d in list(range(8, 129, 8)) + [3, 4, 20, 100, 192, 256, 384]
                for fmt in ("f", "int8", "int4") if fmt != "int4" or d % 2 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [1, 2, 4, 8, 12, 24, 64, 128, 256])
@pytest.mark.parametrize("d, fmt", _PAGED_D_FMT)
@pytest.mark.parametrize("dtype, tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)],
                         ids=["bf16", "f32"])
def test_cuda_paged_kernel_at_every_head_dim_and_page_size(dev, ps, d, fmt, dtype, tol):
    """Kernel 1 at every multiple of 8 from 8 to 128 (int4 rows of 4, 12,
    20, ... bytes copied in 4- and 8-byte pieces), at head_dims that are no
    multiple of 8 (rows of an odd number of bytes copied by plain loads),
    at 256 and past it (256-wide slabs), and at page sizes that are no power
    of two or pass 128, in every pool format (int4 at even head_dims),
    against its plain version: lens 0, 1, page edges and a full table, 1 and
    4 splits, windows none and 7; one launch counted per call."""
    rs = np.random.RandomState(ps * 1000 + d)
    batch, heads, kv_heads = 6, 8, 2
    mpp = max(2, 96 // ps)  # 96 positions a row (128 at page 64)
    n_pool = batch * mpp + 3
    pools = _pools(fmt, dtype, dev, rs, (n_pool, ps, kv_heads, d))
    q = torch.from_numpy(rs.randn(batch, heads, d).astype(np.float32)).to(dev, dtype)
    table = torch.from_numpy(rs.permutation(n_pool)[: batch * mpp].reshape(batch, mpp)
                             .astype(np.int32)).to(dev)
    full = ps * mpp
    lens = torch.tensor([0, 1, ps - 1 if ps > 2 else 2, ps + 1, full - 5, full],
                        dtype=torch.int32, device=dev)
    for splits in (1, 4):
        for window in (None, 7):
            pa.reset_launches()
            got = pa.paged_attention(q, page_table=table, lens=lens, window=window,
                                     num_splits=splits, **pools)
            assert pa.paged_attention.launches_by_format == {
                f: int(f == fmt) for f in pa.FORMATS}
            want = pa.paged_attention_reference(
                q.reshape(batch, kv_heads, heads // kv_heads, d), pools["pool_k"],
                pools["pool_v"], table, lens, sm_scale=d ** -0.5, window=window,
                num_splits=min(splits, mpp), scale_k=pools.get("scale_k"),
                scale_v=pools.get("scale_v"), kv_format=fmt,
            ).reshape(got.shape)
            assert (got[0] == 0).all(), (splits, window)
            assert (got.float() - want.float()).abs().max().item() <= tol, (splits, window)


def _tiny_engine(dev, **kw):
    """GPTConfig.tiny() (float32, head_dim 16) served at page size 4: the
    paged kernel at its smallest head_dim and a small page."""
    from k8s_device_plugin_tpu_torch.models import engine as engine_mod
    from k8s_device_plugin_tpu_torch.models import transformer as tf

    cfg = tf.GPTConfig.tiny()
    paged = tf.PagedConfig(4, 64, 16)
    return cfg, engine_mod.ServingEngine(cfg, tf.init_params(cfg, seed=0), paged, max_slots=4,
                                         device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cuda_block16_graphs_equal_eager(dev, sampled):
    """The engine at decode_block 16 with the overlap round: its dispatches
    replayed as CUDA graphs give the eager run's streams exactly (greedy,
    and sampled under one rng), and the paged kernel is counted once per
    layer on every dispatched step, replayed or eager."""
    from k8s_device_plugin_tpu_torch.utils import prng

    rs = np.random.RandomState(31)
    jobs = [(rs.randint(1, 512, size=3 + 2 * i).tolist(), n)
            for i, n in enumerate((40, 23, 33, 17, 45, 9))]
    kw = dict(temperature=0.8, top_k=50) if sampled else {}
    streams = {}
    for graphs in (True, False):
        pa.reset_launches()
        cfg, eng = _tiny_engine(dev, decode_block=16, overlap_steps=1, cuda_graphs=graphs,
                                rng=prng.PRNGKey(5))
        streams[graphs] = [r.tokens for r in eng.run(jobs, **kw)]
        launches = pa.paged_attention.launches_by_format
        assert launches["f"] == cfg.num_layers * eng.device_steps > 0
        assert (eng.graph_replays > 0) is graphs
    assert streams[True] == streams[False]
    assert [len(t) for t in streams[True]] == [n for _, n in jobs]


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim, page_size, heads, kv_heads",
                         [(256, 16, 8, 1), (20, 12, 4, 2), (64, 24, 48, 1), (384, 4, 2, 1)],
                         ids=["d256-group8", "d20-page12", "group48-page24", "d384"])
def test_cuda_engine_builds_other_head_dims(dev, head_dim, page_size, heads, kv_heads):
    """Shapes past what the kernels once took build on the card, and the
    engine's greedy tokens on the kernel path (kernel 1 each decode step,
    kernel 2 in the bulk prefill) equal those on the gather path, float32."""
    import dataclasses

    from k8s_device_plugin_tpu_torch.models import engine as engine_mod
    from k8s_device_plugin_tpu_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.GPTConfig.tiny(), hidden_size=heads * head_dim,
                              num_heads=heads, num_kv_heads=kv_heads, max_seq=256)
    params = tf.init_params(cfg, seed=0)
    rs = np.random.RandomState(head_dim)
    jobs = [(rs.randint(1, 512, size=n).tolist(), 8) for n in (128, 37)]
    streams = {}
    for use_kernel in (None, False):
        pa.reset_launches()
        eng = engine_mod.ServingEngine(cfg, params, tf.PagedConfig(page_size, 64, 256 // page_size,
                                                                   use_kernel=use_kernel),
                                       max_slots=2, device=dev)
        streams[use_kernel] = [r.tokens for r in eng.run(jobs)]
        assert (pa.paged_attention.launches_by_format["f"] > 0) is (use_kernel is None)
    assert streams[None] == streams[False]


@pytest.mark.cuda
def test_cuda_lora_graph_replays_across_adapter_ids(dev):
    """One multi-LoRA engine replays its captured dispatch while the slots'
    adapter ids change (the same prompts under [0, 1, -1] and then [1, -1,
    0]): every stream equals an eager engine's on the same jobs, so the
    graph reads the id buffer written in place, not the ids of its
    capture."""
    import dataclasses

    from k8s_device_plugin_tpu_torch.models import engine as engine_mod
    from k8s_device_plugin_tpu_torch.models import transformer as tf

    cfg = dataclasses.replace(tf.GPTConfig.tiny(), lora_rank=2, lora_serve=2)
    params = tf.init_params(cfg, seed=0)
    gen = torch.Generator().manual_seed(3)
    for name in params:
        if ".lora_b" in name:
            params[name] = 0.1 * torch.randn(params[name].shape, generator=gen)
    rs = np.random.RandomState(17)
    prompts = [rs.randint(1, 512, size=5 + i).tolist() for i in range(3)]
    rounds = [(0, 1, None), (1, None, 0)]
    streams = {}
    for graphs in (True, False):
        eng = engine_mod.ServingEngine(cfg, params, tf.PagedConfig(4, 64, 16), max_slots=3,
                                       decode_block=4, device=dev, cuda_graphs=graphs)
        out = []
        for aids in rounds:
            reqs = [eng.submit(p, 12, adapter=a) for p, a in zip(prompts, aids)]
            while not all(r.done for r in reqs):
                eng.step()
            out.append([r.tokens for r in reqs])
        streams[graphs] = out
        assert (eng.graph_replays > 0) is graphs
    assert streams[True] == streams[False]
    assert streams[True][0][0] != streams[True][1][2] or streams[True][0][1] != \
        streams[True][1][0]


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cuda_spec_round_replays_across_rewinds(dev, sampled):
    """A speculative engine's rounds (each rewinds seq_lens in place and
    realigns it after) replay one captured graph per sampler variant and
    give the eager engine's streams; the paged kernel runs layers x gamma
    launches a round, none in the verify pass."""
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.utils import prng

    rs = np.random.RandomState(41)
    jobs = [(rs.randint(1, 512, size=3 + 2 * i).tolist(), n) for i, n in enumerate((30, 17, 25))]
    kw = dict(temperature=0.8, top_k=50) if sampled else {}
    draft = quant.quantize_lm_params(tf.init_params(tf.GPTConfig.tiny(), seed=0))
    streams = {}
    for graphs in (True, False):
        pa.reset_launches()
        cfg, eng = _tiny_engine(dev, spec_gamma=3, draft_params=draft, cuda_graphs=graphs,
                                rng=prng.PRNGKey(5))
        streams[graphs] = [r.tokens for r in eng.run(jobs, **kw)]
        assert pa.paged_attention.launches_by_format["f"] == cfg.num_layers * 3 * eng.spec_rounds
        assert eng.spec_rounds > 1 and (eng.graph_replays > 0) is graphs
    assert streams[True] == streams[False]


def _image_batch(n, size, seed=0):
    rs = np.random.RandomState(seed)
    return {"images": torch.from_numpy(rs.randn(n, size, size, 3).astype(np.float32)),
            "labels": torch.from_numpy(rs.randint(0, 10, size=n)).long()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet", "alexnet", "vit", "vit-d256"])
def test_cuda_image_model_step_equals_the_cpu_step(dev, name):
    """One float32 train step (TF32 off) of each image model, card against
    CPU from the same weights, batch and dropout keys: loss and every
    parameter and statistic within 1e-4 (cuDNN's sum order over a conv's
    k*k*C terms, through BatchNorm's 1/std).  ViT at 256 tokens runs the
    FMA variants of kernels 2-4, 2 layers x 1 step each; at head_dim 256
    (two heads of 512), their wide kernels."""
    from k8s_device_plugin_tpu_torch.models import alexnet, resnet, train, vit
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    fp32_reference_precision()
    f32 = torch.float32
    makers = {
        "resnet": (lambda d: resnet.ResNet18Thin(num_classes=10, dtype=f32, norm_dtype=f32,
                                                 device=d), 32),
        "alexnet": (lambda d: alexnet.AlexNet(10, f32, width=0.125, image_size=128, device=d),
                    128),
        "vit": (lambda d: vit.ViT(vit.ViTConfig(image_size=64, patch_size=4, num_classes=10,
                                                hidden_size=128, num_layers=2, num_heads=2,
                                                intermediate_size=256, dtype=f32), device=d), 64),
        "vit-d256": (lambda d: vit.ViT(vit.ViTConfig(image_size=64, patch_size=4,
                                                     num_classes=10, hidden_size=512,
                                                     num_layers=2, num_heads=2,
                                                     intermediate_size=256, dtype=f32),
                                       device=d), 64),
    }
    make, size = makers[name]
    batch = _image_batch(8, size)
    cpu = make("cpu")
    card = make(dev)
    card.load_state_dict(cpu.state_dict())
    results = []
    for model, device in ((card, dev), (cpu, torch.device("cpu"))):
        state = train.state_for(model)
        fa.reset_launches()
        _, loss = train.make_train_step(input_key="images")(
            state, {k: v.to(device) for k, v in batch.items()})
        if device.type == "cuda":
            n = 2 if name.startswith("vit") else 0
            assert fa.flash_attention.launches_by_design == {"wgmma": 0, "fma": n}
            assert fa.flash_backward.dq_launches_by_design == {"wgmma": 0, "fma": n}
            assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 0, "fma": n}
        results.append((loss.item(), {k: v.cpu() for k, v in model.state_dict().items()}))
    (card_loss, card_sd), (cpu_loss, cpu_sd) = results
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)
    for k in cpu_sd:
        torch.testing.assert_close(card_sd[k], cpu_sd[k], rtol=0, atol=1e-4, msg=k)


@pytest.mark.cuda
def test_cuda_bert_bf16_step_runs_kernels_2_to_4_non_causal(dev):
    """BERT's flash route on the card: one bf16 step launches the wgmma
    variants of kernels 2, 3 and 4 once per layer; with an attention mask
    it takes the plain route and launches none."""
    from k8s_device_plugin_tpu_torch.models import bert, train

    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=3, num_heads=2,
                          intermediate_size=256, max_position=256)
    model = bert.Bert(cfg, device=dev)
    ids = torch.randint(0, 512, (2, 256), device=dev)
    fa.reset_launches()
    _, loss = train.make_train_step()(train.state_for(model), {"input_ids": ids, "labels": ids})
    assert torch.isfinite(loss)
    assert fa.flash_attention.launches_by_design == {"wgmma": 3, "fma": 0}
    assert fa.flash_backward.dq_launches_by_design == {"wgmma": 3, "fma": 0}
    assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 3, "fma": 0}
    fa.reset_launches()
    with torch.no_grad():
        model(ids, attention_mask=torch.ones_like(ids))
    assert fa.flash_attention.launches == 0
    # head_dim 50, no multiple of 8: the wrapper pads it, the same kernels run.
    cfg = bert.BertConfig(vocab_size=512, hidden_size=100, num_layers=1, num_heads=2,
                          intermediate_size=256, max_position=256)
    model = bert.Bert(cfg, device=dev)
    fa.reset_launches()
    _, loss = train.make_train_step()(train.state_for(model), {"input_ids": ids, "labels": ids})
    assert torch.isfinite(loss)
    assert fa.flash_attention.launches_by_design == {"wgmma": 1, "fma": 0}
    assert fa.flash_backward.dkv_launches_by_design == {"wgmma": 1, "fma": 0}


@pytest.mark.cuda
def test_cuda_prefetch_lands_batches_on_the_card(dev):
    from k8s_device_plugin_tpu_torch.models import input_pipeline
    from k8s_device_plugin_tpu_torch.utils.platform import peak_bf16_flops

    batches = [{"x": np.full((4, 1024), i, np.float32)} for i in range(6)]
    got = list(input_pipeline.prefetch_to_device(iter(batches), size=2, device=dev))
    assert [int(b["x"][0, 0].item()) for b in got] == list(range(6))
    assert all(b["x"].device.type == "cuda" for b in got)
    name = torch.cuda.get_device_name(dev)
    if "H100 80GB HBM3" in name:
        assert peak_bf16_flops(dev) == 989e12
