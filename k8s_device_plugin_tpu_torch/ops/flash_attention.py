"""Flash-attention forward: the CUDA kernel's wrapper, its plain PyTorch
version, the ``mha_reference`` oracle and the block rule.

Counterpart of ``k8s_device_plugin_tpu/ops/flash_attention.py`` (forward
only; the backward kernels come with the training slice).  Layout
[batch, heads, seq, head_dim]; k/v may carry ``kv_heads`` dividing q's
heads (GQA).  ``csrc/flash_attention.cu`` holds the kernel with its bound
on the card and what its design does about it.

:func:`flash_forward` launches the kernel for CUDA tensors and takes
:func:`flash_attention_reference` (an online-softmax loop over kv tiles)
for CPU tensors, with no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = float("-inf")

# The CUDA kernel's (q rows, kv columns) tile, fixed in csrc/flash_attention.cu
# (BQ, BK): one thread per q row keeps the row and its accumulator in
# registers, which 64 rows and head_dim 64 fit.  It replaces the TPU's
# per-generation block table.  The plain version tiles kv by 128.  Both
# take any sequence length: the last tile of either is ragged.
CUDA_TILE = (64, 64)
_PLAIN_TILE = (128, 128)
_C_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def resolve_blocks(seq_q, seq_kv, *, on_cuda=False):
    """(block_q, block_kv) for a call: the CUDA tile on the card, the
    plain version's tile otherwise, each clamped to its sequence."""
    tile_q, tile_kv = CUDA_TILE if on_cuda else _PLAIN_TILE
    return min(tile_q, seq_q), min(tile_kv, seq_kv)


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def mha_reference(q, k, v, causal=False, sm_scale=None, window=None):
    """Plain attention with the kernel's semantics: float32 scores and
    softmax, probabilities cast to v's type before p.v, output in q's
    type.  GQA expands the kv heads (this is the oracle, not a fast path)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if k.shape[1] != q.shape[1]:
        if q.shape[1] % k.shape[1]:
            raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
        group = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    _check_window(causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        row = torch.arange(s.shape[-2], device=q.device)[:, None]
        col = torch.arange(s.shape[-1], device=q.device)[None, :]
        mask = row >= col
        if window is not None:
            mask = mask & (row - col < window)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_reference(q, k, v, *, causal, sm_scale, window, block_kv):
    """The plain version: online softmax over kv tiles of ``block_kv``
    (the last one ragged when ``block_kv`` does not divide s_kv).  Returns
    (out [b, h, s_q, d] in q's type, lse [b, h, s_q] float32)."""
    batch, heads, seq_q, head_dim = q.shape
    group = heads // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    qf = q.float()
    m = torch.full((batch, heads, seq_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((batch, heads, seq_q, 1), device=q.device)
    acc = torch.zeros((batch, heads, seq_q, head_dim), device=q.device)
    rows = torch.arange(seq_q, device=q.device)[:, None]
    for k0 in range(0, k.shape[2], block_kv):
        kt, vt = k[:, :, k0 : k0 + block_kv], v[:, :, k0 : k0 + block_kv]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt.float()) * sm_scale
        if causal:
            cols = k0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            mask = rows >= cols
            if window is not None:
                mask = mask & (rows - cols < window)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # Rows that have seen nothing keep m = -inf: exp(-inf - -inf) would
        # be NaN, so they take 0 under the guard.
        seen = m_new > NEG_INF
        p = torch.where(seen, torch.exp(s - torch.where(seen, m_new, 0.0)), 0.0)
        alpha = torch.where(seen, torch.exp(torch.where(seen, m - m_new, 0.0)), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(l_safe), NEG_INF)[..., 0]
    return out, lse


def _launch(q, k, v, *, causal, sm_scale, window):
    batch, heads, seq_q, head_dim = q.shape
    kv_heads, seq_kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and type")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes float32|bfloat16, got {q.dtype}")
    if head_dim != 64:
        raise ValueError(f"the CUDA kernel takes head_dim 64, got {head_dim}")
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention", "flash_attention_fwd", _C_ARGS)
    status = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        batch, heads, kv_heads, seq_q, seq_kv, head_dim, int(causal),
        0 if window is None else int(window), float(sm_scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_forward(q, k, v, *, causal=False, sm_scale=None, window=None):
    """The forward with its log-sum-exp (the reference's ``_flash_impl``):
    returns (out [b, h, s_q, d], lse [b, h, s_q] float32)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_window(causal, window)
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    _, block_kv = resolve_blocks(q.shape[2], k.shape[2])
    return flash_attention_reference(
        q, k, v, causal=causal, sm_scale=sm_scale, window=window, block_kv=block_kv
    )


def flash_attention(q, k, v, *, causal=False, sm_scale=None, window=None):
    """Fused attention forward over [batch, heads, seq, head_dim], any
    sequence length; GQA is native.  ``window`` (requires ``causal``): each
    query sees its ``window`` most recent positions, itself included."""
    return flash_forward(q, k, v, causal=causal, sm_scale=sm_scale, window=window)[0]


# Kernel launches since the last reset (the plain version never counts).
flash_attention.launches = 0
