"""Flash attention: the forward and backward CUDA kernels' wrappers, their
plain PyTorch versions, the ``mha_reference`` oracle and the block rule.

Counterpart of ``k8s_device_plugin_tpu/ops/flash_attention.py``.  Layout
[batch, heads, seq, head_dim]; k/v may carry ``kv_heads`` dividing q's
heads (GQA).  The kernels, each source with its bound on the card and what
its design does about it:

- the forward (kernel 2): ``csrc/flash_attention_wgmma.cu`` for bf16, on
  the tensor cores; ``csrc/flash_attention.cu`` for float32, FMA on the
  CUDA cores;
- dQ (kernel 3, which also writes D = rowsum(dO o O) for kernel 4):
  ``csrc/flash_attention_bwd_dq_wgmma.cu`` for bf16, on the tensor cores;
  ``csrc/flash_attention_bwd.cu`` for float32, FMA;
- dK/dV (kernel 4): ``csrc/flash_attention_bwd_wgmma.cu`` for bf16,
  ``csrc/flash_attention_bwd.cu`` for float32.

The variant is chosen by the input type (:data:`VARIANTS`), never by a
failure: ``wgmma`` has no float32 operands and TF32 would miss the float32
tolerances, so float32 keeps the FMA kernels by design, and each type has
exactly one kernel.

:func:`flash_forward` and :func:`flash_backward` launch the kernels for
CUDA tensors and take :func:`flash_attention_reference` (an online-softmax
loop over kv tiles) and :func:`flash_attention_backward_reference` (the
chunked backward) for CPU tensors, with no fallback between them.
:func:`flash_attention` joins the two in one ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NEG_INF = float("-inf")

# The CUDA forward's (q rows, kv columns) tile, the same in both variants
# (BQ, BK in csrc/flash_attention_wgmma.cu: m64n64 wgmma tiles over a
# 64-row q tile and 64-column K/V ring stages; in csrc/flash_attention.cu:
# one thread per q row, with 32-column kv tiles at head_dim 128).  It
# replaces the TPU's per-generation block table.  The plain version tiles kv
# by 128.  All take any sequence length: the last tile of either is ragged.
CUDA_TILE = (64, 64)
_PLAIN_TILE = (128, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_P,) * 5 + (_I,) * 8 + (_F, _P)
_BWD_ARGS = (_P,) * 8 + (_I,) * 8 + (_F, _P)  # kernels 3 and 4


class Variant(NamedTuple):
    """One CUDA kernel variant: its design ("wgmma": tensor cores, "fma":
    CUDA cores) and its C entry ``symbol`` in ``csrc/<source>.cu``."""

    design: str
    source: str
    symbol: str
    argtypes: tuple


# The variant each input type launches, per kernel (see the module note).
VARIANTS = {
    "forward": {
        torch.bfloat16: Variant("wgmma", "flash_attention_wgmma", "flash_attention_fwd_wgmma",
                                _FWD_ARGS),
        torch.float32: Variant("fma", "flash_attention", "flash_attention_fwd_fma", _FWD_ARGS),
    },
    "dq": {
        torch.bfloat16: Variant("wgmma", "flash_attention_bwd_dq_wgmma",
                                "flash_attention_bwd_dq_wgmma", _BWD_ARGS),
        torch.float32: Variant("fma", "flash_attention_bwd", "flash_attention_bwd_dq_fma",
                               _BWD_ARGS),
    },
    "dkv": {
        torch.bfloat16: Variant("wgmma", "flash_attention_bwd_wgmma",
                                "flash_attention_bwd_dkv_wgmma", _BWD_ARGS),
        torch.float32: Variant("fma", "flash_attention_bwd", "flash_attention_bwd_dkv_fma",
                               _BWD_ARGS),
    },
}
DESIGNS = ("wgmma", "fma")


def variant(kernel: str, dtype: torch.dtype) -> Variant:
    """The variant of ``kernel`` ("forward", "dq" or "dkv") that CUDA
    tensors of ``dtype`` launch; raises for a type no kernel takes."""
    try:
        return VARIANTS[kernel][dtype]
    except KeyError:
        raise ValueError(f"the CUDA {kernel} kernel takes float32|bfloat16, got {dtype}") from None


def _call(var: Variant, *args) -> None:
    """Launch ``var``'s C entry (building it at first use); raise
    KernelError on a failed build or a non-zero launch status."""
    _build.check(_build.entry(var.source, var.symbol, list(var.argtypes))(*args), var.symbol)


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


def flash_attention_backward_reference(q, k, v, out, lse, dout, *, causal, sm_scale, window,
                                       block_kv):
    """The plain backward (the reference's ``_mha_bwd_chunked``): P is
    recomputed one kv block of ``block_kv`` at a time from the saved lse
    (the last block ragged when ``block_kv`` does not divide s_kv), so no
    [s_q, s_kv] matrix exists.  GQA runs in a grouped [b, hk, group, s, d]
    layout, so K/V are never expanded and dK/dV sum their group in one
    product; D = rowsum(dO o O) is computed once per row; with a window only
    the query band that can see a kv block is sliced.  P and dS are rounded
    to the input type before their products, as the kernels do (a no-op in
    float32).  Returns (dq, dk, dv) in q's, k's and v's types."""
    batch, heads, seq_q, head_dim = q.shape
    kv_heads, seq_kv = k.shape[1], k.shape[2]
    group = heads // kv_heads
    g5 = (batch, kv_heads, group, seq_q, head_dim)
    qf, dof = q.float().reshape(g5), dout.float().reshape(g5)
    kf, vf = k.float(), v.float()
    d_row = (dof * out.float().reshape(g5)).sum(dim=-1)  # [b, hk, g, s_q]
    lse = lse.reshape(g5[:4])
    # Rows that attended to nothing carry lse = -inf: their P is forced to 0
    # (exp(s - -inf) would be +inf).
    finite = lse > NEG_INF
    lse_safe = torch.where(finite, lse, 0.0)
    banded = (
        causal and window is not None and seq_q == seq_kv and block_kv + window - 1 < seq_q
    )
    q_rows = min(seq_q, block_kv + window - 1) if banded else seq_q
    dq = torch.zeros_like(qf)
    dk = torch.empty((batch, kv_heads, seq_kv, head_dim), device=q.device)
    dv = torch.empty_like(dk)
    for start in range(0, seq_kv, block_kv):
        kb, vb = kf[:, :, start : start + block_kv], vf[:, :, start : start + block_kv]
        # The band [row0, row0 + q_rows) holds every row that sees this
        # block (clamped at the end of the sequence).
        row0 = min(start, seq_q - q_rows) if banded else 0
        rows = slice(row0, row0 + q_rows)
        q_b, do_b = qf[:, :, :, rows], dof[:, :, :, rows]
        s = torch.einsum("bhgqd,bhkd->bhgqk", q_b, kb) * sm_scale
        p = torch.where(finite[..., rows, None], torch.exp(s - lse_safe[..., rows, None]), 0.0)
        if causal:
            r = row0 + torch.arange(q_rows, device=q.device)[:, None]
            c = start + torch.arange(kb.shape[2], device=q.device)[None, :]
            mask = r >= c
            if window is not None:
                mask = mask & (r - c < window)
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do_b, vb)
        ds = (p * (dp - d_row[..., rows, None]) * sm_scale).to(q.dtype).float()
        dq[:, :, :, rows] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb)
        dk[:, :, start : start + block_kv] = torch.einsum("bhgqk,bhgqd->bhkd", ds, q_b)
        dv[:, :, start : start + block_kv] = torch.einsum(
            "bhgqk,bhgqd->bhkd", p.to(dout.dtype).float(), do_b
        )
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The head dims every kernel takes, in both variants: any multiple of 8 from
# 8 to 128.  The FMA kernels are built at 16, 32, 64 and 128, the wgmma
# kernels at 64 and 128; any other head_dim runs in the next wider of the
# 64- and 128-wide builds, its columns past head_dim zero-filled.
HEAD_DIMS = tuple(range(8, 129, 8))


def check_head_dim(head_dim: int) -> None:
    """Raise ValueError, naming what is taken, for a head_dim the CUDA
    kernels do not take."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"the CUDA flash kernels take a head_dim that is a multiple of 8 from 8 to 128, "
            f"got {head_dim}"
        )


def _check_kernel_inputs(kernel, **tensors) -> Variant:
    """The CUDA kernels take contiguous tensors of one type on one device,
    a head_dim of :data:`HEAD_DIMS`, rows aligned for 16-byte loads;
    returns the variant of ``kernel`` that their type launches
    (:func:`variant`, which raises for a type no kernel takes)."""
    ref = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name} must match q's device and type")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    var = variant(kernel, ref.dtype)
    check_head_dim(ref.shape[-1])
    return var


def _check_row_stats(q, **tensors):
    """lse and delta, which the backward kernels read per q row: contiguous
    float32 [batch, heads, seq_q] on q's device."""
    for name, t in tensors.items():
        if (t.dtype != torch.float32 or t.shape != q.shape[:3] or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 [batch, heads, seq_q] "
                             "tensor on q's device")


def _shape_args(q, k, causal, sm_scale, window):
    """The C entries' shape and option arguments, batch through sm_scale."""
    batch, heads, seq_q, head_dim = q.shape
    return (batch, heads, k.shape[1], seq_q, k.shape[2], head_dim, int(causal),
            0 if window is None else int(window), float(sm_scale))


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _launch(q, k, v, *, causal, sm_scale, window):
    """Kernel 2 on CUDA tensors: returns (out, lse)."""
    var = _check_kernel_inputs("forward", q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call(var, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
          *_shape_args(q, k, causal, sm_scale, window), _stream(q))
    flash_attention.launches += 1
    flash_attention.launches_by_design[var.design] += 1
    return out, lse


def launch_dq(q, k, v, out, lse, dout, *, causal, sm_scale, window):
    """Kernel 3 on CUDA tensors: returns (dq, delta), where delta [b, h, s_q]
    float32 is D = rowsum(dO o O), which kernel 4 reads."""
    var = _check_kernel_inputs("dq", q=q, k=k, v=v, out=out, dout=dout)
    _check_row_stats(q, lse=lse)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call(var, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
          *_shape_args(q, k, causal, sm_scale, window), _stream(q))
    flash_backward.dq_launches += 1
    flash_backward.dq_launches_by_design[var.design] += 1
    return dq, delta


def launch_dkv(q, k, v, lse, delta, dout, *, causal, sm_scale, window):
    """Kernel 4 on CUDA tensors (after :func:`launch_dq` on the same
    stream, whose ``delta`` it reads): returns (dk, dv)."""
    var = _check_kernel_inputs("dkv", q=q, k=k, v=v, dout=dout)
    _check_row_stats(q, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call(var, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
          delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          *_shape_args(q, k, causal, sm_scale, window), _stream(q))
    flash_backward.dkv_launches += 1
    flash_backward.dkv_launches_by_design[var.design] += 1
    return dk, dv


def _check_args(q, k, causal, window):
    _check_window(causal, window)
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")


def flash_forward(q, k, v, *, causal=False, sm_scale=None, window=None):
    """The forward with its log-sum-exp (the reference's ``_flash_impl``):
    returns (out [b, h, s_q, d], lse [b, h, s_q] float32)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_args(q, k, causal, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
    _, block_kv = resolve_blocks(q.shape[2], k.shape[2])
    return flash_attention_reference(
        q, k, v, causal=causal, sm_scale=sm_scale, window=window, block_kv=block_kv
    )


def flash_backward(q, k, v, out, lse, dout, *, causal=False, sm_scale=None, window=None):
    """dq, dk, dv from the forward's residuals and the output's gradient
    (the reference's ``_flash_bwd``): kernels 3 and 4 on the card, the
    chunked plain backward on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    _check_args(q, k, causal, window)
    if q.device.type == "cuda":
        opts = dict(causal=causal, sm_scale=sm_scale, window=window)
        dq, delta = launch_dq(q, k, v, out, lse, dout, **opts)
        return (dq, *launch_dkv(q, k, v, lse, delta, dout, **opts))
    _, block_kv = resolve_blocks(q.shape[2], k.shape[2])
    return flash_attention_backward_reference(
        q, k, v, out, lse, dout, causal=causal, sm_scale=sm_scale, window=window,
        block_kv=block_kv,
    )


class _FlashAttention(torch.autograd.Function):
    """Kernel 2 forward, kernels 3 and 4 backward (the reference's
    ``custom_vjp``).  Saves q, k, v, out and lse [b, h, s_q] float32."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        out, lse = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, sm_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, window = ctx.options
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(),
            causal=causal, sm_scale=sm_scale, window=window,
        )
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=False, sm_scale=None, window=None):
    """Fused attention over [batch, heads, seq, head_dim], any sequence
    length; GQA is native; differentiable in q, k and v.  ``window``
    (requires ``causal``): each query sees its ``window`` most recent
    positions, itself included."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if sm_scale is None:
            sm_scale = q.shape[-1] ** -0.5
        return _FlashAttention.apply(q, k, v, causal, sm_scale, window)
    return flash_forward(q, k, v, causal=causal, sm_scale=sm_scale, window=window)[0]


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
    flash_backward.dq_launches = 0
    flash_backward.dq_launches_by_design = dict.fromkeys(DESIGNS, 0)
    flash_backward.dkv_launches = 0
    flash_backward.dkv_launches_by_design = dict.fromkeys(DESIGNS, 0)


# Kernel launches since the last reset (the plain versions never count):
# the forward's, and the backward's dQ and dK/dV kernels', each in total
# and by variant design.
reset_launches()
