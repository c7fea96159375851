"""Split-K paged decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``k8s_device_plugin_tpu/ops/paged_attention.py``.  One query
token per row attends over the row's pages of a shared KV pool through a
page table; each row's page list is partitioned across ``num_splits``
blocks that keep an online-softmax triple (m, l, acc) each, and an exact
combine merges them (see ``csrc/paged_attention.cu`` for the kernel, its
bound on the card, and what its design does about it).

Pool formats, as the reference's: float pools (float32, bfloat16, in q's
type); int8 codes with float32 scale pools ``[pages, page_size,
kv_heads]``; int4 codes packed two per byte along head_dim with the same
scale pools (``ops/quant.py`` ``quantize_kv``/``quantize_kv4``).  The
scales factor out of the head_dim dot: K's multiplies the score, V's the
probability, so no dequantized page is formed.

:func:`paged_attention` launches the kernel for CUDA tensors and takes
:func:`paged_attention_reference` (the port of the reference's
``_decode_xla``: same split partition, same combine) for CPU tensors.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, tuning
from .quant import unpack_int4

NEG_INF = float("-inf")
FORMATS = ("f", "int8", "int4")  # the kernel's kv_format codes 0, 1, 2
_C_ARGS = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def _combine_splits(o_part, m_part, l_part, out_dtype):
    """Reduce the split axis (1): ``o_part`` [b, S, hk, g, d] f32
    unnormalised accumulators, ``m_part``/``l_part`` [b, S, hk, g].  Empty
    splits (m = -inf, l = 0) contribute nothing; a row with no live split
    returns zeros, not NaN."""
    m_star = m_part.amax(dim=1, keepdim=True)
    seen = m_part > NEG_INF
    alpha = torch.where(
        seen, torch.exp(torch.where(seen, m_part - m_star, 0.0)), 0.0
    )
    denom = (alpha * l_part).sum(dim=1)
    out = (alpha[..., None] * o_part).sum(dim=1)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return (out / denom[..., None]).to(out_dtype)


def paged_attention_reference(q4, pool_k, pool_v, table, lens, *, sm_scale, window, num_splits,
                              scale_k=None, scale_v=None, kv_format="f"):
    """The plain version: split-K online softmax vectorised over the split
    axis.  ``q4`` is [batch, kv_heads, group, head_dim]; returns the same
    shape.  Products run in float32 on the operands' exact values (the
    reference's ``preferred_element_type=float32``).  Quantized codes cast
    (int8) or unpack (int4) exactly to q's type; the scores take K's scale
    after ``sm_scale``, ``l`` sums the unscaled probabilities, and the
    probabilities take V's scale and round to q's type before p.v."""
    batch, kv_heads, group, head_dim = q4.shape
    page_size = pool_k.shape[1]
    mpp = table.shape[1]
    pps = -(-mpp // num_splits)
    if pps * num_splits != mpp:
        # Padding entries alias page 0; their positions start at or past
        # max_len >= len, so the frontier mask discards them.
        table = torch.nn.functional.pad(table, (0, pps * num_splits - mpp))
    span = pps * page_size
    idx = table.long()
    k = pool_k[idx].reshape(batch, num_splits, span, kv_heads, -1)
    v = pool_v[idx].reshape(batch, num_splits, span, kv_heads, -1)
    if kv_format == "int4":
        k, v = unpack_int4(k, q4.dtype), unpack_int4(v, q4.dtype)
    elif kv_format == "int8":
        k, v = k.to(q4.dtype), v.to(q4.dtype)
    quant = kv_format != "f"
    s = torch.einsum("bhgd,bslhd->bshgl", q4.float(), k.float()) * sm_scale
    if quant:
        sk = scale_k[idx].reshape(batch, num_splits, span, kv_heads)
        s = s * sk.permute(0, 1, 3, 2)[:, :, :, None, :]
    col = torch.arange(num_splits * span, device=q4.device).reshape(num_splits, span)
    col = col[None, :, None, None, :]
    ln = lens.long()[:, None, None, None, None]
    valid = col < ln
    if window is not None:
        valid = valid & (col >= ln - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    seen = m > NEG_INF
    p = torch.where(seen, torch.exp(s - torch.where(seen, m, 0.0)), 0.0)
    l = p.sum(dim=-1)
    if quant:
        sv = scale_v[idx].reshape(batch, num_splits, span, kv_heads)
        p = p * sv.permute(0, 1, 3, 2)[:, :, :, None, :]
    acc = torch.einsum("bshgl,bslhd->bshgd", p.to(v.dtype).float(), v.float())
    return _combine_splits(acc, m[..., 0], l, q4.dtype)


def _launch(q, pool_k, pool_v, table, lens, scale_k, scale_v, *, sm_scale, window, num_splits,
            kv_format):
    batch, heads, head_dim = q.shape
    kv_heads, page_size = pool_k.shape[2], pool_k.shape[1]
    mpp = table.shape[1]
    scales = () if kv_format == "f" else (("scale_k", scale_k), ("scale_v", scale_v))
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v), ("table", table),
                    ("lens", lens), *scales):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel's row loads)")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("page_table and lens must be int32")
    if head_dim not in (64, 128) or page_size not in (16, 32):
        raise ValueError(
            f"the CUDA kernel takes head_dim 64|128 and page_size 16|32, "
            f"got {head_dim}, {page_size}"
        )
    if heads // kv_heads > 32:
        raise ValueError(f"group {heads // kv_heads} exceeds 32 warps per block")
    out = torch.empty_like(q)
    if num_splits > 1:
        part = torch.empty(
            (batch, num_splits, heads, head_dim), dtype=torch.float32, device=q.device
        )
        ml = torch.empty((2, batch, num_splits, heads), dtype=torch.float32, device=q.device)
        parts = (part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr())
    else:
        parts = (None, None, None)
    ptrs = (None, None) if kv_format == "f" else (scale_k.data_ptr(), scale_v.data_ptr())
    fn = _build.entry("paged_attention", "paged_attention_fwd", _C_ARGS)
    status = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *ptrs, table.data_ptr(),
        lens.data_ptr(), out.data_ptr(), *parts,
        batch, heads, kv_heads, head_dim, page_size, mpp, num_splits,
        0 if window is None else int(window), float(sm_scale),
        FORMATS.index(kv_format), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_attention_fwd")
    paged_attention.launches_by_format[kv_format] += 1
    return out


def _resolve_kv_format(pool_k, pool_v, head_dim: int, scale_k, scale_v, kv_format) -> str:
    """The pool format, inferred and checked as the reference does: int8
    storage whose last dim is ``head_dim // 2`` is int4, other int8 storage
    int8, anything else float; quantized pools need both scale pools and
    float pools take none."""
    if pool_v.dtype != pool_k.dtype or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"pools must match, got k={pool_k.dtype}{tuple(pool_k.shape)} "
            f"v={pool_v.dtype}{tuple(pool_v.shape)}"
        )
    if kv_format is None:
        if pool_k.dtype == torch.int8:
            kv_format = "int4" if pool_k.shape[3] * 2 == head_dim else "int8"
        else:
            kv_format = "f"
    if kv_format not in FORMATS:
        raise ValueError(f"kv_format must be f|int8|int4, got {kv_format!r}")
    int4, quant = kv_format == "int4", kv_format != "f"
    if quant and pool_k.dtype != torch.int8:
        raise ValueError(f"{kv_format} pools must be int8 storage, got {pool_k.dtype}")
    if int4 and head_dim % 2:
        raise ValueError(f"int4 packing needs even head_dim, got {head_dim}")
    want_last = head_dim // 2 if int4 else head_dim
    if pool_k.shape[3] != want_last:
        raise ValueError(
            f"pool head_dim {pool_k.shape[3]} != expected {want_last} for "
            f"kv_format={kv_format!r} (int4 pools pack two values per byte)"
        )
    if quant and (scale_k is None or scale_v is None):
        raise ValueError(f"{kv_format} pools require scale_k and scale_v scale pools")
    if not quant and (scale_k is not None or scale_v is not None):
        raise ValueError(f"scale pools passed with {pool_k.dtype} (non-int8) pools")
    if quant:
        for name, sc in (("scale_k", scale_k), ("scale_v", scale_v)):
            if sc.dtype != torch.float32 or tuple(sc.shape) != tuple(pool_k.shape[:3]):
                raise ValueError(
                    f"{name} must be float32 {tuple(pool_k.shape[:3])} (pages, page_size, "
                    f"kv_heads), got {sc.dtype}{tuple(sc.shape)}"
                )
    return kv_format


def paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    lens: torch.Tensor,
    *,
    scale_k: torch.Tensor | None = None,
    scale_v: torch.Tensor | None = None,
    sm_scale: float | None = None,
    window: int | None = None,
    num_splits: int | None = None,
    kv_format: str | None = None,
) -> torch.Tensor:
    """Single-token decode attention over a paged KV pool (split-K).

    q: [batch, num_heads, head_dim] float32 or bfloat16.  pool_k/pool_v:
    [num_pool_pages, page_size, kv_heads, head_dim] float pools in q's
    type, int8 pools, or int4-packed pools ([..., head_dim // 2] int8).
    page_table: [batch, pages_per_seq] int32 physical page ids.  lens:
    [batch] int32 valid cache slots per row (the current token's K/V
    already written: ``lens = position + 1``).  Returns [batch, num_heads,
    head_dim] in q's type.

    ``scale_k``/``scale_v``: float32 [num_pool_pages, page_size, kv_heads],
    required by the quantized formats.  ``kv_format``: None infers "f",
    "int8" or "int4" from the pools (see :func:`_resolve_kv_format`).
    ``window``: the query sees only its last ``window`` positions.
    ``num_splits``: blocks per row's page list (None = ops/tuning.py for
    the tensor's device); every split count computes the same attention.
    """
    batch, num_heads, head_dim = q.shape
    kv_heads = pool_k.shape[2]
    pages_per_seq = page_table.shape[1]
    if num_heads % kv_heads:
        raise ValueError(f"num_heads {num_heads} not a multiple of kv_heads {kv_heads}")
    kv_format = _resolve_kv_format(pool_k, pool_v, head_dim, scale_k, scale_v, kv_format)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv_format == "f" and q.dtype != pool_k.dtype:
        raise ValueError(f"q is {q.dtype}, pools are {pool_k.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    if num_splits is None:
        num_splits = tuning.pick_num_splits(
            pages_per_seq, tuning.device_generation(q.device)
        )
    num_splits = max(1, min(int(num_splits), pages_per_seq))
    if q.device.type == "cuda":
        return _launch(
            q, pool_k, pool_v, page_table, lens, scale_k, scale_v,
            sm_scale=sm_scale, window=window, num_splits=num_splits, kv_format=kv_format,
        )
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention runs on cuda or cpu, got {q.device}")
    group = num_heads // kv_heads
    out = paged_attention_reference(
        q.reshape(batch, kv_heads, group, head_dim), pool_k, pool_v, page_table, lens,
        sm_scale=sm_scale, window=window, num_splits=num_splits,
        scale_k=scale_k, scale_v=scale_v, kv_format=kv_format,
    )
    return out.reshape(batch, num_heads, head_dim)


def reset_launches() -> None:
    """Set the kernel's launch count of every pool format to 0."""
    paged_attention.launches_by_format = dict.fromkeys(FORMATS, 0)


# Kernel launches by pool format since the last reset (the plain version
# never counts).
reset_launches()
