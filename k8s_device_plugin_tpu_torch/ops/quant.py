"""Post-training int8 quantization for the serving path.

Counterpart of ``k8s_device_plugin_tpu/ops/quant.py``, with the same codes
and scales bit for bit: symmetric scales only (no zero points), the amax
over the reduced axes guarded to scale 1 when it is 0, ``x / scale`` in
float32 rounded half to even and clipped to [-127, 127] (int8) or [-7, 7]
(int4).

- Weights: per-output-channel int8 (:func:`quantize_int8`).  Two compute
  modes in :func:`int8_dot_general`: ``w8`` dequantizes the weight to the
  compute type and runs a plain product (``torch.matmul``); ``w8a8``
  quantizes each activation row over the contracted axes, runs an int8 x
  int8 -> int32 product (``torch._int_mm`` on the card, an int32 matmul on
  the CPU; both exact) and rescales by row scale x channel scale.  These
  products are plain matrix products, which the JAX package leaves to XLA
  outside any Pallas kernel, so they stay library calls here.
- KV: per-(token, head) int8 (:func:`quantize_kv`, :func:`quantize_kv_pair`)
  and int4 packed two codes per byte along head_dim, element 2i in the LOW
  nibble (:func:`pack_int4`, :func:`quantize_kv4`).  The paged-attention
  kernel reads both formats (``ops/paged_attention.py``).

:class:`Int8DenseGeneral` is the quantized dense site; its buffers
``kernel_q``/``kernel_scale`` carry the names and layouts that
:func:`quantize_lm_params` emits, so a quantized state dict loads as it is.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Union

import torch
from torch import nn

# int8 symmetric range [-127, 127]; int4 [-7, 7] (see the reference).
_QMAX = 127.0
_QMAX4 = 7.0

# torch._int_mm on the card takes more than 16 rows (older releases); the
# decode step has one row per slot, so shorter inputs are padded with zero
# rows, which produce zero rows that are dropped.
_INT_MM_MIN_ROWS = 17


def _sym_quantize(x: torch.Tensor, axes: tuple[int, ...], qmax: float = _QMAX, group=None):
    """The symmetric core every quantized path shares: amax over ``axes``
    per remaining coordinate, zero amax guarded to scale 1, round half to
    even and clip to [-qmax, qmax].  Returns (int8 [x.shape], float32
    scale [x.shape minus axes]).  ``group`` (a ``TensorParallel``): ``x``
    is this rank's slice of ``axes``, whose amax is the group's maximum."""
    xf = x.float()
    amax = xf.abs().amax(dim=axes, keepdim=True)
    if group is not None:
        group.all_reduce_max(amax)
    # A tensor divisor: CUDA turns division by a Python scalar into a
    # product with its reciprocal, which can be an ulp off the quotient.
    # It is filled on the device (not copied from the host), so the decode
    # step's appends capture in a CUDA graph.
    scale = torch.where(amax > 0, amax / amax.new_full((), qmax), 1.0)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    return q, scale.squeeze(axes)


def quantize_int8(w: torch.Tensor, contract_ndim: int):
    """Per-output-channel int8 of a kernel [*contract_dims, *feature_dims]:
    the first ``contract_ndim`` axes are reduced for the scale.  Returns
    (int8 [w.shape], float32 [feature_dims])."""
    return _sym_quantize(w, tuple(range(contract_ndim)))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (scale broadcasts over the leading
    contraction axes)."""
    return (q.float() * scale).to(dtype)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) int8 of a K or V slab [batch, tokens, kv_heads,
    head_dim]: one scale per row over head_dim.  Returns (int8 [x.shape],
    float32 [batch, tokens, kv_heads])."""
    return _sym_quantize(x, (-1,))


def quantize_kv_pair(k: torch.Tensor, v: torch.Tensor):
    """Quantize a K/V pair in one pass over the stacked pair (the codes and
    scales equal two :func:`quantize_kv` calls).  Returns ``(k_q, v_q,
    k_scale, v_scale)``."""
    q, scale = _sym_quantize(torch.stack([k, v]), (-1,))
    return q[0], q[1], scale[0], scale[1]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 storage, values in [-7, 7]) two per byte along
    the last axis: element 2i in the low nibble, 2i+1 in the high one."""
    if codes.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {codes.shape[-1]}")
    pairs = codes.reshape(*codes.shape[:-1], codes.shape[-1] // 2, 2).to(torch.int32)
    lo, hi = pairs[..., 0] & 0xF, pairs[..., 1] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: sign-extend each nibble with an
    arithmetic shift on int32 (``(x << 28) >> 28`` for the low one) and
    interleave, doubling the last dim."""
    x = packed.to(torch.int32)
    lo = (x << 28) >> 28
    hi = (x << 24) >> 28
    both = torch.stack([lo, hi], dim=-1)
    return both.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(dtype)


def quantize_kv4(x: torch.Tensor):
    """Per-(token, head) int4 of a K or V slab, packed along head_dim.
    Returns (int8 [..., head_dim // 2], float32 [x.shape minus the last
    axis])."""
    codes, scale = _sym_quantize(x, (-1,), qmax=_QMAX4)
    return pack_int4(codes), scale


def dequantize_kv4(packed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv4`."""
    return (unpack_int4(packed, torch.float32) * scale[..., None]).to(dtype)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] x int8 [k, n] -> int32 [m, n].  On the card
    ``torch._int_mm`` (k and n multiples of 8; rows padded to its minimum);
    a refused launch raises, since a float product is not exact once a sum
    passes 2**24.  On the CPU an int32 matmul."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    rows = a.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    return torch._int_mm(a.contiguous(), b.contiguous())[:rows]


def _normalize_axis(axis: Union[int, Sequence[int]], ndim: int) -> tuple[int, ...]:
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes)


def int8_dot_general(x, w_q, w_scale, *, axis: Union[int, Sequence[int]] = -1,
                     mode: str = "w8", dtype=torch.bfloat16, row_group=None) -> torch.Tensor:
    """Contract ``x``'s ``axis`` dims against the leading dims of ``w_q``
    [*contract, *features]; the result is [*x's other dims, *features] in
    ``dtype``.  ``w8``: the dequantized weight in ``dtype``, plain product.
    ``w8a8``: per-row dynamic int8 activations, exact int32 product,
    rescaled by (row scale x channel scale) in float32.  ``row_group`` (a
    ``TensorParallel``, w8a8 only): ``x`` and ``w_q`` hold this rank's
    slice of the contraction; each row's scale takes the group's absmax
    and the int32 products are summed over the group before the rescale,
    so every rank gets the unsharded result bit for bit."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"mode must be w8|w8a8, got {mode!r}")
    axes = _normalize_axis(axis, x.dim())
    batch_dims = [d for d in range(x.dim()) if d not in axes]
    lead = [x.shape[d] for d in batch_dims]
    n_in = math.prod(x.shape[a] for a in axes)
    feats = tuple(w_q.shape[len(axes):])
    n_out = math.prod(feats)
    rows = x.permute(*batch_dims, *axes).reshape(-1, n_in)
    if mode == "w8":
        w = dequantize_int8(w_q, w_scale, dtype).reshape(n_in, n_out)
        return (rows.to(dtype) @ w).reshape(*lead, *feats)
    x_q, x_scale = _sym_quantize(rows, (1,), group=row_group)  # one scale per row
    acc = _int8_matmul(x_q, w_q.reshape(n_in, n_out))
    if row_group is not None:
        row_group.all_reduce(acc)
    out = acc.float() * x_scale[:, None] * w_scale.reshape(1, n_out)
    return out.to(dtype).reshape(*lead, *feats)


class Int8DenseGeneral(nn.Module):
    """The quantized dense site: ``kernel_q`` int8 [*in_shape, *features]
    and ``kernel_scale`` float32 [*features] are buffers (not trainable;
    ``load_state_dict`` fills them under these names), contracting the
    input's trailing ``len(in_shape)`` axes in ``mode`` and returning
    ``dtype``.  ``row_group``: set by a row-parallel w8a8 site over a
    ``tp`` group, which then returns the whole (reduced) product."""

    def __init__(self, in_shape: tuple, features: tuple, mode: str, dtype, device=None):
        super().__init__()
        if mode not in ("w8", "w8a8"):
            raise ValueError(f"mode must be w8|w8a8, got {mode!r}")
        self.in_shape, self.features = tuple(in_shape), tuple(features)
        self.mode, self.dtype = mode, dtype
        self.register_buffer(
            "kernel_q", torch.zeros(*self.in_shape, *self.features, dtype=torch.int8, device=device)
        )
        self.register_buffer("kernel_scale", torch.ones(self.features, device=device))
        self.row_group = None

    def forward(self, x):
        n = len(self.in_shape)
        return int8_dot_general(
            x, self.kernel_q, self.kernel_scale, axis=tuple(range(-n, 0)),
            mode=self.mode, dtype=self.dtype, row_group=self.row_group,
        )


def contract_ndim(name: str, ndim: int) -> int:
    """Contracted leading axes of the kernel at site ``name`` (the
    reference's rule): 2-D contracts 1; attention's 3-D ``out`` contracts
    2; 3-D ``query``/``key``/``value`` contract 1; anything else raises."""
    if ndim <= 2:
        return 1
    if name == "out" and ndim == 3:
        return 2
    if name in ("query", "key", "value") and ndim == 3:
        return 1
    raise ValueError(
        f"quantize_lm_params: unknown {ndim}-D kernel site {name!r} — contraction "
        "axes cannot be inferred from the name; quantize it explicitly with "
        "quantize_int8(w, contract_ndim) and splice the result into the state dict"
    )


def quantize_lm_params(state: Mapping[str, torch.Tensor]) -> dict:
    """One-time transform of a flat state dict: every ``<site>.kernel``
    becomes ``<site>.kernel_q`` (int8) and ``<site>.kernel_scale`` (float32
    per output channel); embeddings and norm scales pass through."""
    out = {}
    for name, w in state.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf != "kernel":
            out[name] = w
            continue
        site = prefix.rpartition(".")[2]
        q, scale = quantize_int8(w, contract_ndim(site, w.dim()))
        out[f"{prefix}.kernel_q"] = q
        out[f"{prefix}.kernel_scale"] = scale
    return out
