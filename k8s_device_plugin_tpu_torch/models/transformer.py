"""Decoder-only transformer LM in PyTorch.

Counterpart of ``k8s_device_plugin_tpu/models/transformer.py``, with the
same numerics: RMSNorm in float32 then cast, rotary embeddings on
interleaved pairs (x[2i], x[2i+1]), every dense site computing in
``cfg.dtype`` except the float32 ``lm_head``, and attention with float32
scores.  Parameters keep the flax names and layouts (``layer_0.attn.query
.kernel`` is flax's ``layer_0/attn/query/kernel``, [hidden, heads,
head_dim]), so ``convert.py`` moves a flax tree in without reshaping.

Where flax carries the decode cache in a mutable collection, this module
takes an explicit cache object:

- no cache: the full-sequence forward (causal attention through the flash
  kernel at any sequence length);
- :class:`DenseCache`: the fixed-shape decode cache.  A multi-token call in
  ``append_mode="auto"`` is a bulk prefill (attention within the given
  tokens); in ``"cached"`` it is an append scored against the whole cache
  with per-query position masks (the serving engine's chunked prefill);
- :class:`PagedCache`: the shared page pool of the serving engine.  The
  append writes at the carried ``seq_lens``; single-token steps read the
  pool through the paged-attention kernel, or through a gathered view when
  ``PagedConfig.use_kernel`` is False.

Quantized serving, as the reference's: ``quant="w8"|"w8a8"`` builds every
dense site, the float32 ``lm_head`` included, as an ``Int8DenseGeneral``
(``ops/quant.py``; parameters ``kernel_q``/``kernel_scale`` from
``quantize_lm_params``), and ``quant_kv`` keeps both caches as int8 codes
plus float32 scale slabs.  Each append quantizes its K/V pair once; the
paged kernel reads the codes and scales as they are, the gathered view and
the dense cached path dequantize to ``cfg.dtype``, and the dense bulk
prefill attends over the unquantized K/V while it writes the codes.

``TransformerLM(config, train=True)`` is the training model: parameters in
float32, cast to ``cfg.dtype`` at every dense site and at the embedding as
flax casts its float32 params, with gradients on, and each block
recomputed in the backward when ``cfg.remat`` is set.  The serving model
(the default) stores its weights in ``cfg.dtype`` and tracks no gradients.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention
from ..ops.quant import (
    Int8DenseGeneral,
    contract_ndim,
    dequantize_kv,
    quantize_kv_pair,
    quantize_lm_params,
)
from ..utils.device import resolve_device

# Finite large-negative logit for masks and top-k filtering: softmax stays
# NaN-free even if a whole row were masked.
NEG_LOGIT = -1e30


@dataclass(frozen=True)
class PagedConfig:
    """Paged KV-cache geometry: a shared pool ``[num_pages, page_size,
    kv_heads, head_dim]`` per layer plus a per-slot page table ``[batch,
    max_pages_per_seq]`` and a length vector."""

    page_size: int = 16
    num_pages: int = 256
    max_pages_per_seq: int = 16
    # None = auto, which on this port means the paged-attention kernel (on
    # a CUDA tensor the CUDA kernel, on a CPU tensor its plain version).
    # False reads a gathered [max_len] view of each row's pages instead.
    use_kernel: bool | None = None
    # Split-K degree override; None = ops/tuning.py for the device.
    kernel_num_splits: Optional[int] = None

    def kernel_enabled(self, quant_kv: bool = False) -> bool:
        """Resolve the tri-state ``use_kernel`` (auto -> the kernel)."""
        return True if self.use_kernel is None else self.use_kernel

    @property
    def max_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


@dataclass(frozen=True)
class GPTConfig:
    """Field for field the reference's ``GPTConfig``.  ``quant`` (None,
    "w8", "w8a8") and ``quant_kv`` are ported; ``lora_rank`` and
    ``lora_serve`` must keep their defaults."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    intermediate_size: int = 5632
    max_seq: int = 4096
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = False
    num_kv_heads: Optional[int] = None
    attention_window: Optional[int] = None
    quant: Optional[str] = None
    quant_kv: bool = False
    lora_rank: Optional[int] = None
    lora_alpha: float = 16.0
    lora_serve: int = 0
    paged: Optional[PagedConfig] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_heads if self.num_kv_heads is None else self.num_kv_heads

    @staticmethod
    def tiny() -> "GPTConfig":
        """Structural stand-in for CPU tests (the reference's tiny())."""
        return GPTConfig(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_seq=128,
            dtype=torch.float32,
        )


def _check_supported(cfg: GPTConfig) -> None:
    if cfg.quant is not None and cfg.lora_rank is not None:
        raise ValueError(
            "quant and lora_rank are mutually exclusive: train the adapters, "
            "merge_lora_params, then quantize the merged tree"
        )
    if cfg.quant not in (None, "w8", "w8a8"):
        raise ValueError(f"quant must be None, w8 or w8a8, got {cfg.quant!r}")
    later = {"lora_rank": cfg.lora_rank is not None, "lora_serve": bool(cfg.lora_serve)}
    on = [name for name, set_ in later.items() if set_]
    if on:
        raise NotImplementedError(f"{on}: not ported yet (see ROADMAP.md)")
    if cfg.num_heads % cfg.kv_heads:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by kv_heads {cfg.kv_heads}")
    if cfg.attention_window is not None and cfg.attention_window < 1:
        raise ValueError(f"attention_window must be >= 1, got {cfg.attention_window}")


# ------------------------------------------------------------------ caches


def _kv_slabs(cfg: GPTConfig, shape: tuple, device):
    """Per-layer ``(k, v, k_scales, v_scales)`` lists of zero slabs of
    ``shape``: in ``cfg.dtype`` with no scales, or under ``quant_kv`` int8
    codes plus float32 scale slabs of ``shape[:-1]`` (one scale per
    position and kv head; zero scales dequantize unwritten slots to 0)."""
    def new(s, dtype):
        return [torch.zeros(s, dtype=dtype, device=device) for _ in range(cfg.num_layers)]

    if not cfg.quant_kv:
        return new(shape, cfg.dtype), new(shape, cfg.dtype), None, None
    return (new(shape, torch.int8), new(shape, torch.int8),
            new(shape[:-1], torch.float32), new(shape[:-1], torch.float32))


@dataclass
class DenseCache:
    """Fixed-shape decode cache: per layer K and V [batch, max_seq,
    kv_heads, head_dim] and one write index shared by the batch (the
    reference's cached_key/cached_value/cache_index).  Under ``quant_kv``
    K and V are int8 codes and ``key_scales``/``value_scales`` hold float32
    [batch, max_seq, kv_heads] per layer (cached_key_scale/...)."""

    keys: list
    values: list
    index: int = 0
    key_scales: Optional[list] = None
    value_scales: Optional[list] = None

    @classmethod
    def zeros(cls, cfg: GPTConfig, batch: int, device, max_seq: Optional[int] = None):
        shape = (batch, cfg.max_seq if max_seq is None else max_seq, cfg.kv_heads, cfg.head_dim)
        k, v, ks, vs = _kv_slabs(cfg, shape, device)
        return cls(k, v, key_scales=ks, value_scales=vs)

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k, v, k_scales, v_scales); scales None if float."""
        if self.key_scales is None:
            return self.keys[i], self.values[i], None, None
        return self.keys[i], self.values[i], self.key_scales[i], self.value_scales[i]


@dataclass
class PagedCache:
    """The serving engine's paged cache: per layer K and V pools
    [num_pages, page_size, kv_heads, head_dim]; one page table [batch,
    max_pages_per_seq] int32 and one carried ``seq_lens`` [batch] int32
    (first written position per row), shared by every layer.  Under
    ``quant_kv`` the pools hold int8 codes and ``scale_k``/``scale_v``
    float32 [num_pages, page_size, kv_heads] per layer."""

    pool_k: list
    pool_v: list
    page_table: Optional[torch.Tensor]
    seq_lens: torch.Tensor
    scale_k: Optional[list] = None
    scale_v: Optional[list] = None

    @classmethod
    def zeros(cls, cfg: GPTConfig, paged: PagedConfig, batch: int, device):
        shape = (paged.num_pages, paged.page_size, cfg.kv_heads, cfg.head_dim)
        k, v, ks, vs = _kv_slabs(cfg, shape, device)
        return cls(
            k, v,
            torch.zeros((batch, paged.max_pages_per_seq), dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            scale_k=ks, scale_v=vs,
        )

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (k, v, k_scales, v_scales); scales None if float."""
        if self.scale_k is None:
            return self.pool_k[i], self.pool_v[i], None, None
        return self.pool_k[i], self.pool_v[i], self.scale_k[i], self.scale_v[i]


def _append_kv(slabs: tuple, index, k, v) -> None:
    """Write this call's K/V at ``index`` of a layer's (k, v, k_scales,
    v_scales): as they are, or, with scale slabs, quantized once as a pair
    (``quantize_kv_pair``) with the scale rows written beside the codes."""
    ck, cv, cks, cvs = slabs
    if cks is not None:
        k, v, ks, vs = quantize_kv_pair(k, v)
        cks[index] = ks
        cvs[index] = vs
    ck[index] = k
    cv[index] = v


def _dequant(codes, scales, dtype):
    """A cache view in ``dtype``: float slabs as they are, int8 codes
    dequantized with their scales (the reference's dequantize_kv)."""
    return codes if scales is None else dequantize_kv(codes, scales, dtype)


# ----------------------------------------------------------------- pieces


class RMSNorm(nn.Module):
    """Root-mean-square norm, computed in float32 whatever the input type."""

    def __init__(self, features: int, dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` without bias: ``kernel`` [*in_shape,
    *features] contracts the input's trailing ``len(in_shape)`` axes.  The
    product runs in ``dtype``; the kernel is stored in ``dtype`` (the
    training model converts it to float32) and cast to ``dtype`` at every
    call, as flax casts its float32 param."""

    def __init__(self, in_shape: tuple, features: tuple, dtype, device=None):
        super().__init__()
        self.in_shape, self.features, self.dtype = tuple(in_shape), tuple(features), dtype
        self.kernel = nn.Parameter(
            torch.empty(*self.in_shape, *self.features, dtype=dtype, device=device)
        )

    def forward(self, x):
        lead = x.shape[: x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.features)
        y = x.reshape(*lead, n_in).to(self.dtype) @ self.kernel.reshape(n_in, n_out).to(self.dtype)
        return y.reshape(*lead, *self.features)


class Embed(nn.Module):
    """Token embedding stored in ``dtype`` (float32 in the training model);
    the looked-up rows are cast to ``dtype`` (flax casts the table, which
    gives the same values)."""

    def __init__(self, vocab: int, hidden: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, hidden, dtype=dtype, device=device))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.embedding).to(self.dtype)


def dense_site(cfg: GPTConfig, in_shape: tuple, features: tuple, device, dtype=None):
    """One constructor for every projection (the reference's dense_site):
    ``DenseGeneral`` when ``cfg.quant`` is None, else ``Int8DenseGeneral``
    in that mode, with the same names (``kernel`` -> ``kernel_q`` /
    ``kernel_scale``).  ``dtype`` defaults to ``cfg.dtype``."""
    dtype = cfg.dtype if dtype is None else dtype
    if cfg.quant is None:
        return DenseGeneral(in_shape, features, dtype, device)
    return Int8DenseGeneral(in_shape, features, cfg.quant, dtype, device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embeddings, float32.  positions: [..., seq]."""
    freqs = theta ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    )
    ang = positions.float()[..., None] * freqs  # [..., seq, head_dim/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[2i], x[2i+1]); x: [batch, seq, heads, head_dim]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def cached_group_attention(q, k, v, positions, window, num_heads):
    """Masked grouped-query attention against a cache view.

    q: [batch, q_len, num_heads, head_dim]; k/v: [batch, L, kv_heads,
    head_dim].  The query at ``positions[b, i]`` sees slots ``<=`` its
    position (and within the window when set); kv heads are read once per
    group, never expanded.  Scores in float32, the finite NEG_LOGIT mask,
    probabilities cast to v's type before p.v — as the reference."""
    batch, q_len, _, head_dim = q.shape
    length, kv_heads = k.shape[1], k.shape[2]
    group = num_heads // kv_heads
    qg = q.reshape(batch, q_len, kv_heads, group, head_dim)
    key_pos = torch.arange(length, device=q.device)[None, None, None, None, :]
    q_pos = positions[:, None, None, :, None]
    mask = key_pos <= q_pos
    if window is not None:
        mask = mask & (q_pos - key_pos < window)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (head_dim ** -0.5)
    s = torch.where(mask, s, NEG_LOGIT)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(batch, q_len, num_heads, head_dim)


def tiled_causal_attention(qh, kh, vh, window):
    """Causal attention on [batch, heads, seq, head_dim] through the flash
    kernel.  The reference takes its plain ``mha_reference`` when the
    sequence is not 128-tileable; the CUDA kernel masks a ragged last tile
    instead, so every length runs the kernel on the card."""
    return flash_attention(qh, kh, vh, causal=True, window=window)


# ----------------------------------------------------------------- layers


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        self.query = dense_site(cfg, (d,), (cfg.num_heads, hd), device)
        self.key = dense_site(cfg, (d,), (cfg.kv_heads, hd), device)
        self.value = dense_site(cfg, (d,), (cfg.kv_heads, hd), device)
        self.out = dense_site(cfg, (cfg.num_heads, hd), (d,), device)

    def forward(self, hidden, positions, cache=None, layer: int = 0, append_mode: str = "auto"):
        cfg = self.cfg
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(self.query(hidden), cos, sin)
        k = apply_rope(self.key(hidden), cos, sin)
        v = self.value(hidden)
        batch, q_len = hidden.shape[:2]
        if isinstance(cache, PagedCache):
            attn = self._paged(q, k, v, positions, cache, layer)
        elif isinstance(cache, DenseCache):
            ck, cv, cks, cvs = slabs = cache.layer(layer)
            cur = cache.index
            if cur + q_len > ck.shape[1]:
                raise ValueError(f"cache write [{cur}, {cur + q_len}) exceeds {ck.shape[1]} slots")
            _append_kv(slabs, (slice(None), slice(cur, cur + q_len)), k, v)
            if q_len > 1 and append_mode == "auto":
                # Bulk prefill into an empty cache: causal within the given
                # tokens through the flash kernel, over the unquantized K/V
                # (as the reference); the codes still land above.
                qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                attn = tiled_causal_attention(qh, kh, vh, cfg.attention_window).transpose(1, 2)
            else:
                attn = cached_group_attention(
                    q, _dequant(ck, cks, cfg.dtype), _dequant(cv, cvs, cfg.dtype),
                    positions, cfg.attention_window, cfg.num_heads,
                )
        else:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            attn = tiled_causal_attention(qh, kh, vh, cfg.attention_window).transpose(1, 2)
        return self.out(attn)

    def _paged(self, q, k, v, positions, cache: PagedCache, layer: int):
        cfg = self.cfg
        pg = cfg.paged
        batch, q_len = q.shape[:2]
        pool_k, pool_v, scale_k, scale_v = slabs = cache.layer(layer)
        table = cache.page_table
        # Writes go to the CARRIED seq_lens; idle rows have all-zero table
        # rows and land in scratch page 0.  The page index is clamped like
        # the reference's gather (an idle row's lens keeps growing).
        offs = cache.seq_lens.long()[:, None] + torch.arange(q_len, device=q.device)[None, :]
        rows = torch.arange(batch, device=q.device)[:, None]
        page = table[rows, (offs // pg.page_size).clamp(max=pg.max_pages_per_seq - 1)].long()
        _append_kv(slabs, (page, offs % pg.page_size), k, v)
        if pg.kernel_enabled() and q_len == 1:
            # Valid slots per row = position + 1: this token's K/V are in.
            # int8 pools go to the kernel as codes with their scale pools.
            lens = (positions[:, 0] + 1).to(torch.int32)
            return paged_attention(
                q[:, 0], pool_k, pool_v, table, lens, scale_k=scale_k, scale_v=scale_v,
                window=cfg.attention_window, num_splits=pg.kernel_num_splits,
            )[:, None]
        shape = (batch, pg.max_len, cfg.kv_heads, cfg.head_dim)
        idx = table.long()

        def view(codes, scales):  # gathered [max_len] view, dequantized
            return _dequant(codes[idx].reshape(shape),
                            None if scales is None else scales[idx].reshape(shape[:-1]), cfg.dtype)

        return cached_group_attention(
            q, view(pool_k, scale_k), view(pool_v, scale_v),
            positions, cfg.attention_window, cfg.num_heads,
        )


class SwiGluMlp(nn.Module):
    """silu(gate(x)) * up(x) -> down."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate = dense_site(cfg, (d,), (f,), device)
        self.up = dense_site(cfg, (d,), (f,), device)
        self.down = dense_site(cfg, (f,), (d,), device)

    def forward(self, x):
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.dtype, device=device)
        self.attn = CausalSelfAttention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.dtype, device=device)
        self.mlp = SwiGluMlp(cfg, device)

    def forward(self, hidden, positions, cache=None, layer: int = 0, append_mode: str = "auto"):
        hidden = hidden + self.attn(self.attn_norm(hidden), positions, cache, layer, append_mode)
        return hidden + self.mlp(self.mlp_norm(hidden))


class TransformerLM(nn.Module):
    """embed -> N pre-norm blocks -> RMSNorm -> float32 vocab logits.

    ``forward(input_ids, positions=None, cache=None, append_mode="auto",
    output="logits")``; parameters come from :func:`init_params` or
    ``convert.flax_to_state_dict`` through ``load_state_dict``.  Runs on
    ``cuda`` unless ``device="cpu"`` is asked for.  ``train=True`` keeps
    float32 parameters with gradients (see the module docstring)."""

    def __init__(self, config: GPTConfig, device=None, *, train: bool = False):
        super().__init__()
        _check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.train_mode = train
        dev = self.device
        self.embed = Embed(config.vocab_size, config.hidden_size, config.dtype, dev)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", DecoderBlock(config, dev))
        self.final_norm = RMSNorm(config.hidden_size, config.dtype, device=dev)
        self.lm_head = dense_site(
            config, (config.hidden_size,), (config.vocab_size,), dev, torch.float32
        )
        if train:
            self.to(torch.float32)  # float32 master weights, as flax keeps them
        self.requires_grad_(train)  # serving: no autograd state

    def forward(self, input_ids, positions=None, cache=None, append_mode="auto", output="logits"):
        if append_mode not in ("auto", "cached"):
            raise ValueError(f"append_mode must be auto|cached, got {append_mode!r}")
        if output not in ("logits", "hidden"):
            raise ValueError(f"output must be logits|hidden, got {output!r}")
        seq_len = input_ids.shape[-1]
        if positions is None:
            positions = torch.arange(seq_len, device=input_ids.device).expand(input_ids.shape)
        hidden = self.embed(input_ids)
        # remat (the reference's nn.remat(DecoderBlock)): keep only each
        # block's input and recompute the block in the backward.
        remat = self.train_mode and self.config.remat and cache is None and torch.is_grad_enabled()
        for i in range(self.config.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                hidden = checkpoint(block, hidden, positions, use_reentrant=False)
            else:
                hidden = block(hidden, positions, cache, i, append_mode)
        if isinstance(cache, DenseCache):
            cache.index += seq_len
        elif isinstance(cache, PagedCache):
            cache.seq_lens += seq_len
        hidden = self.final_norm(hidden)
        return hidden if output == "hidden" else self.logits(hidden)

    def logits(self, hidden):
        """The float32 ``lm_head`` on final-norm hidden states."""
        return self.lm_head(hidden.float())


def param_shapes(config: GPTConfig) -> dict:
    """Every parameter's name and shape, in the flax names and layouts (a
    quantized config: each ``kernel`` as ``kernel_q`` of the same shape and
    ``kernel_scale`` over its output features, as quantize_lm_params
    gives them)."""
    d, hd, f = config.hidden_size, config.head_dim, config.intermediate_size
    h, hk = config.num_heads, config.kv_heads
    shapes = {"embed.embedding": (config.vocab_size, d)}
    for i in range(config.num_layers):
        p = f"layer_{i}."
        shapes.update({
            p + "attn_norm.scale": (d,),
            p + "attn.query.kernel": (d, h, hd),
            p + "attn.key.kernel": (d, hk, hd),
            p + "attn.value.kernel": (d, hk, hd),
            p + "attn.out.kernel": (h, hd, d),
            p + "mlp_norm.scale": (d,),
            p + "mlp.gate.kernel": (d, f),
            p + "mlp.up.kernel": (d, f),
            p + "mlp.down.kernel": (f, d),
        })
    shapes["final_norm.scale"] = (d,)
    shapes["lm_head.kernel"] = (d, config.vocab_size)
    if config.quant is None:
        return shapes
    quantized = {}
    for name, shape in shapes.items():
        if name.endswith(".kernel"):
            site = name.split(".")[-2]
            quantized[name + "_q"] = shape
            quantized[name + "_scale"] = shape[contract_ndim(site, len(shape)):]
        else:
            quantized[name] = shape
    return quantized


def init_params(config: GPTConfig, seed: int = 0) -> dict:
    """Random float32 parameters from ``seed`` (a stand-in for a
    checkpoint): norm scales 1, every kernel normal with variance 1/fan_in
    like flax's lecun-normal dense sites, the embedding 1/hidden.  The
    values are not flax's; the tests convert flax's own init instead.  A
    quantized config gets this float init through ``quantize_lm_params``,
    as the reference's engine CLI quantizes its init."""
    _check_supported(config)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, shape in param_shapes(dataclasses.replace(config, quant=None)).items():
        if name.endswith(".scale"):
            params[name] = torch.ones(shape)
            continue
        if name.endswith("embedding"):
            fan_in = shape[1]
        elif name.endswith("attn.out.kernel"):
            fan_in = shape[0] * shape[1]
        else:
            fan_in = shape[0]
        params[name] = torch.randn(shape, generator=gen) * fan_in ** -0.5
    return params if config.quant is None else quantize_lm_params(params)


def _check_decode_fits(config: GPTConfig, prompt_len: int, max_new_tokens: int):
    if prompt_len + max_new_tokens > config.max_seq:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
            f"exceeds max_seq {config.max_seq}"
        )


@torch.no_grad()
def greedy_generate(config: GPTConfig, params: dict, prompt, max_new_tokens: int, *, device=None):
    """Greedy decode with the fixed-shape KV cache: one bulk-prefill
    forward over the whole prompt (the flash kernel when the prompt tiles
    by 128), then single-token steps against the cache in a Python loop.

    ``params``: a state dict (``init_params`` or ``convert``).  ``prompt``:
    [batch, prompt_len] token ids.  Returns [batch, prompt_len + new] int64
    on the model's device."""
    model = TransformerLM(config, device=device)
    model.load_state_dict(params)
    prompt = torch.as_tensor(prompt, device=model.device).long()
    batch, prompt_len = prompt.shape
    _check_decode_fits(config, prompt_len, max_new_tokens)
    cache = DenseCache.zeros(config, batch, model.device)
    logits = model(prompt, cache=cache)
    tok = logits[:, -1].argmax(dim=-1)
    out = [prompt, tok[:, None]]
    for t in range(prompt_len, prompt_len + max_new_tokens - 1):
        pos = torch.full((batch, 1), t, device=model.device)
        tok = model(tok[:, None], pos, cache=cache)[:, -1].argmax(dim=-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
