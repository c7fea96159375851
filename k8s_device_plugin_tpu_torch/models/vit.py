"""Vision Transformer (ViT) image classifier in PyTorch.

Counterpart of ``k8s_device_plugin_tpu/models/vit.py``, with its names
(``patch_embed``, ``pos_embed``, ``layer_0.query``, ``layer_0.LayerNorm_1``,
``head``) and numerics: one strided "VALID" conv embeds the patches, whose
tokens run row-major over (H/P, W/P); learned position embeddings; pre-LN
encoder blocks whose LayerNorms run in float32 (epsilon 1e-6) and are cast
back to ``dtype``; tanh-approximated gelu; token-mean pooling and a float32
``head``.

Attention takes the reference's route: when the token count is a multiple
of 128 (ViT-B/16 at 256 px: 256 tokens), the flash kernels, non-causal with
one kv head per head (kernel 2 forward, kernels 3 and 4 backward, through
``ops/flash_attention.py``); otherwise the plain product-softmax-product of
``nn.dot_product_attention`` (``layers.dot_product_attention``).  On the
card the flash route is the CUDA kernels and nothing else, so a head_dim
they do not take is refused when the model is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..ops.flash_attention import check_head_dim, flash_attention
from ..utils.device import resolve_device
from .layers import Conv, Dense, LayerNorm, dot_product_attention, gelu, init_from_seed


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 256
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    dtype: Any = torch.bfloat16

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def base() -> "ViTConfig":
        """ViT-B/16 on 256px inputs: 256 tokens, the flash route."""
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        """Structural stand-in for CPU tests (16 tokens: the plain route)."""
        return ViTConfig(image_size=32, patch_size=8, num_classes=10, hidden_size=64,
                         num_layers=2, num_heads=4, intermediate_size=128)


def flash_route(q, k, v):
    """Non-causal flash attention on [batch, seq, heads, head_dim]
    projections: made contiguous [batch, heads, seq, head_dim] for the
    kernels, and back."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention(qh, kh, vh).transpose(1, 2)


class ViTEncoderLayer(nn.Module):
    """Pre-LN encoder block."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, heads, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.LayerNorm_0 = LayerNorm(d, device)
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(d, (heads, hd), cfg.dtype, device=device))
        self.out = Dense((heads, hd), d, cfg.dtype, device=device)
        self.LayerNorm_1 = LayerNorm(d, device)
        self.Dense_0 = Dense(d, cfg.intermediate_size, cfg.dtype, device=device)
        self.Dense_1 = Dense(cfg.intermediate_size, d, cfg.dtype, device=device)

    def forward(self, hidden):
        x = self.LayerNorm_0(hidden).to(self.cfg.dtype)
        q, k, v = self.query(x), self.key(x), self.value(x)
        if hidden.shape[1] % 128 == 0:
            attn = flash_route(q, k, v)
        else:
            attn = dot_product_attention(q, k, v)
        hidden = hidden + self.out(attn)
        x = self.LayerNorm_1(hidden).to(self.cfg.dtype)
        return hidden + self.Dense_1(gelu(self.Dense_0(x)))


class ViT(nn.Module):
    """Patchify -> pre-LN encoder stack -> LayerNorm -> mean-pool -> class
    logits.  ``forward(images, *, train=False)``: NHWC images [batch,
    image_size, image_size, 3] (``train`` changes nothing: no dropout, no
    batch statistics).  Parameters are float32, drawn from ``seed``."""

    def __init__(self, config: ViTConfig, *, device=None, seed: int = 0):
        super().__init__()
        cfg = self.config = config
        self.num_classes = cfg.num_classes
        self.device = dev = resolve_device(device)
        if dev.type == "cuda" and cfg.num_tokens % 128 == 0:
            check_head_dim(cfg.head_dim)
        self.patch_embed = Conv(3, cfg.hidden_size, cfg.patch_size, cfg.patch_size, "VALID",
                                dtype=cfg.dtype, device=dev)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_tokens, cfg.hidden_size, device=dev))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", ViTEncoderLayer(cfg, dev))
        self.LayerNorm_0 = LayerNorm(cfg.hidden_size, dev)
        self.head = Dense(cfg.hidden_size, cfg.num_classes, torch.float32, device=dev)
        init_from_seed(self, seed)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(seed + 1)
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=gen) * 0.02)

    def forward(self, images, *, train: bool = False):
        cfg = self.config
        b, h, w, _ = images.shape
        if h != cfg.image_size or w != cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}x{cfg.image_size} images, got {h}x{w}")
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))  # [b, d, H/P, W/P]
        x = x.flatten(2).transpose(1, 2)  # [b, tokens, d], row-major over (H/P, W/P)
        x = x + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        pooled = self.LayerNorm_0(x).mean(dim=1)
        return self.head(pooled)
