"""BERT encoder in PyTorch: the BERT pod's workload.

Counterpart of ``k8s_device_plugin_tpu/models/bert.py``, with its names
(``Embed_0``, ``Embed_1``, ``LayerNorm_0``,
``BertEncoderLayer_0.MultiHeadSelfAttention_0.query``, ``Dense_0``) and
numerics: token plus position embeddings in ``dtype``, a float32 LayerNorm
cast back to ``dtype``, post-LN layers whose LayerNorms run and stay in
float32 (so from the first layer on the residual stream is float32, as in
the reference), tanh-approximated gelu, and a float32 masked-LM head over
the vocabulary.

Attention takes the reference's route: with no ``attention_mask`` and a
sequence that tiles by ``min(128, seq)``, the flash kernels, non-causal with
one kv head per head (kernel 2 forward, kernels 3 and 4 backward; BERT-base
at seq 384); otherwise the plain masked product-softmax-product
(``layers.dot_product_attention``).  On the card the kernels take any
head_dim.  A sequence longer than
``max_position`` is refused, where a gather would silently clamp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import Dense, Embed, LayerNorm, dot_product_attention, gelu, init_from_seed
from .vit import flash_route


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        """Structural stand-in for CPU tests."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=128, max_position=128)


def takes_flash(seq_len: int, mask) -> bool:
    """The reference's route rule: no mask and a sequence that tiles by
    min(128, seq)."""
    return mask is None and seq_len % min(128, seq_len) == 0


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        d, heads, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(d, (heads, hd), cfg.dtype, device=device))
        self.out = Dense((heads, hd), d, cfg.dtype, device=device)

    def forward(self, hidden, mask):
        q, k, v = self.query(hidden), self.key(hidden), self.value(hidden)
        if takes_flash(hidden.shape[1], mask):
            attn = flash_route(q, k, v)
        else:
            attn = dot_product_attention(q, k, v, mask)
        return self.out(attn)


class BertEncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.MultiHeadSelfAttention_0 = MultiHeadSelfAttention(cfg, device)
        self.LayerNorm_0 = LayerNorm(d, device)
        self.Dense_0 = Dense(d, cfg.intermediate_size, cfg.dtype, device=device)
        self.Dense_1 = Dense(cfg.intermediate_size, d, cfg.dtype, device=device)
        self.LayerNorm_1 = LayerNorm(d, device)

    def forward(self, hidden, mask):
        hidden = self.LayerNorm_0(hidden + self.MultiHeadSelfAttention_0(hidden, mask))
        mlp = self.Dense_1(gelu(self.Dense_0(hidden)))
        return self.LayerNorm_1(hidden + mlp)


class Bert(nn.Module):
    """Embeddings -> N post-LN layers -> float32 vocab logits.
    ``forward(input_ids, attention_mask=None)``: ids [batch, seq]; a mask
    [batch, seq] (nonzero = attend) takes the plain route.  Parameters are
    float32, drawn from ``seed``."""

    def __init__(self, config: BertConfig, *, device=None, seed: int = 0):
        super().__init__()
        cfg = self.config = config
        self.device = dev = resolve_device(device)
        self.Embed_0 = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, dev)
        self.Embed_1 = Embed(cfg.max_position, cfg.hidden_size, cfg.dtype, dev)
        self.LayerNorm_0 = LayerNorm(cfg.hidden_size, dev)
        for i in range(cfg.num_layers):
            self.add_module(f"BertEncoderLayer_{i}", BertEncoderLayer(cfg, dev))
        self.Dense_0 = Dense(cfg.hidden_size, cfg.vocab_size, torch.float32, device=dev)
        init_from_seed(self, seed)

    def forward(self, input_ids, attention_mask=None):
        cfg = self.config
        seq_len = input_ids.shape[-1]
        if seq_len > cfg.max_position:
            raise ValueError(f"seq_len {seq_len} exceeds max_position {cfg.max_position}")
        # [batch, 1, 1, seq] boolean, broadcast over heads and queries.
        mask = None if attention_mask is None else attention_mask[:, None, None, :].bool()
        positions = torch.arange(seq_len, device=input_ids.device)[None, :]
        hidden = self.LayerNorm_0(self.Embed_0(input_ids) + self.Embed_1(positions))
        hidden = hidden.to(cfg.dtype)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"BertEncoderLayer_{i}")(hidden, mask)
        return self.Dense_0(hidden)
