"""ResNet-V1.5 (ResNet-50 and friends) in PyTorch.

Counterpart of ``k8s_device_plugin_tpu/models/resnet.py``, with its names
(``Conv_stem``, ``BatchNorm_0``, ``BottleneckBlock_3.Conv_1``, ``Dense_0``)
and numerics: compute in ``dtype`` (bf16 by default), BatchNorm statistics
in float32 with its output in ``norm_dtype``, momentum 0.9 and epsilon
1e-5, float32 logits, the stride on the 3x3 conv (V1.5), "SAME" convs and
max pool padded as XLA pads them (``layers.same_pads``).  Images come in
NHWC, as the reference's batches; the network runs NCHW, which on the card
is channels-last in memory (the permuted NHWC input already is, and the
conv kernels are made so), the layout cuDNN's tensor-core convs take.

Both stems: "conv7" (7x7/s2) and "space_to_depth" (2x2 pixel blocks packed
into 12 channels, then a 4x4/s1 conv; a 7x7 kernel zero-padded to 8x8 and
repacked gives the same outputs).  The convs, pools and dense layers are
cuDNN's and cuBLAS's: the reference leaves them to XLA, no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import BatchNorm, Conv, Dense, init_from_seed, max_pool


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 x4, each conv followed by BatchNorm
    (the last one's scale starts at zero), plus a projected shortcut when
    the shape changes."""

    def __init__(self, in_features: int, features: int, strides: int, dtype, norm_dtype,
                 device=None):
        super().__init__()

        def conv(i, o, k, s=1):
            return Conv(i, o, k, s, use_bias=False, dtype=dtype, device=device)

        def norm(f, zero_scale=False):
            return BatchNorm(f, 0.9, 1e-5, norm_dtype, zero_scale, device)

        self.Conv_0, self.BatchNorm_0 = conv(in_features, features, 1), norm(features)
        self.Conv_1, self.BatchNorm_1 = conv(features, features, 3, strides), norm(features)
        self.Conv_2 = conv(features, features * 4, 1)
        self.BatchNorm_2 = norm(features * 4, zero_scale=True)
        self.project = in_features != features * 4 or strides != 1
        if self.project:
            self.Conv_3 = conv(in_features, features * 4, 1, strides)
            self.BatchNorm_3 = norm(features * 4)

    def forward(self, x, *, train: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train=train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train=train))
        y = self.BatchNorm_2(self.Conv_2(y), train=train)
        residual = x
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(x), train=train)
        return torch.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """Stem -> BatchNorm -> relu -> 3x3/s2 "SAME" max pool -> bottleneck
    stages -> spatial mean -> float32 ``Dense_0``.  ``forward(images, *,
    train=False)``: NHWC images [batch, H, W, 3] of any float type;
    ``train`` normalizes with batch statistics and updates the running
    ones.  Parameters are float32, drawn from ``seed`` (or loaded through
    ``convert.py``)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000, width: int = 64,
                 dtype=torch.bfloat16, norm_dtype=torch.bfloat16, stem: str = "conv7", *,
                 device=None, seed: int = 0):
        super().__init__()
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"stem must be 'conv7' or 'space_to_depth', got {stem!r}")
        self.device = resolve_device(device)
        self.dtype, self.stem, self.num_classes = dtype, stem, num_classes
        dev = self.device
        if stem == "space_to_depth":
            self.Conv_stem = Conv(12, width, 4, 1, use_bias=False, dtype=dtype, device=dev)
        else:
            self.Conv_stem = Conv(3, width, 7, 2, use_bias=False, dtype=dtype, device=dev)
        self.BatchNorm_0 = BatchNorm(width, 0.9, 1e-5, norm_dtype, device=dev)
        features, index = width, 0
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                block_features = width * 2**stage
                self.add_module(f"BottleneckBlock_{index}", BottleneckBlock(
                    features, block_features, strides, dtype, norm_dtype, dev))
                features, index = block_features * 4, index + 1
        self.num_blocks = index
        self.Dense_0 = Dense(features, num_classes, torch.float32, device=dev)
        init_from_seed(self, seed)
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, images, *, train: bool = False):
        x = images.to(self.dtype)
        if self.stem == "space_to_depth":
            n, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(
                    f"stem='space_to_depth' packs 2x2 pixel blocks and needs even spatial "
                    f"dims, got {h}x{w}; use stem='conv7' for odd sizes"
                )
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, h // 2, w // 2, 4 * c)
        x = self.Conv_stem(x.permute(0, 3, 1, 2))  # NHWC memory, NCHW dims
        x = torch.relu(self.BatchNorm_0(x, train=train))
        x = max_pool(x, 3, 2, "SAME")
        for i in range(self.num_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x, train=train)
        x = x.float().mean(dim=(2, 3)).to(x.dtype)  # jnp.mean of x's type
        return self.Dense_0(x)


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kwargs)


def ResNet18Thin(**kwargs) -> ResNet:
    """Tiny structural stand-in for CPU tests (same code paths, ~1000x fewer
    FLOPs)."""
    kwargs.setdefault("width", 8)
    return ResNet(stage_sizes=(1, 1, 1, 1), **kwargs)
