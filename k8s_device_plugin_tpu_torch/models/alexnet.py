"""AlexNet in PyTorch: the workload of the example pods.

Counterpart of ``k8s_device_plugin_tpu/models/alexnet.py`` (5 convs, 3
dense layers, single tower), with its names (``Conv_0``-``Conv_4``,
``Dense_0``-``Dense_2``) and numerics: the ``width`` multiplier
(``max(8, int(c * width))`` channels), "SAME" convs with bias (the 11x11/s4
conv on 224 pads (3, 4), as XLA), 3x3/s2 "VALID" max pools, compute in
``dtype``, float32 logits, and dropout 0.5 after the two hidden dense
layers in training, with flax's keys: ``Dropout_0`` and ``Dropout_1`` each
fold their name into the step's root key (``layers.dropout``), so a
training step draws the reference's masks bit for bit.

Images come in NHWC; the convs run NCHW (channels-last memory on the
card), and the features are flattened in (H, W, C) order before
``Dense_0``, as the reference flattens NHWC, so its 9216 rows (6 x 6 x 256
at 224 px) are read as trained.  flax sizes ``Dense_0`` from the first
batch; here ``image_size`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import Conv, Dense, dropout, init_from_seed, max_pool

# (features, kernel, stride) of each conv, before the width multiplier;
# a max pool follows convs 0, 1 and 4.
CONVS = ((64, 11, 4), (192, 5, 1), (384, 3, 1), (256, 3, 1), (256, 3, 1))
POOL_AFTER = (0, 1, 4)
DROPOUT_RATE = 0.5


def _pooled(size: int) -> int:
    """A 3x3/s2 VALID pool's output size."""
    out = (size - 3) // 2 + 1
    if out < 1:
        raise ValueError("the image is too small for AlexNet's three 3x3/s2 pools")
    return out


class AlexNet(nn.Module):
    """``forward(images, *, train=False, dropout_rng=None)``: NHWC images
    [batch, image_size, image_size, 3]; ``train`` turns dropout on and then
    needs ``dropout_rng``, the step's root key as two ints
    (``utils/prng.fold_in_words``)."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16, width: float = 1.0,
                 image_size: int = 224, *, device=None, seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype, self.image_size, self.num_classes = dtype, image_size, num_classes

        def w(c):
            return max(8, int(c * width))

        in_ch, size = 3, image_size
        for i, (feats, kernel, stride) in enumerate(CONVS):
            self.add_module(f"Conv_{i}", Conv(in_ch, w(feats), kernel, stride, "SAME",
                                              dtype=dtype, device=self.device))
            in_ch, size = w(feats), -(-size // stride)
            if i in POOL_AFTER:
                size = _pooled(size)
        self.Dense_0 = Dense(size * size * in_ch, w(4096), dtype, device=self.device)
        self.Dense_1 = Dense(w(4096), w(4096), dtype, device=self.device)
        self.Dense_2 = Dense(w(4096), num_classes, torch.float32, device=self.device)
        self.batch_rank = 0  # the dp replica of a split batch (layers.dropout)
        init_from_seed(self, seed)
        if self.device.type == "cuda":
            self.to(memory_format=torch.channels_last)

    def forward(self, images, *, train: bool = False, dropout_rng=None):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(CONVS)):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
            if i in POOL_AFTER:
                x = max_pool(x, 3, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten (H, W, C)
        x = torch.relu(self.Dense_0(x))
        if train:
            x = dropout(x, DROPOUT_RATE, dropout_rng, "Dropout_0", self.batch_rank)
        x = torch.relu(self.Dense_1(x))
        if train:
            x = dropout(x, DROPOUT_RATE, dropout_rng, "Dropout_1", self.batch_rank)
        return self.Dense_2(x)
