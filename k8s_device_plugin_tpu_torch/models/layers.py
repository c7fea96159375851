"""The flax.linen layers the image and encoder models use, in PyTorch.

Each keeps flax's parameter names (``kernel``, ``bias``, ``scale``,
``embedding``; BatchNorm's ``mean`` and ``var`` as buffers), so a module's
state dict reads as the flax tree's paths, and flax's numerics: parameters
stay float32 and are cast to the layer's ``dtype`` at every call, as flax
promotes its float32 params.  Layouts are flax's except the conv kernel,
which is torch's [out, in, kh, kw] (``convert.py`` transposes flax's [kh,
kw, in, out]).  Activations are NCHW; on the card the image models keep
them and the conv kernels channels-last.

Defaults that differ between the frameworks are flax's here: LayerNorm's
epsilon is 1e-6; ``gelu`` is the tanh approximation; convs and the ResNet
max pool pad "SAME" as XLA does (asymmetric at stride 2, see
:func:`same_pads`); BatchNorm's running variance takes the biased batch
variance (flax's), where ``F.batch_norm(training=True)`` would take the
unbiased one.

Every layer draws its initial values from a CPU ``torch.Generator`` in
``reset_from`` (:func:`init_from_seed` walks a model), so a seed gives the
same weights on either device.  The values are not flax's: the tests load
flax's own init through ``convert.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax's default (torch's is 1e-5)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output is
    ceil(size / stride), ``total = max((out - 1) * stride + kernel - size,
    0)`` and the low side takes ``total // 2``.  At stride 2 the extra row
    goes high: a 7x7/s2 conv on 224 pads (2, 3), a 3x3/s2 on 56 (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded for a "SAME" window of ``kernel`` at
    ``stride``, or (x, symmetric pad) when both dims pad evenly, so the
    conv can take the pad itself."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen) * std)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW input: a square ``kernel_size`` at
    ``stride``, padding "SAME" or "VALID", ``kernel`` [out, in, k, k] and
    an optional ``bias`` [out]; computes in ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: str = "SAME", use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size, self.stride, self.padding, self.dtype = kernel_size, stride, padding, dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device)) if use_bias else None

    @torch.no_grad()
    def reset_from(self, gen: torch.Generator) -> None:
        _normal_(self.kernel, math.prod(self.kernel.shape[1:]) ** -0.5, gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        pad = (0, 0)
        if self.padding == "SAME":
            x, pad = pad_same(x, self.kernel_size, self.stride)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias, self.stride, pad)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: str = "VALID"):
    """flax ``nn.max_pool`` on NCHW input; "SAME" pads with -inf as XLA's
    reduce_window does."""
    if padding == "SAME":
        x, pad = pad_same(x, window, stride, value=float("-inf"))
        return F.max_pool2d(x, window, stride, pad)
    return F.max_pool2d(x, window, stride)


class Dense(nn.Module):
    """flax ``nn.DenseGeneral`` (``nn.Dense`` when both shapes have one
    dim): ``kernel`` [*in_shape, *features] contracts the input's trailing
    ``len(in_shape)`` dims, plus ``bias`` [*features]; computes in
    ``dtype``."""

    def __init__(self, in_shape, features, dtype=torch.float32, device=None):
        super().__init__()
        self.in_shape = tuple(in_shape) if isinstance(in_shape, (tuple, list)) else (in_shape,)
        self.features = tuple(features) if isinstance(features, (tuple, list)) else (features,)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.features, device=device))
        self.bias = nn.Parameter(torch.empty(*self.features, device=device))

    @torch.no_grad()
    def reset_from(self, gen: torch.Generator) -> None:
        _normal_(self.kernel, math.prod(self.in_shape) ** -0.5, gen)
        self.bias.zero_()

    def forward(self, x):
        lead = x.shape[: x.dim() - len(self.in_shape)]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.features)
        kernel = self.kernel.to(self.dtype).reshape(n_in, n_out)
        bias = self.bias.to(self.dtype).reshape(n_out)
        y = F.linear(x.reshape(*lead, n_in).to(self.dtype), kernel.t(), bias)
        return y.reshape(*lead, *self.features)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding`` [num, features], cast to
    ``dtype`` (flax casts the table, which gives the same values)."""

    def __init__(self, num: int, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features, device=device))

    @torch.no_grad()
    def reset_from(self, gen: torch.Generator) -> None:
        _normal_(self.embedding, self.embedding.shape[1] ** -0.5, gen)

    def forward(self, ids):
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last dim: ``scale`` and
    ``bias``, epsilon 1e-6, computed and returned in float32."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    @torch.no_grad()
    def reset_from(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, LAYER_NORM_EPS)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of NCHW input: ``scale`` and ``bias``
    (float32 parameters; ``zero_scale`` for the last norm of a residual
    branch), running ``mean`` and ``var`` (float32 buffers).

    ``train=True`` normalizes with the batch's own statistics and updates
    ``mean = m * mean + (1 - m) * batch mean`` and ``var = m * var + (1 -
    m) * batch var`` in float32, without gradients, where the batch
    variance is the biased one, as flax's (flax takes E[x^2] - E[x]^2, torch
    a one-pass Welford sum: they part by float32 rounding);
    ``train=False`` normalizes with the running averages and changes
    nothing.  The normalization runs in the wider of
    the input's type and ``dtype`` (flax computes it in float32 from the
    float32 statistics) and returns ``dtype``.

    ``batch_group`` (set by ``parallel/sharding.shard_train_step`` when the
    batch is split over ranks) makes the training statistics the global
    batch's, as flax's means over a sharded batch: :class:`_GlobalMoments`
    all-reduces the count, sum and sum of squares over the group, and its
    backward the two sums the input gradient needs."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype=torch.float32, zero_scale: bool = False, device=None):
        super().__init__()
        self.momentum, self.epsilon, self.dtype, self.zero_scale = (
            momentum, epsilon, dtype, zero_scale)
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.batch_group = None

    @torch.no_grad()
    def reset_from(self, gen: torch.Generator) -> None:
        self.scale.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, *, train: bool):
        wide = torch.promote_types(x.dtype, self.dtype)
        if not train:
            y = F.batch_norm(x.to(wide), self.mean, self.var, self.scale, self.bias, False, 0.0,
                             self.epsilon)
            return y.to(self.dtype)
        if self.batch_group is not None:
            y, mean, var = _GlobalMoments.apply(x, self.scale, self.bias, self.epsilon,
                                                self.batch_group)
            self._update_running(mean, var)
            return y.to(self.dtype)
        # One pass computes the batch statistics and normalizes with them;
        # the running averages take the biased variance back from its
        # 1/sqrt(var + eps), in float64 (a few ulps of float32).
        y, mean, invstd = torch.native_batch_norm(x.to(wide), self.scale, self.bias, None, None,
                                                  True, 0.0, self.epsilon)
        with torch.no_grad():
            var = (invstd.double().square().reciprocal() - self.epsilon).clamp_min(0.0)
        self._update_running(mean, var)
        return y.to(self.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var) -> None:
        m = self.momentum
        self.mean.mul_(m).add_(mean.float(), alpha=1.0 - m)
        self.var.mul_(m).add_(var.float(), alpha=1.0 - m)


class _GlobalMoments(torch.autograd.Function):
    """Training BatchNorm over dim 1 with the moments of the whole batch
    split over ``group``'s ranks, in float32, as flax computes them: mean =
    E[x], var = max(E[x^2] - mean^2, 0) (biased), y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias.  Forward all-reduces (sum, sum of
    squares, count) per channel; backward all-reduces (sum dy, sum dy *
    xhat), whose global means the input gradient takes.  Each rank's
    ``scale``/``bias`` gradients are its own rows' (FSDP averages them).
    Returns (y float32, mean, var)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        c = x.shape[1]
        count = torch.full((1,), float(x.numel() // c), device=x.device)
        stats = torch.cat([xf.sum(dims), xf.square().sum(dims), count])
        torch.distributed.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * scale).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, scale, mean, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, invstd, n = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        c = x.shape[1]
        dy = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        sums = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        dscale, dbias = sums[c:].clone(), sums[:c].clone()
        torch.distributed.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = sums[:c] / n, sums[c:] / n
        dx = (scale * invstd).view(shape) * (
            dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
        return dx.to(x.dtype), dscale, dbias, None, None


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, key_words: Optional[tuple], name: str,
            batch_rank: int = 0):
    """flax ``nn.Dropout(rate)`` named ``name`` in training: keep where
    ``bernoulli(fold_in_static(root, (name, 1)), 1 - rate, x.shape)`` (the
    module's first ``make_rng("dropout")``) and divide the kept values by
    1 - rate.  ``key_words`` is the step's root dropout key as two ints.
    With ``batch_rank`` r, ``x`` is ``dp`` replica r's equal share of a batch
    split in replica order, and the mask is the global mask's rows: the
    draw starts at element ``r * x.numel()`` (the ``mp`` ranks of a replica
    draw one mask, as the reference's one draw gives them)."""
    from ..utils import prng

    if key_words is None:
        raise ValueError(f"{name} needs a dropout key in training (dropout_rng=...)")
    keep = 1.0 - rate
    key = prng.key_tensor(prng.fold_in_static(key_words, (name, 1)), x.device)
    mask = prng.bernoulli(key, keep, x.shape, offset=batch_rank * x.numel())
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(q, k, v, mask=None):
    """flax ``nn.dot_product_attention`` without dropout or bias: q, k, v
    [batch, seq, heads, head_dim] in one type; q is divided by
    sqrt(head_dim) in that type, masked scores (``mask`` broadcast to
    [batch, heads, q, k], False = masked) take the type's most negative
    value, the softmax result is cast to the type before p.v.  Returns
    [batch, seq_q, heads, head_dim]."""
    dtype = q.dtype
    depth = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q / depth.to(q.device), k)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(dtype).min)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def init_from_seed(model: nn.Module, seed: int) -> None:
    """Draw every layer's initial values (``reset_from``) from one CPU
    generator seeded with ``seed``, in module order."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_from"):
            module.reset_from(gen)
