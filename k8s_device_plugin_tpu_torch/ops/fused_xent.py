"""Fused LM-head + softmax cross-entropy without materializing the logits.

Counterpart of ``k8s_device_plugin_tpu/ops/fused_xent.py``.  The standard
LM training tail, ``logits = hidden @ W`` then the mean cross-entropy, holds
a float32 [tokens, vocab] tensor (1 GiB at b8 s1024 V32000).  Here an
online log-sum-exp runs over vocab chunks, so only one [tokens, chunk]
tile exists at a time, and the backward recomputes each chunk's softmax
from the saved log-sum-exp and accumulates

    dH = (P - onehot) @ W^T,   dW = H^T @ (P - onehot)

chunk by chunk.  The reference writes this in XLA, not Pallas, so the chunk
products here are ``torch.matmul`` and no CUDA kernel stands behind it.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def naive_linear_xent(hidden, w, labels):
    """The oracle: materialize the logits, mean token cross-entropy."""
    logits = (hidden @ w).float()
    correct = logits.gather(-1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - correct).mean()


def _chunk_logits(hidden, w_pad, ci, chunk, vocab):
    """[N, chunk] float32 logits of chunk ``ci``; padded columns are -inf."""
    logits = hidden.float() @ w_pad[:, ci * chunk : (ci + 1) * chunk].float()
    cols = ci * chunk + torch.arange(chunk, device=hidden.device)
    return logits.masked_fill(cols[None, :] >= vocab, NEG_INF)


def _label_in_chunk(labels, ci, chunk):
    local = labels.long() - ci * chunk
    return local, (local >= 0) & (local < chunk)


def _forward_stats(hidden, w_pad, labels, chunk, vocab):
    """Online (max, sum of exp, label logit) over the vocab chunks: returns
    (lse [N], correct [N]) float32."""
    n = hidden.shape[0]
    m = torch.full((n,), NEG_INF, device=hidden.device)
    l = torch.zeros(n, device=hidden.device)
    correct = torch.zeros(n, device=hidden.device)
    for ci in range(w_pad.shape[1] // chunk):
        logits = _chunk_logits(hidden, w_pad, ci, chunk, vocab)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        local, in_chunk = _label_in_chunk(labels, ci, chunk)
        picked = logits.gather(-1, local.clamp(0, chunk - 1)[:, None])[:, 0]
        correct = torch.where(in_chunk, picked, correct)
        m = m_new
    return m + torch.log(l), correct


class _FusedLinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w_pad, labels, chunk, vocab):
        lse, correct = _forward_stats(hidden, w_pad, labels, chunk, vocab)
        ctx.save_for_backward(hidden, w_pad, labels, lse)
        ctx.chunk, ctx.vocab = chunk, vocab
        return (lse - correct).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, w_pad, labels, lse = ctx.saved_tensors
        chunk, vocab = ctx.chunk, ctx.vocab
        scale = g / hidden.shape[0]  # d(mean)/d(token) with the incoming gradient
        dh = torch.zeros(hidden.shape, device=hidden.device)
        dw = torch.empty_like(w_pad)
        for ci in range(w_pad.shape[1] // chunk):
            w_c = w_pad[:, ci * chunk : (ci + 1) * chunk]
            p = torch.exp(_chunk_logits(hidden, w_pad, ci, chunk, vocab) - lse[:, None])
            local, in_chunk = _label_in_chunk(labels, ci, chunk)
            onehot = torch.nn.functional.one_hot(local.clamp(0, chunk - 1), chunk).float()
            delta = (p - onehot * in_chunk[:, None]) * scale  # [N, chunk] float32
            dh += (delta.to(w_c.dtype) @ w_c.T).float()
            dw[:, ci * chunk : (ci + 1) * chunk] = (hidden.T @ delta.to(hidden.dtype)).float()
        return dh.to(hidden.dtype), dw, None, None, None


def fused_linear_xent(hidden, w, labels, chunk: int = 4096):
    """Mean token cross-entropy of ``hidden @ w`` against ``labels``.

    hidden [N, d] (batch and sequence flattened), w [d, V], labels [N]
    integers.  ``chunk`` needs no relation to V: w is padded to a chunk
    multiple and the ragged tail is masked in both passes (the pad
    columns' gradient is zero and autograd slices it away).  Peak extra
    memory is N x chunk logits.  Differentiable in ``hidden`` and ``w``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    vocab = w.shape[1]
    chunk = min(chunk, vocab)
    pad = (-vocab) % chunk
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    return _FusedLinearXent.apply(hidden, w, labels, chunk, vocab)
