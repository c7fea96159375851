"""Ulysses sequence parallelism: an all-to-all trades heads for sequence.

Counterpart of the reference's ``parallel/ulysses.py``.  One all-to-all a
tensor re-partitions [batch, heads, seq/n, head_dim] into [batch, heads/n,
seq, head_dim]: every rank then holds the whole sequence for a subset of
the heads, runs the flash kernel on it (``ops/flash_attention.py``:
kernel 2 forward, kernels 3 and 4 in its backward) with no communication
inside, and the inverse all-to-all gives the sequence split back.

The reference runs ``lax.all_to_all`` inside ``shard_map``; here each rank
is one process and the exchange is ``TensorParallel.exchange`` over the
``sp`` group (c10d's ``all_to_all_single``), whose autograd backward is
the same exchange of the gradient.  The reference attends with its plain
``mha_reference`` when the full sequence is not 128-tileable; the port's
kernels mask a ragged last tile, so every length runs the kernel on the
card (the two agree within tolerance).

:func:`ulysses_attention` is the per-rank body.  As for the ring, the
reference wrapper's expand fallback for kv heads a tensor-parallel degree
does not split has no counterpart: ``tensor.lm_layout`` refuses the degree.
"""

from __future__ import annotations

from ..ops.flash_attention import flash_attention
from .ring import expand_gqa_kv


def _scatter_heads(x, sp):
    """[b, h, s/n, d] -> [b, h/n, s, d]: head block j goes to rank j, and
    every rank's sequence block of this rank's heads comes back in rank
    order."""
    b, h, s, d = x.shape
    n = sp.size
    got = sp.exchange(x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous())
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _gather_heads(x, sp):
    """[b, h/n, s, d] -> [b, h, s/n, d]: the inverse exchange."""
    b, h, s, d = x.shape
    n = sp.size
    got = sp.exchange(x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous())
    return got.transpose(0, 1).reshape(b, n * h, s // n, d)


def ulysses_attention(q, k, v, sp, causal: bool = False):
    """Per-rank Ulysses body.

    This rank's shards [batch, heads, local_seq, head_dim] of a sequence
    split over ``sp`` (a ``tensor.TensorParallel`` over the group); heads
    must divide by its size.  When ``kv_heads`` divides it too, k/v ride
    their own, group-times smaller all-to-all and the kernel runs GQA
    natively; otherwise kv is expanded to full heads first."""
    n = sp.size
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by {sp.axis}={n}; "
                         "use ring attention for head-poor long-context models")
    kv_heads = k.shape[1]
    if q.shape[1] % kv_heads:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {kv_heads}")
    if kv_heads != q.shape[1] and kv_heads % n:
        # Too few kv heads to scatter over the group: expand to full heads
        # (the kernel would take GQA; the all-to-all cannot).
        k, v = expand_gqa_kv(q, k, v)
    out = flash_attention(_scatter_heads(q, sp), _scatter_heads(k, sp), _scatter_heads(v, sp),
                          causal=causal)
    return _gather_heads(out, sp)

