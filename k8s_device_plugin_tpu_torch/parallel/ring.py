"""Ring attention: sequence parallelism over a group of ranks.

Counterpart of the reference's ``parallel/ring.py``.  Each rank keeps its
query shard and passes its key/value shard round the ring of the ``sp``
group; at every step it folds the visiting kv block into a running
online-softmax state, so after ``sp`` steps every query row has attended
to every kv position while no rank holds more than its own shards and one
visiting pair.

The reference runs the body inside ``shard_map`` and rotates with
``lax.ppermute``; here each rank is one process, and the rotation is
``TensorParallel.ring_shift`` over the group (``batch_isend_irecv`` to the
next rank; its autograd backward sends the cotangent to the previous one,
ppermute's transpose).  The reference's scan rotates after every step,
the last hop bringing each rank its own shard back unused; here that hop
is not made, so a ring of ``sp`` shifts ``sp - 1`` times a call and a ring
of one not at all.  The products are float32 einsums as the reference's:
no kernel runs in the ring.

The reference's wrapper also expands kv heads that a tensor-parallel
degree does not split; the port's ``tensor.lm_layout`` refuses such a
degree, so no rank meets that case and there is no wrapper here.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def expand_gqa_kv(q, k, v):
    """Grouped-query k/v repeated to q's head count (the fallback when a
    split cannot take ``kv_heads``; the ring and Ulysses share it)."""
    group = q.shape[1] // k.shape[1]
    return k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)


def ring_attention(q, k, v, sp, causal: bool = False):
    """Per-rank ring attention body.

    Shapes are this rank's shards [batch, heads, local_seq, head_dim] of a
    sequence split over ``sp`` (a ``tensor.TensorParallel`` over the
    group): rank i holds global positions [i * local_seq, (i + 1) *
    local_seq).  Grouped-query attention is native: the rotating kv shard
    stays at ``kv_heads`` and q is reshaped to [b, kv_heads, group, s, d],
    so the exchange scales with kv_heads, not heads."""
    sm_scale = q.shape[-1] ** -0.5
    n, rank = sp.size, sp.rank
    batch, heads, seq_q, head_dim = q.shape
    kv_heads, seq_kv = k.shape[1], k.shape[2]
    if heads % kv_heads:
        raise ValueError(f"q heads {heads} not a multiple of kv heads {kv_heads}")
    group = heads // kv_heads
    f32 = torch.float32
    qf = q.to(f32).reshape(batch, kv_heads, group, seq_q, head_dim)
    rows = torch.arange(seq_q, device=q.device)[:, None]
    cols = torch.arange(seq_kv, device=q.device)[None, :]
    m = torch.full((batch, kv_heads, group, seq_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((batch, kv_heads, group, seq_q, 1), device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n):
        src = (rank - t) % n  # whose kv shard is here at this step
        # h = kv head, g = member of its q-head group: one kv shard serves
        # the whole group (GQA-native, no repeat).
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_blk.to(f32)) * sm_scale
        if causal:
            s = torch.where(rank * seq_q + rows >= src * seq_kv + cols, s, NEG_INF)
        # Online softmax fold (the flash kernel's update rule).
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        seen = m_new > NEG_INF
        p = torch.where(seen, torch.exp(s - torch.where(seen, m_new, 0.0)), 0.0)
        alpha = torch.where(seen, torch.exp(torch.where(seen, m - m_new, 0.0)), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, v_blk.to(f32))
        m = m_new
        if t < n - 1:  # the hop after the last block would bring our own back
            k_blk, v_blk = sp.ring_shift(k_blk, v_blk)
    l = torch.where(l == 0.0, 1.0, l)  # rows that saw nothing -> zero output
    return (acc / l).to(q.dtype).reshape(batch, heads, seq_q, head_dim)
