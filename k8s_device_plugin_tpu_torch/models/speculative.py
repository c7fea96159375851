"""Speculative decoding over the dense cache: a cheap draft proposes, the
target verifies.

Counterpart of the reference's ``models/speculative.py`` (batch 1; the
serving engine's shared-pool rounds are ``engine_spec.py``).  Each round:

1. the draft runs ``gamma + 1`` single-token cached steps from the last
   token, proposing d_1..d_gamma (the last step only writes d_gamma's K/V,
   so on a full accept the draft cache covers the next round's start);
2. the target scores [x_t, d_1..d_gamma] in ONE cached (gamma+1)-token
   append (``append_mode="cached"``);
3. greedy: a = the longest prefix where the target's argmax agrees, and the
   round emits d_1..d_a plus the target's token at a; sampled: the
   Leviathan/Chen acceptance-rejection (accept d w.p. min(1, P(d)/Q(d)),
   the first rejection draws from max(0, P - Q) renormalized, a full accept
   draws the bonus from P);
4. both caches rewind their write index to the consumed length: slots past
   it are rewritten before any later query can read them.

Greedy output equals ``greedy_generate``'s token for token; sampled output
equals the reference's under one key (``utils/prng.py`` threefry on the
reference's schedule).  Both models prefill through the bulk forward (the
flash kernel).  Returns ``(sequence [1, prompt + new], accepted [new])``,
``accepted[i] = 1`` where token i was a draft proposal the target took.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import prng
from .transformer import DenseCache, GPTConfig, TransformerLM


def _validate_spec_args(target_cfg: GPTConfig, draft_cfg: GPTConfig, prompt, max_new_tokens: int,
                        gamma: int) -> int:
    """Both entry points' preconditions (the reference's checks and
    messages); returns the prompt length."""
    batch, prompt_len = prompt.shape
    if batch != 1:
        raise ValueError(f"speculative decode is batch-1 (got batch={batch})")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab {target_cfg.vocab_size}"
        )
    # A round may write gamma + 1 slots past the accepted point before it
    # rewinds, so both caches need headroom past max_new_tokens.
    need = prompt_len + max_new_tokens + gamma
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if need > cfg.max_seq:
            raise ValueError(
                f"{name} max_seq {cfg.max_seq} < prompt {prompt_len} + max_new "
                f"{max_new_tokens} + gamma {gamma} headroom"
            )
    return prompt_len


def accept_draws(u, q_d, p_d):
    """The acceptance test of each proposal d: ``u·Q(d) < P(d)``, i.e. a
    uniform draw under min(1, P(d)/Q(d)) (the engine's rounds share it)."""
    return u * q_d < p_d


def _rewind(cache: DenseCache, new_index: int) -> None:
    """Set the cache's write index (every layer's) to ``new_index``."""
    cache.index = new_index


def _model(cfg: GPTConfig, params: dict, device) -> TransformerLM:
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(params)
    return model


@torch.no_grad()
def _speculate(target_cfg, target_params, draft_cfg, draft_params, prompt, max_new_tokens: int,
               gamma: int, temperature: Optional[float], rng, device):
    prompt = torch.as_tensor(prompt).long()
    prompt_len = _validate_spec_args(target_cfg, draft_cfg, prompt, max_new_tokens, gamma)
    target = _model(target_cfg, target_params, device)
    draft = _model(draft_cfg, draft_params, device)
    dev = target.device
    prompt = prompt.to(dev)
    sampling = temperature is not None
    t_cache = DenseCache.zeros(target_cfg, 1, dev)
    d_cache = DenseCache.zeros(draft_cfg, 1, dev)
    pos = torch.arange(prompt_len, device=dev)[None, :]
    t_logits = target(prompt, pos, cache=t_cache)
    draft(prompt, pos, cache=d_cache)
    if sampling:
        rng = torch.as_tensor(rng).to(dev)
        first = prng.categorical(prng.fold_in(rng, 0), t_logits[:, -1] / temperature)[0]
        key = prng.fold_in(rng, 1)
    else:
        first = t_logits[0, -1].argmax()
    out, acc = [first], [0]
    t_pos, last = prompt_len, first
    steps = torch.arange(gamma + 1, device=dev)
    while len(out) < max_new_tokens:
        if sampling:
            key, kd, ka, kt = prng.split(key, 4)
        # 1. gamma + 1 draft steps; the last one's proposal is discarded.
        tok, props, qs = last, [], []
        for i in range(gamma + 1):
            row = draft(tok.reshape(1, 1), torch.full((1, 1), t_pos + i, device=dev),
                        cache=d_cache)[0, -1]
            if sampling:
                scaled = row / temperature
                tok = prng.categorical(prng.fold_in(kd, i), scaled)
                qs.append(torch.softmax(scaled, dim=-1))
            else:
                tok = row.argmax()
            props.append(tok)
        props = torch.stack(props[:gamma])
        # 2. The target scores [x_t, d_1..d_gamma] in one cached append.
        block = torch.cat([last.reshape(1), props])[None, :]
        v_logits = target(block, (t_pos + steps)[None, :], cache=t_cache,
                          append_mode="cached")[0]
        if sampling:
            # 3s. Acceptance-rejection; each emitted token is marginally a
            # draw from the target at this temperature.
            p_all = torch.softmax(v_logits / temperature, dim=-1)  # [gamma+1, V]
            q_ext = torch.stack(qs)  # [gamma+1, V]
            jj = steps[:gamma]
            p_d, q_d = p_all[jj, props], q_ext[jj, props]
            u = prng.uniform(ka, (gamma,))
            a = int(torch.cumprod(accept_draws(u, q_d, p_d).long(), 0).sum())
            p_a, q_a = p_all[a], q_ext[a]
            resid = (p_a - q_a).clamp_min(0.0) if a < gamma else p_a
            norm = resid.sum()
            tail_p = torch.where(norm > 0, resid / norm, p_a)
            tail = prng.categorical(kt, torch.log(tail_p))
        else:
            # 3. a = the longest prefix where the target's argmax agrees.
            t_toks = v_logits.argmax(dim=-1)
            a = int(torch.cumprod((t_toks[:-1] == props).long(), 0).sum())
            tail = t_toks[a]
        out.extend([*props[:a], tail])
        acc.extend([1] * a + [0])
        # 4. Rewind both caches to the consumed length.
        t_pos += a + 1
        _rewind(t_cache, t_pos)
        _rewind(d_cache, t_pos)
        last = tail
    seq = torch.cat([prompt[0], torch.stack(out[:max_new_tokens])])[None, :]
    return seq, torch.tensor(acc[:max_new_tokens], device=dev)


def speculative_generate(target_cfg: GPTConfig, target_params: dict, draft_cfg: GPTConfig,
                         draft_params: dict, prompt, max_new_tokens: int, *, gamma: int = 4,
                         device=None):
    """Greedy speculative decode.  ``prompt``: [1, prompt_len] token ids;
    ``*_params``: state dicts (a ``w8`` self-draft is the target's state
    dict through ``quantize_lm_params`` under ``quant="w8"``).  The sequence
    is exactly ``greedy_generate(target_cfg, target_params, prompt,
    max_new_tokens)``."""
    return _speculate(target_cfg, target_params, draft_cfg, draft_params, prompt,
                      max_new_tokens, gamma, None, None, device)


def speculative_sample_generate(target_cfg: GPTConfig, target_params: dict, draft_cfg: GPTConfig,
                                draft_params: dict, prompt, max_new_tokens: int, *, rng,
                                temperature: float = 1.0, gamma: int = 4, device=None):
    """Distribution-preserving speculative sampling at ``temperature``
    (``rng``: a ``prng.PRNGKey``); the contract and return of
    :func:`speculative_generate`."""
    if temperature <= 0:
        raise ValueError(
            f"temperature must be > 0, got {temperature}; use speculative_generate for greedy "
            "decoding"
        )
    return _speculate(target_cfg, target_params, draft_cfg, draft_params, prompt,
                      max_new_tokens, gamma, float(temperature), rng, device)
