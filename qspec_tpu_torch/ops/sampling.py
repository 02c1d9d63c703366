"""Sampling: top-k/p/min-p filters, seeded draws, and the lossless speculative
rejection sampler.

Port of ``qspec_tpu/ops/sampling.py`` (grammar-guided decoding is not ported).
Random draws come from an explicit ``torch.Generator``; the rejection
sampler's uniforms may be injected instead. A generator and a JAX key give
different numbers, so sampled paths are held against the JAX package by
distributions or by greedy rows, never by token equality.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class SamplingTensors(NamedTuple):
    """Per-sequence sampling knobs, padded to the batch bucket.

    ``vocab_mask`` [B, V] bool (True = allowed) carries allowed/banned token
    sets and min-tokens EOS suppression; ``logit_bias`` [B, V] f32 carries
    presence/frequency penalties and logit_bias. Both are None when no row
    uses them. ``needs_filter`` is worked out on the host when the tensors
    are built: False skips the full-vocabulary sorts of the top-k/top-p/min-p
    filters (no row asks for them) without reading the card.
    """

    temperature: torch.Tensor  # [B] f32; 0 => greedy
    top_k: torch.Tensor        # [B] int32; <= 0 => disabled
    top_p: torch.Tensor        # [B] f32; 1.0 => disabled
    min_p: torch.Tensor        # [B] f32; 0 => disabled
    vocab_mask: Optional[torch.Tensor] = None
    logit_bias: Optional[torch.Tensor] = None
    needs_filter: bool = True


def _apply_top_k(logits, top_k):
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.to(torch.int64).clamp(1, vocab)
    kth = sorted_logits.gather(-1, (k - 1)[:, None])
    keep = (logits >= kth) | (top_k <= 0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def _apply_top_p(logits, top_p):
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix with cumulative mass >= top_p; the threshold
    # is the lowest logit inside that prefix
    cutoff = (cum - probs) < top_p[:, None]
    kth = torch.where(cutoff, sorted_logits,
                      torch.full_like(sorted_logits, -NEG_INF)).amin(dim=-1, keepdim=True)
    keep = (logits >= kth) | (top_p >= 1.0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def _apply_min_p(logits, min_p):
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    keep = (probs >= pmax * min_p[:, None]) | (min_p <= 0)[:, None]
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def _per_row(arr, rows):
    # the verify path evaluates k+1 positions per sequence
    if arr.shape[0] != rows:
        return torch.repeat_interleave(arr, rows // arr.shape[0], dim=0)
    return arr


def _masked_logits(logits, st):
    lf = logits.to(torch.float32)
    if st.logit_bias is not None:
        lf = lf + _per_row(st.logit_bias, lf.shape[0])
    if st.vocab_mask is not None:
        lf = torch.where(_per_row(st.vocab_mask, lf.shape[0]), lf,
                         torch.full_like(lf, NEG_INF))
    return lf


def sampling_probs(logits: torch.Tensor, st: SamplingTensors) -> torch.Tensor:
    """logits [R, V] -> post-filter sampling distribution [R, V] (f32).

    Greedy rows (temperature 0) give the one-hot of the argmax, which makes
    rejection sampling reduce exactly to 'accept iff the argmax matches' —
    the invariant behind greedy spec == greedy AR.
    """
    rows = logits.shape[0]
    lf = _masked_logits(logits, st)
    temp_raw = _per_row(st.temperature, rows)
    temp = torch.where(temp_raw > 0, temp_raw, torch.ones_like(temp_raw))
    lf = lf / temp[:, None]
    if st.needs_filter:
        lf = _apply_top_k(lf, _per_row(st.top_k, rows))
        lf = _apply_top_p(lf, _per_row(st.top_p, rows))
        lf = _apply_min_p(lf, _per_row(st.min_p, rows))
    probs = torch.softmax(lf, dim=-1)
    greedy_src = lf if (st.vocab_mask is not None or st.logit_bias is not None) \
        else logits
    onehot = torch.nn.functional.one_hot(greedy_src.argmax(dim=-1),
                                         logits.shape[-1]).to(torch.float32)
    return torch.where((temp_raw == 0)[:, None], onehot, probs)


def sample(logits: torch.Tensor, st: SamplingTensors,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample one token per row. [B, V] -> [B] int32."""
    return sample_with_logprob(logits, st, gen)[0]


def sample_with_logprob(logits: torch.Tensor, st: SamplingTensors,
                        gen: Optional[torch.Generator] = None):
    """[B, V] -> ([B] int32 tokens, [B] f32 logprob of the chosen token under
    the unfiltered softmax)."""
    probs = sampling_probs(logits, st)
    sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
    greedy = _masked_logits(logits, st).argmax(dim=-1)
    toks = torch.where(st.temperature == 0, greedy, sampled).to(torch.int32)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    chosen = logp.gather(-1, toks.to(torch.int64)[:, None])[:, 0]
    return toks, chosen


class RejectionResult(NamedTuple):
    tokens: torch.Tensor            # [B, k+1] int32, -1 past accepted_len
    accepted_len: torch.Tensor      # [B] int32 in [1, k+1]: accepted draft + 1
    num_draft_accepted: torch.Tensor  # [B] int32 in [0, k]
    token_logprobs: torch.Tensor    # [B, k+1] f32 log p_target(token), 0 past len


def rejection_sample(draft_tokens: torch.Tensor, draft_probs: torch.Tensor,
                     target_probs: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None) -> RejectionResult:
    """Lossless speculative verification.

    draft_tokens [B, k] (-1 = no proposal); draft_probs [B, k, V] (the
    draft's sampling distribution q); target_probs [B, k+1, V] (p). Accept
    d_i with probability min(1, p_i(d_i) / q_i(d_i)); at the first rejection
    emit a recovery token from norm(max(p_i - q_i, 0)); if all k are
    accepted, a bonus token from p_k. ``uniforms`` [B, k] replaces the
    accept draws (tests inject them).
    """
    B, k = draft_tokens.shape
    dev = target_probs.device
    d = draft_tokens.to(torch.int64)
    d_safe = d.clamp_min(0)[..., None]
    p_at_d = target_probs[:, :k].gather(-1, d_safe)[..., 0]
    q_at_d = draft_probs.gather(-1, d_safe)[..., 0]
    u = uniforms if uniforms is not None else torch.rand(
        (B, k), generator=gen, device=dev)
    ratio = p_at_d / q_at_d.clamp_min(1e-30)
    accept = (u < ratio.clamp(max=1.0)) & (d >= 0) & (q_at_d > 0)

    rejected = ~accept
    any_rej = rejected.any(dim=1)
    first_rej = rejected.to(torch.int32).argmax(dim=1)
    n_acc = torch.where(any_rej, first_rej, torch.full_like(first_rej, k))

    pos = n_acc.clamp(max=k - 1).to(torch.int64)
    idx = pos[:, None, None].expand(B, 1, target_probs.shape[-1])
    p_rej = target_probs.gather(1, idx)[:, 0]
    q_rej = draft_probs.gather(1, idx)[:, 0]
    resid = (p_rej - q_rej).clamp_min(0.0)
    resid_sum = resid.sum(dim=-1, keepdim=True)
    # degenerate case (q covers p exactly): fall back to p
    resid = torch.where(resid_sum > 1e-9, resid, p_rej)
    recovery = torch.multinomial(resid, 1, generator=gen)[:, 0]
    bonus = torch.multinomial(target_probs[:, k], 1, generator=gen)[:, 0]

    final_tok = torch.where(n_acc == k, bonus, recovery)
    slots = torch.arange(k + 1, device=dev)[None, :]
    padded = torch.cat([d, torch.full((B, 1), -1, dtype=torch.int64, device=dev)], 1)
    n_acc64 = n_acc.to(torch.int64)[:, None]
    out = torch.where(slots < n_acc64, padded, torch.full_like(padded, -1))
    out = torch.where(slots == n_acc64, final_tok[:, None], out)
    p_at_out = target_probs.gather(-1, out.clamp_min(0)[..., None])[..., 0]
    logp = torch.where(out >= 0, torch.log(p_at_out.clamp_min(1e-30)),
                       torch.zeros_like(p_at_out))
    return RejectionResult(out.to(torch.int32), (n_acc + 1).to(torch.int32),
                           n_acc.to(torch.int32), logp.to(torch.float32))
