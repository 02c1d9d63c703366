"""Model runner: owns the parameters and the paged caches, runs the steps.

Port of the QSpec path of ``qspec_tpu/engine/model_runner.py``. The JAX
package compiles one executable per (phase, bucket); here the steps are
plain functions that launch the kernels eagerly on the caller's device. The
QSpec scheme switch is the same as there: ``draft_steps`` runs the forward
under the w4a4 (or w4a8) scheme and ``verify_step`` under w4a16, on the same
parameters. Batches keep the JAX package's bucketed shapes.

All control flow inside a step (token advancement, accepted lengths, budgets)
stays in tensors on the device, so a fused call reads nothing back until the
caller asks for the tokens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qspec_tpu_torch.config import EngineConfig
from qspec_tpu_torch.models.llama import AttentionBatch, model_forward, resolve_device
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.ops.sampling import (SamplingTensors, rejection_sample,
                                          sample, sample_with_logprob,
                                          sampling_probs)


def _slot_of(block_tables: torch.Tensor, pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """Flat kv slot for absolute positions. block_tables [B, P], pos [B, Q].
    Positions past the table (bucket padding) clamp to its last entry; the
    callers mask them to slot 0."""
    pos = pos.to(torch.int64)
    page_idx = (pos // page_size).clamp(max=block_tables.shape[1] - 1)
    page_id = block_tables.to(torch.int64).gather(1, page_idx)
    return page_id * page_size + pos % page_size


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def prefill_step(params, cache, token_ids, positions, block_tables, ctx_len, *,
                 cfg, scheme):
    """One prompt-chunk rectangle. token_ids [B, Q]; returns the logits of
    each row's last valid position ([B, V]) and the cache (written in
    place). ``ctx_len`` [B] counts tokens including this chunk; padded tail
    positions write to the null page and are masked out of attention."""
    page_size = cache.page_size
    Q = token_ids.shape[1]
    valid = positions < ctx_len[:, None]
    slot = torch.where(valid, _slot_of(block_tables, positions, page_size),
                       torch.zeros_like(positions, dtype=torch.int64))
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=ctx_len)
    last_idx = (ctx_len - 1 - positions[:, 0]).clamp(0, Q - 1)
    logits, cache = model_forward(params, cfg, token_ids, cache, batch,
                                  scheme=scheme, logits_indices=last_idx)
    return logits[:, 0], cache


def decode_step(params, cache, last_tokens, start_pos, block_tables, st, gen,
                *, cfg, scheme):
    """Autoregressive decode: one token per sequence. last_tokens [B] (not
    yet processed), start_pos [B] = their positions. Returns
    (next_tokens [B], logprobs [B], cache)."""
    pos = start_pos[:, None]
    slot = _slot_of(block_tables, pos, cache.page_size)
    batch = AttentionBatch(positions=pos, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=start_pos + 1)
    logits, cache = model_forward(params, cfg, last_tokens[:, None], cache,
                                  batch, scheme=scheme)
    next_tokens, lp = sample_with_logprob(logits[:, 0], st, gen)
    return next_tokens, lp, cache


def _draft_impl(params, cache, last_tokens, start_pos, block_tables, st, gen,
                *, cfg, scheme, k, prev_tokens=None):
    """k sequential draft forwards; returns (tokens [B, k], probs [B, k, V],
    cache).

    ``prev_tokens`` (the token at ``start_pos - 1``) makes the FIRST step a
    Q=2 pass over [prev, last]. That rewrites the draft-KV slot the previous
    round left stale: the k-th proposal's KV is never written in its own
    round, so a fully accepted round would leave a hole in the draft cache
    that later draft attention reads. Rows at start_pos == 0 send the
    phantom query's KV write to the null page; its output is discarded.
    """
    page_size = cache.page_size
    first_k = k
    toks0 = probs0 = None
    if prev_tokens is not None:
        p2 = torch.stack([start_pos - 1, start_pos], dim=1)       # [B, 2]
        slot2 = torch.where(p2 >= 0, _slot_of(block_tables, p2.clamp_min(0), page_size),
                            torch.zeros_like(p2, dtype=torch.int64))
        batch = AttentionBatch(positions=p2, slot_mapping=slot2,
                               block_tables=block_tables,
                               ctx_lens=start_pos + 1)
        t2 = torch.stack([prev_tokens, last_tokens], dim=1)
        logits, cache = model_forward(params, cfg, t2, cache, batch, scheme=scheme)
        probs0 = sampling_probs(logits[:, 1], st)
        toks0 = sample(logits[:, 1], st, gen)
        last_tokens, start_pos = toks0, start_pos + 1
        first_k = k - 1

    toks, probs = [], []
    tok, pos = last_tokens, start_pos
    for _ in range(first_k):
        p = pos[:, None]
        batch = AttentionBatch(positions=p,
                               slot_mapping=_slot_of(block_tables, p, page_size),
                               block_tables=block_tables, ctx_lens=pos + 1)
        logits, cache = model_forward(params, cfg, tok[:, None], cache, batch,
                                      scheme=scheme)
        probs.append(sampling_probs(logits[:, 0], st))
        tok = sample(logits[:, 0], st, gen)
        toks.append(tok)
        pos = pos + 1
    if toks0 is not None:
        toks.insert(0, toks0)
        probs.insert(0, probs0)
    return torch.stack(toks, dim=1), torch.stack(probs, dim=1), cache


def draft_steps(params, cache, last_tokens, start_pos, block_tables, st, gen,
                *, cfg, scheme, k):
    """k sequential draft steps. Returns (draft_tokens [B, k],
    draft_probs [B, k, V], cache)."""
    return _draft_impl(params, cache, last_tokens, start_pos, block_tables, st,
                       gen, cfg=cfg, scheme=scheme, k=k)


def _verify_impl(params, cache, last_tokens, draft_tokens, draft_probs, start_pos,
                 block_tables, st, gen, *, cfg, scheme):
    B, k = draft_tokens.shape
    tokens = torch.cat([last_tokens[:, None], draft_tokens], dim=1)  # [B, k+1]
    positions = start_pos[:, None] + torch.arange(k + 1, device=start_pos.device)[None, :]
    slot = _slot_of(block_tables, positions, cache.page_size)
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=start_pos + k + 1)
    logits, cache = model_forward(params, cfg, tokens, cache, batch, scheme=scheme)
    V = logits.shape[-1]
    st_rep = st._replace(
        temperature=torch.repeat_interleave(st.temperature, k + 1),
        top_k=torch.repeat_interleave(st.top_k, k + 1),
        top_p=torch.repeat_interleave(st.top_p, k + 1),
        min_p=torch.repeat_interleave(st.min_p, k + 1))
    target_probs = sampling_probs(logits.reshape(B * (k + 1), V), st_rep)
    result = rejection_sample(draft_tokens, draft_probs,
                              target_probs.reshape(B, k + 1, V), gen)
    return result, cache


def verify_step(params, cache, last_tokens, draft_tokens, draft_probs, start_pos,
                block_tables, st, gen, *, cfg, scheme):
    """Score k+1 positions in one pass and rejection-sample: the weights are
    read once for the whole [last, d_1..d_k] window."""
    return _verify_impl(params, cache, last_tokens, draft_tokens, draft_probs,
                        start_pos, block_tables, st, gen, cfg=cfg, scheme=scheme)


def spec_rounds_step(params, draft_cache, cache, last_tokens, prev_tokens,
                     start_pos, block_tables, draft_block_tables, max_new,
                     enable: bool, st, gen, *, cfg, draft_scheme, verify_scheme,
                     k, num_rounds=1):
    """``num_rounds`` full QSpec rounds (k drafts + verify + rejection).

    ``max_new`` [B] caps the tokens emitted per sequence. ``enable=False``
    nulls every proposal (tokens -> -1, draft probs -> 0, so the recovery
    distribution is exactly the target's) and each round emits exactly one
    autoregressive token through the SAME computation at the SAME shapes:
    the bit-exact AR oracle for the greedy spec == AR invariant.

    Returns (tokens [R, B, k+1] (-1 padded), accepted_len [R, B],
    logprobs [R, B, k+1], (last, prev, pos, budget), draft_cache, cache).
    """
    last, prev, pos, budget = last_tokens, prev_tokens, start_pos, max_new
    out_t, out_a, out_l = [], [], []
    slots = torch.arange(k + 1, device=last.device)[None, :]
    for _ in range(num_rounds):
        d_toks, d_probs, draft_cache = _draft_impl(
            params, draft_cache, last, pos, draft_block_tables, st, gen,
            cfg=cfg, scheme=draft_scheme, k=k, prev_tokens=prev)
        if not enable:
            d_toks = torch.full_like(d_toks, -1)
            d_probs = torch.zeros_like(d_probs)
        result, cache = _verify_impl(params, cache, last, d_toks, d_probs, pos,
                                     block_tables, st, gen, cfg=cfg,
                                     scheme=verify_scheme)
        active = budget > 0
        acc = torch.minimum(result.accepted_len, budget.clamp_min(0))
        acc = torch.where(active, acc.clamp_min(1), torch.zeros_like(acc))
        live = slots < acc[:, None]
        toks = torch.where(live, result.tokens, torch.full_like(result.tokens, -1))
        lps = torch.where(live, result.token_logprobs,
                          torch.zeros_like(result.token_logprobs))
        # advance: the next input is the last emitted token, position += acc
        idx1 = (acc - 1).clamp_min(0).to(torch.int64)[:, None]
        new_last = result.tokens.gather(1, idx1)[:, 0]
        new_last = torch.where(active, new_last, last)
        # predecessor (at the new position - 1) for the next draft's backfill:
        # emitted[acc-2] when >= 2 tokens were emitted, else this round's last
        idx2 = (acc - 2).clamp_min(0).to(torch.int64)[:, None]
        cand = result.tokens.gather(1, idx2)[:, 0]
        new_prev = torch.where(acc >= 2, cand, last)
        prev = torch.where(active, new_prev, prev)
        last = new_last
        pos = pos + acc
        budget = budget - acc
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l),
            (last, prev, pos, budget), draft_cache, cache)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


class ModelRunner:
    """Owns params + paged caches and runs bucketed steps on one device."""

    def __init__(self, config: EngineConfig, params, num_pages: int,
                 need_draft_cache: bool = False, device="cuda", seed: int = 0):
        self.config = config
        self.cfg = config.model
        self.params = params
        self.device = resolve_device(device)
        page_size = config.cache.page_size
        kv_cfg = kvc.KVCacheConfig(
            num_layers=self.cfg.num_layers, num_kv_heads=self.cfg.cache_kv_heads,
            head_dim=self.cfg.cache_head_dim, num_pages=num_pages,
            page_size=page_size, dtype=config.cache.kv_cache_dtype)
        self.cache = kvc.allocate(kv_cfg, self.device)
        # the draft keeps its own KV (computed under the draft scheme) in a
        # second pool with the same page ids
        self.draft_cache = kvc.allocate(kv_cfg, self.device) if need_draft_cache else None
        self.page_size = page_size
        self.max_pages_per_seq = -(-config.scheduler.max_model_len // page_size)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        spec = config.speculative
        self.k = spec.num_speculative_tokens if spec else 1
        self.draft_scheme = spec.draft_scheme if spec else "w4a4"
        self.verify_scheme = "w4a16"

    # -- helpers ----------------------------------------------------------
    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _bucket_batch(self, b: int) -> int:
        for cand in self.config.scheduler.decode_batch_buckets:
            if b <= cand:
                return cand
        return self.config.scheduler.decode_batch_buckets[-1]

    def _bucket_tokens(self, t: int) -> int:
        for cand in self.config.scheduler.prefill_token_buckets:
            if t <= cand:
                return cand
        return self.config.scheduler.prefill_token_buckets[-1]

    def _pad_block_tables(self, tables: list) -> torch.Tensor:
        out = np.zeros((len(tables), self.max_pages_per_seq), np.int32)
        for i, t in enumerate(tables):
            n = min(len(t), self.max_pages_per_seq)
            out[i, :n] = t[:n]
        return self._t(out)

    def sampling_tensors(self, st: SamplingTensors, n: int, bucket: int) -> SamplingTensors:
        """Pad host (numpy) sampling knobs to the bucket and move them to the
        device."""
        def pad(x, fill, dtype):
            arr = np.full(bucket, fill, dtype)
            arr[:n] = np.asarray(x)[:n]
            return self._t(arr, torch.int32 if dtype == np.int32 else torch.float32)

        mask = bias = None
        if st.vocab_mask is not None:
            m = np.ones((bucket, st.vocab_mask.shape[1]), bool)
            m[:n] = np.asarray(st.vocab_mask)[:n]
            mask = torch.as_tensor(m, device=self.device)
        if st.logit_bias is not None:
            bb = np.zeros((bucket, st.logit_bias.shape[1]), np.float32)
            bb[:n] = np.asarray(st.logit_bias)[:n]
            bias = torch.as_tensor(bb, device=self.device)
        return SamplingTensors(
            temperature=pad(st.temperature, 0.0, np.float32),
            top_k=pad(st.top_k, 0, np.int32),
            top_p=pad(st.top_p, 1.0, np.float32),
            min_p=pad(st.min_p, 0.0, np.float32),
            vocab_mask=mask, logit_bias=bias, needs_filter=st.needs_filter)

    # -- phases -----------------------------------------------------------
    def run_prefill_chunks(self, chunks, *, draft: bool = False) -> torch.Tensor:
        """Batched prompt chunks as one (B, Q) rectangle. chunks: list of
        (seq, start, end). Returns device logits [B, V] of each row's last
        valid position (meaningful for rows whose chunk ends the prompt).
        ``draft`` runs the draft scheme into the draft cache."""
        B = self._bucket_batch(len(chunks))
        Q = self._bucket_tokens(max(end - start for _, start, end in chunks))
        toks = np.zeros((B, Q), np.int32)
        positions = np.zeros((B, Q), np.int32)
        ctx = np.zeros(B, np.int32)
        tables = [[] for _ in range(B)]
        for i, (seq, start, end) in enumerate(chunks):
            # token_ids (prompt + preserved outputs): a resumed preempted
            # sequence re-prefills its generated tokens too
            piece = seq.token_ids[start:end]
            toks[i, :len(piece)] = piece
            positions[i] = np.arange(start, start + Q, dtype=np.int32)
            ctx[i] = end
            tables[i] = seq.page_ids
        cache = self.draft_cache if draft else self.cache
        logits, _ = prefill_step(
            self.params, cache, self._t(toks), self._t(positions),
            self._pad_block_tables(tables), self._t(ctx), cfg=self.cfg,
            scheme=self.draft_scheme if draft else self.verify_scheme)
        return logits

    def sample_tokens(self, logits, st: SamplingTensors):
        """Sample one token per row of [B, V] device logits.
        Returns numpy (tokens [B], logprobs [B])."""
        toks, lps = sample_with_logprob(logits, st, self.gen)
        return toks.cpu().numpy(), lps.cpu().numpy()

    def _decode_inputs(self, seqs):
        B = self._bucket_batch(len(seqs))
        last = np.zeros(B, np.int32)
        prev = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)
        max_new = np.zeros(B, np.int32)
        tables = [[] for _ in range(B)]
        for i, s in enumerate(seqs):
            toks = s.token_ids
            last[i] = toks[-1]
            # token at pos-1 for the draft's backfill pass (_draft_impl)
            prev[i] = toks[-2] if len(toks) >= 2 else last[i]
            pos[i] = s.num_tokens - 1
            max_new[i] = max(s.sampling_params.max_tokens - len(s.output_token_ids), 0)
            tables[i] = s.page_ids
        return B, last, prev, pos, max_new, self._pad_block_tables(tables)

    def run_decode(self, seqs, sampling: SamplingTensors):
        """One autoregressive step. Returns numpy (tokens [1, n], logprobs [1, n])."""
        B, last, _, pos, _, tables = self._decode_inputs(seqs)
        st = self.sampling_tensors(sampling, len(seqs), B)
        toks, lps, _ = decode_step(self.params, self.cache, self._t(last),
                                   self._t(pos), tables, st, self.gen,
                                   cfg=self.cfg, scheme=self.verify_scheme)
        n = len(seqs)
        return toks.cpu().numpy()[None, :n], lps.cpu().numpy()[None, :n]

    def run_spec_rounds(self, seqs, sampling: SamplingTensors, num_rounds: int = 1,
                        chain: int = 1, enable: bool = True):
        """``num_rounds`` QSpec rounds per call; ``chain`` calls issued back
        to back on device-resident advance state (nothing is read back in
        between). ``enable=False`` runs the same rounds with nulled
        proposals: the bit-exact AR oracle.

        Returns numpy (tokens [chain*R, n, k+1] (-1 padded), accepted
        [chain*R, n], logprobs [chain*R, n, k+1]).
        """
        B, last, prev, pos, max_new, tables = self._decode_inputs(seqs)
        st = self.sampling_tensors(sampling, len(seqs), B)
        state = (self._t(last), self._t(prev), self._t(pos), self._t(max_new))
        parts = []
        for _ in range(max(1, chain)):
            toks, accs, lps, state, _, _ = spec_rounds_step(
                self.params, self.draft_cache, self.cache, *state[:3], tables,
                tables, state[3], enable, st, self.gen, cfg=self.cfg,
                draft_scheme=self.draft_scheme, verify_scheme=self.verify_scheme,
                k=self.k, num_rounds=num_rounds)
            parts.append((toks, accs, lps))
        n = len(seqs)
        toks = torch.cat([p[0] for p in parts]).cpu().numpy()
        accs = torch.cat([p[1] for p in parts]).cpu().numpy()
        lps = torch.cat([p[2] for p in parts]).cpu().numpy()
        return toks[:, :n], accs[:, :n], lps[:, :n]


def make_sampling_tensors(seqs, vocab_size: Optional[int] = None,
                          eos_token_id: Optional[int] = None) -> SamplingTensors:
    """Batch the per-sequence knobs on the host (numpy); builds a [B, V]
    vocab mask only when a row carries allowed/banned token sets or a
    min-tokens EOS suppression, and a logit bias only for penalties and
    logit_bias."""
    mask = None
    if vocab_size is not None:
        need = any(s.sampling_params.allowed_token_ids
                   or s.sampling_params.banned_token_ids
                   or (s.sampling_params.min_tokens
                       and len(s.output_token_ids) < s.sampling_params.min_tokens)
                   for s in seqs)
        if need:
            m = np.ones((len(seqs), vocab_size), bool)
            for i, s in enumerate(seqs):
                sp = s.sampling_params
                if sp.allowed_token_ids:
                    m[i] = False
                    m[i, np.asarray(sp.allowed_token_ids)] = True
                if sp.banned_token_ids:
                    m[i, np.asarray(sp.banned_token_ids)] = False
                if (sp.min_tokens and eos_token_id is not None
                        and len(s.output_token_ids) < sp.min_tokens):
                    m[i, eos_token_id] = False
                    for t in (sp.stop_token_ids or ()):
                        m[i, t] = False
            mask = m
    bias = None
    if vocab_size is not None and any(
            s.sampling_params.presence_penalty or s.sampling_params.frequency_penalty
            or s.sampling_params.logit_bias for s in seqs):
        bias = np.zeros((len(seqs), vocab_size), np.float32)
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            if sp.presence_penalty or sp.frequency_penalty:
                counts = np.bincount(np.asarray(s.output_token_ids, np.int64),
                                     minlength=vocab_size) if s.output_token_ids \
                    else np.zeros(vocab_size, np.int64)
                bias[i] = -(sp.presence_penalty * (counts > 0)
                            + sp.frequency_penalty * counts)
            if sp.logit_bias:
                for tok, b in sp.logit_bias.items():
                    t = int(tok)
                    if 0 <= t < vocab_size:
                        bias[i, t] += float(b)
    sps = [s.sampling_params for s in seqs]
    needs_filter = any(sp.top_k > 0 or sp.top_p < 1.0 or sp.min_p > 0.0
                       for sp in sps)
    return SamplingTensors(
        temperature=np.array([sp.temperature for sp in sps], np.float32),
        top_k=np.array([sp.top_k for sp in sps], np.int32),
        top_p=np.array([sp.top_p for sp in sps], np.float32),
        min_p=np.array([sp.min_p for sp in sps], np.float32),
        vocab_mask=mask, logit_bias=bias, needs_filter=needs_filter)
