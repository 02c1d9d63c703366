"""Model runner: owns the parameters and the paged caches, runs the steps.

Port of the QSpec path of ``qspec_tpu/engine/model_runner.py``. The JAX
package compiles one executable per (phase, bucket); here the steps are
plain functions that launch the kernels eagerly on the caller's device. The
QSpec scheme switch is the same as there: ``draft_steps`` runs the forward
under the draft scheme (w4a4, w4a8, or w4a16 for a checkpoint without
rotations) and ``verify_step`` under w4a16, on the same parameters.
Batches keep the JAX package's bucketed shapes.

Under ``SpeculativeConfig.draft_kv_window`` the draft (same weights, its own
KV) attends only to the last ``window`` positions (MagicDec), and its KV
lives in a small per-sequence ring of pages instead of a second full-size
pool (see ``ModelRunner``). With ``SpeculativeConfig.draft_model`` a separate,
smaller model drafts: its own parameters and cfg, its own KV pool of its own
geometry over the target's page ids and tables.

Medusa (``method="medusa"``) has no draft forward and no draft cache: each
round's verify pass also returns the post-final-norm hidden state, and the
heads (``params["medusa"]``) read it at the last accepted position to
propose the next round's tokens (``medusa_rounds_step``); with
``SpeculativeConfig.medusa_tree`` a round verifies a whole candidate tree in
one rectangle under the tree mask and walks it
(``medusa_tree_rounds_step``). The proposals and the tree's prefix tokens
live in per-sequence rows of small device tensors (``ModelRunner``).
MLPSpeculator (``method="mlp_speculator"``, ``params["mlp_spec"]``) serves
through the same chain rounds: its recurrent heads read the hidden state
with the last emitted token.

EAGLE (``method="eagle"``, ``params["eagle"]``) drafts with a one-layer bf16
net over (embedding, target hidden) features that keeps its own one-layer KV
pool over the target's page ids: the prompt's features stream through it in
the target's prefill (``prefill_eagle_step``), and each round re-feeds the
previous round's accepted span with its true hidden states, drafts k tokens
on predicted hidden states and verifies them under the one-hot rule
(``eagle_rounds_step``). The span lives in per-sequence rows of a device
bank between engine steps.

N-gram prompt lookup (``method="ngram"``, the proposer of a bf16
checkpoint) also has no draft forward: each sequence's tokens live in a row
of a device history bank, the proposals are matched there
(``ops/ngram.py``), verified under the one-hot rule, and the accepted
tokens appended to the row, all inside ``ngram_rounds_step``.

All control flow inside a step (token advancement, accepted lengths, budgets)
stays in tensors on the device, so a fused call reads nothing back until the
caller asks for the tokens.

Grammar-guided decoding rides every path but the Medusa tree, as in the JAX
package: the batch's token-FSM tables sit on the device
(``SamplingTensors.grammar_next``) and each row's automaton state is a
device tensor that the steps carry. QSpec's draft masks its backfill and
every draft step; every verify masks position i by the state reached
through drafts 0..i-1; and each rounds loop advances the state through the
tokens a round emitted (``_grammar_advance_emitted``).

LoRA: the prefill, decode and QSpec steps take ``lora_ids`` [B], each row's
slot in ``params["lora"]`` (None when no row of the batch has an adapter);
a separate draft model runs none. The prefill takes prompt embeddings
(``input_embeds`` with the positions they replace). ``gather_pages`` /
``write_pages`` copy a sequence's pages of either cache to host memory and
back (swap preemption).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from qspec_tpu_torch import envs
from qspec_tpu_torch.config import EngineConfig
from qspec_tpu_torch.models.llama import (AttentionBatch, check_served, compute_logits,
                                          embed_rows, model_forward, resolve_device)
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.ops.attention import TreeMask, tree_mask
from qspec_tpu_torch.ops.ngram import ngram_match_device
from qspec_tpu_torch.ops.sampling import (SamplingTensors, grammar_advance, rejection_sample,
                                          rejection_sample_onehot, sample,
                                          sample_with_logprob, sampling_probs,
                                          top_logprobs, typical_acceptance_sample)
from qspec_tpu_torch.spec_decode.eagle import eagle_cfg_for, eagle_layer_step, fuse_features
from qspec_tpu_torch.spec_decode.medusa import medusa_propose, medusa_propose_tree
from qspec_tpu_torch.spec_decode.medusa_tree import TreeSpec, build_tree
from qspec_tpu_torch.spec_decode.mlp_speculator import mlp_speculator_propose


# the top-n alternatives computed when a request asks for logprobs > 1: the
# JAX package's TOPN; a request's dict holds its first ``logprobs`` of them
TOPN = 20
# compiled grammars whose transition tables a runner keeps on its device
GRAMMAR_TABLES = 32


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
                 cfg, scheme, ring_cap=None, lora_ids=None, input_embeds=None,
                 embeds_rows=None):
    """One prompt-chunk rectangle. token_ids [B, Q]; returns the logits of
    each row's last valid position ([B, V]) and the cache (written in
    place). ``ctx_len`` [B] counts tokens including this chunk; padded tail
    positions write to the null page and are masked out of attention.

    ``ring_cap``: the ring-buffer KV write floor of the windowed draft's
    cache (ModelRunner ring layout): ``block_tables`` wraps with period
    ring_pages, so within one rectangle only the final ``ring_cap``
    positions before each row's ctx_len may be written; older positions
    would alias the same physical pages in a single scatter (undefined write
    order). Their KV is dead anyway: the windowed draft never reads past the
    window, and early-query attention outputs of a prefill are discarded.

    ``lora_ids`` [B]: each row's adapter slot; ``input_embeds`` [B, Q, H]
    with ``embeds_rows`` [B, Q]: the flagged positions' embedding rows
    (prompt embeddings), as ``model_forward`` takes them."""
    page_size = cache.page_size
    Q = token_ids.shape[1]
    valid = positions < ctx_len[:, None]
    if ring_cap is not None:
        valid &= positions >= ctx_len[:, None] - ring_cap
    slot = torch.where(valid, _slot_of(block_tables, positions, page_size),
                       torch.zeros_like(positions, dtype=torch.int64))
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=ctx_len)
    last_idx = (ctx_len - 1 - positions[:, 0]).clamp(0, Q - 1)
    logits, cache = model_forward(params, cfg, token_ids, cache, batch,
                                  scheme=scheme, logits_indices=last_idx, lora_ids=lora_ids,
                                  input_embeds=input_embeds, embeds_rows=embeds_rows)
    return logits[:, 0], cache


def decode_step(params, cache, last_tokens, start_pos, block_tables, st, gen,
                *, cfg, scheme, num_top: int = 0, lora_ids=None):
    """Autoregressive decode: one token per sequence. last_tokens [B] (not
    yet processed), start_pos [B] = their positions. Returns
    (next_tokens [B], logprobs [B], cache); with ``num_top`` > 0 also the
    top-n alternatives (values [B, n], ids [B, n]) before the cache. A
    guided row samples under the grammar state of ``st.grammar_state``: one
    step a call, so the host's per-sequence state (advanced as each token is
    appended) is the state the step starts from."""
    pos = start_pos[:, None]
    slot = _slot_of(block_tables, pos, cache.page_size)
    batch = AttentionBatch(positions=pos, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=start_pos + 1)
    logits, cache = model_forward(params, cfg, last_tokens[:, None], cache,
                                  batch, scheme=scheme, lora_ids=lora_ids)
    next_tokens, lp = sample_with_logprob(logits[:, 0], st, gen)
    if num_top:
        topv, topi = top_logprobs(logits[:, 0], num_top)
        return next_tokens, lp, topv, topi, cache
    return next_tokens, lp, cache


def _grammar_advance_emitted(st, g, toks):
    """Advance grammar states through one round's emitted tokens (toks
    [B, k+1], -1 past the accepted length)."""
    if g is None:
        return None
    for i in range(toks.shape[1]):
        t = toks[:, i]
        g = torch.where(t >= 0, grammar_advance(st, g, t.clamp_min(0)), g)
    return g


def _entry_states(st):
    # the grammar states the rounds carry: None when no row is guided
    return st.grammar_state if st.grammar_next is not None else None


def _draft_impl(params, cache, last_tokens, start_pos, block_tables, st, gen,
                *, cfg, scheme, k, prev_tokens=None, gstate=None, lora_ids=None):
    """k sequential draft forwards; returns (tokens [B, k], probs [B, k, V],
    cache).

    ``prev_tokens`` (the token at ``start_pos - 1``) makes the FIRST step a
    Q=2 pass over [prev, last]. That rewrites the draft-KV slot the previous
    round left stale: the k-th proposal's KV is never written in its own
    round, so a fully accepted round would leave a hole in the draft cache
    that later draft attention reads. Rows at start_pos == 0 send the
    phantom query's KV write to the null page; its output is discarded.

    ``gstate`` [B]: the grammar states at ``start_pos`` (default the
    call-entry states); the backfill's sample and every draft step's are
    masked by the grammar and advance it, so the proposals stay inside it.
    ``lora_ids`` [B]: each row's adapter slot, on every draft forward.
    """
    page_size = cache.page_size
    if gstate is None:
        gstate = _entry_states(st)
    first_k = k
    toks0 = probs0 = None
    if prev_tokens is not None:
        p2 = torch.stack([start_pos - 1, start_pos], dim=1)       # [B, 2]
        write = p2 >= 0
        slot2 = torch.where(write, _slot_of(block_tables, p2.clamp_min(0), page_size),
                            torch.zeros_like(p2, dtype=torch.int64))
        batch = AttentionBatch(positions=p2, slot_mapping=slot2,
                               block_tables=block_tables,
                               ctx_lens=start_pos + 1)
        t2 = torch.stack([prev_tokens, last_tokens], dim=1)
        logits, cache = model_forward(params, cfg, t2, cache, batch, scheme=scheme,
                                      lora_ids=lora_ids)
        probs0 = sampling_probs(logits[:, 1], st, gstate)
        toks0 = sample(logits[:, 1], st, gen, gstate)
        gstate = grammar_advance(st, gstate, toks0)
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
                                      scheme=scheme, lora_ids=lora_ids)
        probs.append(sampling_probs(logits[:, 0], st, gstate))
        tok = sample(logits[:, 0], st, gen, gstate)
        gstate = grammar_advance(st, gstate, tok)
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


def _repeat_rows(st: SamplingTensors, n: int) -> SamplingTensors:
    """Each sequence's knobs for its n scored positions (the [B, V] mask and
    bias are row-repeated by the sampler itself)."""
    return st._replace(temperature=torch.repeat_interleave(st.temperature, n),
                       top_k=torch.repeat_interleave(st.top_k, n),
                       top_p=torch.repeat_interleave(st.top_p, n),
                       min_p=torch.repeat_interleave(st.min_p, n))


def _verify_impl(params, cache, last_tokens, draft_tokens, draft_probs, start_pos,
                 block_tables, st, gen, *, cfg, scheme, return_hidden=False,
                 acceptance="rejection_sampler", gstate=None, lora_ids=None):
    """Score [last, d_1..d_k] in one pass and rejection-sample. ``draft_probs``
    None: deterministic proposals (Medusa), verified by the one-hot rule;
    ``acceptance="typical_acceptance_sampler"``: the lossy typical rule.
    ``return_hidden``: ((result, hidden [B, k+1, H]), cache).

    Under a grammar, position i's target distribution is masked by the state
    reached from ``gstate`` (default the call-entry states) through drafts
    0..i-1; a nulled proposal (-1) advances as token 0, as in the JAX
    package (the position is rejected whatever its state)."""
    B, k = draft_tokens.shape
    tokens = torch.cat([last_tokens[:, None], draft_tokens], dim=1)  # [B, k+1]
    positions = start_pos[:, None] + torch.arange(k + 1, device=start_pos.device)[None, :]
    slot = _slot_of(block_tables, positions, cache.page_size)
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=start_pos + k + 1)
    out = model_forward(params, cfg, tokens, cache, batch, scheme=scheme,
                        return_hidden=return_hidden, lora_ids=lora_ids)
    logits, cache = out[0], out[-1]
    V = logits.shape[-1]
    if gstate is None:
        gstate = _entry_states(st)
    pos_states = None
    if gstate is not None:
        states = [gstate]
        for i in range(k):
            states.append(grammar_advance(st, states[-1], draft_tokens[:, i].clamp_min(0)))
        pos_states = torch.stack(states, dim=1).reshape(B * (k + 1))
    target_probs = sampling_probs(logits.reshape(B * (k + 1), V), _repeat_rows(st, k + 1),
                                  pos_states)
    target_probs = target_probs.reshape(B, k + 1, V)
    if acceptance == "typical_acceptance_sampler":
        result = typical_acceptance_sample(draft_tokens, target_probs)
    elif draft_probs is None:
        result = rejection_sample_onehot(draft_tokens, target_probs, gen)
    else:
        result = rejection_sample(draft_tokens, draft_probs, target_probs, gen)
    if return_hidden:
        return (result, out[1]), cache
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
                     k, num_rounds=1, draft_cfg=None, draft_params=None,
                     force_accept=None, acceptance="rejection_sampler", lora_ids=None):
    """``num_rounds`` full QSpec rounds (k drafts + verify + rejection).

    ``draft_params`` / ``draft_cfg``: a separate draft model's (None: the
    drafts read the target's parameters under ``draft_scheme``; ``draft_cfg``
    may still be the sliding-window variant of the target's cfg,
    SpeculativeConfig.draft_kv_window); ``draft_block_tables`` map the draft
    cache's logical pages (the target's tables when the draft pool shares
    its page ids, ring tables under the windowed draft's ring pool).

    ``force_accept`` (SpeculativeConfig.force_accept_len, timing only): each
    round's accepted length becomes min(force_accept + 1, k + 1) whatever
    the verify decided, and the emitted slots past the real acceptance
    (-1) become token 0; every draft and verify forward still runs.
    ``acceptance``: SpeculativeConfig.acceptance_method. A guided row's
    grammar state is carried across the rounds on the device. ``lora_ids``
    [B]: each row's adapter slot, on the verify and on the shared-weights
    draft (a separate draft model runs none, as in the JAX package).

    ``max_new`` [B] caps the tokens emitted per sequence. ``enable=False``
    nulls every proposal (tokens -> -1, draft probs -> 0, so the recovery
    distribution is exactly the target's) and each round emits exactly one
    autoregressive token through the SAME computation at the SAME shapes:
    the bit-exact AR oracle for the greedy spec == AR invariant.

    Returns (tokens [R, B, k+1] (-1 padded), accepted_len [R, B],
    logprobs [R, B, k+1], (last, prev, pos, budget), draft_cache, cache).
    """
    d_params = params if draft_params is None else draft_params
    d_cfg = cfg if draft_cfg is None else draft_cfg
    d_lora = lora_ids if draft_params is None else None
    last, prev, pos, budget = last_tokens, prev_tokens, start_pos, max_new
    g = _entry_states(st)
    out_t, out_a, out_l = [], [], []
    for _ in range(num_rounds):
        d_toks, d_probs, draft_cache = _draft_impl(
            d_params, draft_cache, last, pos, draft_block_tables, st, gen,
            cfg=d_cfg, scheme=draft_scheme, k=k, prev_tokens=prev, gstate=g, lora_ids=d_lora)
        if not enable:
            d_toks = torch.full_like(d_toks, -1)
            d_probs = torch.zeros_like(d_probs)
        result, cache = _verify_impl(params, cache, last, d_toks, d_probs, pos,
                                     block_tables, st, gen, cfg=cfg,
                                     scheme=verify_scheme, acceptance=acceptance, gstate=g,
                                     lora_ids=lora_ids)
        if force_accept is not None:
            result = result._replace(
                accepted_len=torch.full_like(result.accepted_len, min(force_accept + 1, k + 1)),
                tokens=result.tokens.clamp_min(0))
        # advance: the next input is the last emitted token, position += acc
        acc, toks, lps, new_last = _advance(result, budget, last, k)
        # predecessor (at the new position - 1) for the next draft's backfill:
        # emitted[acc-2] when >= 2 tokens were emitted, else this round's last
        idx2 = (acc - 2).clamp_min(0).to(torch.int64)[:, None]
        cand = result.tokens.gather(1, idx2)[:, 0]
        new_prev = torch.where(acc >= 2, cand, last)
        prev = torch.where(budget > 0, new_prev, prev)
        last = new_last
        pos = pos + acc
        budget = budget - acc
        g = _grammar_advance_emitted(st, g, toks)
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l),
            (last, prev, pos, budget), draft_cache, cache)


def _advance(result, budget, last, k: int):
    """A verified round's emitted rectangle and advance: ``acc`` [B] tokens
    emitted (at least 1 while the budget lasts, 0 after), the tokens and
    logprobs -1 / 0 past it, and the next input token (the last emitted)."""
    active = budget > 0
    acc = torch.minimum(result.accepted_len, budget.clamp_min(0))
    acc = torch.where(active, acc.clamp_min(1), torch.zeros_like(acc))
    live = torch.arange(k + 1, device=last.device)[None, :] < acc[:, None]
    toks = torch.where(live, result.tokens, torch.full_like(result.tokens, -1))
    lps = torch.where(live, result.token_logprobs, torch.zeros_like(result.token_logprobs))
    idx = (acc - 1).clamp_min(0).to(torch.int64)[:, None]
    new_last = torch.where(active, result.tokens.gather(1, idx)[:, 0], last)
    return acc, toks, lps, new_last


def ngram_rounds_step(params, cache, history, hist_rows, hist_len, last_tokens,
                      start_pos, block_tables, max_new, enable: bool, st, gen, *,
                      cfg, scheme, k, num_rounds=1, nmin=1, nmax=4):
    """``num_rounds`` prompt-lookup rounds (``qspec_tpu/engine/model_runner.py::
    ngram_rounds_step``): each matches its sequence's row of ``history``
    (ops/ngram.py), verifies the k proposals under the one-hot rule in one
    pass and appends the emitted tokens to the row. No draft forward runs
    and nothing is read back to the host.

    ``history`` [rows, Hmax + 1] int32, updated in place: one row per
    sequence, tokens 0..hist_len-1 valid, the last column a trash slot that
    takes the writes of unemitted slots; ``hist_rows`` [B] the batch's rows
    (padded lanes share a scratch row, and append nothing: their budget is 0).
    ``enable=False`` nulls every proposal: each round emits exactly the AR
    token through the same computation at the same shapes (the oracle,
    ``method="null"``).

    Returns (tokens [R, B, k+1] (-1 padded), accepted [R, B], logprobs
    [R, B, k+1], (last, pos, hist_len, budget), cache).
    """
    rows = hist_rows.to(torch.int64)
    trash = history.shape[1] - 1
    last, pos, hlen, budget = last_tokens, start_pos, hist_len, max_new
    slots = torch.arange(k + 1, device=last.device)[None, :]
    g = _entry_states(st)
    out_t, out_a, out_l = [], [], []
    for _ in range(num_rounds):
        props = ngram_match_device(history[rows, :trash], hlen, k=k, nmin=nmin, nmax=nmax)
        if not enable:
            props = torch.full_like(props, -1)
        result, cache = _verify_impl(params, cache, last, props, None, pos, block_tables,
                                     st, gen, cfg=cfg, scheme=scheme, gstate=g)
        acc, toks, lps, last = _advance(result, budget, last, k)
        # append the emitted tokens to each row; the slots past a round's
        # tokens (and past the bank's end) go to the trash column
        cols = hlen.to(torch.int64)[:, None] + slots
        cols = torch.where((slots < acc[:, None]) & (cols < trash), cols, trash)
        history.index_put_((rows[:, None].expand_as(cols), cols), toks.to(history.dtype))
        pos, hlen, budget = pos + acc, hlen + acc, budget - acc
        g = _grammar_advance_emitted(st, g, toks)
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l),
            (last, pos, hlen, budget), cache)


def medusa_rounds_step(params, cache, props, prop_rows, last_tokens, start_pos,
                       block_tables, max_new, enable: bool, st, gen, *, cfg, scheme,
                       k, num_rounds=1, net="medusa"):
    """``num_rounds`` Medusa or MLPSpeculator rounds (the single top-1
    chain): each verifies the k proposals of its sequence's row of ``props``
    under the one-hot rule, and the proposer ``params[net]`` then reads the
    verify pass's hidden state at the last emitted token (index acc - 1: its
    head output is that token, so head j proposes the token j + 1 past the
    next one) and writes the next round's proposals into the row: the
    Medusa heads (``net="medusa"``) from the hidden state alone, the
    MLPSpeculator chain (``net="mlp_spec"``) also from the last emitted
    token. No draft forward runs.

    ``props`` [rows, K] int32, updated in place: one row per sequence
    (-1 = no proposal yet: the round then emits one AR token and seeds the
    heads); ``prop_rows`` [B] the rows of the batch (padded lanes share a
    scratch row). ``enable=False`` nulls every proposal: each round emits
    exactly the AR token through the same computation (the oracle).

    Returns (tokens [R, B, k+1] (-1 padded), accepted [R, B], logprobs
    [R, B, k+1], (last, pos, budget), cache).
    """
    rows = prop_rows.to(torch.int64)
    last, pos, budget = last_tokens, start_pos, max_new
    g = _entry_states(st)
    out_t, out_a, out_l = [], [], []
    for _ in range(num_rounds):
        p_b = props[rows][:, :k]
        if not enable:
            p_b = torch.full_like(p_b, -1)
        (result, hidden), cache = _verify_impl(params, cache, last, p_b, None, pos,
                                               block_tables, st, gen, cfg=cfg,
                                               scheme=scheme, return_hidden=True, gstate=g)
        acc, toks, lps, new_last = _advance(result, budget, last, k)
        idx = (acc - 1).clamp_min(0).to(torch.int64)[:, None]
        h_star = hidden.gather(1, idx[:, :, None].expand(-1, 1, hidden.shape[-1]))[:, 0]
        if net == "mlp_spec":
            new_p = mlp_speculator_propose(params["mlp_spec"], h_star, new_last)  # [B, K]
        else:
            new_p = medusa_propose(params["medusa"], h_star)
        props[rows] = torch.where((budget > 0)[:, None], new_p, props[rows])
        last, pos, budget = new_last, pos + acc, budget - acc
        g = _grammar_advance_emitted(st, g, toks)
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l),
            (last, pos, budget), cache)


@dataclasses.dataclass(frozen=True, eq=False)
class TreeTensors:
    """A Medusa tree's static data on the runner's device, made once per
    runner (:func:`tree_tensors`): the attention's mask (prefix = depth + 1
    rows), each node's depth [T], and per depth level the level's nodes and
    their parents + 1 (0 = the root), which the acceptance walk indexes."""
    spec: TreeSpec
    mask: TreeMask
    depth: torch.Tensor
    levels: tuple


def tree_tensors(tspec: TreeSpec, device) -> TreeTensors:
    levels = []
    for d in range(1, tspec.max_depth + 1):
        nodes = [i for i in range(tspec.num_nodes) if tspec.depth[i] == d]
        levels.append((torch.tensor(nodes, device=device),
                       torch.tensor([tspec.parent[i] + 1 for i in nodes], device=device)))
    return TreeTensors(tspec, tree_mask(tspec.max_depth + 1, tspec.ancestors, device),
                       torch.tensor(tspec.depth, device=device), tuple(levels))


def _verify_tree_impl(params, cache, recent_tokens, tree_tokens, start_pos,
                      block_tables, st, gen, *, cfg, scheme, tree: TreeTensors):
    """One Medusa tree verify pass over the rectangle [prefix | tree].

    ``recent_tokens`` [B, prefix]: the last committed tokens, the rightmost
    at ``start_pos`` (the root). Scoring them again gives the root its
    logits and rewrites their KV slots, which the previous round's accepted
    tokens left holding tree-slot KV. Tree node i carries token
    ``tree_tokens[:, i]`` at rope position start_pos + depth(i) and KV slot
    start_pos + 1 + i; it attends the context up to the root and its
    ancestors (the tree mask). Prefix rows before position 0 (a prompt
    shorter than the prefix) write to the null page; their outputs are not
    read.

    Returns (sampled [B, 1+T], logprobs [B, 1+T], hidden [B, 1+T, H],
    cache): the target's sample (greedy: argmax) at the root and at every
    node, each distributed as the target given that node's path.
    """
    B, prefix = recent_tokens.shape
    T = tree.spec.num_nodes
    dev = start_pos.device
    depth = tree.depth
    tokens = torch.cat([recent_tokens, tree_tokens], dim=1)
    prefix_pos = start_pos[:, None] - (prefix - 1) + torch.arange(prefix, device=dev)[None, :]
    tree_slot = start_pos[:, None] + 1 + torch.arange(T, device=dev)[None, :]
    positions = torch.cat([prefix_pos.clamp_min(0), start_pos[:, None] + depth[None]], 1)
    slot_idx = torch.cat([prefix_pos.clamp_min(0), tree_slot], 1)
    slot = _slot_of(block_tables, slot_idx, cache.page_size)
    write = torch.cat([prefix_pos >= 0, torch.ones_like(tree_slot, dtype=torch.bool)], 1)
    slot = torch.where(write, slot, torch.zeros_like(slot))
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=start_pos + 1 + T)
    logits, hidden, cache = model_forward(params, cfg, tokens, cache, batch,
                                          scheme=scheme, return_hidden=True,
                                          tree=tree.mask)
    n = T + 1
    lg = logits[:, prefix - 1:]                                       # [B, 1+T, V]
    # the tree does not compose with guided decoding (LLMEngine refuses it)
    samp, lp = sample_with_logprob(lg.reshape(B * n, lg.shape[-1]),
                                   _repeat_rows(st, n)._replace(grammar_next=None), gen)
    return samp.reshape(B, n), lp.reshape(B, n), hidden[:, prefix - 1:], cache


def medusa_tree_rounds_step(params, cache, props, recent_bank, prop_rows, start_pos,
                            block_tables, max_new, enable: bool, st, gen, *, cfg,
                            scheme, tree: TreeTensors, num_rounds=1):
    """``num_rounds`` Medusa tree rounds. Each verifies its sequence's tree
    of proposals (``props`` row, [T]) in one rectangle and walks it: from
    the root, the target's sampled token either equals the proposal of a
    child of the current node (the walk descends into the first such child
    and emits the token) or ends the round as the bonus / recovery token.
    The heads then read the hidden state at the last accepted node and
    propose the next tree. Greedy output equals AR's; ``enable=False``
    nulls the proposals, so each round emits exactly the root's sample (the
    oracle). The walk is tensor operations over the static tree (no host
    read inside a round).

    ``props`` [rows, T] and ``recent_bank`` [rows, D+1] (each sequence's
    last D+1 committed tokens, the verify prefix) are updated in place;
    ``prop_rows`` [B] (padded lanes share a scratch row).

    Returns (tokens [R, B, D+1] (-1 padded), accepted [R, B], logprobs,
    (pos, budget), cache).
    """
    D = tree.spec.max_depth
    prefix = recent_bank.shape[1]
    rows = prop_rows.to(torch.int64)
    pos, budget = start_pos, max_new
    dev = pos.device
    slots = torch.arange(D + 1, device=dev)[None, :]
    roll = torch.arange(prefix, device=dev)[None, :]
    out_t, out_a, out_l = [], [], []
    for _ in range(num_rounds):
        recent = recent_bank[rows]                                    # [B, prefix]
        p_b = props[rows]                                             # [B, T]
        if not enable:
            p_b = torch.full_like(p_b, -1)
        t_samp, t_lp, hid, cache = _verify_tree_impl(
            params, cache, recent, p_b, pos, block_tables, st, gen, cfg=cfg,
            scheme=scheme, tree=tree)
        # the walk: cur = the last accepted node (0 = root, i + 1 = node i)
        cur = torch.zeros_like(pos, dtype=torch.int64)
        alive = torch.ones_like(pos, dtype=torch.bool)
        e = t_samp[:, 0]
        emitted, lps_l = [e], [t_lp[:, 0]]
        acc = torch.ones_like(pos)
        for nodes, parents in tree.levels:
            cand = p_b[:, nodes]                                      # [B, n]
            m = (alive[:, None] & (cur[:, None] == parents[None]) & (cand == e[:, None])
                 & (cand >= 0))
            alive = alive & m.any(dim=1)
            cur = torch.where(alive, nodes[m.to(torch.int32).argmax(dim=1)] + 1, cur)
            e_next = t_samp.gather(1, cur[:, None])[:, 0]
            lp_next = t_lp.gather(1, cur[:, None])[:, 0]
            e = torch.where(alive, e_next, e)
            emitted.append(torch.where(alive, e_next, torch.full_like(e_next, -1)))
            lps_l.append(torch.where(alive, lp_next, torch.zeros_like(lp_next)))
            acc = acc + alive.to(acc.dtype)
        active = budget > 0
        acc = torch.minimum(acc, budget.clamp_min(0))
        acc = torch.where(active, acc.clamp_min(1), torch.zeros_like(acc))
        live = slots < acc[:, None]
        toks = torch.where(live, torch.stack(emitted, 1), -1)
        lps = torch.where(live, torch.stack(lps_l, 1), 0.0)
        # roll the recent window forward by acc
        combined = torch.cat([recent, toks.clamp_min(0).to(recent.dtype)], 1)
        new_recent = combined.gather(1, acc.to(torch.int64)[:, None] + roll)
        recent_bank[rows] = torch.where(active[:, None], new_recent, recent)
        # the next tree from the hidden state at the last accepted node
        h_star = hid.gather(1, cur[:, None, None].expand(-1, 1, hid.shape[-1]))[:, 0]
        new_p = medusa_propose_tree(params["medusa"], h_star, tree.spec)
        props[rows] = torch.where(active[:, None], new_p, p_b)
        pos, budget = pos + acc, budget - acc
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l), (pos, budget),
            cache)


def prefill_eagle_step(params, cache, draft_cache, token_ids, shifted_tokens, feat_len,
                       positions, block_tables, ctx_len, *, cfg, ecfg, scheme):
    """A target prompt chunk (``prefill_step``) that also streams the
    chunk's features through the EAGLE layer into the draft cache.

    ``shifted_tokens`` [B, Q] holds x_{p+1} for each position p of the
    chunk; ``feat_len`` [B] counts the valid features (the chunk's length,
    or one less on a prompt's final chunk, whose last feature pairs with the
    token yet to be sampled: the decode rounds' span covers it). Returns
    (logits of each row's last position [B, V], the hidden state there
    [B, H], cache, draft_cache)."""
    page_size = cache.page_size
    Q = token_ids.shape[1]
    valid = positions < ctx_len[:, None]
    slot = torch.where(valid, _slot_of(block_tables, positions, page_size),
                       torch.zeros_like(positions, dtype=torch.int64))
    batch = AttentionBatch(positions=positions, slot_mapping=slot,
                           block_tables=block_tables, ctx_lens=ctx_len)
    last_idx = (ctx_len - 1 - positions[:, 0]).clamp(0, Q - 1)
    logits, hidden, cache = model_forward(params, cfg, token_ids, cache, batch, scheme=scheme,
                                          logits_indices=last_idx, return_hidden="all")
    feats = fuse_features(params["eagle"], embed_rows(params, cfg, shifted_tokens), hidden)
    start = positions[:, 0]
    fvalid = positions < (start + feat_len)[:, None]
    fbatch = AttentionBatch(positions=positions,
                            slot_mapping=torch.where(fvalid, slot, torch.zeros_like(slot)),
                            block_tables=block_tables, ctx_lens=start + feat_len)
    _, draft_cache = eagle_layer_step(params["eagle"], ecfg, draft_cache, feats, fbatch)
    idx = last_idx.to(torch.int64)[:, None, None].expand(-1, 1, hidden.shape[-1])
    return logits[:, 0], hidden.gather(1, idx)[:, 0], cache, draft_cache


def eagle_rounds_step(params, draft_cache, cache, espan_h, espan_t, espan_pos, espan_len,
                      rows, block_tables, max_new, st, gen, *, cfg, ecfg, scheme, k,
                      num_rounds=1):
    """``num_rounds`` EAGLE rounds over the span bank.

    The bank holds, per sequence row, the previous round's accepted
    positions with their true hidden states: ``espan_h`` [rows, k+1, H]
    bf16, the paired tokens ``espan_t`` [rows, k+1] (t[i] is the token at
    position espan_pos + i + 1), ``espan_pos`` and ``espan_len`` [rows];
    ``rows`` [B] maps each lane to its row (padded lanes share a scratch
    row). The bank is updated in place. Each round (1) re-feeds the span
    through the draft layer, overwriting the KV the previous round's
    drafting wrote there (the EAGLE rollback), and takes the prediction at
    its last position; (2) drafts k tokens, each the argmax of the target's
    head on the predicted hidden state, feeding each back with that hidden
    state; (3) verifies them under the one-hot rule (greedy output is AR's
    for any net); (4) makes the verify pass's hidden states and emitted
    tokens the next span.

    Returns (tokens [R, B, k+1] (-1 padded), accepted [R, B], logprobs
    [R, B, k+1], budget, draft_cache, cache).
    """
    page_size = cache.page_size
    eagle, lm_head = params["eagle"], params["lm_head"]
    rows = rows.to(torch.int64)
    h_span, t_span = espan_h[rows], espan_t[rows]
    span_pos, span_len = espan_pos[rows], espan_len[rows]
    budget = max_new
    dev = budget.device
    span_w = k + 1
    H = h_span.shape[-1]
    g = _entry_states(st)
    out_t, out_a, out_l = [], [], []
    for _ in range(num_rounds):
        pos = span_pos + span_len               # the position of the pending last token
        at_last = (span_len - 1).clamp_min(0).to(torch.int64)[:, None]
        last = t_span.gather(1, at_last)[:, 0]
        # (1) the span, with its true hidden states
        feats = fuse_features(eagle, embed_rows(params, cfg, t_span), h_span)
        fpos = span_pos[:, None] + torch.arange(span_w, device=dev)[None, :]
        fvalid = torch.arange(span_w, device=dev)[None, :] < span_len[:, None]
        fslot = torch.where(fvalid, _slot_of(block_tables, fpos, page_size),
                            torch.zeros_like(fpos, dtype=torch.int64))
        a, draft_cache = eagle_layer_step(eagle, ecfg, draft_cache, feats, AttentionBatch(
            positions=fpos, slot_mapping=fslot, block_tables=block_tables, ctx_lens=pos))
        h_hat = a.gather(1, at_last[:, :, None].expand(-1, 1, H))[:, 0]
        # (2) k drafts on predicted hidden states (top-1)
        props = []
        for j in range(k):
            d = compute_logits(h_hat, lm_head, cfg.vocab_size).argmax(dim=-1)  # @ pos+1+j
            d = d.to(torch.int32)
            props.append(d)
            fp = (pos + j)[:, None]
            f = fuse_features(eagle, embed_rows(params, cfg, d[:, None]), h_hat[:, None])
            a1, draft_cache = eagle_layer_step(eagle, ecfg, draft_cache, f, AttentionBatch(
                positions=fp, slot_mapping=_slot_of(block_tables, fp, page_size),
                block_tables=block_tables, ctx_lens=pos + j + 1))
            h_hat = a1[:, 0]
        # (3) verify under the one-hot rule
        (result, hidden), cache = _verify_impl(params, cache, last, torch.stack(props, 1),
                                               None, pos, block_tables, st, gen, cfg=cfg,
                                               scheme=scheme, return_hidden=True, gstate=g)
        acc, toks, lps, _ = _advance(result, budget, last, k)
        # (4) the next span: the true hidden states at pos .. pos + k paired
        # with the emitted tokens
        active = budget > 0
        h_span = torch.where(active[:, None, None], hidden.to(h_span.dtype), h_span)
        t_span = torch.where(active[:, None], result.tokens.clamp_min(0).to(t_span.dtype),
                             t_span)
        span_pos = torch.where(active, pos, span_pos)
        span_len = torch.where(active, acc.to(span_len.dtype), span_len)
        budget = budget - acc
        g = _grammar_advance_emitted(st, g, toks)
        out_t.append(toks)
        out_a.append(acc)
        out_l.append(lps)
    espan_h[rows], espan_t[rows] = h_span, t_span
    espan_pos[rows], espan_len[rows] = span_pos, span_len
    return (torch.stack(out_t), torch.stack(out_a), torch.stack(out_l), budget,
            draft_cache, cache)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


class RowBank:
    """Which row of a per-sequence device bank each sequence holds. The bank
    has one row per decode-batch slot plus a last row, the scratch row that
    padded batch lanes read and write, never assigned. ``synced`` keeps, per
    sequence, what the host last knew its row to hold; it goes with the row."""

    def __init__(self, rows: int):
        self.scratch = rows - 1
        self.slot: dict = {}
        self.synced: dict = {}

    def assign(self, sid, live_ids) -> tuple:
        """(row, new): the sequence's row, a fresh one if it held none. When
        every row is taken, a sequence outside the batch gives its row up."""
        if sid in self.slot:
            return self.slot[sid], False
        used = set(self.slot.values())
        row = next((r for r in range(self.scratch) if r not in used), None)
        if row is None:
            victim = next(s for s in self.slot if s not in live_ids)
            row = self.slot.pop(victim)
            self.synced.pop(victim, None)
        self.slot[sid] = row
        return row, True

    def free(self, sid) -> None:
        self.slot.pop(sid, None)
        self.synced.pop(sid, None)


def draft_window(config: EngineConfig) -> Optional[int]:
    """The windowed draft's window: SpeculativeConfig.draft_kv_window, capped
    by the model's own sliding window; None without a draft window, and
    with a separate draft model (which keeps a full pool of its own, as in
    the JAX package)."""
    spec = config.speculative
    if spec is None or spec.draft_kv_window is None or spec.draft_model is not None:
        return None
    w = spec.draft_kv_window
    if config.model.sliding_window is not None:
        w = min(w, config.model.sliding_window)
    return w


def ring_pages(config: EngineConfig) -> int:
    """Pages per sequence of the windowed draft's ring pool, 0 when the
    draft keeps a full pool (no window, or QSPEC_RING_DRAFT=0, the JAX
    package's switch). The draft reads the last ``window`` positions and
    writes at most k + 1 ahead; the +2 pages cover a span straddling page
    boundaries and the window's off-by-ones."""
    w = draft_window(config)
    if w is None or not envs.QSPEC_RING_DRAFT:
        return 0
    k = config.speculative.num_speculative_tokens
    return -(-(w + k + 1) // config.cache.page_size) + 2


def ring_rows(config: EngineConfig) -> int:
    """Rows of the ring pool: one per decode-batch slot plus a scratch row
    for padded batch lanes."""
    return max(config.scheduler.decode_batch_buckets) + 1


def _check_draft_model(dc, cfg, draft_params) -> None:
    """Raise for a separate draft model the runner cannot serve beside the
    target ``cfg`` (the JAX package's checks, made at construction)."""
    if draft_params is None:
        raise ValueError("speculative.draft_model set but no draft_params passed to "
                         "the engine")
    if dc.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft and target must share a vocabulary (rejection "
                         f"sampling): draft vocab {dc.vocab_size}, target {cfg.vocab_size}")
    check_served(dc)
    if dc.quant not in ("w4", "none"):
        raise ValueError(f"a separate draft model of quant={dc.quant!r}: a 'w4' draft "
                         "runs draft_scheme and a float ('none') one the bf16 scheme")


def _check_eagle(cfg, params) -> None:
    """Raise for an EAGLE configuration the runner cannot serve."""
    if "eagle" not in params:
        raise ValueError("speculative.method='eagle' but params carry no 'eagle' draft "
                         "net (load it with spec_decode.eagle.load_eagle)")
    if cfg.arch != "llama" or cfg.quant not in ("w4", "w4g", "w8", "none"):
        raise NotImplementedError(
            f"EAGLE on an {cfg.arch} quant={cfg.quant!r} target is not ported (ROADMAP "
            "queue 1 item 7): its draft layer serves Llama targets, QuaRot (quant='w4'), "
            "weight-only int4 / int8 / fp8 (AWQ, GPTQ, compressed-tensors, GGUF Q4_0: "
            "'w4g', 'w8') or bf16 ('none')")


class ModelRunner:
    """Owns params + paged caches and runs bucketed steps on one device.

    The draft keeps its own KV (computed under the draft scheme). Without a
    draft window it is a second pool with the target's page ids; a separate
    draft model's pool has the draft's geometry (layers, KV heads, head dim)
    over the same page ids and tables, and its forwards read
    ``draft_params``. Under
    ``draft_kv_window`` it is a RING pool (MagicDec): each sequence holds a
    row of R = :func:`ring_pages` pages, and the ring block table maps
    logical page lp -> 1 + row * R + lp % R, so the steps are unchanged: the
    indirection lives in the table. Page 0 stays the null page.

    Medusa keeps its state in device tensors of one row per decode-batch
    slot plus a scratch row that padded batch lanes read and write: the
    proposals ``_mprops`` ([rows, K] for the chain, [rows, T] for a tree)
    and, for a tree, ``_mrecent`` [rows, D+1], the verify prefix, written
    from the host when a sequence takes a row or when its tokens moved on
    without the rounds, and rolled forward on the device by the rounds.
    MLPSpeculator keeps the chain's proposals the same way.

    EAGLE's draft cache is a pool of the one-layer draft net's geometry
    (``eagle_cfg_for``) over the target's page ids and tables, and its span
    bank (``_espan_h`` [rows, k+1, H], ``_espan_t``, ``_espan_pos``,
    ``_espan_len``) has the same rows; a row is written from the host (the
    sequence's ``eagle_span`` seed) when a sequence takes it or when its
    tokens moved on without the rounds.
    """

    def __init__(self, config: EngineConfig, params, num_pages: int,
                 need_draft_cache: bool = False, device="cuda", seed: int = 0,
                 draft_params=None):
        self.config = config
        self.cfg = config.model
        self.params = params
        self.device = resolve_device(device)
        page_size = config.cache.page_size
        spec = config.speculative
        self._medusa = spec is not None and spec.method in ("medusa", "medusa_null",
                                                            "mlp_speculator")
        self._ngram = spec is not None and spec.method in ("ngram", "null")
        self._eagle = spec is not None and spec.method == "eagle"
        sep_draft = spec is not None and spec.draft_model is not None
        if (self._medusa or self._eagle) and self.cfg.num_experts:
            raise NotImplementedError(
                f"{spec.method} on a mixture-of-experts target is not ported (ROADMAP "
                "queue 1 item 9): its proposers serve dense targets; QSpec, the "
                "separate draft model and n-gram serve an MoE")
        if (self._medusa or self._eagle) and self.cfg.attention_type == "mla":
            raise NotImplementedError(
                f"{spec.method} on a multi-head latent attention target (DeepSeek-V2 / V3, "
                "MiniCPM3) is not ported: its proposers serve dense MHA targets (the "
                "Medusa tree mask never reaches _mla_attention's attention); n-gram "
                "serves MLA")
        if draft_params is not None and not sep_draft:
            raise ValueError("draft_params passed without speculative.draft_model, "
                             "the draft's ModelConfig")
        self.draft_params = draft_params
        if sep_draft:
            _check_draft_model(spec.draft_model, self.cfg, draft_params)
        elif self._eagle:
            _check_eagle(self.cfg, params)
        elif spec is not None and not (self._medusa or self._ngram):
            if self.cfg.quant == "none":
                raise ValueError("a bf16 (quant='none') checkpoint has no int4 "
                                 "weights, so QSpec's shared-weights draft cannot "
                                 "run on it; use method='ngram' or 'medusa'")
            if self.cfg.quant in ("w4g", "w8") and spec.draft_scheme != "w4a16":
                raise ValueError(
                    "AWQ/GPTQ/compressed-tensors (w4g/w8) checkpoints have no QuaRot "
                    "rotations, so the shared-weights w4a4/w4a8 draft scheme is "
                    "unavailable; use draft_scheme='w4a16' (with draft_kv_window)")
        kv_cfg = kvc.KVCacheConfig(
            num_layers=self.cfg.num_layers, num_kv_heads=self.cfg.cache_kv_heads,
            head_dim=self.cfg.cache_head_dim, num_pages=num_pages,
            page_size=page_size, dtype=config.cache.kv_cache_dtype)
        self.cache = kvc.allocate(kv_cfg, self.device)
        window = draft_window(config)
        # the windowed draft: same params, attention (and prompt prefill)
        # under a sliding window
        self.draft_cfg = (spec.draft_model if sep_draft else eagle_cfg_for(self.cfg)
                          if self._eagle else self.cfg if window is None else
                          dataclasses.replace(self.cfg, sliding_window=window,
                                              sliding_window_pattern=1))
        self.page_size = page_size
        self.max_pages_per_seq = -(-config.scheduler.max_model_len // page_size)
        self._ring_pages = ring_pages(config) if need_draft_cache else 0
        self._ring_rows = ring_rows(config) if self._ring_pages else 0
        self._ring = RowBank(self._ring_rows)
        if self._ring_pages:
            # wrap pattern of every table row: 1 + ring_row * R + lp % R
            self._ring_base = np.arange(self.max_pages_per_seq,
                                        dtype=np.int32) % self._ring_pages
            kv_cfg = kv_cfg._replace(num_pages=self._ring_rows * self._ring_pages + 1)
        if sep_draft or self._eagle:
            # a pool of the draft's own geometry over the same page ids
            kv_cfg = kv_cfg._replace(num_layers=self.draft_cfg.num_layers,
                                     num_kv_heads=self.draft_cfg.cache_kv_heads,
                                     head_dim=self.draft_cfg.cache_head_dim)
        self.draft_cache = (kvc.allocate(kv_cfg, self.device)
                            if need_draft_cache or self._eagle else None)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.k = spec.num_speculative_tokens if spec else 1
        self.draft_scheme = spec.draft_scheme if spec else "w4a4"
        if sep_draft and self.draft_cfg.quant == "none":
            # a float draft model runs the bf16 scheme
            self.draft_scheme = "bf16"
        self.force_accept = spec.force_accept_len if spec else None
        self.acceptance = spec.acceptance_method if spec else "rejection_sampler"
        # the grammars' transition tables on the device (grammar_table)
        self._gtables: dict = {}
        # the target's scheme: bf16 for a float checkpoint, else W4A16 (a
        # w8 checkpoint's W8A16 GEMM runs in W4A16's slot)
        self.verify_scheme = "bf16" if self.cfg.quant == "none" else "w4a16"
        # verify passes run by run_medusa_rounds / run_ngram_rounds /
        # run_eagle_rounds, every forward of the target (prompt chunks,
        # decode steps, verify passes) and every forward into the draft
        # cache (prompt chunks, draft steps; EAGLE: each pass of its layer)
        self.spec_rounds_run = 0
        self.target_forwards = 0
        self.draft_forwards = 0
        # the Medusa and n-gram banks: one row per decode-batch slot plus
        # the scratch row
        rows = max(config.scheduler.decode_batch_buckets) + 1
        self._mprops = self._mtree = self._mrecent = None
        self._mbank = RowBank(rows)
        if self._medusa:
            self._init_medusa(spec, params, rows)
        # the n-gram rounds' token history, a row long enough for a whole
        # sequence and one call's rounds
        self._hist = None
        self._hbank = RowBank(rows)
        if self._ngram:
            hmax = (config.scheduler.max_model_len
                    + (self.k + 1) * max(spec.rounds_per_step, 1) + 8)
            self._hist = torch.zeros((rows, hmax + 1), dtype=torch.int32,
                                     device=self.device)
        # EAGLE's span bank
        self._ebank = RowBank(rows)
        if self._eagle:
            H = self.cfg.hidden_size
            self._espan_h = torch.zeros((rows, self.k + 1, H), dtype=torch.bfloat16,
                                        device=self.device)
            self._espan_t = torch.zeros((rows, self.k + 1), dtype=torch.int32,
                                        device=self.device)
            self._espan_pos = torch.zeros(rows, dtype=torch.int32, device=self.device)
            self._espan_len = torch.zeros(rows, dtype=torch.int32, device=self.device)

    def _init_medusa(self, spec, params, rows: int) -> None:
        # the proposer net: MLPSpeculator's for its method, Medusa's heads
        # for "medusa"; the oracle ("medusa_null") runs either, Medusa's
        # where params carry both
        net = {"mlp_speculator": "mlp_spec", "medusa": "medusa"}.get(
            spec.method, "mlp_spec" if "mlp_spec" in params and "medusa" not in params
            else "medusa")
        if net not in params:
            loader = ("spec_decode.mlp_speculator.load_mlp_speculator" if net == "mlp_spec"
                      else "spec_decode.medusa.load_medusa")
            raise ValueError(f"speculative.method={spec.method!r} but params carry no "
                             f"{net!r} net (load it with {loader})")
        self._mnet = net
        n_heads = int(params[net]["head"].shape[0])
        if self.k > n_heads:
            raise ValueError(f"num_speculative_tokens={self.k} exceeds the {n_heads} "
                             "trained proposer heads")
        if spec.medusa_tree is None:
            self._mprops = torch.full((rows, n_heads), -1, dtype=torch.int32,
                                      device=self.device)
            return
        if net != "medusa":
            raise ValueError("a Medusa tree (medusa_tree) needs Medusa heads "
                             "(params['medusa']); MLPSpeculator serves the chain")
        tspec = build_tree(spec.medusa_tree)
        if tspec.max_depth > n_heads:
            raise ValueError(f"medusa_tree depth {tspec.max_depth} exceeds the "
                             f"{n_heads} trained proposer heads")
        self._mtree = tree_tensors(tspec, self.device)
        self._mprops = torch.full((rows, tspec.num_nodes), -1, dtype=torch.int32,
                                  device=self.device)
        self._mrecent = torch.zeros((rows, tspec.max_depth + 1), dtype=torch.int32,
                                    device=self.device)

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

    def _lora_ids(self, seqs, bucket: int, draft: bool = False) -> Optional[torch.Tensor]:
        """[bucket] adapter slots, or None when no row has an adapter (or
        for a separate draft model's forwards, which run none)."""
        if (draft and self.draft_params is not None) or "lora" not in self.params \
                or not any(s.lora_id for s in seqs):
            return None
        ids = np.zeros(bucket, np.int32)
        ids[:len(seqs)] = [s.lora_id for s in seqs]
        return self._t(ids)

    def _pad_block_tables(self, tables: list) -> torch.Tensor:
        out = np.zeros((len(tables), self.max_pages_per_seq), np.int32)
        for i, t in enumerate(tables):
            n = min(len(t), self.max_pages_per_seq)
            out[i, :n] = t[:n]
        return self._t(out)

    def grammar_table(self, fsm) -> torch.Tensor:
        """A compiled TokenFSM's transition table [S, V] int32 on the device,
        copied there once per grammar (the last GRAMMAR_TABLES used are
        kept; the GrammarCompiler hands out one object a grammar). A
        vocabulary shorter than the model's (a tokenizer's against a padded
        embedding) bans the ids past its end."""
        key = id(fsm)
        hit = self._gtables.pop(key, None)
        if hit is None or hit[0] is not fsm:
            ns = fsm.next_state
            V = self.cfg.vocab_size
            if ns.shape[1] > V:
                raise ValueError(f"the grammar's vocabulary has {ns.shape[1]} tokens, the "
                                 f"model {V}")
            table = torch.full((ns.shape[0], V), -1, dtype=torch.int32, device=self.device)
            table[:, :ns.shape[1]] = torch.as_tensor(ns, dtype=torch.int32, device=self.device)
            hit = (fsm, table)
        self._gtables[key] = hit           # most recently used last
        while len(self._gtables) > GRAMMAR_TABLES:
            self._gtables.pop(next(iter(self._gtables)))
        return hit[1]

    def stack_grammars(self, fsms) -> torch.Tensor:
        """The batch's distinct grammars stacked on the device, [G, S, V]
        int32, the state axis padded with -1 to the largest automaton (a
        copy on the device; a single grammar is its resident table)."""
        tables = [self.grammar_table(f) for f in fsms]
        if len(tables) == 1:
            return tables[0][None]
        out = torch.full((len(tables), max(t.shape[0] for t in tables), tables[0].shape[1]),
                         -1, dtype=torch.int32, device=self.device)
        for i, t in enumerate(tables):
            out[i, :t.shape[0]] = t
        return out

    def sampling_tensors(self, st: SamplingTensors, n: int, bucket: int) -> SamplingTensors:
        """Pad host (numpy) sampling knobs to the bucket and move them to the
        device (``grammar_next`` is there already: ``stack_grammars``);
        padded lanes are unguided."""
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
        gnext = gidx = gstate = None
        if st.grammar_next is not None:
            gnext = st.grammar_next
            gidx = pad(st.grammar_idx, -1, np.int32)
            gstate = pad(st.grammar_state, 0, np.int32)
        return SamplingTensors(
            temperature=pad(st.temperature, 0.0, np.float32),
            top_k=pad(st.top_k, 0, np.int32),
            top_p=pad(st.top_p, 1.0, np.float32),
            min_p=pad(st.min_p, 0.0, np.float32),
            vocab_mask=mask, logit_bias=bias, needs_filter=st.needs_filter,
            grammar_next=gnext, grammar_idx=gidx, grammar_state=gstate)

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
        ring = draft and self._ring_pages
        seqs = [c[0] for c in chunks]
        tables = (self._t(self._ring_tables(seqs, B)) if ring
                  else self._pad_block_tables(tables))
        embeds, rows = self._prefill_embeds(chunks, B, Q)
        self.target_forwards += not draft
        self.draft_forwards += draft
        logits, _ = prefill_step(
            self.draft_params if draft and self.draft_params is not None else self.params,
            self.draft_cache if draft else self.cache,
            self._t(toks), self._t(positions), tables, self._t(ctx),
            cfg=self.draft_cfg if draft else self.cfg,
            scheme=self.draft_scheme if draft else self.verify_scheme,
            ring_cap=self.ring_cap if ring else None,
            lora_ids=self._lora_ids(seqs, B, draft), input_embeds=embeds, embeds_rows=rows)
        return logits

    def _prefill_embeds(self, chunks, B: int, Q: int):
        """(input_embeds [B, Q, H] f32, embeds_rows [B, Q]) of the chunks'
        prompt-embeds positions, or (None, None) when no sequence has
        prompt embeddings. A resumed sequence's positions past its prompt
        (its generated tokens) keep their table rows."""
        if all(s.prompt_embeds is None for s, _, _ in chunks):
            return None, None
        H = self.cfg.hidden_size
        embeds = torch.zeros((B, Q, H), dtype=torch.float32, device=self.device)
        rows = torch.zeros((B, Q), dtype=torch.bool, device=self.device)
        for i, (seq, start, end) in enumerate(chunks):
            pe = seq.prompt_embeds
            if pe is None or start >= len(pe):
                continue
            piece = pe[start:min(end, len(pe))]
            embeds[i, :len(piece)] = piece
            rows[i, :len(piece)] = True
        return embeds, rows

    def sample_tokens(self, logits, st: SamplingTensors, want_top: bool = False):
        """Sample one token per row of [B, V] device logits. Returns numpy
        (tokens [B], logprobs [B], top): ``top`` is (values [B, TOPN], ids
        [B, TOPN]) when ``want_top``, else None."""
        toks, lps = sample_with_logprob(logits, st, self.gen)
        top = None
        if want_top:
            topv, topi = top_logprobs(logits, TOPN)
            top = (topv.cpu().numpy(), topi.cpu().numpy())
        return toks.cpu().numpy(), lps.cpu().numpy(), top

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

    def run_decode(self, seqs, sampling: SamplingTensors, want_top: bool = False):
        """One autoregressive step. Returns numpy (tokens [1, n], logprobs
        [1, n], top): ``top`` is (values [1, n, TOPN], ids [1, n, TOPN])
        when ``want_top``, else None."""
        B, last, _, pos, _, tables = self._decode_inputs(seqs)
        st = self.sampling_tensors(sampling, len(seqs), B)
        out = decode_step(self.params, self.cache, self._t(last), self._t(pos), tables,
                          st, self.gen, cfg=self.cfg, scheme=self.verify_scheme,
                          num_top=TOPN if want_top else 0, lora_ids=self._lora_ids(seqs, B))
        self.target_forwards += 1
        n = len(seqs)
        top = None
        if want_top:
            top = (out[2].cpu().numpy()[None, :n], out[3].cpu().numpy()[None, :n])
        return out[0].cpu().numpy()[None, :n], out[1].cpu().numpy()[None, :n], top

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
        d_tables = self._t(self._ring_tables(seqs, B)) if self._ring_pages else tables
        lora = self._lora_ids(seqs, B)
        parts = []
        for _ in range(max(1, chain)):
            toks, accs, lps, state, _, _ = spec_rounds_step(
                self.params, self.draft_cache, self.cache, *state[:3], tables,
                d_tables, state[3], enable, st, self.gen, cfg=self.cfg,
                draft_scheme=self.draft_scheme, verify_scheme=self.verify_scheme,
                k=self.k, num_rounds=num_rounds, draft_cfg=self.draft_cfg,
                draft_params=self.draft_params, force_accept=self.force_accept,
                acceptance=self.acceptance, lora_ids=lora)
            parts.append((toks, accs, lps))
        n = len(seqs)
        toks = torch.cat([p[0] for p in parts]).cpu().numpy()
        accs = torch.cat([p[1] for p in parts]).cpu().numpy()
        lps = torch.cat([p[2] for p in parts]).cpu().numpy()
        self.target_forwards += toks.shape[0]
        self.draft_forwards += toks.shape[0] * self.k
        return toks[:, :n], accs[:, :n], lps[:, :n]

    # -- Medusa and n-gram rounds ------------------------------------------
    def _round_inputs(self, seqs, bank: RowBank):
        """``_decode_inputs`` (less ``prev``) and each sequence's row of
        ``bank``: padded lanes take the scratch row, in range and never a
        live row. Also the rows newly assigned."""
        B, last, _, pos, max_new, tables = self._decode_inputs(seqs)
        live_ids = {s.seq_id for s in seqs}
        rows = np.full(B, bank.scratch, np.int64)
        new = []
        for i, s in enumerate(seqs):
            rows[i], fresh = bank.assign(s.seq_id, live_ids)
            if fresh:
                new.append(int(rows[i]))
        return B, last, pos, max_new, rows, new, tables

    def _chained(self, step, chain: int, n: int):
        """``step()`` issued ``chain`` times back to back (its state stays on
        the device), then read back once: numpy (tokens, accepted, logprobs)
        of the ``n`` live lanes, each [chain*R, n, ...]."""
        parts = [step() for _ in range(max(1, chain))]
        toks, accs, lps = (torch.cat([p[j] for p in parts]).cpu().numpy() for j in range(3))
        self.spec_rounds_run += toks.shape[0]
        self.target_forwards += toks.shape[0]
        return toks[:, :n], accs[:, :n], lps[:, :n]

    def _sync_recent(self, seqs, prop_rows) -> None:
        """Write each sequence's last D+1 tokens (left-padded with its first)
        into its row of the verify-prefix bank, unless the rounds already
        rolled that row to the sequence's current length."""
        W = self._mrecent.shape[1]
        rows, vals = [], []
        for i, s in enumerate(seqs):
            if self._mbank.synced.get(s.seq_id) != s.num_tokens:
                tail = s.token_ids[-W:]
                rows.append(prop_rows[i])
                vals.append([tail[0]] * (W - len(tail)) + list(tail))
        if rows:
            self._mrecent[self._t(rows, torch.int64)] = self._t(vals)

    def run_medusa_rounds(self, seqs, sampling: SamplingTensors, enable: bool = True,
                          chain: int = 1):
        """``rounds_per_step`` Medusa rounds (the chain, or the tree under
        ``medusa_tree``) per call, ``chain`` calls back to back on
        device-resident state. A new row's proposals are reset to -1 (no
        proposal: its first round emits one AR token and seeds the heads).
        ``enable=False``: the same rounds with the proposals nulled (the AR
        oracle). Returns numpy (tokens [chain*R, n, width] (-1 padded),
        accepted [chain*R, n], logprobs)."""
        B, last, pos, max_new, prop_rows, new, tables_d = self._round_inputs(seqs, self._mbank)
        if new:
            self._mprops[self._t(new, torch.int64)] = -1
        st = self.sampling_tensors(sampling, len(seqs), B)
        rows_d = self._t(prop_rows, torch.int64)
        state = [self._t(last), self._t(pos), self._t(max_new)]
        rounds = self.config.speculative.rounds_per_step
        if self._mtree is not None:
            self._sync_recent(seqs, prop_rows)

        def step():
            if self._mtree is not None:
                toks, accs, lps, state[1:], _ = medusa_tree_rounds_step(
                    self.params, self.cache, self._mprops, self._mrecent, rows_d, state[1],
                    tables_d, state[2], enable, st, self.gen, cfg=self.cfg,
                    scheme=self.verify_scheme, tree=self._mtree, num_rounds=rounds)
            else:
                toks, accs, lps, state[:], _ = medusa_rounds_step(
                    self.params, self.cache, self._mprops, rows_d, *state[:2],
                    tables_d, state[2], enable, st, self.gen, cfg=self.cfg,
                    scheme=self.verify_scheme, k=self.k, num_rounds=rounds,
                    net=self._mnet)
            return toks, accs, lps
        toks, accs, lps = self._chained(step, chain, len(seqs))
        if self._mtree is not None:
            for i, s in enumerate(seqs):
                # the rounds rolled this row to the length the tokens give
                self._mbank.synced[s.seq_id] = s.num_tokens + int(accs[:, i].sum())
        return toks, accs, lps

    def run_ngram_rounds(self, seqs, sampling: SamplingTensors, enable: bool = True,
                         chain: int = 1):
        """``rounds_per_step`` prompt-lookup rounds per call, ``chain`` calls
        back to back on device-resident state (``ngram_rounds_step``). A
        sequence's history row is written from the host only when its tokens
        moved on without the rounds (a new row, a prefill, a preemption).
        ``enable=False``: the same rounds with the proposals nulled (the AR
        oracle, ``method="null"``). Returns numpy (tokens [chain*R, n, k+1]
        (-1 padded), accepted [chain*R, n], logprobs)."""
        B, last, pos, max_new, hist_rows, _, tables_d = self._round_inputs(seqs, self._hbank)
        hist_len = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            if self._hbank.synced.get(s.seq_id) != s.num_tokens:
                self._hist[int(hist_rows[i]), :s.num_tokens] = self._t(s.token_ids)
            hist_len[i] = s.num_tokens
        st = self.sampling_tensors(sampling, len(seqs), B)
        spec = self.config.speculative
        state = [self._t(last), self._t(pos), self._t(hist_len), self._t(max_new)]
        rows_d = self._t(hist_rows, torch.int64)

        def step():
            toks, accs, lps, state[:], _ = ngram_rounds_step(
                self.params, self.cache, self._hist, rows_d, state[2], state[0], state[1],
                tables_d, state[3], enable, st, self.gen, cfg=self.cfg,
                scheme=self.verify_scheme, k=self.k, num_rounds=spec.rounds_per_step,
                nmin=spec.ngram_prompt_lookup_min, nmax=spec.ngram_prompt_lookup_max)
            return toks, accs, lps
        toks, accs, lps = self._chained(step, chain, len(seqs))
        for i, s in enumerate(seqs):
            # the rounds appended this row's emitted tokens
            self._hbank.synced[s.seq_id] = s.num_tokens + int(accs[:, i].sum())
        return toks, accs, lps

    # -- EAGLE -------------------------------------------------------------
    def run_prefill_chunks_eagle(self, chunks):
        """Prompt chunks through the target and, fused, their features
        through the EAGLE layer into the draft cache (``prefill_eagle_step``).
        Returns (device logits [B, V] of each row's last valid position,
        numpy f32 [B, H] hidden states there: each pairs with the token
        after it to seed the sequence's decode span)."""
        B = self._bucket_batch(len(chunks))
        Q = self._bucket_tokens(max(end - start for _, start, end in chunks))
        toks = np.zeros((B, Q), np.int32)
        shifted = np.zeros((B, Q), np.int32)
        feat_len = np.zeros(B, np.int32)
        positions = np.zeros((B, Q), np.int32)
        ctx = np.zeros(B, np.int32)
        tables = [[] for _ in range(B)]
        for i, (seq, start, end) in enumerate(chunks):
            ids = seq.token_ids
            piece = ids[start:end]
            toks[i, :len(piece)] = piece
            # x_{p+1} for each position p of the chunk; a fresh prompt's last
            # position pairs with the token sampled after this call, which
            # the decode span covers: feat_len leaves it out
            nxt = ids[start + 1:min(end + 1, seq.num_tokens)]
            shifted[i, :len(nxt)] = nxt
            feat_len[i] = len(nxt)
            positions[i] = np.arange(start, start + Q, dtype=np.int32)
            ctx[i] = end
            tables[i] = seq.page_ids
        self.target_forwards += 1
        self.draft_forwards += 1
        logits, h_last, _, _ = prefill_eagle_step(
            self.params, self.cache, self.draft_cache, self._t(toks), self._t(shifted),
            self._t(feat_len), self._t(positions), self._pad_block_tables(tables),
            self._t(ctx), cfg=self.cfg, ecfg=self.draft_cfg, scheme=self.verify_scheme)
        return logits, h_last.to(torch.float32).cpu().numpy()

    def _sync_espan(self, seqs, rows) -> None:
        """Write each sequence's span seed (``seq.eagle_span``: one position,
        the hidden state at the prompt's last position paired with the token
        after it) into its bank row, unless the rounds already carried the
        row to the sequence's length. A seed that no longer ends at the
        pending last token (the sequence moved on without the rounds: decode
        steps with speculation disabled) gives way to a one-position span at
        the right place: the last token with a zero hidden state, which costs
        one round's draft quality and no correctness."""
        H = self.cfg.hidden_size
        for s, row in zip(seqs, rows):
            if self._ebank.synced.get(s.seq_id) == s.num_tokens:
                continue
            h, t, p, n = s.eagle_span
            if int(p) + int(n) != s.num_tokens - 1:
                h, t, p = np.zeros((1, H), np.float32), [s.last_token()], s.num_tokens - 2
            row = int(row)
            self._espan_h[row] = 0
            self._espan_h[row, 0] = self._t(h[0], torch.float32).to(torch.bfloat16)
            self._espan_t[row] = 0
            self._espan_t[row, 0] = int(t[0])
            self._espan_pos[row] = int(p)
            self._espan_len[row] = 1
            self._ebank.synced[s.seq_id] = s.num_tokens

    def run_eagle_rounds(self, seqs, sampling: SamplingTensors, chain: int = 1):
        """``rounds_per_step`` EAGLE rounds per call (``eagle_rounds_step``),
        ``chain`` calls back to back on the device-resident span bank.
        Returns numpy (tokens [chain*R, n, k+1] (-1 padded), accepted
        [chain*R, n], logprobs)."""
        B, _, _, max_new, rows, _, tables_d = self._round_inputs(seqs, self._ebank)
        self._sync_espan(seqs, rows[:len(seqs)])
        st = self.sampling_tensors(sampling, len(seqs), B)
        rounds = self.config.speculative.rounds_per_step
        rows_d = self._t(rows, torch.int64)
        budget = [self._t(max_new)]

        def step():
            toks, accs, lps, budget[0], _, _ = eagle_rounds_step(
                self.params, self.draft_cache, self.cache, self._espan_h, self._espan_t,
                self._espan_pos, self._espan_len, rows_d, tables_d, budget[0], st, self.gen,
                cfg=self.cfg, ecfg=self.draft_cfg, scheme=self.verify_scheme, k=self.k,
                num_rounds=rounds)
            return toks, accs, lps
        toks, accs, lps = self._chained(step, chain, len(seqs))
        self.draft_forwards += toks.shape[0] * (self.k + 1)
        for i, s in enumerate(seqs):
            # the rounds carried this row to the length the tokens give
            self._ebank.synced[s.seq_id] = s.num_tokens + int(accs[:, i].sum())
        return toks, accs, lps

    # -- swap-mode preemption ----------------------------------------------
    def gather_pages(self, page_ids, draft: bool = False):
        """Host copies of the pages ``page_ids`` of every layer of the
        target cache, or of the draft cache (``draft``: a pool over the
        same page ids, or the ring's own pages): (entries [L, n, 2, Hkv, S,
        D * bytes] as raw bytes, the 8-bit scales [L, n, 2, Hkv, S] or
        None), in page-locked memory from the card. The entries travel as
        bytes, so one path serves bf16 and every 8-bit type."""
        cache = self.draft_cache if draft else self.cache
        ids = self._t(page_ids, torch.int64)
        pages = _to_host(cache.kv_pages.view(torch.uint8).index_select(1, ids))
        scales = (None if cache.kv_scales is None
                  else _to_host(cache.kv_scales.index_select(1, ids)))
        return pages, scales

    def write_pages(self, page_ids, pages, scales=None, draft: bool = False) -> None:
        """Scatter :meth:`gather_pages`' copies into the pages ``page_ids``
        (of the draft cache with ``draft``), in place."""
        cache = self.draft_cache if draft else self.cache
        ids = self._t(page_ids, torch.int64)
        cache.kv_pages.view(torch.uint8).index_copy_(1, ids, pages.to(self.device))
        if scales is not None:
            cache.kv_scales.index_copy_(1, ids, scales.to(self.device))

    def ring_page_ids(self, seq) -> Optional[list]:
        """The ring pool's pages of a sequence's row (None without one)."""
        row = self._ring.slot.get(seq.seq_id)
        if row is None:
            return None
        return list(range(1 + row * self._ring_pages, 1 + (row + 1) * self._ring_pages))

    def assign_ring_row(self, seq, live_ids) -> list:
        """A ring row for a resumed sequence (a free one, or one of a
        sequence outside ``live_ids``); returns its pages."""
        self._ring.assign(seq.seq_id, live_ids)
        return self.ring_page_ids(seq)

    def free_rows(self, seq) -> None:
        """Release a finished sequence's rows of every bank (each a no-op
        without one)."""
        for bank in (self._ring, self._mbank, self._hbank, self._ebank):
            bank.free(seq.seq_id)

    # -- ring-buffer draft KV (windowed shared-weights draft) --------------
    @property
    def ring_cap(self) -> int:
        """Ring write floor: only the last ring_cap positions of a prefill
        rectangle may be written (older ones would alias ring pages within
        one scatter). Always >= window + k + page_size."""
        return (self._ring_pages - 1) * self.page_size

    def _ring_tables(self, seqs, B: int) -> np.ndarray:
        """[B, max_pages_per_seq] draft block tables under the ring layout:
        entry lp -> 1 + row * R + lp % R. Padded lanes ride the scratch
        ring. A sequence takes a free row, or the row of one outside the
        batch (acceptance-only cost: the evictee's draft window rebuilds
        through backfill)."""
        live = {s.seq_id for s in seqs}
        scratch = 1 + self._ring.scratch * self._ring_pages
        out = np.empty((B, self.max_pages_per_seq), np.int32)
        out[:] = scratch + self._ring_base
        for i, s in enumerate(seqs):
            out[i] = 1 + self._ring.assign(s.seq_id, live)[0] * self._ring_pages + self._ring_base
        return out

    def free_ring_row(self, seq) -> None:
        """Release a sequence's ring row (a no-op without a ring or a row)."""
        self._ring.free(seq.seq_id)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a device tensor, page-locked so the copy runs at the
    link's rate; a CPU tensor (a fresh gather) as it is."""
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def make_sampling_tensors(seqs, vocab_size: Optional[int] = None,
                          eos_token_id: Optional[int] = None,
                          grammar_tables=None) -> SamplingTensors:
    """Batch the per-sequence knobs on the host (numpy); builds a [B, V]
    vocab mask only when a row carries allowed/banned token sets or a
    min-tokens EOS suppression, and a logit bias only for penalties and
    logit_bias.

    Guided rows (``seq.grammar_fsm``): the batch's distinct grammars, by
    object identity, stacked [G, S, V] on the device by ``grammar_tables``
    (``ModelRunner.stack_grammars``: the state axis padded by -1 to the
    largest automaton), each row's grammar index (-1: unguided) and
    state."""
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
    gnext = gidx = gstate = None
    if any(s.grammar_fsm is not None for s in seqs):
        fsms, which = [], []
        for s in seqs:
            f = s.grammar_fsm
            if f is None:
                which.append(-1)
                continue
            if all(f is not g for g in fsms):
                fsms.append(f)
            which.append(next(i for i, g in enumerate(fsms) if g is f))
        gnext = grammar_tables(fsms)
        gidx = np.asarray(which, np.int32)
        gstate = np.asarray([s.grammar_state for s in seqs], np.int32)
    sps = [s.sampling_params for s in seqs]
    needs_filter = any(sp.top_k > 0 or sp.top_p < 1.0 or sp.min_p > 0.0
                       for sp in sps)
    return SamplingTensors(
        temperature=np.array([sp.temperature for sp in sps], np.float32),
        top_k=np.array([sp.top_k for sp in sps], np.int32),
        top_p=np.array([sp.top_p for sp in sps], np.float32),
        min_p=np.array([sp.min_p for sp in sps], np.float32),
        vocab_mask=mask, logit_bias=bias, needs_filter=needs_filter,
        grammar_next=gnext, grammar_idx=gidx, grammar_state=gstate)
