"""The port's engine on the CPU: the greedy QSpec invariant, and agreement
with the JAX package's engine on the same tiny weights and prompts.

Weights: qspec_tpu init_params(ModelConfig.tiny(quant="w4",
lm_head_quant="bf16"), seed 0), carried over with params_from_numpy. Prompts:
4 random token-id lists from numpy seed 7 (the JAX package's
tests/spec_decode/test_e2e_invariant.py prompts), 20 greedy tokens each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu_torch import (LLM, CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.models.llama import params_from_numpy

# a step where the two packages may pick different greedy tokens must be a
# near-tie in the JAX package's logits: top-2 gap below this
TIE_GAP = 2e-2
MAX_TOKENS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run faster on one thread, and the suite's parallel
    workers then do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                               device="cpu")
    r = np.random.default_rng(7)
    prompts = [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40)))))
               for _ in range(4)]
    return jcfg, jparams, cfg, params, prompts


def _sched(**over):
    d = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    d.update(over)
    return d


def run_port(cfg, params, prompts, spec=None, **sched):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched(**sched)),
                                 speculative=spec), params, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    return [outs[i] for i in range(len(prompts))], eng


@pytest.mark.parametrize("k", [1, 3, 5])
def test_greedy_spec_equals_ar_oracle(setup, k):
    """Greedy QSpec == the qspec_null oracle (same rounds, proposals nulled)
    == plain AR decode, bit for bit."""
    _, _, cfg, params, prompts = setup
    spec, eng = run_port(cfg, params, prompts, SpeculativeConfig(num_speculative_tokens=k))
    oracle, _ = run_port(cfg, params, prompts,
                         SpeculativeConfig(num_speculative_tokens=k, method="qspec_null"))
    ar, _ = run_port(cfg, params, prompts)
    assert spec == oracle == ar
    assert all(len(t) == MAX_TOKENS for t in spec)
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0 and 0.0 <= m.draft_acceptance_rate <= 1.0
    assert m.num_emitted_tokens >= m.num_draft_accepted


def test_greedy_invariant_while_batch_changes(setup):
    """Queueing (2 running of 4) and rounds of 2 per step change the batch
    shape over time; the invariant still holds."""
    _, _, cfg, params, prompts = setup
    spec, _ = run_port(cfg, params, prompts,
                       SpeculativeConfig(num_speculative_tokens=3, rounds_per_step=2),
                       max_num_seqs=2)
    ar, _ = run_port(cfg, params, prompts, max_num_seqs=2)
    assert spec == ar


def _jax_last_logits(jcfg, jparams, ids):
    """JAX logits of the token after ``ids`` (one prefill rectangle)."""
    S, Q = 16, len(ids)
    n_pages = -(-Q // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, n_pages + 1, S))
    pos = np.arange(Q, dtype=np.int32)[None]
    tables = np.arange(1, n_pages + 1, dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S),
                                  jnp.asarray(tables), jnp.asarray([Q], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                                     cache, batch, scheme="w4a16")
    return np.asarray(logits[0, -1])


def test_greedy_tokens_match_jax_engine(setup):
    jcfg, jparams, cfg, params, prompts = setup
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**_sched())), jparams)
    for p in prompts:
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    jout = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                jout[o.request_id] = o.output_token_ids
    port, _ = run_port(cfg, params, prompts, SpeculativeConfig(num_speculative_tokens=3))
    for i, p in enumerate(prompts):
        ref, got = jout[i], port[i]
        diff = [j for j, (a, b) in enumerate(zip(ref, got)) if a != b]
        if diff:
            j = diff[0]
            top2 = np.sort(_jax_last_logits(jcfg, jparams, p + ref[:j]))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (i, j, top2)


def test_llm_entry_point_on_cpu(setup):
    llm = LLM(model="tiny", device="cpu", lm_head_quant="bf16",
              num_speculative_tokens=3, block_size=16, max_model_len=256,
              max_num_seqs=4, prefill_chunk_size=64, num_pages=64, seed=5)
    outs = llm.generate([[1, 2, 3, 4], list(range(10, 40))],
                        SamplingParams(temperature=0.0, max_tokens=8))
    assert [len(o.output_token_ids) for o in outs] == [8, 8]
    assert all(o.finished and o.finish_reason == "length" for o in outs)
    assert all(0 <= t < 512 for o in outs for t in o.output_token_ids)
    assert llm.spec_metrics.num_spec_rounds > 0


def test_sampled_decoding_runs_and_is_seeded(setup):
    _, _, cfg, params, prompts = setup

    def run(seed):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=SchedulerConfig(**_sched()),
                                     speculative=SpeculativeConfig(num_speculative_tokens=2)),
                        params, device="cpu", seed=seed)
        for p in prompts[:2]:
            eng.add_request(p, SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                              max_tokens=12))
        outs = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.output_token_ids
        return [outs[0], outs[1]]

    a = run(3)
    assert a == run(3)
    assert [len(t) for t in a] == [12, 12]


def test_unported_options_raise(setup):
    _, _, cfg, params, _ = setup
    with pytest.raises(NotImplementedError):
        LLMEngine(EngineConfig(model=cfg, speculative=SpeculativeConfig(method="ngram")),
                  params, device="cpu")
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=8),
                                 scheduler=SchedulerConfig(**_sched())), params,
                    device="cpu")
    with pytest.raises(NotImplementedError):
        eng.add_request([1, 2], SamplingParams(stop=["x"]))
    assert torch.is_tensor(eng.runner.cache.kv_pages)


def test_draft_and_verify_steps(setup):
    """draft_steps proposes k tokens under w4a4 from the draft cache;
    verify_step scores them under w4a16 in one pass. With greedy sampling
    the emitted tokens are the first tokens plain AR decoding produces from
    the same state."""
    from qspec_tpu_torch.engine import model_runner as mr
    from qspec_tpu_torch.ops import kv_cache as tkv
    from qspec_tpu_torch.ops.sampling import SamplingTensors
    _, _, cfg, params, prompts = setup
    B, k, S = 2, 3, 16
    toks = np.zeros((B, 40), np.int32)
    lens = [len(prompts[0]), len(prompts[1])]
    for i in range(B):
        toks[i, :lens[i]] = prompts[i]
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    ctx = torch.tensor(lens, dtype=torch.int32)
    pos = torch.arange(40, dtype=torch.int32).repeat(B, 1)
    st = SamplingTensors(torch.zeros(B), torch.zeros(B, dtype=torch.int32),
                         torch.ones(B), torch.zeros(B), needs_filter=False)
    gen = torch.Generator().manual_seed(0)

    def cache():
        c = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, 10, S), "cpu")
        logits, _ = mr.prefill_step(params, c, torch.tensor(toks), pos, tables, ctx,
                                    cfg=cfg, scheme="w4a16")
        return c, logits.argmax(-1).to(torch.int32)

    target, first = cache()
    draft, _ = cache()
    ar_cache, _ = cache()
    ar, tok, p = [], first, ctx.clone()
    for _ in range(k + 1):
        tok, _, _ = mr.decode_step(params, ar_cache, tok, p, tables, st, gen,
                                   cfg=cfg, scheme="w4a16")
        ar.append(tok)
        p = p + 1
    ar = torch.stack(ar, 1)

    d_toks, d_probs, _ = mr.draft_steps(params, draft, first, ctx, tables, st, gen,
                                        cfg=cfg, scheme="w4a4", k=k)
    assert tuple(d_toks.shape) == (B, k) and tuple(d_probs.shape) == (B, k, cfg.vocab_size)
    res, _ = mr.verify_step(params, target, first, d_toks, d_probs, ctx, tables, st, gen,
                            cfg=cfg, scheme="w4a16")
    for b in range(B):
        n = int(res.accepted_len[b])
        assert res.tokens[b, :n].tolist() == ar[b, :n].tolist()
        assert res.tokens[b, :n - 1].tolist() == d_toks[b, :n - 1].tolist()


@pytest.mark.parametrize("num_pages", [12, None])
def test_prefix_cache_and_preemption_keep_greedy_output(setup, num_pages):
    """A prompt served twice (the second time from the prefix cache, prefill
    starting past position 0) and a cache too small for all four sequences
    (recompute preemption) give the unconstrained greedy tokens."""
    _, _, cfg, params, prompts = setup
    ref, _ = run_port(cfg, params, prompts)
    again = prompts + [prompts[0] + [7, 8, 9]]
    eng = LLMEngine(EngineConfig(model=cfg,
                                 cache=CacheConfig(page_size=16, num_pages=num_pages),
                                 scheduler=SchedulerConfig(**_sched()),
                                 speculative=SpeculativeConfig(num_speculative_tokens=3)),
                    params, device="cpu")
    for p in again:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    assert [outs[i] for i in range(4)] == ref
    tail, _ = run_port(cfg, params, [again[4]])
    assert outs[4] == tail[0]
