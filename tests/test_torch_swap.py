"""Swap-mode preemption in the port, on the CPU.

The five cases of ``tests/engine/test_swap_preemption.py`` on the port's
engine (outputs under page pressure equal an unconstrained run's and
recompute mode's, swaps happen, the pool drains, int8 pages travel with
their scales, QSpec's draft cache is parked too, a zero-byte pool falls
back to recompute); the windowed draft's ring pool, whose pages are
restored into whatever row the sequence resumes in; the proposers' own
state (EAGLE's pool, the n-gram and Medusa rows); and the tokens against
the JAX engine under the same swaps.

Weights: init_params(ModelConfig.tiny(quant="w4")), seed 0 (the port's own
for the port-only cases, the JAX package's carried over for the JAX
comparison); prompts of 40 ids from numpy seeds, as the JAX test's.
"""

import jax
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.core.swap import HostSwapPool
from qspec_tpu_torch.models.llama import init_params, params_from_numpy
from tests.test_torch_engine import TIE_GAP, _jax_last_logits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MC = ModelConfig.tiny(quant="w4")


@pytest.fixture(scope="module")
def params():
    return init_params(MC, seed=0, device="cpu")


def _sched(mode):
    return dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
                decode_batch_buckets=(2, 4), prefill_token_buckets=(64,), preemption_mode=mode)


def run(params, num_pages, prompts, *, mode="swap", swap_gb=4.0, kv_dtype="bfloat16",
        spec=None, max_tokens=24, cfg=MC):
    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_pages=num_pages,
                                     kv_cache_dtype=kv_dtype, swap_space_gb=swap_gb),
        scheduler=SchedulerConfig(**_sched(mode)), speculative=spec),
        params, num_pages=num_pages, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                          ignore_eos=True))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 2000, "no forward progress"
    return outs, eng


def _prompts(seed=11, n=4, size=40):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=size))) for _ in range(n)]


def _swapped(eng):
    pool = eng._swap_pool
    assert pool.num_swap_outs > 0, "pressure never triggered a swap"
    assert pool.num_swap_ins == pool.num_swap_outs and pool.used_pages == 0
    assert eng.swap_bytes_out > 0


# ------------------------------- tests/engine/test_swap_preemption.py's cases

def test_swap_preemption_preserves_outputs(params):
    prompts = _prompts()
    rich, _ = run(params, 128, prompts)
    tight, eng = run(params, 12, prompts)
    assert rich == tight
    _swapped(eng)


def test_swap_matches_recompute(params):
    prompts = _prompts(seed=7)
    swap, eng = run(params, 12, prompts, mode="swap")
    rec, _ = run(params, 12, prompts, mode="recompute")
    assert swap == rec
    _swapped(eng)


def test_swap_pool_full_falls_back_to_recompute(params):
    """A zero-byte pool degrades to recompute preemption, not a deadlock."""
    prompts = _prompts(seed=3)
    rich, _ = run(params, 128, prompts)
    tight, eng = run(params, 12, prompts, swap_gb=0.0)
    assert rich == tight
    assert eng._swap_pool.num_swap_outs == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_swap_8bit_kv_cache(params, kv_dtype):
    """The 8-bit pages travel as bytes, with their scales where they have
    them."""
    prompts = _prompts(seed=5)
    rich, _ = run(params, 128, prompts, kv_dtype=kv_dtype)
    tight, eng = run(params, 12, prompts, kv_dtype=kv_dtype)
    assert rich == tight
    _swapped(eng)


def test_swap_with_spec_decode_draft_cache(params):
    """QSpec's draft cache is parked with the target's: the draft's KV of
    the context is as stateful as the target's (acceptance, not only the
    tokens, is the unconstrained run's)."""
    prompts = _prompts(seed=9)
    spec = SpeculativeConfig(num_speculative_tokens=2, draft_scheme="w4a8")
    rich, e_rich = run(params, 128, prompts, spec=spec)
    tight, eng = run(params, 16, prompts, spec=spec)
    assert rich == tight
    _swapped(eng)
    assert eng.spec_metrics.num_draft_accepted == e_rich.spec_metrics.num_draft_accepted


# --------------------------------------------------------------- the port's

def test_swap_ring_pool_under_draft_window(params, monkeypatch):
    """Under draft_kv_window the draft's ring row is parked and restored
    into the row the sequence resumes in: the tokens and the drafts
    accepted are those of the unconstrained run, and of the full draft
    pool (QSPEC_RING_DRAFT=0) under the same swaps."""
    prompts = _prompts(seed=9)
    spec = SpeculativeConfig(num_speculative_tokens=2, draft_scheme="w4a8",
                             draft_kv_window=24)
    rich, e_rich = run(params, 128, prompts, spec=spec)
    tight, eng = run(params, 16, prompts, spec=spec)
    assert eng.runner._ring_pages and rich == tight
    _swapped(eng)
    assert eng.spec_metrics.num_draft_accepted == e_rich.spec_metrics.num_draft_accepted
    monkeypatch.setenv("QSPEC_RING_DRAFT", "0")
    full, e_full = run(params, 16, prompts, spec=spec)
    assert not e_full.runner._ring_pages and full == tight
    assert e_full.spec_metrics.num_draft_accepted == eng.spec_metrics.num_draft_accepted


@pytest.mark.parametrize("method", ["ngram", "medusa", "eagle"])
def test_swap_with_proposer_state(params, method):
    """EAGLE's KV pool is parked with the target's; the n-gram, Medusa and
    EAGLE rows of a parked sequence are kept or rebuilt: the tokens are the
    unconstrained run's (each method's greedy output is AR's)."""
    from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
    from qspec_tpu_torch.spec_decode.medusa import init_medusa_params
    p = dict(params)
    if method == "eagle":
        p["eagle"] = init_eagle_params(MC, seed=0, device="cpu")
    if method == "medusa":
        p["medusa"] = init_medusa_params(MC.hidden_size, MC.vocab_size, 2, device="cpu")
    prompts = _prompts(seed=13)
    spec = SpeculativeConfig(num_speculative_tokens=2, method=method)
    rich, _ = run(p, 128, prompts, spec=spec)
    tight, eng = run(p, 16, prompts, spec=spec)
    assert rich == tight
    _swapped(eng)


def test_abort_discards_parked_kv(params):
    prompts = _prompts()
    eng = LLMEngine(EngineConfig(model=MC, cache=CacheConfig(page_size=16, num_pages=12),
                                 scheduler=SchedulerConfig(**_sched("swap"))),
                    params, num_pages=12, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True))
    while not eng.scheduler.swapped:
        eng.step()
    sid = eng.scheduler.swapped[0].seq_id
    assert eng._swap_pool.has(sid)
    eng.abort_request(sid)
    assert not eng._swap_pool.has(sid) and all(s.seq_id != sid for s in eng.scheduler.swapped)
    while eng.has_unfinished_requests():
        eng.step()
    assert eng._swap_pool.used_pages == 0


def test_host_swap_pool_budget():
    pool = HostSwapPool(max_bytes=10 * 100, page_bytes=100)
    assert pool.can_reserve(10) and not pool.can_reserve(11)
    pool.put(1, 6, "a")
    assert pool.used_bytes == 600 and not pool.can_reserve(5)
    with pytest.raises(ValueError):
        pool.put(1, 1, "b")
    pool.discard(2)
    assert pool.pop(1) == "a" and pool.used_pages == 0
    assert (pool.num_swap_outs, pool.num_swap_ins) == (1, 1)


def test_preemption_mode_checked():
    cfg = EngineConfig(model=MC, scheduler=SchedulerConfig(preemption_mode="bogus"))
    with pytest.raises(ValueError, match="preemption_mode"):
        LLMEngine(cfg, None, num_pages=8, device="cpu")


# ---------------------------------------------------------- the JAX engine

def test_tokens_match_jax_engine_under_swap():
    """The same weights under the same page pressure in both packages
    (QSpec, W4A8 draft, k = 2, the bf16 head), each swapping: equal greedy
    tokens but at a near-tie of the JAX logits (tests/test_torch_engine.py's
    rule)."""
    jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(seed=9)
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16, num_pages=16),
                              scheduler=JSched(**_sched("swap")),
                              speculative=JSpec(num_speculative_tokens=2,
                                                draft_scheme="w4a8")),
                      jparams, num_pages=16)
    for p in prompts:
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True))
    jout = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                jout[o.request_id] = o.output_token_ids
    tout, eng = run(tparams, 16, prompts, cfg=cfg,
                    spec=SpeculativeConfig(num_speculative_tokens=2, draft_scheme="w4a8"))
    _swapped(eng)
    assert jeng._swap_pool.num_swap_outs > 0
    for i, p in enumerate(prompts):
        diff = [j for j, (a, b) in enumerate(zip(jout[i], tout[i])) if a != b]
        if diff:
            top2 = np.sort(_jax_last_logits(jcfg, jparams, p + jout[i][:diff[0]]))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (i, diff[0], top2)
