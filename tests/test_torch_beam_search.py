"""Beam search in the port, on the CPU.

``tests/engine/test_beam_search.py``'s three cases on the port's engine
(beam width 1 is greedy decoding; width 3 gives distinct beams, ranked;
the top beam's cumulative logprob is the sum of its tokens' logprobs), the
beams against ``qspec_tpu.beam_search.beam_search`` on the same tiny model
(equal token lists but where a step is a near-tie of the JAX logprobs;
cumulative logprobs within 2e-2, the two forwards' rounding over a few
tokens), ``LLM.beam_search``, and the width the engine's top-n caps.
"""

import jax
import numpy as np
import pytest
import torch

from qspec_tpu.beam_search import BeamSearchParams as JBeamSearchParams
from qspec_tpu.beam_search import beam_search as jbeam_search
from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu_torch import (LLM, CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig)
from qspec_tpu_torch.beam_search import BeamSearchParams, beam_search
from qspec_tpu_torch.models.llama import params_from_numpy

# a cumulative logprob's distance from the JAX package's, and the gap below
# which two candidates' JAX logprobs count as a near-tie
SCORE_TOL = 2e-2
TIE_GAP = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHED = dict(max_num_seqs=8, max_model_len=128, prefill_chunk_size=64,
             decode_batch_buckets=(4, 8), prefill_token_buckets=(64,))


@pytest.fixture(scope="module")
def models():
    jcfg = JModel.tiny(quant="w4")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def engine(models):
    cfg, params = models[2], models[3]
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                  scheduler=SchedulerConfig(**SCHED)), params, device="cpu")


def _prompts(n=2, length=10):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(1, 500, size=length))) for _ in range(n)]


def _final(engine, prompt, **sp):
    rid = engine.add_request(prompt, SamplingParams(temperature=0.0, ignore_eos=True, **sp))
    final = None
    while engine.has_unfinished_requests():
        for o in engine.step():
            if o.finished and o.request_id == rid:
                final = o
    return final


# --------------------------------------- tests/engine/test_beam_search.py's cases

def test_beam_width_1_equals_greedy(engine):
    ps = _prompts()
    outs = beam_search(engine, ps, BeamSearchParams(beam_width=1, max_tokens=6,
                                                    ignore_eos=True))
    for p, out in zip(ps, outs):
        assert out.sequences[0].tokens == _final(engine, p, max_tokens=6).output_token_ids


def test_beam_width_3_ranked_and_distinct(engine):
    seqs = beam_search(engine, _prompts(1), BeamSearchParams(beam_width=3, max_tokens=5,
                                                             ignore_eos=True))[0].sequences
    assert len(seqs) == 3 and len({tuple(s.tokens) for s in seqs}) == 3
    scores = [s.score(1.0) for s in seqs]
    assert scores == sorted(scores, reverse=True)
    assert all(len(s.tokens) == 5 for s in seqs) and all(s.cum_logprob <= 1e-6 for s in seqs)


def test_beam_cum_logprob_is_sum(engine):
    ps = _prompts(1)
    out = beam_search(engine, ps, BeamSearchParams(beam_width=1, max_tokens=4,
                                                   ignore_eos=True))[0]
    final = _final(engine, ps[0], max_tokens=4, logprobs=1)
    assert abs(out.sequences[0].cum_logprob - sum(final.logprobs)) < 1e-3


# ---------------------------------------------------------- the JAX package

def test_beams_match_jax_beam_search(models, engine):
    jcfg, jparams, _, _ = models
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**SCHED)), jparams)
    ps = _prompts()
    want = jbeam_search(jeng, ps, JBeamSearchParams(beam_width=4, max_tokens=5,
                                                    ignore_eos=True))
    got = beam_search(engine, ps, BeamSearchParams(beam_width=4, max_tokens=5,
                                                   ignore_eos=True))
    for w, g in zip(want, got):
        wt = [s.tokens for s in w.sequences]
        gt = [s.tokens for s in g.sequences]
        if wt != gt:
            # the beams may part only where two candidates' scores are a
            # near-tie (they were equal here, scores to the bit)
            j = next(i for i, (a, b) in enumerate(zip(wt, gt)) if a != b)
            assert abs(w.sequences[j].cum_logprob - g.sequences[j].cum_logprob) < TIE_GAP
        for ws, gs in zip(w.sequences, g.sequences):
            if ws.tokens == gs.tokens:
                assert abs(ws.cum_logprob - gs.cum_logprob) < SCORE_TOL


def test_llm_beam_search_under_qspec():
    """LLM.beam_search through a QSpec engine (each step a prefill), width
    4: distinct, sorted beams."""
    llm = LLM(model="tiny", device="cpu", num_speculative_tokens=2, block_size=16,
              max_model_len=128, max_num_seqs=8, prefill_chunk_size=64, num_pages=96)
    outs = llm.beam_search(_prompts(), BeamSearchParams(beam_width=4, max_tokens=4,
                                                        ignore_eos=True))
    for o in outs:
        scores = [s.score(1.0) for s in o.sequences]
        assert len({tuple(s.tokens) for s in o.sequences}) == 4
        assert scores == sorted(scores, reverse=True)


def test_beam_width_past_top_n_raises(engine):
    with pytest.raises(ValueError, match="at most 20"):
        beam_search(engine, _prompts(1), BeamSearchParams(beam_width=11))
