"""N-gram prompt lookup in the port against the JAX package, on the CPU.

Ports of tests/spec_decode/test_ngram.py and test_ngram_device.py: the
port's device matcher (``ops/ngram.py``) against the JAX package's host
matcher (``NgramProposer``, its reference) and device matcher, on random
and repeating histories (all bit-equal: integer compares); the
engine with ``method="ngram"`` on a tiny BLOOM (bf16, ALiBi) against its
``"null"`` oracle (bit for bit) and against the JAX engine's greedy tokens
(equal up to near-ties, top-2 logits within 2e-2), with rounds 1 and 2, a
preemption, and a repeating prompt that makes the proposals land.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.ngram import ngram_match_device as j_match
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu.spec_decode.ngram import NgramProposer as JNgramProposer
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.core.scheduler import Scheduler
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops.ngram import ngram_match_device

TIE_GAP = 2e-2
TINY_BLOOM = {"model_type": "bloom", "vocab_size": 512, "hidden_size": 128, "n_layer": 2,
              "n_head": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeSeq:
    def __init__(self, toks):
        self.token_ids = list(toks)


# ---------------------------------------------------------------- matchers

@pytest.mark.parametrize("hist,nmin,nmax,k,want", [
    ([1, 2, 7, 8, 9, 4, 5, 6, 7, 8, 9], 1, 3, 2, [4, 5]),  # after the earlier [7, 8, 9]
    ([1, 2, 3, 4, 5], 2, 3, 2, None),                       # no repeat
    ([4, 7, 4, 7], 1, 2, 3, [4, 7, 7]),                     # short continuation, padded
], ids=["repeat", "no-match", "padded"])
def test_host_proposer(hist, nmin, nmax, k, want):
    """The host proposer's cases: the device matcher on one history gives
    what the JAX host proposer gives (no match: every slot -1)."""
    got = ngram_match_device(torch.tensor([hist], dtype=torch.int32),
                             torch.tensor([len(hist)], dtype=torch.int32),
                             k=k, nmin=nmin, nmax=nmax)[0].tolist()
    jwant = JNgramProposer(nmin, nmax).propose(hist, k)
    assert (jwant is None) == (want is None)
    assert got == ([-1] * k if want is None else want)
    if want is not None:
        assert list(jwant) == want


def _histories(rng, B, H, nmax, vocab, period=None):
    hist = np.zeros((B, H), np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(nmax + 2, H))
        if period:
            base = rng.integers(0, vocab, size=period)
            toks = np.resize(base, n).astype(np.int32)
            toks[rng.integers(0, n, size=2)] = rng.integers(0, vocab, size=2)
        else:
            toks = rng.integers(0, vocab, size=n).astype(np.int32)
        hist[b, :n] = toks
        lens[b] = n
    return hist, lens


@pytest.mark.parametrize("nmin,nmax", [(1, 4), (2, 3), (1, 1)])
@pytest.mark.parametrize("kind", ["random", "repeating"])
def test_device_matcher_matches_host_and_jax(nmin, nmax, kind):
    """The device matcher equals the JAX host matcher and the JAX device
    matcher on random small-vocabulary histories (many repeats) and on
    periodic ones with two tokens changed; stale tokens past each row's
    length are never read."""
    rng = np.random.default_rng(nmin * 10 + nmax + (kind == "repeating"))
    k, B, H = 4, 8, 96
    hist, lens = _histories(rng, B, H, nmax, 6, period=5 if kind == "repeating" else None)
    stale = hist.copy()
    for b in range(B):
        stale[b, lens[b]:] = rng.integers(0, 6, size=H - lens[b])
    want = JNgramProposer(nmin, nmax).propose_batch([FakeSeq(h[:n]) for h, n in zip(hist, lens)],
                                                   k)
    got = ngram_match_device(torch.tensor(stale), torch.tensor(lens), k=k, nmin=nmin, nmax=nmax)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jgot = np.asarray(j_match(jnp.asarray(hist), jnp.asarray(lens), k=k, nmin=nmin, nmax=nmax))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_device_matcher_no_match_and_short():
    hist = np.zeros((3, 32), np.int32)
    hist[0, :6] = [1, 2, 3, 4, 5, 6]       # all distinct: no repeat
    hist[1, :1] = [9]                      # too short for any n-gram
    hist[2, :7] = [5, 1, 2, 9, 9, 1, 2]    # tail (1, 2) repeats at 1
    got = ngram_match_device(torch.tensor(hist), torch.tensor([6, 1, 7]), k=3, nmin=1, nmax=3)
    assert (got[0] == -1).all() and (got[1] == -1).all()
    assert got[2].tolist() == [9, 9, 1]


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def tiny_bloom():
    """The JAX init_params of a tiny BLOOM, its norms and betas randomized
    and an embedding LayerNorm added (as BLOOM has), carried over."""
    jcfg = JModelConfig.from_hf_config(TINY_BLOOM)
    jparams = jllama.init_params(jcfg, seed=2)
    rng = np.random.default_rng(2)
    H = jcfg.hidden_size

    def rand(shape, mean):
        return jnp.asarray(mean + 0.1 * rng.standard_normal(shape), jnp.bfloat16)
    layers = dict(jparams["layers"])
    for name in ("input_norm", "post_norm"):
        layers[name] = rand(layers[name].shape, 1.0)
        layers[name + "_b"] = rand(layers[name].shape, 0.0)
    jparams = {**jparams, "layers": layers, "embed_norm": rand((H,), 1.0),
               "embed_norm_b": rand((H,), 0.0), "final_norm_b": rand((H,), 0.0)}
    cfg = ModelConfig.from_hf_config(TINY_BLOOM)
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    return jcfg, jparams, cfg, params


SCHED = dict(max_num_seqs=4, max_model_len=160, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))


def _prompts():
    r = np.random.default_rng(7)
    ps = [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40))))) for _ in range(4)]
    ps[2] = ps[2][:6] * 4                      # a repeated span
    return ps


def run_port(cfg, params, prompts, spec, max_tokens=20, temp=0.0, **over):
    cache = CacheConfig(page_size=16, num_pages=over.pop("num_pages", None))
    eng = LLMEngine(EngineConfig(model=cfg, cache=cache,
                                 scheduler=SchedulerConfig(**{**SCHED, **over}),
                                 speculative=spec), params, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=temp, max_tokens=max_tokens,
                                          ignore_eos=True))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    return [outs[i] for i in range(len(prompts))], eng


def run_jax(jcfg, jparams, prompts, spec, max_tokens=20):
    eng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                             scheduler=JSched(**SCHED), speculative=spec), jparams)
    for p in prompts:
        eng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=max_tokens,
                                           ignore_eos=True))
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in range(len(prompts))]


def _jax_last_logits(jcfg, jparams, ids, S=16):
    Q = len(ids)
    n_pages = -(-Q // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, n_pages + 1, S))
    pos = np.arange(Q, dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S),
                                  jnp.asarray(np.arange(1, n_pages + 1, dtype=np.int32)[None]),
                                  jnp.asarray([Q], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32), cache, batch,
                                     scheme="bf16")
    return np.asarray(logits[0, -1], np.float32)


@pytest.fixture(scope="module")
def jax_ngram(tiny_bloom):
    jcfg, jparams, _, _ = tiny_bloom
    return run_jax(jcfg, jparams, _prompts(), JSpec(num_speculative_tokens=3, method="ngram"),
                   max_tokens=32)


@pytest.mark.parametrize("rounds", [1, 2])
def test_greedy_ngram_equals_oracle_and_jax(tiny_bloom, jax_ngram, rounds):
    """Greedy n-gram == the port's "null" oracle (no proposal ever accepted
    there) == AR, bit for bit; == the JAX engine up to near-ties; the
    repeated span's proposals are accepted."""
    jcfg, jparams, cfg, params = tiny_bloom
    prompts = _prompts()
    spec, eng = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=3, method="ngram", rounds_per_step=rounds), max_tokens=32)
    oracle, eng0 = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=3, method="null", rounds_per_step=rounds), max_tokens=32)
    ar, _ = run_port(cfg, params, prompts, None, max_tokens=32)
    assert spec == oracle == ar
    assert all(len(t) == 32 for t in spec)
    assert eng.runner.draft_cache is None and eng.runner.verify_scheme == "bf16"
    assert eng.spec_metrics.num_draft_accepted > 0
    assert eng0.spec_metrics.num_draft_accepted == 0 and eng0.runner.spec_rounds_run > 0
    # every round is one forward of the target, and so is each prompt chunk
    assert eng.runner.target_forwards > eng.runner.spec_rounds_run > 0
    for i, p in enumerate(prompts):
        diff = [j for j, (a, b) in enumerate(zip(jax_ngram[i], spec[i])) if a != b]
        if diff:
            top2 = np.sort(_jax_last_logits(jcfg, jparams, p + jax_ngram[i][:diff[0]]))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (i, diff[0], top2)


def test_ngram_batch_changes_and_preemption(tiny_bloom, monkeypatch):
    """Two sequences at a time (the history rows are handed on) and a cache
    too small for all of them (recompute preemption: a row is written again
    from the host): n-gram still gives the oracle's tokens."""
    _, _, cfg, params = tiny_bloom
    preempted = []
    preempt = Scheduler._preempt_one

    def counted(self, *a, **kw):
        preempted.append(preempt(self, *a, **kw))
        return preempted[-1]
    monkeypatch.setattr(Scheduler, "_preempt_one", counted)
    prompts = _prompts()
    outs = []
    for method in ("ngram", "null"):
        out, eng = run_port(cfg, params, prompts, SpeculativeConfig(
            num_speculative_tokens=3, method=method), max_tokens=24, max_num_seqs=2,
            num_pages=6)
        outs.append(out)
    assert outs[0] == outs[1] and any(preempted)


def test_ngram_accepts_on_repetitive_prompt(tiny_bloom):
    _, _, cfg, params = tiny_bloom
    _, eng = run_port(cfg, params, [[11, 23, 7, 42] * 12], SpeculativeConfig(
        num_speculative_tokens=4, method="ngram", rounds_per_step=2), max_tokens=24)
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0 and m.num_draft_tokens > 0


def test_ngram_with_temperature_completes(tiny_bloom):
    _, _, cfg, params = tiny_bloom
    outs, eng = run_port(cfg, params, _prompts()[:3], SpeculativeConfig(
        num_speculative_tokens=3, method="ngram", rounds_per_step=2), max_tokens=12, temp=0.8)
    assert [len(t) for t in outs] == [12, 12, 12]
    assert eng.spec_metrics.num_emitted_tokens > 0


def test_engine_args_ngram():
    """speculative_model="[ngram]" selects prompt lookup, with "null" as
    its oracle and the lookup lengths passed on; a bf16 model refuses
    QSpec's draft."""
    args = EngineArgs(model="tiny", quantization=None, num_speculative_tokens=3,
                      speculative_model="[ngram]", ngram_prompt_lookup_max=3)
    spec = args.create_engine_config().speculative
    assert (spec.method, spec.ngram_prompt_lookup_max, spec.ngram_prompt_lookup_min) == (
        "ngram", 3, 1)
    args.speculative_method = "null"
    assert args.create_engine_config().speculative.method == "null"
    args.speculative_method = "medusa_null"
    with pytest.raises(ValueError):
        args.create_engine_config()
    cfg = ModelConfig.from_hf_config(TINY_BLOOM)
    with pytest.raises(ValueError, match="int4"):
        LLMEngine(EngineConfig(model=cfg, speculative=SpeculativeConfig(method="qspec")),
                  tllama.init_params(cfg, device="cpu"), device="cpu")
