"""Stop strings, the incremental detokenizer and top-n logprobs of the port,
held against the JAX package on the same token streams.

Tokenizer: ``IdTokenizer``, lossless (id i decodes to "<i>"), so a stop
string can straddle two tokens ("3><1"). Model: the tiny QuaRot Llama of
tests/test_torch_engine.py (qspec_tpu init_params seed 0, bf16 head,
carried over with params_from_numpy); its prompts (numpy seed 7).
"""

import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.core.sequence import Sequence as JSequence
from qspec_tpu.detokenizer import DetokState as JDetokState
from qspec_tpu.detokenizer import detokenize_incrementally as j_detok
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops.sampling import top_logprobs as j_top_logprobs
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.core.sequence import Sequence
from qspec_tpu_torch.detokenizer import DetokState, detokenize_incrementally
from qspec_tpu_torch.models.llama import params_from_numpy
from qspec_tpu_torch.ops.sampling import top_logprobs

MAX_TOKENS = 16
# the logprob values of the two packages' forwards differ by their
# rounding (bf16 activations); the engine tests' near-tie gap
LOGPROB_ATOL = 2e-2


class IdTokenizer:
    """Lossless: id i <-> "<i>"."""

    eos_token_id = None

    def encode(self, text):
        return [int(t) for t in re.findall(r"<(\d+)>", text)]

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


class ByteTokenizer:
    """Each id one UTF-8 byte: every multi-byte character splits across
    tokens (tests/test_detokenizer.py's). ``calls``: each decode's window."""

    def __init__(self):
        self.calls = []

    def decode(self, ids):
        self.calls.append(len(ids))
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


SCHED = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))


def run_port(setup, sp, k=None, prompts=None):
    _, _, cfg, params, all_prompts = setup
    spec = SpeculativeConfig(num_speculative_tokens=k) if k else None
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**SCHED), speculative=spec),
                    params, device="cpu", tokenizer=IdTokenizer())
    return _drain(eng, prompts or all_prompts[:1], sp)


def run_jax(setup, sp, k=None, prompts=None):
    jcfg, jparams, _, _, all_prompts = setup
    spec = JSpec(num_speculative_tokens=k) if k else None
    eng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                             scheduler=JSched(**SCHED), speculative=spec), jparams,
                     tokenizer=IdTokenizer())
    return _drain(eng, prompts or all_prompts[:1], sp)


def _drain(eng, prompts, sp):
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o
    return [outs[i] for i in ids]


def _common(a, b) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


# ------------------------------------------------------------ stop strings

def _feed(check, seq, stream, chunks):
    """Append ``stream`` to ``seq`` in steps of the sizes in ``chunks``,
    running the stop check after each step, as the engine does."""
    pos = 0
    for c in chunks:
        if seq.is_finished or pos >= len(stream):
            break
        for t in stream[pos:pos + c]:
            seq.append_token(t, -0.5)
        pos += c
        check(seq)


@pytest.mark.parametrize("case", range(12))
def test_stop_string_check_matches_jax(case):
    """The same token stream fed in the same steps through the port's and
    the JAX package's stop-string check: the same truncated ids, stop_text
    and finish reason, with include_stop_str_in_output both ways; the
    stop string straddles tokens (and steps) in most cases."""
    rng = np.random.default_rng(100 + case)
    tok = IdTokenizer()
    stream = [int(t) for t in rng.integers(1, 40, size=30)]
    text = tok.decode(stream)
    chunks = [int(c) for c in rng.integers(1, 5, size=30)]
    start = int(rng.integers(3, len(text) - 10))
    stops = [text[start:start + int(rng.integers(2, 9))]]
    if case % 4 == 3:
        stops = ["<999>"]          # never emitted: runs to the end
    elif case % 4 == 2:
        stops.append(text[start + 4:start + 7])   # two stops, the earliest wins
    fake = SimpleNamespace(tokenizer=tok)
    for include in (False, True):
        sp_kw = dict(temperature=0.0, max_tokens=64, stop=stops,
                     include_stop_str_in_output=include)
        jseq = JSequence(0, [1, 2], JSamplingParams(**sp_kw))
        seq = Sequence(0, [1, 2], SamplingParams(**sp_kw))
        _feed(lambda s: JLLMEngine._check_stop_strings(fake, s), jseq, stream, chunks)
        _feed(lambda s: LLMEngine._check_stop_strings(fake, s), seq, stream, chunks)
        assert seq.output_token_ids == jseq.output_token_ids
        assert seq.output_logprobs == jseq.output_logprobs
        assert seq.stop_text == jseq.stop_text
        assert seq.finish_reason == jseq.finish_reason
        if stops != ["<999>"]:
            assert seq.finish_reason == "stop"
            cut = tok.decode(seq.output_token_ids)
            hit, first = min((cut.find(s), s) for s in stops if s in cut)
            # the shortest prefix holding a stop string, cut before it or
            # after it
            assert not any(s in tok.decode(seq.output_token_ids[:-1]) for s in stops)
            assert seq.stop_text == (cut[:hit + len(first)] if include else cut[:hit])


@pytest.mark.parametrize("k", [None, 3], ids=["ar", "qspec3"])
def test_stop_string_engine_matches_jax(setup, k):
    """The port's engine (AR, and QSpec at k = 3, whose steps add several
    tokens) and the JAX engine (AR) with a stop string that straddles two
    tokens of their common greedy stream: the same ids, text and finish
    reason, with include_stop_str_in_output both ways."""
    sp = dict(temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True)
    port = run_port(setup, SamplingParams(**sp), k)[0]
    ref = run_jax(setup, JSamplingParams(**sp))[0]
    n = _common(port.output_token_ids, ref.output_token_ids)
    assert n >= 8, (port.output_token_ids, ref.output_token_ids)
    tok = IdTokenizer()
    a, b = tok.decode([port.output_token_ids[5]]), tok.decode([port.output_token_ids[6]])
    stop = a[-2:] + b[:2]          # "N><M": straddles two tokens
    for include in (False, True):
        sp_stop = dict(sp, stop=[stop], include_stop_str_in_output=include)
        got = run_port(setup, SamplingParams(**sp_stop), k)[0]
        want = run_jax(setup, JSamplingParams(**sp_stop))[0]
        assert got.output_token_ids == want.output_token_ids
        assert got.text == want.text
        assert got.finish_reason == want.finish_reason == "stop"
        # the shortest prefix of the free stream whose text holds it
        m = next(m for m in range(1, n + 1)
                 if stop in tok.decode(port.output_token_ids[:m]))
        assert m >= 2 and got.output_token_ids == port.output_token_ids[:m]
        assert got.text.endswith(stop) == include


def test_stop_strings_need_a_tokenizer(setup):
    _, _, cfg, params, _ = setup
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=8),
                                 scheduler=SchedulerConfig(**SCHED)), params, device="cpu")
    with pytest.raises(NotImplementedError, match="tokenizer"):
        eng.add_request([1, 2], SamplingParams(stop=["x"]))


# ------------------------------------------------------------ detokenizer

def test_detokenizer_multibyte_across_updates():
    """tests/test_detokenizer.py's case, through both packages: no U+FFFD
    in any delta, the same text after every update, the whole text at the
    end."""
    text = "héllo € wörld 你好"
    ids = list(text.encode("utf-8"))
    st, jst = DetokState(), JDetokState()
    rng = np.random.default_rng(0)
    emitted, i = "", 0
    while i < len(ids):
        i = min(len(ids), i + int(rng.integers(1, 4)))
        full = detokenize_incrementally(ByteTokenizer(), ids[:i], st)
        assert full == j_detok(ByteTokenizer(), ids[:i], jst)
        assert "�" not in full[len(emitted):]
        emitted = full
    assert emitted == text


def test_detokenizer_window_stays_bounded():
    ids = list(("abcdefgh" * 200).encode("utf-8"))
    tok = ByteTokenizer()
    st = DetokState()
    for i in range(1, len(ids) + 1):
        detokenize_incrementally(tok, ids[:i], st)
    assert max(tok.calls) < 16, "incremental decode re-read a long window"
    assert st.text == "abcdefgh" * 200


# ------------------------------------------------------------ top-n logprobs

@pytest.mark.parametrize("n", [1, 5, 20])
def test_top_logprobs_matches_jax(n):
    logits = np.random.default_rng(n).standard_normal((4, 512)).astype(np.float32) * 3
    vals, ids = top_logprobs(torch.from_numpy(logits), n)
    jvals, jids = j_top_logprobs(logits, n)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    assert tuple(vals.shape) == tuple(ids.shape) == (4, n)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))   # no ties


def _check_top_dicts(got, want, n):
    """Each position's {id: logprob}: n entries; where the two packages'
    top n are apart by more than the tolerance, the same ids, and values
    within it."""
    assert len(got) == n
    g, w = sorted(got.items(), key=lambda kv: -kv[1]), sorted(want.items(), key=lambda kv: -kv[1])
    for (gi, gv), (wi, wv) in zip(g, w):
        assert abs(gv - wv) < LOGPROB_ATOL
    wv = [v for _, v in w]
    if min(np.diff(wv) * -1, default=1.0) > 2 * LOGPROB_ATOL:
        assert [i for i, _ in g] == [i for i, _ in w]


def test_top_logprob_dicts_ar_match_jax(setup):
    """logprobs=3 on the AR path: a dict at every position (the prefill's
    first token and each decode step), against the JAX engine's on the
    positions where the streams agree; the chosen token's logprob beside."""
    prompts = setup[4][:2]
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True, logprobs=3)
    port = run_port(setup, SamplingParams(**sp), prompts=prompts)
    ref = run_jax(setup, JSamplingParams(**sp), prompts=prompts)
    for got, want in zip(port, ref):
        assert len(got.top_logprobs) == len(got.output_token_ids) == 8
        n = _common(got.output_token_ids, want.output_token_ids)
        assert n >= 4
        for j in range(n):
            _check_top_dicts(got.top_logprobs[j], want.top_logprobs[j], 3)
            assert got.output_token_ids[j] in got.top_logprobs[j]
            assert got.top_logprobs[j][got.output_token_ids[j]] == pytest.approx(
                got.logprobs[j], abs=1e-6)
        np.testing.assert_allclose(got.logprobs[:n], want.logprobs[:n], atol=LOGPROB_ATOL)


def test_top_logprob_dicts_spec_rounds_are_none(setup):
    """QSpec (k = 3) with logprobs=3: the prefill's position has its dict,
    every position a speculative round emitted has None, as in the JAX
    engine; logprobs=1 returns no dicts at all."""
    prompts = setup[4][:1]
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True, logprobs=3)
    got = run_port(setup, SamplingParams(**sp), k=3, prompts=prompts)[0]
    want = run_jax(setup, JSamplingParams(**sp), k=3, prompts=prompts)[0]
    assert [d is None for d in got.top_logprobs] == [d is None for d in want.top_logprobs] \
        == [False] + [True] * 7
    _check_top_dicts(got.top_logprobs[0], want.top_logprobs[0], 3)
    one = run_port(setup, SamplingParams(**dict(sp, logprobs=1)), k=3, prompts=prompts)[0]
    assert one.top_logprobs is None and len(one.logprobs) == 8
