"""Grammar-guided decoding and typical acceptance through the port's engine
and server on the CPU.

Model: the JAX package's tiny QuaRot Llama (init_params(ModelConfig.tiny(
quant="w4"), seed 0), the int8 head), carried over, with random Medusa
heads, an MLPSpeculator and an EAGLE net made by the port; vocabulary: the
toy byte vocabulary of tests/test_guided_decoding.py (EOS 0). Four requests
in one batch: a regex, a JSON schema, a choice and an unguided row.

Held: greedy guided tokens of the port against the JAX engine's (a
difference only at a near-tie of the JAX logits among the tokens the
grammar allows); inside the port, greedy guided speculation == greedy
guided AR bit for bit on every proposer (QSpec at W4A4 and W4A8, the
windowed W4A16 draft of a w4g checkpoint, a separate draft model, n-gram,
the Medusa chain, MLPSpeculator, EAGLE), and typical acceptance at greedy
== its oracle; every guided output walks its FSM, sampled ones too.
"""

import http.client
import json

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
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.entrypoints.llm import chat_token_ids
from qspec_tpu_torch.entrypoints.openai.api_server import ServerThread, build_server
from qspec_tpu_torch.entrypoints.openai.tool_parser import (forced_call_schema,
                                                            parse_tool_calls,
                                                            tools_system_message)
from qspec_tpu_torch.guided import GrammarCompiler, hf_vocab_bytes
from qspec_tpu_torch.models.llama import init_params, params_from_numpy
from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
from qspec_tpu_torch.spec_decode.medusa import init_medusa_params
from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE
from qspec_tpu_torch.spec_decode.mlp_speculator import init_mlp_speculator_params

# a step where the two packages may pick different greedy tokens must be a
# near-tie among the allowed tokens of the JAX logits (tests/test_torch_engine.py)
TIE_GAP = 2e-2
MAX_TOKENS = 16
REGEX = r"\[\d(,\d)*\]"
SCHEMA = {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 4}
CHOICE = ["[1,2]", "aaa", "0"]
# (prompt, guided option): the batch of every test
REQUESTS = [([5, 6, 7], {"guided_regex": REGEX}),
            ([8, 9, 10, 11], {"guided_json": SCHEMA}),
            ([12, 3, 4], {"guided_choice": CHOICE}),
            ([20, 21, 22, 23, 24], {})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_vocab(vsize=512):
    """tests/test_guided_decoding.py's: id 0 eos; 1..9 the digits '1'..'9';
    10 ','; 11 '['; 12 ']'; 13 '0'; 14 'a'; 15 '"'; the rest unmappable."""
    vocab = [None] * vsize
    for i in range(1, 10):
        vocab[i] = str(i).encode()
    vocab[10], vocab[11], vocab[12] = b",", b"[", b"]"
    vocab[13], vocab[14], vocab[15] = b"0", b"a", b'"'
    return vocab


@pytest.fixture(scope="module")
def tiny():
    jcfg = JModel.tiny(quant="w4")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    H, V = cfg.hidden_size, cfg.vocab_size
    params = {**params,
              "medusa": init_medusa_params(H, V, k=3, seed=5, device="cpu"),
              "mlp_spec": init_mlp_speculator_params(H, V, k=3, seed=3, scale_input=True,
                                                     device="cpu"),
              "eagle": init_eagle_params(cfg, seed=4, device="cpu")}
    return jcfg, jparams, cfg, params


def _sched(**over):
    d = dict(max_num_seqs=4, max_model_len=128, prefill_chunk_size=32,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(32,))
    d.update(over)
    return d


def run(cfg, params, spec=None, temp=0.0, draft_params=None, requests=REQUESTS, **kw):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched()), speculative=spec),
                    params, eos_token_id=0, device="cpu", draft_params=draft_params,
                    grammar_vocab=toy_vocab(cfg.vocab_size), **kw)
    for p, g in requests:
        eng.add_request(p, SamplingParams(temperature=temp, top_p=0.95 if temp else 1.0,
                                          max_tokens=MAX_TOKENS, **g))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 400
    return [outs[i] for i in range(len(requests))], eng


def fsm_of(gc: GrammarCompiler, g: dict):
    if "guided_regex" in g:
        return gc.from_regex(g["guided_regex"])
    if "guided_json" in g:
        return gc.from_json_schema(g["guided_json"])
    if "guided_choice" in g:
        return gc.from_choice(g["guided_choice"])
    return None


def walk(fsm, toks, eos=0):
    """The FSM's state after ``toks`` (EOS included: it self-loops at an
    accepting state), -1 where a token is not allowed."""
    s = 0
    for t in toks:
        s = int(fsm.next_state[s, t])
        if s < 0:
            return -1
    return s


def check_walks(outs, requests=REQUESTS, vocab=None):
    gc = GrammarCompiler(vocab or toy_vocab(), eos_token_id=0)
    for toks, (_, g) in zip(outs, requests):
        fsm = fsm_of(gc, g)
        if fsm is not None:
            assert toks and walk(fsm, toks) >= 0, (g, toks)


def _jax_last_logits(jcfg, jparams, ids, S=16):
    Q = len(ids)
    n_pages = -(-Q // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, n_pages + 1, S))
    pos = np.arange(Q, dtype=np.int32)[None]
    tables = np.arange(1, n_pages + 1, dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S), jnp.asarray(tables),
                                  jnp.asarray([Q], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32), cache,
                                     batch, scheme="w4a16")
    return np.asarray(logits[0, -1])


@pytest.fixture(scope="module")
def jax_guided(tiny):
    """The JAX engine's greedy guided tokens (AR) on the same weights."""
    jcfg, jparams, _, _ = tiny
    eng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                             scheduler=JSched(**_sched())), jparams, eos_token_id=0,
                     grammar_vocab=toy_vocab())
    for p, g in REQUESTS:
        eng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, **g))
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in range(len(REQUESTS))]


@pytest.fixture(scope="module")
def port_ar(tiny):
    _, _, cfg, params = tiny
    return run(cfg, params)[0]


@pytest.mark.parametrize("spec", [None, "qspec"])
def test_guided_tokens_match_jax_engine(tiny, jax_guided, port_ar, spec):
    """The port's greedy guided tokens (AR, and QSpec at W4A4) against the
    JAX engine's: equal, or a first difference at a near-tie of the JAX
    logits among the tokens the grammar allows there."""
    jcfg, jparams, cfg, params = tiny
    got = port_ar if spec is None else run(cfg, params,
                                           SpeculativeConfig(num_speculative_tokens=3))[0]
    gc = GrammarCompiler(toy_vocab(), eos_token_id=0)
    for (p, g), ref, mine in zip(REQUESTS, jax_guided, got):
        diff = [j for j, (a, b) in enumerate(zip(ref, mine)) if a != b]
        if not diff:
            assert ref == mine
            continue
        j = diff[0]
        logits = _jax_last_logits(jcfg, jparams, p + ref[:j])
        fsm = fsm_of(gc, g)
        if fsm is not None:
            logits = np.where(fsm.next_state[walk(fsm, ref[:j])] >= 0, logits, -np.inf)
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE_GAP, (g, j, top2)
    check_walks(got)
    # the guided rows end on EOS (or the budget); the regex and the choice
    # open as their grammars demand
    assert got[0][0] == 11 and got[2][0] in (11, 14, 13)


SPECS = {
    "qspec_w4a4": SpeculativeConfig(num_speculative_tokens=3),
    "qspec_w4a8": SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a8",
                                    rounds_per_step=2),
    "ngram": SpeculativeConfig(num_speculative_tokens=3, method="ngram"),
    "medusa": SpeculativeConfig(num_speculative_tokens=3, method="medusa"),
    "mlp_speculator": SpeculativeConfig(num_speculative_tokens=3, method="mlp_speculator",
                                        rounds_per_step=2),
    "eagle": SpeculativeConfig(num_speculative_tokens=3, method="eagle"),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_guided_spec_equals_ar(tiny, port_ar, name):
    """Greedy guided speculation == greedy guided AR, bit for bit: the
    drafts (QSpec's masked too) are verified position by position under
    the state reached through the drafts before them."""
    _, _, cfg, params = tiny
    got, eng = run(cfg, params, SPECS[name])
    assert got == port_ar
    assert eng.spec_metrics.num_spec_rounds > 0
    check_walks(got)


def test_guided_qspec_accepts_drafts(tiny, port_ar):
    """The grammar-masked W4A8 drafts are accepted: most of them at this
    draft, which agrees with the target."""
    _, _, cfg, params = tiny
    got, eng = run(cfg, params, SPECS["qspec_w4a8"])
    m = eng.spec_metrics
    assert got == port_ar and m.num_draft_accepted > 0, (m.num_draft_tokens,
                                                         m.num_draft_accepted)


def test_guided_windowed_w4g_draft():
    """The windowed W4A16 draft of an AWQ-style (w4g) checkpoint on its ring
    pool: guided spec == guided AR."""
    cfg = ModelConfig.tiny(quant="w4g")
    params = init_params(cfg, seed=1, device="cpu", group_size=64)
    ar = run(cfg, params)[0]
    got, eng = run(cfg, params, SpeculativeConfig(num_speculative_tokens=3,
                                                  draft_scheme="w4a16", draft_kv_window=24))
    assert got == ar and eng.runner._ring_pages
    check_walks(got)


def test_guided_separate_draft_model(tiny, port_ar):
    _, _, cfg, params = tiny
    dc = ModelConfig.tiny(quant="w4", num_layers=1, hidden_size=128, intermediate_size=192,
                          num_heads=2, num_kv_heads=2)
    got, _ = run(cfg, params, SpeculativeConfig(num_speculative_tokens=3, draft_model=dc),
                 draft_params=init_params(dc, seed=3, device="cpu"))
    assert got == port_ar


@pytest.mark.parametrize("scheme", ["w4a4", "w4a8"])
def test_typical_acceptance_greedy_equals_oracle(tiny, port_ar, scheme):
    """At temperature 0 typical acceptance accepts a draft iff it is the
    target's argmax, so its tokens are the oracle's (qspec_null) and AR's."""
    _, _, cfg, params = tiny
    typ = dict(num_speculative_tokens=3, draft_scheme=scheme,
               acceptance_method="typical_acceptance_sampler")
    got, eng = run(cfg, params, SpeculativeConfig(**typ))
    oracle, _ = run(cfg, params, SpeculativeConfig(**{**typ, "method": "qspec_null"}))
    assert got == oracle == port_ar
    assert eng.runner.acceptance == "typical_acceptance_sampler"


def test_guided_unguided_request_unchanged(tiny):
    """The unguided row of a guided batch gets the tokens it gets alone."""
    _, _, cfg, params = tiny
    spec = SPECS["qspec_w4a8"]
    mixed = run(cfg, params, spec)[0]
    alone = run(cfg, params, spec, requests=REQUESTS[3:])[0]
    assert mixed[3] == alone[0]


@pytest.mark.parametrize("name", ["qspec_w4a8", "ngram", "medusa", "eagle", None])
def test_sampled_guided_outputs_walk_their_fsms(tiny, name):
    """Temperature 0.8, top_p 0.95: every guided output is a prefix the
    grammar allows (EOS only where it accepts)."""
    _, _, cfg, params = tiny
    for seed in (0, 1):
        got, _ = run(cfg, params, None if name is None else SPECS[name], temp=0.8, seed=seed)
        check_walks(got)


def test_medusa_tree_with_a_grammar_raises(tiny):
    _, _, cfg, params = tiny
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched()),
                                 speculative=SpeculativeConfig(
                                     num_speculative_tokens=3, method="medusa",
                                     medusa_tree=tuple(p for p in DEFAULT_TREE if len(p) <= 3))),
                    params, device="cpu", grammar_vocab=toy_vocab())
    with pytest.raises(ValueError, match="medusa candidate tree"):
        eng.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4,
                                                  guided_regex="a+"))
    # without a grammar the tree serves
    eng.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4))


def test_guided_needs_a_vocabulary(tiny):
    _, _, cfg, params = tiny
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched())), params,
                    device="cpu")
    with pytest.raises(ValueError, match="needs a tokenizer or grammar_vocab"):
        eng.add_request([1, 2], SamplingParams(guided_choice=["a"]))
    # from a tokenizer's vocabulary (hf_vocab_bytes)
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched())), params,
                    eos_token_id=0, device="cpu", tokenizer=CharTokenizer())
    eng.add_request([1, 2], SamplingParams(temperature=0.0, max_tokens=8,
                                           guided_choice=["hello", "world"]))
    while eng.has_unfinished_requests():
        outs = [o for o in eng.step() if o.finished]
    assert outs[0].text in ("hello", "world")
    with pytest.raises(ValueError):
        eng.add_request([1], SamplingParams(guided_regex="(ab"))


def test_acceptance_method_checked():
    with pytest.raises(ValueError, match="acceptance_method"):
        SpeculativeConfig(acceptance_method="greedy")
    args = EngineArgs(model="tiny", num_speculative_tokens=2,
                      spec_acceptance_method="typical_acceptance_sampler")
    assert args.create_engine_config().speculative.acceptance_method == \
        "typical_acceptance_sampler"
    cfg = ModelConfig.tiny(quant="w4")
    with pytest.raises(ValueError, match="QSpec rounds"):
        LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                               scheduler=SchedulerConfig(**_sched()),
                               speculative=SpeculativeConfig(
                                   num_speculative_tokens=2, method="ngram",
                                   acceptance_method="typical_acceptance_sampler")),
                  init_params(cfg, device="cpu"), device="cpu")


# ------------------------------------------------------------- the server

class CharTokenizer:
    """A byte-level tokenizer that ``hf_vocab_bytes`` reads: id 0 the EOS
    special, ids 1..95 the printable ASCII characters, then a few pieces of
    several characters (tokens that cross DFA edges); 120 ids, fewer than
    the model's 512 (the grammar bans the rest). A chat template joins the
    messages' contents."""

    eos_token_id = 0
    all_special_ids = [0]
    PIECES = ['{"', '":', '","', '"}', "name", "arguments", "get_weather", '":{"', "}}",
              "hello", "world", "ab"]

    def __init__(self):
        pieces = ["</s>"] + [chr(c) for c in range(32, 127)] + self.PIECES
        pieces += [f"<x{i}>" for i in range(120 - len(pieces))]
        self.pieces = pieces
        self._vocab = {p: i for i, p in enumerate(pieces)}

    @property
    def vocab_size(self):
        return len(self.pieces)

    def get_vocab(self):
        return dict(self._vocab)

    def convert_tokens_to_string(self, toks):
        return "".join(toks)

    def encode(self, text):
        return [self._vocab.get(c, self._vocab["?"]) for c in text]

    def decode(self, ids):
        return "".join(self.pieces[i] for i in ids if 0 < i < len(self.pieces))

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        return self.encode(" ".join(m["content"] for m in messages))


TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {"type": "object", "properties": {
        "unit": {"enum": ["c", "f"]}, "days": {"enum": [1, 2, 3]}},
        "required": ["unit", "days"]}}},
    {"type": "function", "function": {"name": "f"}}]
SERVER = dict(model="tiny", max_model_len=1024, max_num_seqs=4, num_speculative_tokens=2)


def post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    if r.getheader("Content-Type", "") == "text/event-stream":
        lines = [ln.strip() for ln in data.decode().splitlines() if ln.strip()]
        assert lines[-1] == "data: [DONE]"
        return r.status, [json.loads(ln[6:]) for ln in lines[:-1]]
    return r.status, json.loads(data)


@pytest.fixture(scope="module")
def served(tiny):
    """A server over the tiny model with CharTokenizer, and LLM.generate of
    the same engine config."""
    _, _, _, params = tiny
    params = {k: v for k, v in params.items() if k not in ("medusa", "mlp_spec", "eagle")}
    server = build_server(EngineArgs(**SERVER), model_name="tiny-guided", params=params,
                          device="cpu", tokenizer=CharTokenizer())
    llm = LLM(params=params, tokenizer=CharTokenizer(), device="cpu", **SERVER)
    with ServerThread(server) as st:
        yield st.port, llm


@pytest.mark.parametrize("choice", ["required", "named"])
def test_forced_tool_choice_over_http(served, choice):
    """tool_choice "required" or a named function: the reply's tool_calls
    parse and equal LLM.generate under the same guided_json, streamed or
    not."""
    port, llm = served
    messages = [{"role": "user", "content": "weather?"}]
    tc = "required" if choice == "required" else {"type": "function",
                                                   "function": {"name": "get_weather"}}
    status, data = post(port, "/v1/chat/completions", {
        "messages": messages, "tools": TOOLS, "tool_choice": tc, "temperature": 0.0,
        "max_tokens": 96})
    assert status == 200, data
    c = data["choices"][0]
    assert c["finish_reason"] == "tool_calls"
    calls = c["message"]["tool_calls"]
    assert len(calls) == 1 and calls[0]["type"] == "function"
    fn = calls[0]["function"]
    if choice == "named":
        assert fn["name"] == "get_weather"
    args = json.loads(fn["arguments"])
    assert args == {} if fn["name"] == "f" else set(args) == {"unit", "days"}
    tok = CharTokenizer()
    ids = chat_token_ids(tok, [tools_system_message(TOOLS)] + messages)
    schema = forced_call_schema(TOOLS, None if choice == "required" else "get_weather")
    want = llm.generate([ids], SamplingParams(temperature=0.0, max_tokens=96,
                                              guided_json=schema))[0]
    _, want_calls = parse_tool_calls(want.text, [t["function"]["name"] for t in TOOLS])
    assert [w["function"] for w in want_calls] == [fn]
    status, chunks = post(port, "/v1/chat/completions", {
        "messages": messages, "tools": TOOLS, "tool_choice": tc, "temperature": 0.0,
        "max_tokens": 96, "stream": True})
    deltas = [ch["choices"][0]["delta"] for ch in chunks]
    streamed = [d["tool_calls"][0]["function"] for d in deltas if "tool_calls" in d]
    assert status == 200 and streamed == [fn]
    assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"


@pytest.mark.parametrize("option", ["guided_regex", "guided_json", "guided_choice"])
def test_guided_completion_over_http(served, option):
    port, llm = served
    value = {"guided_regex": r"(ab)+c", "guided_choice": ["hello", "world"],
             "guided_json": {"type": "object", "properties": {
                 "name": {"enum": ["ab", "c"]}, "n": {"type": "integer"}},
                 "required": ["name"]}}[option]
    body = {"prompt": "say:", "max_tokens": 24, "temperature": 0.0, option: value}
    status, data = post(port, "/v1/completions", body)
    assert status == 200, data
    text = data["choices"][0]["text"]
    want = llm.generate([CharTokenizer().encode("say:")], SamplingParams(
        temperature=0.0, max_tokens=24, **{option: value}))[0]
    assert text == want.text
    gc = GrammarCompiler(hf_vocab_bytes(CharTokenizer()), eos_token_id=0)
    assert walk(fsm_of(gc, {option: value}), want.output_token_ids) >= 0
    if option == "guided_choice":
        assert text in value


def test_guided_errors_answer_400(served):
    port, _ = served
    status, data = post(port, "/v1/completions", {"prompt": "x", "guided_regex": "(ab"})
    assert status == 400
    status, data = post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "nope"}}})
    assert status == 400 and "unknown tool" in data["message"]
    # a forced call cut by max_tokens
    status, data = post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "tools": TOOLS,
        "tool_choice": "required", "max_tokens": 3, "temperature": 0.0})
    assert status == 400 and "truncated" in data["message"]


# -------------------------------------------------- induction_lm_v2 (I2)

def test_induction_guided_drafts_accepted():
    """chip_smoke.py (I2) on the CPU: induction_lm_v2 (quantize_float, bf16
    head), greedy W4A4 QSpec (k = 3), 4 prompts of 128, 32 tokens, each
    prompt under the grammar of its own segment's tokens (the copy it
    continues with satisfies it; every other token is banned). Tokens ==
    qspec_null's, grammar-masked drafts accepted, and the counts the card
    must give (chip_smoke.GUIDED_INDUCTION_DAE)."""
    import chip_smoke
    from qspec_tpu_torch.model_loader.loader import quantize_float
    with np.load(chip_smoke.INDUCTION + ".npz") as z:
        sd = {k: z[k] for k in z.files}
    with open(chip_smoke.INDUCTION + ".json") as f:
        meta = json.load(f)["cfg"]
    names = set(ModelConfig.__dataclass_fields__)
    params, cfg = quantize_float(sd, ModelConfig(**{k: v for k, v in meta.items()
                                                   if k in names}), device="cpu")
    prompts = chip_smoke.induction_prompts(4, 128, cfg.vocab_size)
    vocab = [None, None] + [f"<{t}>".encode() for t in range(2, cfg.vocab_size)]
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                            decode_batch_buckets=(4,), prefill_token_buckets=(128,))
    out = {}
    for method in ("qspec", "qspec_null"):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=sched,
                                     speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                                   method=method)),
                        params, device="cpu", grammar_vocab=vocab)
        ids = [eng.add_request(p, SamplingParams(
            temperature=0.0, max_tokens=32, ignore_eos=True,
            guided_regex=chip_smoke.induction_grammar(p))) for p in prompts]
        done = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        m = eng.spec_metrics
        out[method] = ([done[i] for i in ids],
                       [m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens])
    toks, dae = out["qspec"]
    assert toks == out["qspec_null"][0]
    gc = GrammarCompiler(vocab)
    for p, t in zip(prompts, toks):
        assert walk(gc.from_regex(chip_smoke.induction_grammar(p)), t) >= 0
        assert set(t) <= set(p)
    assert dae[1] > 0 and dae == chip_smoke.GUIDED_INDUCTION_DAE
