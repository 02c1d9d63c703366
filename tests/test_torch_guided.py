"""The port's grammar compiler, grammar masks and typical acceptance on the
CPU, held against the JAX package's.

The compiler (``qspec_tpu_torch/guided/``) is a copy in pure Python and
numpy, so its byte DFAs, schema regexes and token-FSM tables must be EQUAL
to the JAX package's for the patterns and schemas of tests/test_grammar.py
and tests/test_guided_decoding.py, on the toy vocabulary of the latter and
on a vocabulary of multi-byte tokens. The masks and the advance are equal
on random tables; ``sampling_probs`` under a grammar agrees within 1e-6;
typical acceptance gives the same tokens and lengths, logprobs within 1e-6.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu import guided as jg
from qspec_tpu.engine.model_runner import make_sampling_tensors as j_make_st
from qspec_tpu.ops import sampling as js
from qspec_tpu_torch import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig
from qspec_tpu_torch import guided as pg
from qspec_tpu_torch.core.sequence import Sequence
from qspec_tpu_torch.engine.model_runner import ModelRunner, make_sampling_tensors
from qspec_tpu_torch.guided.json_schema import _esc
from qspec_tpu_torch.ops import sampling as ps
from qspec_tpu_torch.sampling_params import SamplingParams

# tests/test_grammar.py's patterns, and those of tests/test_guided_decoding.py
PATTERNS = [r"abc", r"a*b+", r"(foo|bar)+", r"[a-c]{2,3}", r"-?\d+(\.\d+)?",
            r'"[^"\n]*"', r"a.c", r"(ab){1,2}c", r"\w+@\w+\.(com|org)", r"(a|b){2,}",
            r"héllo", r"[\x41-\x43]+", r"\[(\d+)(,\d+)*\]", r"\[\d(,\d)*\]", r"a+", r"ab"]
SCHEMAS = [
    {"enum": ["red", "green", 3]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 2, "maxItems": 3},
    {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    {"type": "string", "format": "uuid"},
    {"type": "string", "minLength": 2, "maxLength": 4},
    {"type": "boolean"},
    {"type": "number"},
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"},
                                      "nick": {"type": "string"}},
     "required": ["name", "age"]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1, "maxItems": 4},
    # a forced tool call's schema (tool_parser.forced_call_schema)
    {"type": "object", "properties": {"name": {"const": "get_weather"},
                                      "arguments": {"type": "object", "properties": {
                                          "city": {"type": "string"},
                                          "days": {"type": "integer"}},
                                          "required": ["city"]}},
     "required": ["name", "arguments"]},
]
CHOICES = [["yes", "no"], ["red", "green", "a.b(c)"]]


def _toy_vocab(vsize=512):
    """tests/test_guided_decoding.py's: id 0 eos; 1..9 the digits '1'..'9';
    10 ','; 11 '['; 12 ']'; 13 '0'; 14 'a'; 15 '"'; the rest unmappable."""
    vocab = [None] * vsize
    for i in range(1, 10):
        vocab[i] = str(i).encode()
    vocab[10], vocab[11], vocab[12] = b",", b"[", b"]"
    vocab[13], vocab[14], vocab[15] = b"0", b"a", b'"'
    return vocab


def _multibyte_vocab():
    """Every printable ASCII byte, then tokens of 2-4 bytes that cross DFA
    edges (and a 2-byte UTF-8 character), a special (None) and EOS at 0."""
    vocab = [None] + [bytes([b]) for b in range(32, 127)]
    vocab += [b"ab", b"abc", b"12", b'",', b'": ', b'":', b"[1", b"],", b"foo", b"bar",
              b"true", b"null", b"\xc3\xa9", b"h\xc3\xa9", b"llo", b'{"', b'"}', b"com", None]
    return vocab


VOCABS = {"toy": _toy_vocab, "multibyte": _multibyte_vocab}


@pytest.mark.parametrize("pat", PATTERNS)
def test_byte_dfa_equals_jax(pat):
    a, b = pg.compile_regex(pat), jg.compile_regex(pat)
    assert np.array_equal(a.table, b.table) and a.table.dtype == b.table.dtype
    assert np.array_equal(a.accepting, b.accepting)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_regex_equals_jax(i):
    sch = SCHEMAS[i]
    assert pg.schema_to_regex(sch) == jg.schema_to_regex(sch)
    # a schema given as a JSON string compiles to the same regex
    assert pg.schema_to_regex(json.dumps(sch)) == jg.schema_to_regex(json.dumps(sch))
    d = pg.compile_regex(pg.schema_to_regex(sch))
    assert np.array_equal(d.table, jg.compile_regex(jg.schema_to_regex(sch)).table)


def test_esc_equals_jax():
    from qspec_tpu.guided.json_schema import _esc as j_esc
    for lit in ["a.b", "x|y", "(1)", "[q]", "a\\b", "^-$", "plain", 'q"uote']:
        assert _esc(lit) == j_esc(lit)


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("pat", PATTERNS)
def test_token_fsm_equals_jax(vocab, pat):
    v = VOCABS[vocab]()
    a = pg.build_token_fsm(pg.compile_regex(pat), v, 0, pat)
    b = jg.build_token_fsm(jg.compile_regex(pat), v, 0, pat)
    assert np.array_equal(a.next_state, b.next_state) and a.next_state.dtype == np.int32
    assert a.num_states == b.num_states and a.pattern == b.pattern
    assert np.array_equal(a.allowed(0), b.allowed(0))


@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_grammar_compiler_equals_jax(vocab):
    v = VOCABS[vocab]()
    pc, jc = pg.GrammarCompiler(v, eos_token_id=0), jg.GrammarCompiler(v, eos_token_id=0)
    for sch in SCHEMAS:
        a, b = pc.from_json_schema(sch), jc.from_json_schema(sch)
        assert np.array_equal(a.next_state, b.next_state) and a.pattern == b.pattern
        # cached: the same object for the same schema
        assert pc.from_json_schema(dict(sch)) is a
    for ch in CHOICES:
        assert np.array_equal(pc.from_choice(ch).next_state, jc.from_choice(ch).next_state)
    assert pc.from_regex("a+") is pc.from_regex("a+")


class ByteTokenizer:
    """A Hugging Face-like tokenizer: byte-level pieces with "Ġ" for a space,
    two specials (<s> 0, </s> 1)."""

    all_special_ids = [0, 1]

    def __init__(self):
        pieces = ["<s>", "</s>"] + [chr(c) for c in range(33, 127)] + ["Ġ", "Ġthe", "ing",
                                                                        "é"]
        self._vocab = {p: i for i, p in enumerate(pieces)}

    @property
    def vocab_size(self):
        return len(self._vocab)

    def get_vocab(self):
        return dict(self._vocab)

    def convert_tokens_to_string(self, toks):
        return "".join(toks).replace("Ġ", " ")


def test_hf_vocab_bytes():
    tok = ByteTokenizer()
    got = pg.hf_vocab_bytes(tok)
    assert got == jg.hf_vocab_bytes(tok)
    assert got[0] is None and got[1] is None
    v = tok.get_vocab()
    assert got[v["a"]] == b"a" and got[v["Ġ"]] == b" " and got[v["Ġthe"]] == b" the"
    assert got[v["é"]] == "é".encode()
    assert len(got) == tok.vocab_size


def _random_tables(rng, G=3, S=7, V=40):
    t = rng.integers(-1, S, size=(G, S, V)).astype(np.int32)
    t[rng.random((G, S, V)) < 0.4] = -1
    return t


@pytest.mark.parametrize("rep", [1, 4], ids=["B", "B*(k+1)"])
def test_grammar_mask_and_advance_equal_jax(rep):
    """Random [G, S, V] tables, [B] grammar indices (-1: unguided) against
    states of B or B*(k+1) rows (-1: dead), and tokens."""
    rng = np.random.default_rng(3)
    B, V = 5, 40
    tables = _random_tables(rng, V=V)
    gidx = np.array([0, 2, -1, 1, 0], np.int32)
    states = rng.integers(-1, 7, size=B * rep).astype(np.int32)
    states[:2] = [-1, 3]
    toks = rng.integers(0, V, size=B * rep).astype(np.int32)
    jst = js.SamplingTensors(jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B), jnp.zeros(B),
                             grammar_next=jnp.asarray(tables), grammar_idx=jnp.asarray(gidx))
    pst = ps.SamplingTensors(torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
                             torch.zeros(B), grammar_next=torch.as_tensor(tables),
                             grammar_idx=torch.as_tensor(gidx))
    jm = np.asarray(js.grammar_mask(jst, jnp.asarray(states)))
    pm = ps.grammar_mask(pst, torch.as_tensor(states)).numpy()
    assert pm.dtype == np.bool_ and np.array_equal(pm, jm)
    ja = np.asarray(js.grammar_advance(jst, jnp.asarray(states), jnp.asarray(toks)))
    pa = ps.grammar_advance(pst, torch.as_tensor(states), torch.as_tensor(toks)).numpy()
    assert np.array_equal(pa, ja)
    # unguided: no mask, the states unchanged
    bare = pst._replace(grammar_next=None)
    assert ps.grammar_mask(bare, torch.as_tensor(states)) is None
    assert ps.grammar_advance(bare, None, torch.as_tensor(toks)) is None


def _st_pair(temp, top_k, top_p, tables, gidx, gstate):
    B = len(temp)
    jst = js.SamplingTensors(jnp.asarray(temp, jnp.float32), jnp.asarray(top_k, jnp.int32),
                             jnp.asarray(top_p, jnp.float32), jnp.zeros(B),
                             grammar_next=jnp.asarray(tables), grammar_idx=jnp.asarray(gidx),
                             grammar_state=jnp.asarray(gstate))
    pst = ps.SamplingTensors(torch.tensor(temp, dtype=torch.float32),
                             torch.tensor(top_k, dtype=torch.int32),
                             torch.tensor(top_p, dtype=torch.float32), torch.zeros(B),
                             needs_filter=True, grammar_next=torch.as_tensor(tables),
                             grammar_idx=torch.as_tensor(gidx),
                             grammar_state=torch.as_tensor(gstate))
    return jst, pst


def test_sampling_probs_under_grammar_equal_jax():
    """Greedy and sampled rows (top-k, top-p), a guided row beside an
    unguided one and a dead state, at the call-entry states and at per-row
    states of the verify's B*(k+1) rows."""
    rng = np.random.default_rng(5)
    V = 40
    tables = _random_tables(rng, V=V)
    tables[:, :, 7] = np.arange(7)[None]          # every state allows token 7
    temp, top_k, top_p = [0.0, 0.8, 1.0, 0.0], [0, 5, 0, 0], [1.0, 0.9, 1.0, 1.0]
    gidx, gstate = [0, 1, -1, 2], [2, 0, 0, -1]
    jst, pst = _st_pair(temp, top_k, top_p, tables, np.int32(gidx), np.int32(gstate))
    logits = rng.normal(size=(4, V)).astype(np.float32) * 3
    jp = np.asarray(js.sampling_probs(jnp.asarray(logits), jst))
    pp = ps.sampling_probs(torch.as_tensor(logits), pst).numpy()
    np.testing.assert_allclose(pp, jp, rtol=1e-6, atol=1e-6)
    # the greedy rows' one-hot is the masked argmax
    allowed = tables[0, 2] >= 0
    assert pp[0].argmax() == np.where(allowed, logits[0], -np.inf).argmax()
    # the verify's rows: k+1 = 3 states a sequence
    lg3 = rng.normal(size=(12, V)).astype(np.float32) * 3
    st3 = rng.integers(-1, 7, size=12).astype(np.int32)
    jrep = js.SamplingTensors(*(jnp.repeat(x, 3) for x in jst[:4]),
                              grammar_next=jst.grammar_next, grammar_idx=jst.grammar_idx)
    prep = pst._replace(**{f: torch.repeat_interleave(getattr(pst, f), 3)
                           for f in ("temperature", "top_k", "top_p", "min_p")})
    jp3 = np.asarray(js.sampling_probs(jnp.asarray(lg3), jrep, jnp.asarray(st3)))
    pp3 = ps.sampling_probs(torch.as_tensor(lg3), prep, torch.as_tensor(st3)).numpy()
    np.testing.assert_allclose(pp3, jp3, rtol=1e-6, atol=1e-6)
    # greedy tokens and their logprobs (under the unfiltered softmax)
    greedy = [0.0] * 4
    jst0, pst0 = _st_pair(greedy, [0] * 4, [1.0] * 4, tables, np.int32(gidx), np.int32(gstate))
    import jax
    jt, jl = js.sample_with_logprob(jnp.asarray(logits), jst0, jax.random.PRNGKey(0))
    pt, pl = ps.sample_with_logprob(torch.as_tensor(logits), pst0)
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)


def test_sampled_tokens_stay_in_grammar():
    rng = np.random.default_rng(9)
    V = 40
    tables = _random_tables(rng, V=V)
    tables[:, :, 3] = np.arange(7)[None]
    gidx, gstate = np.int32([0, 1, 2, 0]), np.int32([1, 2, 3, 4])
    _, pst = _st_pair([0.8, 1.0, 1.5, 0.7], [0, 0, 10, 0], [0.95, 1.0, 1.0, 0.9], tables,
                      gidx, gstate)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        logits = torch.as_tensor(rng.normal(size=(4, V)).astype(np.float32))
        toks = ps.sample(logits, pst, gen).numpy()
        assert all(tables[gidx[i], gstate[i], toks[i]] >= 0 for i in range(4))


def _typical_inputs(rng, B=5, k=3, V=24):
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32) * 2.5
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    drafts = rng.integers(0, V, size=(B, k)).astype(np.int32)
    # row 0 accepts all k: each draft the argmax of a peaked distribution
    drafts[0] = probs[0, :k].argmax(-1)
    probs[0, :k] = 0.02 / (V - 1)
    probs[0, np.arange(k), drafts[0]] = 0.98
    # row 1 accepts 1: the argmax, then a token of probability near 0
    drafts[1, 0] = probs[1, 0].argmax()
    drafts[1, 1] = probs[1, 1].argmin()
    # row 2: greedy rows' one-hot targets (temperature 0), the first two
    # drafts their argmax
    oh = np.eye(V, dtype=np.float32)[probs[2].argmax(-1)]
    probs[2] = oh
    drafts[2, :2] = probs[2, :2].argmax(-1)
    drafts[2, 2] = (probs[2, 2].argmax() + 1) % V
    return drafts, probs.astype(np.float32)


def test_typical_acceptance_equals_jax():
    rng = np.random.default_rng(11)
    drafts, probs = _typical_inputs(rng)
    j = js.typical_acceptance_sample(jnp.asarray(drafts), jnp.asarray(probs), None)
    p = ps.typical_acceptance_sample(torch.as_tensor(drafts), torch.as_tensor(probs))
    assert np.array_equal(p.tokens.numpy(), np.asarray(j.tokens))
    assert np.array_equal(p.accepted_len.numpy(), np.asarray(j.accepted_len))
    assert np.array_equal(p.num_draft_accepted.numpy(), np.asarray(j.num_draft_accepted))
    np.testing.assert_allclose(p.token_logprobs.numpy(), np.asarray(j.token_logprobs),
                               rtol=1e-6, atol=1e-6)
    n = p.num_draft_accepted.numpy()
    assert n[0] == 3 and n[1] == 1 and n[2] == 2
    # after k accepts the last slot is argmax(p_k)
    assert p.tokens[0, 3] == probs[0, 3].argmax()


def test_typical_acceptance_never_accepts_a_null_proposal():
    """A -1 slot (a nulled proposal) is rejected whatever the target: the
    emitted token is the argmax, as the oracle's."""
    rng = np.random.default_rng(12)
    _, probs = _typical_inputs(rng, B=3)
    probs[:, :, -1] = 0.99        # the -1 slot would wrap to the last id
    probs /= probs.sum(-1, keepdims=True)
    r = ps.typical_acceptance_sample(torch.full((3, 3), -1, dtype=torch.int32),
                                     torch.as_tensor(probs))
    assert r.num_draft_accepted.tolist() == [0, 0, 0]
    assert r.tokens[:, 0].tolist() == probs[:, 0].argmax(-1).tolist()


def _seqs(vocab):
    gc = pg.GrammarCompiler(vocab, eos_token_id=0)
    a, b = gc.from_regex(r"\[\d(,\d)*\]"), gc.from_regex(r"a+")
    seqs = [Sequence(seq_id=i, prompt_token_ids=[1, 2], sampling_params=SamplingParams())
            for i in range(4)]
    seqs[0].grammar_fsm, seqs[1].grammar_fsm, seqs[3].grammar_fsm = a, b, a
    seqs[0].grammar_state, seqs[3].grammar_state = 1, 2
    return seqs, (a, b)


@pytest.fixture(scope="module")
def runner():
    cfg = ModelConfig.tiny(quant="w4")
    from qspec_tpu_torch.models.llama import init_params
    return ModelRunner(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                    scheduler=SchedulerConfig(max_num_seqs=4,
                                                              max_model_len=64)),
                       init_params(cfg, device="cpu"), 16, device="cpu")


def test_make_sampling_tensors_stacks_like_jax(runner):
    """Distinct grammars by identity, states padded with -1 to the largest
    automaton, -1 for unguided rows: the JAX package's arrays."""
    seqs, _ = _seqs(_toy_vocab())
    p = make_sampling_tensors(seqs, 512, 0, runner.stack_grammars)
    j = j_make_st(seqs, 512, 0)
    for f in ("grammar_next", "grammar_idx", "grammar_state"):
        assert np.array_equal(np.asarray(getattr(p, f)), np.asarray(getattr(j, f))), f
    assert p.grammar_idx.tolist() == [0, 1, -1, 0]
    none = make_sampling_tensors([seqs[2]], 512, 0, runner.stack_grammars)
    assert none.grammar_next is None and none.grammar_state is None


def test_runner_keeps_grammar_tables_on_its_device(runner):
    """The runner copies a grammar's table to its device once and stacks a
    lone grammar as its table itself; padded lanes are unguided."""
    seqs, (a, b) = _seqs(_toy_vocab())
    st = make_sampling_tensors(seqs, 512, 0, runner.stack_grammars)
    ta = runner.grammar_table(a)
    assert runner.grammar_table(a) is ta
    assert torch.equal(runner.stack_grammars([a, b]), st.grammar_next)
    lone = runner.stack_grammars([b])
    assert lone.data_ptr() == runner.grammar_table(b).data_ptr()
    dev = runner.sampling_tensors(st, 4, 4)
    assert dev.grammar_next is st.grammar_next
    assert dev.grammar_idx.tolist() == [0, 1, -1, 0] and dev.grammar_state.tolist() == [1, 0, 0, 2]
    assert runner.sampling_tensors(st, 4, 8).grammar_idx.tolist()[4:] == [-1] * 4
    # a vocabulary shorter than the model's bans the ids past its end
    short = pg.GrammarCompiler(_toy_vocab(300), 0).from_regex("a+")
    t = runner.grammar_table(short)
    assert t.shape == (short.num_states, 512) and bool((t[:, 300:] == -1).all())
