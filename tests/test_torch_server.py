"""The port's OpenAI-compatible server over real HTTP on the CPU.

Each test starts the server in-process on 127.0.0.1 at a free port
(``ServerThread``) and talks to it with ``http.client``. Model: the tiny
QuaRot Llama (qspec_tpu init_params(ModelConfig.tiny(quant="w4"), seed 0),
the int8 head, carried over with params_from_numpy), QSpec at k = 2, with a
copy of tests/entrypoints/test_openai_server.py's FakeTokenizer. The cases
of that file that the port serves are here, plus: greedy server tokens ==
LLM.generate == the qspec_null oracle bit for bit, the same requests to the
JAX package's aiohttp server, the 501 routes, the 400 refusals, and the
step loop's serialization.
"""

import asyncio
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.models import llama as jllama
from qspec_tpu_torch import LLM, ModelConfig, SamplingParams
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.engine.async_engine import AsyncEngineDeadError
from qspec_tpu_torch.engine.metrics import LoggingStatLogger
from qspec_tpu_torch.entrypoints.openai.api_server import (NOT_PORTED, ServerThread,
                                                           build_server)
from qspec_tpu_torch.entrypoints.openai.run_batch import run_batch
from qspec_tpu_torch.models.llama import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
# a step where the two packages may pick different greedy tokens must be a
# near-tie in the JAX package's logits (tests/test_torch_engine.py)
TIE_GAP = 2e-2
ENGINE = dict(model="tiny", max_model_len=256, max_num_seqs=4, num_speculative_tokens=2)


class FakeTokenizer:
    eos_token_id = 0

    def encode(self, s):
        return [ord(c) % 250 + 1 for c in s][:32]

    def decode(self, ids):
        return "".join(chr(96 + (i % 26)) for i in ids)

    def apply_chat_template(self, messages, tokenize=True, add_generation_prompt=True):
        text = " ".join(m["content"] for m in messages)
        return self.encode(text)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JModel.tiny(quant="w4")
    jparams = jllama.init_params(jcfg, seed=0)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               ModelConfig.tiny(quant="w4"), device="cpu")
    return jcfg, jparams, params


def make_server(weights, tokenizer="fake", **over):
    return build_server(EngineArgs(**{**ENGINE, **over}), model_name="tiny-test",
                        params=weights[2], device="cpu",
                        tokenizer=FakeTokenizer() if tokenizer == "fake" else tokenizer)


def request(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path, None if body is None else json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    ctype = r.getheader("Content-Type", "")
    return r.status, json.loads(data) if ctype.startswith("application/json") else data


def post(port, path, body):
    return request(port, "POST", path, body)


def stream(port, path, body):
    """The SSE chunks of a streamed request (the [DONE] line checked)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    lines = [ln.strip() for ln in r.read().decode().splitlines() if ln.strip()]
    c.close()
    assert lines[-1] == "data: [DONE]"
    assert all(ln.startswith("data: ") for ln in lines)
    return [json.loads(ln[6:]) for ln in lines[:-1]]


def tokens_of(choice):
    return [int(t) for t in choice["logprobs"]["tokens"]]


# ------------------------------------------------- the reference file's cases

def test_health_and_models(weights):
    with ServerThread(make_server(weights)) as st:
        status, body = request(st.port, "GET", "/health")
        assert status == 200 and body == b"ok"
        status, data = request(st.port, "GET", "/v1/models")
        assert status == 200 and data["data"][0]["id"] == "tiny-test"


def test_completions(weights):
    with ServerThread(make_server(weights)) as st:
        status, data = post(st.port, "/v1/completions", {
            "model": "tiny-test", "prompt": "hello world", "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True})
    assert status == 200
    assert data["object"] == "text_completion"
    assert data["usage"] == {"prompt_tokens": 11, "completion_tokens": 8,
                             "total_tokens": 19}
    assert len(data["choices"][0]["text"]) == 8
    assert data["choices"][0]["finish_reason"] == "length"


def test_concurrent_requests(weights):
    """Six connections at once: every request answered, each with the
    tokens it gets alone."""
    texts = {}
    with ServerThread(make_server(weights)) as st:
        def one(i):
            status, data = post(st.port, "/v1/completions", {
                "prompt": f"request {i}", "max_tokens": 6, "temperature": 0.0,
                "ignore_eos": True})
            assert status == 200
            texts[i] = data["choices"][0]["text"]
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        alone = {i: post(st.port, "/v1/completions", {
            "prompt": f"request {i}", "max_tokens": 6, "temperature": 0.0,
            "ignore_eos": True})[1]["choices"][0]["text"] for i in range(6)}
    assert texts == alone and all(len(t) == 6 for t in texts.values())


def test_chat_streaming(weights):
    with ServerThread(make_server(weights)) as st:
        chunks = stream(st.port, "/v1/chat/completions", {
            "model": "tiny-test", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "temperature": 0.0, "stream": True})
        status, full = post(st.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
            "temperature": 0.0})
    assert chunks and all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    total = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert total == full["choices"][0]["message"]["content"] and total


def test_tokenize_roundtrip(weights):
    with ServerThread(make_server(weights)) as st:
        toks = post(st.port, "/tokenize", {"prompt": "abc"})[1]["tokens"]
        assert len(toks) == 3
        assert len(post(st.port, "/detokenize", {"tokens": toks})[1]["prompt"]) == 3
    with ServerThread(make_server(weights, tokenizer=None)) as st:
        status, data = post(st.port, "/tokenize", {"prompt": "abc"})
        assert status == 400 and "tokenizer" in data["message"]


def test_completions_n_choices(weights):
    with ServerThread(make_server(weights)) as st:
        status, data = post(st.port, "/v1/completions", {
            "prompt": "abcd", "max_tokens": 4, "n": 3, "temperature": 0.0,
            "ignore_eos": True})
    assert status == 200
    assert [c["index"] for c in data["choices"]] == [0, 1, 2]
    assert len({c["text"] for c in data["choices"]}) == 1     # greedy
    assert data["usage"]["completion_tokens"] == 12


def test_chat_n_choices(weights):
    with ServerThread(make_server(weights)) as st:
        status, data = post(st.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi there"}], "max_tokens": 3,
            "n": 2, "temperature": 0.0, "ignore_eos": True})
    assert status == 200 and len(data["choices"]) == 2
    assert data["choices"][0]["message"]["content"] == \
        data["choices"][1]["message"]["content"]


def test_batch_runner(weights, tmp_path):
    """The batch runner drives the server's own handler (no HTTP): the
    completions and chat lines answer, the 501 route and the unknown URL
    are errors."""
    inp, outp = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    reqs = [
        {"custom_id": "c1", "method": "POST", "url": "/v1/completions",
         "body": {"prompt": "abcd", "max_tokens": 4, "temperature": 0.0, "ignore_eos": True}},
        {"custom_id": "c2", "method": "POST", "url": "/v1/chat/completions",
         "body": {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                  "ignore_eos": True}},
        {"custom_id": "c3", "method": "POST", "url": "/v1/completions",
         "body": {"prompt": "x", "repetition_penalty": 1.3}},
        {"custom_id": "bad", "method": "POST", "url": "/v1/nope", "body": {}},
    ]
    inp.write_text("\n".join(json.dumps(r) for r in reqs) + "\nnot json\n")
    server = make_server(weights)
    assert asyncio.run(run_batch(server, str(inp), str(outp))) == 2
    lines = [json.loads(ln) for ln in outp.read_text().splitlines()]
    assert len(lines) == 5
    by_id = {ln["custom_id"]: ln for ln in lines}
    assert len(by_id["c1"]["response"]["body"]["choices"][0]["text"]) == 4
    assert by_id["c2"]["response"]["body"]["choices"][0]["message"]["content"]
    assert by_id["c3"]["response"]["status_code"] == 400
    assert "repetition_penalty" in by_id["c3"]["error"]["message"]
    assert by_id["bad"]["error"] is not None and by_id[None]["error"] is not None
    assert server.errors == []


@pytest.mark.parametrize("stop", [None, "ab"], ids=["plain", "stop"])
def test_stream_content_matches_nonstream(weights, stop):
    """The streamed deltas add up to the text that is not streamed, with
    and without a stop string (whose characters the stream holds back)."""
    req = {"prompt": "stream me", "max_tokens": 12, "temperature": 0.0,
           "ignore_eos": True, **({"stop": [stop]} if stop else {})}
    with ServerThread(make_server(weights)) as st:
        full = post(st.port, "/v1/completions", req)[1]["choices"][0]
        chunks = stream(st.port, "/v1/completions", {**req, "stream": True})
    text = "".join(c["choices"][0]["text"] for c in chunks)
    assert text == full["text"]
    assert [c["choices"][0]["finish_reason"] for c in chunks][-1] == full["finish_reason"]
    assert all(c["choices"][0]["finish_reason"] is None for c in chunks[:-1])
    if stop is None:
        assert full["finish_reason"] == "length" and len(text) == 12


# ------------------------------------------------- against the engine

def test_greedy_server_equals_llm_generate_and_oracle(weights):
    """One request with four token-id prompts (admitted in one step, as
    LLM.generate admits them): its tokens equal LLM.generate's on the same
    engine config and those of the qspec_null oracle, bit for bit; the
    streamed request's tokens too."""
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, 500, size=int(rng.integers(5, 40)))))
               for _ in range(4)]
    body = {"prompt": prompts, "max_tokens": 16, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 1}
    with ServerThread(make_server(weights)) as st:
        status, data = post(st.port, "/v1/completions", body)
        one = post(st.port, "/v1/completions", {**body, "prompt": prompts[1]})[1]
    assert status == 200 and [c["index"] for c in data["choices"]] == [0, 1, 2, 3]
    served = [tokens_of(c) for c in data["choices"]]
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    llm = [o.output_token_ids for o in LLM(params=weights[2], device="cpu", **ENGINE)
           .generate(prompts, sp)]
    oracle = [o.output_token_ids for o in LLM(params=weights[2], device="cpu",
                                              speculative_method="qspec_null", **ENGINE)
              .generate(prompts, sp)]
    assert served == llm == oracle
    assert all(len(t) == 16 for t in served)
    assert tokens_of(one["choices"][0]) == llm[1]
    assert data["usage"]["prompt_tokens"] == sum(map(len, prompts))


def test_same_answers_as_the_jax_server(weights):
    """The same requests to the JAX package's aiohttp server (aiohttp's
    test client), built with the four fields its build_server honours: the
    same keys, object, finish_reason, usage and choice count, and greedy
    tokens equal up to a near-tie of the JAX logits."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from qspec_tpu.engine.arg_utils import EngineArgs as JEngineArgs
    from qspec_tpu.entrypoints.openai.api_server import build_server as j_build_server
    from tests.test_torch_engine import _jax_last_logits

    jcfg, jparams, _ = weights
    reqs = [("/v1/completions", {"prompt": [[5, 17, 300, 41], "hello world"],
                                 "max_tokens": 8, "temperature": 0.0, "logprobs": 1,
                                 "n": 2}),
            # n=4: the batch of the first request, no new JAX executables
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi there"}],
                                      "max_tokens": 8, "temperature": 0.0, "logprobs": 1,
                                      "n": 4})]
    jserver = j_build_server(JEngineArgs(**ENGINE), model_name="tiny-test", params=jparams,
                             tokenizer=FakeTokenizer())

    async def jax_answers():
        client = TestClient(TestServer(jserver.app()))
        await client.start_server()
        try:
            out = []
            for path, body in reqs:
                r = await client.post(path, json=body)
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    want = asyncio.run(jax_answers())
    with ServerThread(make_server(weights)) as st:
        got = [post(st.port, path, body) for path, body in reqs]
    tok = FakeTokenizer()
    for (path, body), (gs, g), (ws, w) in zip(reqs, got, want):
        assert gs == ws == 200
        assert set(g) == set(w) and g["object"] == w["object"]
        assert g["usage"] == w["usage"]
        assert len(g["choices"]) == len(w["choices"])
        for gc, wc in zip(g["choices"], w["choices"]):
            assert set(gc) == set(wc) and gc["index"] == wc["index"]
            assert gc["finish_reason"] == wc["finish_reason"]
            gt, wt = tokens_of(gc), tokens_of(wc)
            diff = [j for j, (a, b) in enumerate(zip(gt, wt)) if a != b]
            if diff:
                j = diff[0]
                if path.endswith("chat/completions"):
                    prompt = tok.apply_chat_template(body["messages"])
                else:
                    p = body["prompt"]
                    p = p[gc["index"] // body.get("n", 1)] if isinstance(p, list) \
                        and not isinstance(p[0], int) else p
                    prompt = tok.encode(p) if isinstance(p, str) else p
                top2 = np.sort(_jax_last_logits(jcfg, jparams, prompt + wt[:j]))[-2:]
                assert top2[1] - top2[0] < TIE_GAP, (path, j, top2)
            else:
                assert gt == wt


# ------------------------------------------------- forced tool choices

class VocabTokenizer(FakeTokenizer):
    """FakeTokenizer with a vocabulary that hf_vocab_bytes reads: id 0 the
    EOS special, ids 1..95 the printable ASCII characters, and a decode
    that gives each id's character; the model's other ids map to nothing."""

    all_special_ids = [0]
    CHARS = [chr(c) for c in range(32, 127)]
    vocab_size = len(CHARS) + 1

    def get_vocab(self):
        return {"</s>": 0, **{c: i + 1 for i, c in enumerate(self.CHARS)}}

    def convert_tokens_to_string(self, toks):
        return "".join(toks)

    def encode(self, s):
        return [ord(c) - 31 if 32 <= ord(c) < 127 else 1 for c in s][:32]

    def decode(self, ids):
        return "".join(self.CHARS[i - 1] for i in ids if 1 <= i <= len(self.CHARS))


@pytest.mark.parametrize("choice", [
    "required", {"type": "function", "function": {"name": "f"}}],
    ids=["tool_required", "tool_named"])
def test_forced_tool_choice_is_served(weights, choice):
    """A forced tool choice ("required" or a named function) is decoded
    under the grammar of its call (forced_call_schema): the reply's
    tool_calls parse, streamed or not. Served where a vocabulary is (these
    cases answered 400 while guided decoding was not ported)."""
    tools = [{"type": "function", "function": {"name": "f"}},
             {"type": "function", "function": {"name": "g", "parameters": {
                 "type": "object", "properties": {"x": {"enum": [1, 2]}},
                 "required": ["x"]}}}]
    body = {"messages": [{"role": "user", "content": "hi"}], "tools": tools,
            "tool_choice": choice, "temperature": 0.0, "max_tokens": 40}
    with ServerThread(make_server(weights, tokenizer=VocabTokenizer(),
                                  max_model_len=1024)) as st:
        status, data = post(st.port, "/v1/chat/completions", body)
        assert status == 200, data
        c = data["choices"][0]
        assert c["finish_reason"] == "tool_calls"
        fn = c["message"]["tool_calls"][0]["function"]
        assert fn in ({"name": "f", "arguments": "{}"}, {"name": "g", "arguments": '{"x":1}'},
                      {"name": "g", "arguments": '{"x":2}'})
        if isinstance(choice, dict):
            assert fn["name"] == "f"
        chunks = stream(st.port, "/v1/chat/completions", {**body, "stream": True})
        calls = [ch["choices"][0]["delta"]["tool_calls"][0]["function"] for ch in chunks
                 if "tool_calls" in ch["choices"][0]["delta"]]
        assert calls == [fn] and chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"


# ------------------------------------------------- what the port refuses

def test_not_ported_routes_answer_501(weights):
    with ServerThread(make_server(weights)) as st:
        for (method, path), why in NOT_PORTED.items():
            status, data = request(st.port, method, path, {} if method == "POST" else None)
            assert status == 501 and data["message"] == why
            assert "ROADMAP queue 1 item" in why
        assert request(st.port, "GET", "/v1/nothing")[0] == 404
        assert request(st.port, "GET", "/v1/completions")[0] == 405


def test_lora_routes_and_the_model_field(weights, tmp_path):
    """Load an adapter from a PEFT directory, list it (also in /v1/models),
    complete under it by naming it in ``model`` (the tokens LLM.generate
    gives with lora_name; the served model's name gives the base's), then
    unload it; the errors are 400 / 404, and a server without a bank
    answers 400."""
    from qspec_tpu_torch.lora import LoRAConfig, init_lora_params
    from tests.test_torch_lora import peft_adapter
    cfg = ModelConfig.tiny(quant="w4")
    np.savez(tmp_path / "adapter_model.npz", **peft_adapter(cfg, 31))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"lora_alpha": 8}))
    params = {**weights[2], "lora": init_lora_params(cfg, LoRAConfig(3, 16), device="cpu")}
    prompt = list(range(3, 20))
    body = {"prompt": prompt, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True,
            "logprobs": 1}
    server = build_server(EngineArgs(**ENGINE), model_name="tiny-test", params=params,
                          device="cpu", tokenizer=FakeTokenizer())
    with ServerThread(server) as st:
        assert request(st.port, "GET", "/v1/lora_adapters") == (200, {"adapters": []})
        status, data = post(st.port, "/v1/load_lora_adapter",
                            {"lora_name": "ad", "lora_path": str(tmp_path)})
        assert (status, data) == (200, {"name": "ad", "slot": 1})
        _, listed = request(st.port, "GET", "/v1/lora_adapters")
        assert [a["name"] for a in listed["adapters"]] == ["ad"]
        _, models = request(st.port, "GET", "/v1/models")
        assert [m["id"] for m in models["data"]] == ["tiny-test", "ad"]
        status, data = post(st.port, "/v1/completions", {**body, "model": "ad"})
        assert status == 200
        got = tokens_of(data["choices"][0])
        base = tokens_of(post(st.port, "/v1/completions", {**body, "model": "tiny-test"})[1]
                         ["choices"][0])
        assert post(st.port, "/v1/completions", {**body, "model": "nope"})[0] == 404
        assert post(st.port, "/v1/load_lora_adapter", {"lora_name": "x"})[0] == 400
        assert post(st.port, "/v1/load_lora_adapter",
                    {"lora_name": "x", "lora_path": str(tmp_path / "missing.npz")})[0] == 400
        assert post(st.port, "/v1/unload_lora_adapter", {"lora_name": "ad"}) == \
            (200, {"unloaded": "ad"})
        assert post(st.port, "/v1/unload_lora_adapter", {"lora_name": "ad"})[0] == 400
        assert request(st.port, "GET", "/v1/lora_adapters") == (200, {"adapters": []})
    llm = LLM(params={**weights[2], "lora": init_lora_params(cfg, LoRAConfig(3, 16),
                                                             device="cpu")},
              device="cpu", **ENGINE)
    llm.llm_engine.lora.load_path("ad", str(tmp_path))
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    assert got == llm.generate([prompt], sp, lora_name="ad")[0].output_token_ids
    assert base == llm.generate([prompt], sp)[0].output_token_ids != got
    with ServerThread(make_server(weights)) as st:
        status, data = post(st.port, "/v1/load_lora_adapter",
                            {"lora_name": "ad", "lora_path": str(tmp_path)})
        assert status == 400 and "adapter bank" in data["message"]


@pytest.mark.parametrize("body,match", [
    ({"repetition_penalty": 1.2}, "repetition_penalty"),
    ({"temperature": 0.8, "seed": 3}, "seed"),
    ({"guided_regex": "a+"}, "guided decoding"),
    ({"temperature": -1.0}, "temperature"),
], ids=["repetition_penalty", "sampled_seed", "guided", "bad_temperature"])
def test_refused_options_answer_400(weights, body, match):
    """The guided case: FakeTokenizer has no vocabulary (get_vocab) and the
    server no grammar_vocab, so the engine's ValueError is the answer."""
    with ServerThread(make_server(weights)) as st:
        chat = "tools" in body
        path = "/v1/chat/completions" if chat else "/v1/completions"
        base = {"messages": [{"role": "user", "content": "hi"}]} if chat else {"prompt": "hi"}
        for stream_it in (False, True):
            status, data = post(st.port, path, {**base, **body, "stream": stream_it})
            assert status == 400 and match in data["message"], data
        # a greedy request's seed is served (it draws nothing)
        assert post(st.port, "/v1/completions", {"prompt": "hi", "temperature": 0.0,
                                                 "seed": 3, "max_tokens": 2})[0] == 200


def test_stop_string_needs_a_tokenizer(weights):
    with ServerThread(make_server(weights, tokenizer=None)) as st:
        status, data = post(st.port, "/v1/completions",
                            {"prompt": [1, 2, 3], "stop": ["x"], "max_tokens": 2})
        assert status == 400 and "tokenizer" in data["message"]
        status, data = post(st.port, "/v1/completions",
                            {"prompt": [1, 2, 3], "max_tokens": 2, "logprobs": 1})
        assert status == 200 and len(tokens_of(data["choices"][0])) == 2


def test_tool_call_parsed_from_the_answer(weights, monkeypatch):
    """tool_choice "auto": the tools reach the prompt as the canonical
    system message, and a tool block in the answer becomes tool_calls."""
    server = make_server(weights)
    seen = []
    tok = server.tokenizer
    monkeypatch.setattr(tok, "apply_chat_template",
                        lambda m, **kw: seen.append(m) or FakeTokenizer.apply_chat_template(
                            tok, m), raising=False)
    call = '<tool_call>{"name": "f", "arguments": {"x": 1}}</tool_call>'
    monkeypatch.setattr(tok, "decode", lambda ids: call, raising=False)
    tools = [{"type": "function", "function": {"name": "f", "parameters": {}}}]
    with ServerThread(server) as st:
        status, data = post(st.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "tools": tools,
            "max_tokens": 2, "temperature": 0.0})
    assert status == 200
    assert seen[0][0]["role"] == "system" and '"name":"f"' in seen[0][0]["content"]
    choice = data["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["tool_calls"][0]["function"] == {"name": "f",
                                                              "arguments": '{"x":1}'}


# ------------------------------------------------- the async engine

def test_steps_never_overlap(weights):
    """Two concurrent generate calls (and HTTP requests at once) never run
    two LLMEngine.step calls at the same time."""
    server = make_server(weights)
    eng = server.engine.engine
    state = {"now": 0, "most": 0, "steps": 0}
    lock = threading.Lock()
    step = eng.step

    def watched():
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
            state["steps"] += 1
        time.sleep(0.002)
        try:
            return step()
        finally:
            with lock:
                state["now"] -= 1
    eng.step = watched

    async def two():
        sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)

        async def one(p):
            return [o async for o in server.engine.generate(p, sp)][-1]
        return await asyncio.gather(one([1, 2, 3]), one([4, 5, 6, 7]))

    outs = asyncio.run(two())
    assert all(o.finished and len(o.output_token_ids) == 8 for o in outs)
    with ServerThread(server) as st:
        threads = [threading.Thread(target=post, args=(st.port, "/v1/completions", {
            "prompt": f"p{i}", "max_tokens": 5, "temperature": 0.0})) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert state["most"] == 1 and state["steps"] > 8


def test_abort_when_the_caller_leaves(weights):
    """A generate call left before its request finished aborts it: the
    engine holds no unfinished request and has freed its pages."""
    server = make_server(weights)
    eng = server.engine.engine
    free0 = eng.block_manager.num_free_pages

    async def leave_early():
        agen = server.engine.generate([1, 2, 3, 4], SamplingParams(
            temperature=0.0, max_tokens=64, ignore_eos=True))
        first = await agen.__anext__()
        await agen.aclose()
        return first

    first = asyncio.run(leave_early())
    assert not first.finished
    assert not eng.has_unfinished_requests()
    assert eng.block_manager.num_free_pages == free0


def test_engine_death_reaches_every_waiter(weights):
    server = make_server(weights)

    def boom():
        raise RuntimeError("step failed")
    server.engine.engine.step = boom
    with pytest.raises(RuntimeError, match="handler errors"):
        with ServerThread(server) as st:
            status, data = post(st.port, "/v1/completions", {"prompt": "hi", "max_tokens": 2})
            assert status == 500 and "step failed" in data["message"]
            assert request(st.port, "GET", "/health")[0] == 500
            status, _ = post(st.port, "/v1/completions", {"prompt": "hi", "max_tokens": 2})
            assert status == 500
    assert isinstance(server.errors[0], AsyncEngineDeadError)


def test_traces_and_stat_loggers(weights):
    """A finished output carries its trace's latencies; a stat logger gets
    one Stats a step; /metrics exposes the engine's Prometheus metrics,
    or answers 501 without prometheus_client."""
    pytest.importorskip("prometheus_client")
    lines = []
    server = make_server(weights)
    server.engine.engine.stat_loggers.append(LoggingStatLogger(interval_s=0.0,
                                                               log_fn=lines.append))

    async def one():
        sp = SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True)
        return [o async for o in server.engine.generate([3, 4, 5], sp)][-1]
    out = asyncio.run(one())
    m = out.metrics
    assert 0 <= m["time_in_queue"] <= m["time_to_first_token"] <= m["e2e"]
    assert lines and "accept" in lines[-1]
    with ServerThread(server) as st:
        status, text = request(st.port, "GET", "/metrics")
    assert status == 200 and b"qspec_generation_tokens_total" in text
    assert b"qspec_spec_decode_draft_acceptance_rate" in text
    server.metrics_registry = None
    with ServerThread(server) as st:
        assert request(st.port, "GET", "/metrics")[0] == 501


# ------------------------------------------------- the entry points

def test_build_server_passes_every_engine_arg(weights):
    """Every EngineArgs field reaches the engine (the JAX package's
    build_server keeps four): the int8 KV cache and the W4A8 draft here."""
    server = make_server(weights, kv_cache_dtype="int8", speculative_draft_scheme="w4a8",
                         block_size=16, enable_prefix_caching=False)
    cfg = server.engine.engine.config
    assert cfg.cache.kv_cache_dtype == "int8" and cfg.cache.page_size == 16
    assert cfg.speculative.draft_scheme == "w4a8" and cfg.speculative.num_speculative_tokens == 2
    assert not cfg.cache.enable_prefix_caching


def test_llm_string_prompts_and_chat(weights):
    """LLM takes string prompts through its tokenizer, and chat falls back
    on conversation.py's llama-3 template without a chat template."""
    from qspec_tpu_torch.conversation import get_conv_template

    class Plain:
        eos_token_id = None

        def encode(self, s):
            return [ord(c) % 250 + 1 for c in s][-24:]

        def decode(self, ids):
            return "".join(chr(96 + (i % 26)) for i in ids)
    llm = LLM(params=weights[2], device="cpu", tokenizer=Plain(), **ENGINE)
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    by_text, by_ids = llm.generate(["hello", Plain().encode("hello")], sp)
    assert by_text.output_token_ids == by_ids.output_token_ids
    assert by_text.text == Plain().decode(by_text.output_token_ids)
    conv = get_conv_template("llama-3")
    conv.system_message = "be brief"
    conv.append_message("user", "hi")
    conv.append_message("assistant", None)
    chat = llm.chat([{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi"}], sp)[0]
    assert chat.prompt_token_ids == Plain().encode(conv.get_prompt())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the card's machine has none of these: the server must not need them
BLOCK = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("aiohttp", "transformers", "prometheus_client",
                                  "opentelemetry", "jax", "qspec_tpu"):
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
from qspec_tpu_torch.scripts import main
sys.exit(main(sys.argv[1:]))
"""


def test_scripts_serve_on_the_cpu_without_optional_packages():
    """python -m qspec_tpu_torch.scripts serve --model tiny --device cpu,
    with aiohttp, transformers, prometheus_client, opentelemetry and jax
    made unimportable, answers /v1/completions over HTTP (token ids: no
    tokenizer) and 501 on /metrics."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", BLOCK, "serve", "--model", "tiny",
                             "--device", "cpu", "--port", str(port), "--max-model-len",
                             "256", "--num-speculative-tokens", "2"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                if request(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
            time.sleep(0.2)
        status, data = post(port, "/v1/completions", {
            "prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0.0, "logprobs": 1})
        assert status == 200 and len(tokens_of(data["choices"][0])) == 4
        assert data["choices"][0]["text"] == ""
        assert request(port, "GET", "/metrics")[0] == 501
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_scripts_refuse_bench_and_demo(capsys):
    from qspec_tpu_torch.scripts import main
    for cmd in ("bench", "demo"):
        assert main([cmd, "--quick"]) == 2
        assert "item 2" in capsys.readouterr().err


def test_client_leaving_a_stream_aborts_its_request(weights):
    """A client that closes the connection mid-stream: the server's next
    write fails, the request is aborted in the engine, and no server error
    is recorded."""
    server = make_server(weights)
    eng = server.engine.engine
    step, abort, aborted = eng.step, eng.abort_request, []

    def slow_step():
        time.sleep(0.02)
        return step()

    def recorded_abort(rid):
        aborted.append(rid)
        return abort(rid)
    eng.step, eng.abort_request = slow_step, recorded_abort
    with ServerThread(server) as st:
        sock = socket.create_connection(("127.0.0.1", st.port))
        body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 200, "temperature": 0.0,
                           "ignore_eos": True, "stop": ["zz"], "stream": True}).encode()
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        assert sock.recv(4096).startswith(b"HTTP/1.1 200 OK")
        sock.close()
        deadline = time.time() + 60
        while (not aborted or eng.has_unfinished_requests()) and time.time() < deadline:
            time.sleep(0.05)
    assert aborted and not eng.has_unfinished_requests()
    assert server.errors == []
