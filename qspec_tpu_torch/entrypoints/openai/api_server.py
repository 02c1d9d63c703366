"""OpenAI-compatible HTTP server on the Python standard library.

The port of ``qspec_tpu/entrypoints/openai/api_server.py``, whose aiohttp
stack is replaced by ``asyncio.start_server`` and a minimal HTTP/1.1
handler: it reads the request line, the headers and a ``Content-Length``
body, and answers with JSON, or with Server-Sent Events for
``"stream": true``, one connection a request (``Connection: close``). The
wire format is the reference's:

- ``GET /health``, ``GET /v1/models``, ``GET /metrics`` (Prometheus text
  when ``prometheus_client`` imports, else 501);
- ``POST /v1/completions`` and ``/v1/chat/completions`` (``n`` choices,
  stop strings, top-n logprobs, ``guided_regex`` / ``guided_json`` /
  ``guided_choice``, tools, a forced tool choice decoded under the grammar
  of ``forced_call_schema``, streaming with incremental detokenization
  ending in ``data: [DONE]``);
- ``POST /tokenize`` and ``/detokenize``;
- LoRA adapters over the engine's bank (``params["lora"]``):
  ``POST /v1/load_lora_adapter`` (``lora_name``, ``lora_path``: a PEFT
  directory or file, optional ``alpha``), ``POST /v1/unload_lora_adapter``,
  ``GET /v1/lora_adapters``; a completion whose ``model`` names a loaded
  adapter runs under it, and ``/v1/models`` lists the adapters.

The routes of modules not ported answer 501 with the ROADMAP item that
ports them: ``/v1/embeddings``, ``/v1/score``, ``/score`` and
``/v1/audio/transcriptions``. A request option the
engine refuses (``LLMEngine.check_request``, or a grammar that does not
compile in ``add_request``) is a 400 with its message.

    python -m qspec_tpu_torch.scripts serve --model llama3-8b \\
        --num-speculative-tokens 3 --port 8000
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import logging
import threading
import time
import traceback
import uuid
from typing import List, Optional

from qspec_tpu_torch.detokenizer import DetokState, detokenize_incrementally
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.engine.async_engine import AsyncEngineDeadError, AsyncLLMEngine
from qspec_tpu_torch.entrypoints.llm import chat_token_ids
from qspec_tpu_torch.lora.manager import LoRASlotError
from qspec_tpu_torch.entrypoints.openai.tool_parser import (StreamingToolParser,
                                                            forced_call_schema,
                                                            parse_tool_calls,
                                                            tools_system_message)
from qspec_tpu_torch.sampling_params import SamplingParams

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 << 20
REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
           411: "Length Required", 413: "Payload Too Large",
           431: "Request Header Fields Too Large", 500: "Internal Server Error",
           501: "Not Implemented"}
# the routes of modules the port does not have yet, and the ROADMAP item
# (queue 1) that ports each
NOT_PORTED = {
    ("POST", "/v1/embeddings"): "pooling requests (task='embed') and their model "
                                "families are not ported (ROADMAP queue 1 item 9)",
    ("POST", "/v1/score"): "scoring needs pooling and score heads, not ported "
                           "(ROADMAP queue 1 items 9 and 10)",
    ("POST", "/score"): "scoring needs pooling and score heads, not ported "
                        "(ROADMAP queue 1 items 9 and 10)",
    ("POST", "/v1/audio/transcriptions"): "whisper is not ported (ROADMAP queue 1 "
                                          "item 9)",
}


def _now() -> int:
    return int(time.time())


class HTTPError(Exception):
    """An error answered to the client with its status and message."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclasses.dataclass
class Request:
    method: str
    path: str
    headers: dict
    body: bytes = b""
    # the connection, for a streamed answer; None where the caller takes a
    # Response back (run_batch)
    writer: Optional[asyncio.StreamWriter] = None
    # set once a streamed answer has sent its head: nothing else may follow
    streamed: bool = False

    def json(self) -> dict:
        try:
            data = json.loads(self.body or b"{}")
        except ValueError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e
        if not isinstance(data, dict):
            raise HTTPError(400, "the body must be a JSON object")
        return data


@dataclasses.dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"

    @classmethod
    def of_json(cls, obj, status: int = 200) -> "Response":
        return cls(status, json.dumps(obj).encode())

    @classmethod
    def of_text(cls, text: str, status: int = 200) -> "Response":
        return cls(status, text.encode(), "text/plain; charset=utf-8")

    def json(self):
        return json.loads(self.body)


def error_response(status: int, message: str) -> Response:
    """The OpenAI error body (vLLM's ErrorResponse)."""
    return Response.of_json({"object": "error", "message": message,
                             "type": REASONS.get(status, "Error"), "code": status}, status)


async def read_request(reader: asyncio.StreamReader) -> Optional[Request]:
    """One request off the connection; None if the client closed it first."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HTTPError(400, "truncated request head") from e
    except asyncio.LimitOverrunError as e:
        raise HTTPError(431, "request head too large") from e
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HTTPError(400, f"bad request line {lines[0]!r}")
    headers = {}
    for line in lines[1:]:
        if line:
            name, sep, value = line.partition(":")
            if not sep:
                raise HTTPError(400, f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise HTTPError(411, "a chunked request body is not read: send Content-Length")
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError as e:
        raise HTTPError(400, "bad Content-Length") from e
    if not 0 <= n <= MAX_BODY_BYTES:
        raise HTTPError(413, f"a body of {n} bytes (at most {MAX_BODY_BYTES})")
    body = await reader.readexactly(n) if n else b""
    return Request(parts[0].upper(), parts[1].split("?", 1)[0], headers, body)


def _head(status: int, content_type: str, length: Optional[int] = None,
          extra: str = "") -> bytes:
    size = f"Content-Length: {length}\r\n" if length is not None else ""
    return (f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}\r\n"
            f"Content-Type: {content_type}\r\n{size}{extra}Connection: close\r\n\r\n"
            ).encode("latin-1")


async def write_response(writer: asyncio.StreamWriter, resp: Response) -> None:
    writer.write(_head(resp.status, resp.content_type, len(resp.body)) + resp.body)
    await writer.drain()


class EventStream:
    """A Server-Sent Events answer on a connection: the head goes out with
    the first event, each event is flushed as it is written."""

    def __init__(self, req: Request):
        self.req = req

    async def send(self, data: str) -> None:
        if not self.req.streamed:
            self.req.writer.write(_head(200, "text/event-stream",
                                        extra="Cache-Control: no-cache\r\n"))
            self.req.streamed = True
        self.req.writer.write(f"data: {data}\n\n".encode())
        await self.req.writer.drain()


class OpenAIServer:
    def __init__(self, async_engine: AsyncLLMEngine, model_name: str, tokenizer,
                 metrics_registry=None):
        self.engine = async_engine
        self.model_name = model_name
        self.tokenizer = tokenizer
        # the Prometheus registry /metrics exposes (None: 501)
        self.metrics_registry = metrics_registry
        self._request_counter = itertools.count()
        # unexpected exceptions of the handlers, each also answered with a
        # 500: a caller that runs the server checks this stays empty
        self.errors: List[BaseException] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self.routes = {
            ("GET", "/health"): self.health,
            ("GET", "/v1/models"): self.models,
            ("GET", "/metrics"): self.metrics,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/tokenize"): self.tokenize,
            ("POST", "/detokenize"): self.detokenize,
            ("POST", "/v1/load_lora_adapter"): self.load_lora,
            ("POST", "/v1/unload_lora_adapter"): self.unload_lora,
            ("GET", "/v1/lora_adapters"): self.list_lora,
        }

    # ------------------------------------------------------------ transport
    async def start(self, host: str = "127.0.0.1", port: int = 0):
        self._server = await asyncio.start_server(self._handle_connection, host, port)
        return self._server

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self, host: str, port: int) -> None:
        await self.start(host, port)
        logger.info("serving %s on %s:%d", self.model_name, host, self.port)
        try:
            await self._server.serve_forever()
        finally:
            await self.close()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.engine.shutdown()

    async def _handle_connection(self, reader, writer) -> None:
        try:
            try:
                req = await read_request(reader)
            except HTTPError as e:
                await write_response(writer, error_response(e.status, e.message))
                return
            if req is None:
                return
            req.writer = writer
            resp = await self.respond(req)
            # a stream that failed half-way ends with the connection
            if resp is not None and not req.streamed:
                await write_response(writer, resp)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass    # the client went away
        finally:
            writer.close()

    async def respond(self, req: Request) -> Optional[Response]:
        """The answer to one request (None: it was streamed on
        ``req.writer``). Client errors become their status; anything else
        is recorded in ``errors``, logged and answered with 500."""
        try:
            handler = self.routes.get((req.method, req.path))
            if handler is None:
                if (req.method, req.path) in NOT_PORTED:
                    raise HTTPError(501, NOT_PORTED[(req.method, req.path)])
                known = {p for _, p in (*self.routes, *NOT_PORTED)}
                raise HTTPError(405 if req.path in known else 404,
                                f"{req.method} {req.path}")
            return await handler(req)
        except HTTPError as e:
            return error_response(e.status, e.message)
        except ConnectionError:
            raise       # the client left mid-stream: not a server fault
        except AsyncEngineDeadError as e:
            self.errors.append(e)
            logger.error("engine loop died: %r", e.__cause__)
            return error_response(500, f"engine loop died: {e.__cause__!r}")
        except Exception as e:
            self.errors.append(e)
            logger.error("%s %s failed:\n%s", req.method, req.path, traceback.format_exc())
            return error_response(500, f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------ routes
    async def health(self, req) -> Response:
        if not self.engine.is_running():
            return Response.of_text("engine dead", 500)
        return Response.of_text("ok")

    async def models(self, req) -> Response:
        data = [{"id": self.model_name, "object": "model", "created": _now(),
                 "owned_by": "qspec_tpu_torch"}]
        lm = self.engine.engine._lora_manager
        if lm is not None:
            # a loaded adapter is a model a request's "model" field names
            data += [{"id": a["name"], "object": "model", "created": int(a["loaded_at"]),
                      "owned_by": "qspec_tpu_torch", "parent": self.model_name}
                     for a in lm.list_adapters()]
        return Response.of_json({"object": "list", "data": data})

    # ------------------------------------------------------------ LoRA
    def _lora_manager(self):
        try:
            return self.engine.engine.lora
        except LoRASlotError as e:
            raise HTTPError(400, str(e)) from e

    async def load_lora(self, req) -> Response:
        """Load a PEFT adapter under a name. It runs on the engine's worker
        thread, between two steps: the bank is written in place."""
        body = req.json()
        name, path = body.get("lora_name"), body.get("lora_path")
        if not name or not path:
            raise HTTPError(400, "lora_name and lora_path are required")
        mgr = self._lora_manager()
        try:
            slot = await self.engine.run(mgr.load_path, name, path, alpha=body.get("alpha"))
        except (LoRASlotError, OSError, KeyError, ValueError) as e:
            raise HTTPError(400, f"load failed: {e}") from e
        return Response.of_json({"name": name, "slot": slot})

    async def unload_lora(self, req) -> Response:
        body = req.json()
        name = body.get("lora_name")
        if not name:
            raise HTTPError(400, "lora_name is required")
        mgr = self._lora_manager()
        try:
            await self.engine.run(mgr.unload, name)
        except LoRASlotError as e:
            raise HTTPError(400, str(e)) from e
        return Response.of_json({"unloaded": name})

    async def list_lora(self, req) -> Response:
        return Response.of_json({"adapters": self._lora_manager().list_adapters()})

    def _lora_name_of(self, body: dict) -> Optional[str]:
        """The adapter a request's ``model`` field names, or None (the
        served model, or no field). A name that is neither is a 404."""
        m = body.get("model")
        if not m or m == self.model_name:
            return None
        lm = self.engine.engine._lora_manager
        if lm is None or all(a["name"] != m for a in lm.list_adapters()):
            raise HTTPError(404, f"model {m!r} is neither the served model "
                                 f"({self.model_name!r}) nor a loaded adapter")
        return m

    async def metrics(self, req) -> Response:
        if self.metrics_registry is None:
            return Response.of_text("prometheus_client missing", 501)
        from prometheus_client import generate_latest
        return Response(200, generate_latest(self.metrics_registry),
                        "text/plain; version=0.0.4; charset=utf-8")

    def _need_tokenizer(self, what: str):
        if self.tokenizer is None:
            raise HTTPError(400, f"{what} needs a tokenizer; the server has none")
        return self.tokenizer

    async def tokenize(self, req) -> Response:
        body = req.json()
        ids = list(self._need_tokenizer("/tokenize").encode(body.get("prompt", "")))
        return Response.of_json({"tokens": ids, "count": len(ids)})

    async def detokenize(self, req) -> Response:
        body = req.json()
        text = self._need_tokenizer("/detokenize").decode(body.get("tokens", []))
        return Response.of_json({"prompt": text})

    # ------------------------------------------------------------ requests
    def _sampling(self, body: dict) -> SamplingParams:
        """The reference's request fields, the guided ones among them, plus
        those the port refuses (``repetition_penalty``, a sampled request's
        ``seed``), so that a request never has an option silently
        dropped."""
        banned, bias = None, None
        try:
            if body.get("logit_bias"):
                # OpenAI logit_bias {token_id: bias}: <= -100 bans
                banned = [int(t) for t, v in body["logit_bias"].items() if v <= -100]
                bias = {int(t): float(v) for t, v in body["logit_bias"].items()
                        if v > -100}
            sp = SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", -1)),
                min_p=float(body.get("min_p", 0.0)),
                max_tokens=int(body.get("max_tokens",
                                        body.get("max_completion_tokens", 128))),
                min_tokens=int(body.get("min_tokens", 0)),
                ignore_eos=bool(body.get("ignore_eos", False)),
                presence_penalty=float(body.get("presence_penalty", 0.0)),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                repetition_penalty=float(body.get("repetition_penalty", 1.0)),
                allowed_token_ids=body.get("allowed_token_ids"),
                banned_token_ids=banned or body.get("banned_token_ids"),
                logit_bias=bias or None,
                stop=body.get("stop"),
                stop_token_ids=body.get("stop_token_ids"),
                include_stop_str_in_output=bool(body.get("include_stop_str_in_output",
                                                         False)),
                logprobs=body.get("logprobs"),
                seed=body.get("seed"),
                guided_regex=body.get("guided_regex"),
                guided_json=body.get("guided_json"),
                guided_choice=body.get("guided_choice"))
        except (TypeError, ValueError, AttributeError) as e:
            raise HTTPError(400, f"bad sampling parameters: {e}") from e
        self._check(sp)
        return sp

    def _check(self, sp: SamplingParams) -> None:
        try:
            self.engine.engine.check_request(sp)
        except (ValueError, NotImplementedError) as e:
            raise HTTPError(400, str(e)) from e

    def _encode_prompts(self, body: dict) -> List[List[int]]:
        """OpenAI ``prompt``: a string, a token-id list, or a list of either;
        returns token-id lists."""
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return [list(self._need_tokenizer("a string prompt").encode(prompt))]
        if isinstance(prompt, list) and prompt:
            if all(isinstance(t, int) for t in prompt):
                return [prompt]
            out = []
            for p in prompt:
                if isinstance(p, str):
                    out.append(list(self._need_tokenizer("a string prompt").encode(p)))
                elif isinstance(p, list) and p and all(isinstance(t, int) for t in p):
                    out.append(p)
                else:
                    raise HTTPError(400, "each prompt must be a string or token ids")
            return out
        raise HTTPError(400, "prompt must be a string, token ids, or a list of either")

    @staticmethod
    def _n(body: dict) -> int:
        try:
            return max(1, int(body.get("n", 1)))
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad n: {e}") from e

    @staticmethod
    def _logprobs_payload(out, want):
        if not want:
            return None
        top = None
        if out.top_logprobs is not None:
            top = [None if d is None else {str(t): lp for t, lp in d.items()}
                   for d in out.top_logprobs]
        return {"token_logprobs": list(out.logprobs or []),
                "tokens": [str(t) for t in out.output_token_ids],
                "top_logprobs": top, "text_offset": []}

    @staticmethod
    def _nth_sp(sp, j):
        """Per-choice sampling params for n > 1: distinct seeds when seeded,
        otherwise shared (each request draws fresh engine randomness)."""
        if j == 0 or sp.seed is None:
            return sp
        return dataclasses.replace(sp, seed=sp.seed + j)

    async def _generate(self, token_ids, sp, lora_name=None):
        """The engine's outputs of one request; a request ``add_request``
        refuses (a guided pattern or schema that does not compile, an
        adapter the path does not serve) is a 400 with its message, raised
        before anything is sent."""
        outs = self.engine.generate(token_ids, sp, request_id=next(self._request_counter),
                                    lora_name=lora_name)
        try:
            try:
                first = await outs.__anext__()
            except (ValueError, LoRASlotError) as e:
                raise HTTPError(400, str(e)) from e
            yield first
            async for out in outs:
                yield out
        finally:
            await outs.aclose()

    async def _generate_one(self, token_ids, sp, lora_name=None):
        final = None
        async for out in self._generate(token_ids, sp, lora_name):
            final = out
        return final

    @staticmethod
    def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
        return {"prompt_tokens": prompt_tokens, "completion_tokens": completion_tokens,
                "total_tokens": prompt_tokens + completion_tokens}

    async def completions(self, req) -> Optional[Response]:
        body = req.json()
        prompts = self._encode_prompts(body)
        sp = self._sampling(body)
        n = self._n(body)
        lora = self._lora_name_of(body)
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if body.get("stream"):
            if len(prompts) > 1 or n > 1:
                raise HTTPError(400, "streaming supports a single prompt with n=1")
            return await self._stream(req, prompts[0], sp, cid, chat=False, lora_name=lora)
        # n > 1 fans out n engine requests a prompt (independent samples;
        # prefix caching shares the prompt's KV), all at once
        jobs = [(i * n + j, token_ids, self._nth_sp(sp, j))
                for i, token_ids in enumerate(prompts) for j in range(n)]
        finals = await asyncio.gather(*(self._generate_one(t, s, lora) for _, t, s in jobs))
        choices = [{"index": idx, "text": final.text,
                    "logprobs": self._logprobs_payload(final, sp.logprobs),
                    "finish_reason": final.finish_reason}
                   for (idx, _, _), final in zip(jobs, finals)]
        return Response.of_json({
            "id": cid, "object": "text_completion", "created": _now(),
            "model": self.model_name, "choices": choices,
            "usage": self._usage(sum(len(t) for t in prompts),
                                 sum(len(f.output_token_ids) for f in finals))})

    def _chat_ids(self, messages, tools, tool_choice) -> List[int]:
        """The conversation's prompt ids; with tools, their specs through the
        tokenizer's own ``tools=`` template when it uses them, else in a
        system message of the canonical wire format."""
        tok = self._need_tokenizer("chat")
        for m in messages:
            if not isinstance(m, dict) or "content" not in m or "role" not in m:
                raise HTTPError(400, "each message needs a role and a content")
            if not isinstance(m["content"], str):
                # OpenAI list content: text parts only; image parts need the
                # vision towers
                parts = m["content"] if isinstance(m["content"], list) else []
                if any(p.get("type") != "text" for p in parts):
                    raise HTTPError(400, "only text content parts are served: image "
                                         "inputs are not ported (ROADMAP queue 1 item 9)")
                m["content"] = "".join(p["text"] for p in parts)
        if not tools or tool_choice == "none":
            return chat_token_ids(tok, messages)
        # a chat template that does not use `tools` silently drops the
        # keyword: look for it in the template's source
        if "tools" in str(getattr(tok, "chat_template", None) or ""):
            return chat_token_ids(tok, messages, tools=tools)
        return chat_token_ids(tok, [tools_system_message(tools)] + list(messages))

    async def chat_completions(self, req) -> Optional[Response]:
        body = req.json()
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise HTTPError(400, "messages must be a non-empty list")
        tools = body.get("tools")
        tool_choice = body.get("tool_choice", "auto" if tools else "none")
        want_tools = bool(tools) and tool_choice != "none"
        token_ids = self._chat_ids(messages, tools, tool_choice)
        sp = self._sampling(body)
        # a forced tool choice ("required" or a named function) is decoded
        # under the JSON grammar of the call, so it parses by construction
        forced = tools and (tool_choice == "required" or isinstance(tool_choice, dict))
        if forced:
            name = (tool_choice.get("function", {}).get("name")
                    if isinstance(tool_choice, dict) else None)
            try:
                sp.guided_json = forced_call_schema(tools, name)
            except (KeyError, TypeError, AttributeError, ValueError) as e:
                raise HTTPError(400, f"bad tools / tool_choice: {e!r}") from e
            self._check(sp)
        tool_names = [t.get("function", t).get("name") for t in (tools or ())]
        n = self._n(body)
        lora = self._lora_name_of(body)
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        if body.get("stream"):
            if n > 1:
                raise HTTPError(400, "streaming supports n=1")
            return await self._stream(req, token_ids, sp, cid, chat=True,
                                      tool_names=tool_names if want_tools else None,
                                      lora_name=lora)
        finals = await asyncio.gather(*(self._generate_one(token_ids, self._nth_sp(sp, j), lora)
                                        for j in range(n)))
        choices = []
        for j, final in enumerate(finals):
            msg = {"role": "assistant", "content": final.text}
            finish = final.finish_reason
            if want_tools:
                content, calls = parse_tool_calls(final.text, tool_names)
                if forced and not calls:
                    # the grammar makes the call parse, but max_tokens can
                    # cut it half-way
                    raise HTTPError(400, "forced tool call truncated; raise max_tokens")
                if calls:
                    msg = {"role": "assistant", "content": content, "tool_calls": calls}
                    finish = "tool_calls"
            choices.append({"index": j, "message": msg,
                            "logprobs": self._logprobs_payload(final, sp.logprobs),
                            "finish_reason": finish})
        return Response.of_json({
            "id": cid, "object": "chat.completion", "created": _now(),
            "model": self.model_name, "choices": choices,
            "usage": self._usage(len(token_ids),
                                 sum(len(f.output_token_ids) for f in finals))})

    async def _stream(self, req, token_ids, sp, cid, chat: bool, tool_names=None,
                      lora_name=None):
        """Server-Sent Events: one chunk an engine output that adds text,
        the last with the finish reason, then ``data: [DONE]``. The text is
        detokenized incrementally; with stop strings, the last
        max(len(stop)) - 1 characters are held back until the request
        finishes (they may begin a stop string the engine then cuts), so the
        streamed text equals the text that is not streamed."""
        if req.writer is None:
            raise HTTPError(400, "stream is served over a connection only")
        tok = self.tokenizer
        hold = max(map(len, sp.stop)) - 1 if sp.stop else 0
        detok = DetokState()
        # streaming tool-call extraction: content streams through, completed
        # tool blocks become tool_calls deltas
        parser = StreamingToolParser(tool_names) if chat and tool_names is not None else None
        events = EventStream(req)
        emitted = 0

        async def write_chunk(delta, finish=None):
            if chat:
                payload = {"id": cid, "object": "chat.completion.chunk",
                           "created": _now(), "model": self.model_name,
                           "choices": [{"index": 0, "delta": delta,
                                        "finish_reason": finish}]}
            else:
                payload = {"id": cid, "object": "text_completion",
                           "created": _now(), "model": self.model_name,
                           "choices": [{"index": 0, "text": delta.get("content", ""),
                                        "finish_reason": finish}]}
            await events.send(json.dumps(payload))

        async for out in self._generate(token_ids, sp, lora_name):
            if out.finished:
                text = out.text
            elif tok is not None:
                text = detokenize_incrementally(tok, out.output_token_ids, detok)
                text = text[:max(len(text) - hold, emitted)]
            else:
                text = ""
            delta_text, emitted = text[emitted:], max(emitted, len(text))
            if parser is not None:
                deltas = parser.push(delta_text)
                if out.finished:
                    deltas += parser.finish()
                for d in deltas:
                    await write_chunk(d)
                if out.finished:
                    await write_chunk({}, "tool_calls" if parser.n_calls else out.finish_reason)
                continue
            if delta_text or out.finished:
                await write_chunk({"content": delta_text},
                                  out.finish_reason if out.finished else None)
        await events.send("[DONE]")
        return None


def build_server(args: EngineArgs, model_name: Optional[str] = None, params=None,
                 tokenizer=None, device="cuda") -> OpenAIServer:
    """The server over ``LLM(**args)``: every EngineArgs field reaches the
    engine (the JAX package's build_server passes only quantization,
    max_model_len, max_num_seqs and num_speculative_tokens, and drops the
    rest). ``params`` / ``tokenizer`` as ``LLM`` takes them; with
    ``prometheus_client`` the engine's stats feed /metrics."""
    from qspec_tpu_torch.entrypoints.llm import LLM
    llm = LLM(params=params, tokenizer=tokenizer, device=device,
              **dataclasses.asdict(args))
    name = model_name or args.model
    registry = None
    try:
        import prometheus_client
    except ImportError:
        prometheus_client = None
    if prometheus_client is not None:
        from qspec_tpu_torch.engine.metrics import PrometheusMetrics
        registry = prometheus_client.CollectorRegistry()
        llm.llm_engine.stat_loggers.append(PrometheusMetrics(name, registry=registry))
    return OpenAIServer(AsyncLLMEngine(llm.llm_engine), name, llm.tokenizer,
                        metrics_registry=registry)


class ServerThread:
    """The server on an event loop of its own in a thread, at ``port``
    (0: a free one, read back from ``.port``)::

        with ServerThread(server) as st:
            http.client.HTTPConnection("127.0.0.1", st.port) ...

    On exit the loop stops and the thread is joined; an exception of the
    thread, or one a handler answered with 500 (``server.errors``), is
    raised there."""

    def __init__(self, server: OpenAIServer, host: str = "127.0.0.1", port: int = 0):
        self.server, self.host, self.port = server, host, port
        self.error: Optional[BaseException] = None
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread = threading.Thread(target=self._main, name="qspec-server",
                                        daemon=True)

    def _main(self) -> None:
        loop = self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self.server.start(self.host, self.port))
            self.port = self.server.port
            self._ready.set()
            loop.run_forever()
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            loop.run_until_complete(self.server.close())
            loop.run_until_complete(loop.shutdown_asyncgens())
        except BaseException as e:
            self.error = e
        finally:
            self._ready.set()
            loop.close()

    def __enter__(self) -> "ServerThread":
        self._thread.start()
        self._ready.wait()
        if self.error is not None:
            raise RuntimeError("the server did not start") from self.error
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join()
        if exc[0] is None:
            first = self.error or (self.server.errors[0] if self.server.errors else None)
            if first is not None:
                raise RuntimeError(f"the server thread failed ({len(self.server.errors)} "
                                   "handler errors)") from first
