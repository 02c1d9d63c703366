"""OpenAI tool calling: prompt injection and tool-call extraction.

The port's copy of ``qspec_tpu/entrypoints/openai/tool_parser.py``. One
canonical wire format, the hermes-style
``<tool_call>{"name": ..., "arguments": {...}}</tool_call>`` block, plus a
permissive extractor that also accepts a bare JSON object and mistral's
``[TOOL_CALLS]`` array. A forced tool choice ("required" or a named
function) rides grammar-guided decoding (``qspec_tpu_torch/guided/``): the
server compiles ``forced_call_schema`` into the request's ``guided_json``,
so the emitted call parses by construction.
"""

from __future__ import annotations

import json
import uuid
from typing import List, Optional, Tuple

TOOL_CALL_OPEN = "<tool_call>"
TOOL_CALL_CLOSE = "</tool_call>"
MISTRAL_MARK = "[TOOL_CALLS]"

SYSTEM_TEMPLATE = (
    "You have access to the following tools. To call a tool, respond with\n"
    '<tool_call>{{"name": <tool-name>, "arguments": <args-json>}}</tool_call>\n'
    "Available tools:\n{tools}"
)


def tools_system_message(tools: List[dict]) -> dict:
    """A system message describing `tools` in the canonical wire format —
    the fallback when the tokenizer's chat template has no native `tools=`
    support (HF tool-capable templates are preferred when present)."""
    specs = [json.dumps(t.get("function", t), separators=(",", ":"))
             for t in tools]
    return {"role": "system",
            "content": SYSTEM_TEMPLATE.format(tools="\n".join(specs))}


def forced_call_schema(tools: List[dict], name: Optional[str] = None) -> dict:
    """JSON schema for a guided (grammar-constrained) tool call.

    name=None -> any of the listed tools (tool_choice="required");
    name=str  -> exactly that tool (named tool_choice). The schema feeds
    SamplingParams.guided_json, so the emitted call parses by construction.
    """
    def one(t):
        fn = t.get("function", t)
        return {"type": "object",
                "properties": {"name": {"const": fn["name"]},
                               "arguments": fn.get("parameters", {"type": "object"})},
                "required": ["name", "arguments"]}

    picked = [t for t in tools if name is None or t.get("function", t).get("name") == name]
    if not picked:
        raise ValueError(f"tool_choice names unknown tool {name!r}")
    if len(picked) == 1:
        return one(picked[0])
    return {"anyOf": [one(t) for t in picked]}


def _call_payload(obj: dict) -> Optional[dict]:
    """Normalize one parsed JSON object into an OpenAI tool_call entry."""
    if not isinstance(obj, dict) or "name" not in obj:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        arg_str = args
    else:
        arg_str = json.dumps(args, separators=(",", ":"))
    return {"id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
            "function": {"name": str(obj["name"]), "arguments": arg_str}}


def _scan_json_objects(text: str) -> List[Tuple[int, int, object]]:
    """All top-level JSON values starting at '{' or '[' in `text`, found by
    raw_decode scanning (tolerates surrounding prose)."""
    dec = json.JSONDecoder()
    out = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in "{[":
            try:
                val, end = dec.raw_decode(text, i)
            except ValueError:
                i += 1
                continue
            out.append((i, end, val))
            i = end
        else:
            i += 1
    return out


def parse_tool_calls(text: str, tool_names=None) -> Tuple[Optional[str], List[dict]]:
    """Extract tool calls from generated text.

    Returns (content, tool_calls): content is the non-tool prose (None if
    the whole message was tool calls), tool_calls the OpenAI-format list.
    Accepted shapes: <tool_call>..</tool_call> blocks (canonical),
    [TOOL_CALLS] [..] (mistral), or bare JSON object(s) carrying
    name+arguments (llama-3 style / guided output).

    ``tool_names``: the request's declared tool names. When given, only
    objects whose "name" matches a declared tool are promoted to calls —
    ordinary JSON content like {"name": "Alice", "age": 30} stays content
    (reference tool parsers validate against the request's tools too).
    """
    calls: List[dict] = []
    content_parts: List[str] = []
    names = set(tool_names) if tool_names is not None else None

    def payload(obj):
        c = _call_payload(obj)
        if c is not None and names is not None and \
                c["function"]["name"] not in names:
            return None
        return c

    if TOOL_CALL_OPEN in text:
        rest = text
        while TOOL_CALL_OPEN in rest:
            pre, _, tail = rest.partition(TOOL_CALL_OPEN)
            content_parts.append(pre)
            body, sep, rest = tail.partition(TOOL_CALL_CLOSE)
            if not sep:           # unterminated block: try to parse anyway
                rest = ""
            try:
                c = payload(json.loads(body.strip()))
                if c:
                    calls.append(c)
                else:
                    # valid JSON that isn't a (declared) call: keep the
                    # model's output as content rather than dropping it
                    content_parts.append(body)
            except ValueError:
                content_parts.append(body)
        content_parts.append(rest)
    elif MISTRAL_MARK in text:
        pre, _, tail = text.partition(MISTRAL_MARK)
        content_parts.append(pre)
        for _s, _e, val in _scan_json_objects(tail):
            vals = val if isinstance(val, list) else [val]
            for v in vals:
                c = payload(v)
                if c:
                    calls.append(c)
            break                 # the marker owns exactly one JSON value
    else:
        # bare JSON object(s): only treat as calls when they carry the
        # name+arguments shape (and match a declared tool), otherwise the
        # text is plain content
        spans = []
        for s, e, val in _scan_json_objects(text):
            c = payload(val)
            if c:
                calls.append(c)
                spans.append((s, e))
        if calls:
            last = 0
            for s, e in spans:
                content_parts.append(text[last:s])
                last = e
            content_parts.append(text[last:])
        else:
            content_parts.append(text)

    content = "".join(content_parts).strip()
    return (content or None), calls


def _longest_marker_suffix(text: str, markers) -> int:
    """Chars at the end of `text` that form a PREFIX of some marker (they
    might complete into the marker with the next delta, so they must be
    held back from streaming)."""
    best = 0
    for m in markers:
        for n in range(min(len(m), len(text)), 0, -1):
            if text.endswith(m[:n]):
                best = max(best, n)
                break
    return best


class StreamingToolParser:
    """Incremental tool-call extraction over SSE deltas (reference:
    vllm/entrypoints/openai/tool_parsers/hermes_tool_parser.py streaming
    path). ``push(delta_text)`` returns OpenAI `delta` payloads — content
    fragments are streamed through immediately except for held-back text
    that might begin a tool-call marker; a completed block is emitted as one
    tool_calls delta (id + name + full arguments). ``finish()`` flushes any
    held-back tail (an unterminated marker reverts to plain content).
    """

    MARKERS = (TOOL_CALL_OPEN, MISTRAL_MARK)

    def __init__(self, tool_names=None):
        self.names = set(tool_names) if tool_names is not None else None
        self.buf = ""
        self.mode = "content"      # "content" | "block" | "json"
        self.n_calls = 0

    def _payload(self, obj):
        c = _call_payload(obj)
        if c is not None and self.names is not None and \
                c["function"]["name"] not in self.names:
            return None
        return c

    def _call_delta(self, call) -> dict:
        d = {"tool_calls": [{"index": self.n_calls, "id": call["id"],
                             "type": "function",
                             "function": call["function"]}]}
        self.n_calls += 1
        return d

    def push(self, delta_text: str) -> List[dict]:
        self.buf += delta_text
        out: List[dict] = []
        while True:
            if self.mode == "content":
                starts = []
                open_i = self.buf.find(TOOL_CALL_OPEN)
                if open_i != -1:
                    starts.append((open_i, "block", len(TOOL_CALL_OPEN)))
                mist_i = self.buf.find(MISTRAL_MARK)
                if mist_i != -1:
                    starts.append((mist_i, "json", len(MISTRAL_MARK)))
                if not self.n_calls:
                    brace_i = self.buf.find("{")
                    if brace_i != -1:
                        starts.append((brace_i, "json", 0))
                if starts:
                    i, mode, skip = min(starts)
                    pre = self.buf[:i]
                    if pre:
                        out.append({"content": pre})
                    self.buf = self.buf[i + skip:]
                    self.mode = mode
                    continue
                hold = _longest_marker_suffix(self.buf, self.MARKERS)
                # also hold back a trailing "{" tail (possible bare JSON)
                if not self.n_calls:
                    b = self.buf.find("{")
                    if b != -1:
                        hold = max(hold, len(self.buf) - b)
                emit = self.buf[:len(self.buf) - hold]
                if emit:
                    out.append({"content": emit})
                    self.buf = self.buf[len(emit):]
                return out
            if self.mode == "block":
                body, sep, rest = self.buf.partition(TOOL_CALL_CLOSE)
                if not sep:
                    return out
                try:
                    c = self._payload(json.loads(body.strip()))
                except ValueError:
                    c = None
                if c:
                    out.append(self._call_delta(c))
                elif body.strip():
                    out.append({"content": body})
                self.buf = rest
                self.mode = "content"
                continue
            # "json": buffer until a top-level JSON value parses
            s = self.buf.lstrip()
            if not s:
                return out
            try:
                val, end = json.JSONDecoder().raw_decode(s)
            except ValueError:
                return out      # incomplete (or never-JSON: flushed at finish)
            vals = val if isinstance(val, list) else [val]
            any_call = False
            for v in vals:
                c = self._payload(v)
                if c:
                    out.append(self._call_delta(c))
                    any_call = True
            consumed = len(self.buf) - len(s) + end
            if not any_call:
                out.append({"content": self.buf[:consumed]})
            self.buf = self.buf[consumed:]
            self.mode = "content"
            continue

    def finish(self) -> List[dict]:
        """Flush the held-back tail as content (unterminated markers /
        never-completing JSON are the model's literal output)."""
        tail, self.buf = self.buf, ""
        if self.mode == "block" and tail.strip():
            tail = TOOL_CALL_OPEN + tail
        self.mode = "content"
        return [{"content": tail}] if tail else []
