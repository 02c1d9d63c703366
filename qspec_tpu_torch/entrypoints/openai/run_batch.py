"""Offline OpenAI Batch-API runner.

The port of ``qspec_tpu/entrypoints/openai/run_batch.py``. Input: a JSONL
file, one OpenAI batch request a line::

    {"custom_id": "req-1", "method": "POST", "url": "/v1/chat/completions",
     "body": {"messages": [...], "max_tokens": 16}}

Endpoints: /v1/completions and /v1/chat/completions (streaming is not a
batch answer). Output: a JSONL file of batch outputs::

    {"id": "qspec-batch-...", "custom_id": "req-1",
     "response": {"status_code": 200, "body": {...}}, "error": null}

Every request goes to the server's own handler (``OpenAIServer.respond``)
in-process, all at once: the engine's continuous batching schedules them.

    python -m qspec_tpu_torch.entrypoints.openai.run_batch -i in.jsonl -o out.jsonl \\
        --model <dir-or-preset> [engine flags]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import uuid

from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.entrypoints.openai.api_server import OpenAIServer, Request, build_server

URLS = ("/v1/chat/completions", "/v1/completions")


def _batch_id() -> str:
    return f"qspec-batch-{uuid.uuid4().hex[:16]}"


async def run_request(server: OpenAIServer, line: str) -> dict:
    try:
        req = json.loads(line)
    except json.JSONDecodeError as e:
        return {"id": _batch_id(), "custom_id": None, "response": None,
                "error": {"message": f"invalid JSON: {e}"}}
    url = req.get("url", "")
    body = req.get("body") or {}
    out = {"id": _batch_id(), "custom_id": req.get("custom_id"), "response": None,
           "error": None}
    if req.get("method", "POST") != "POST" or url not in URLS:
        out["error"] = {"message": f"unsupported method/url {req.get('method')} {url}"}
        return out
    if body.get("stream"):
        out["error"] = {"message": "a batch request is not streamed"}
        return out
    resp = await server.respond(Request("POST", url, {}, json.dumps(body).encode()))
    answer = resp.json()
    out["response"] = {"status_code": resp.status, "body": answer}
    if resp.status != 200:
        out["error"] = {"message": answer.get("message") or str(answer)}
    return out


async def run_batch(server: OpenAIServer, input_path: str, output_path: str) -> int:
    """Run every request of ``input_path`` through ``server``; returns the
    number answered with 200."""
    with open(input_path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    results = await asyncio.gather(*(run_request(server, ln) for ln in lines))
    with open(output_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    return sum(1 for r in results if r["response"] and r["response"]["status_code"] == 200)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-i", "--input-file", required=True)
    ap.add_argument("-o", "--output-file", required=True)
    ap.add_argument("--device", default="cuda")
    EngineArgs.add_cli_args(ap)
    args = ap.parse_args(argv)
    server = build_server(EngineArgs.from_cli_args(args), device=args.device)
    ok = asyncio.run(run_batch(server, args.input_file, args.output_file))
    print(f"wrote {args.output_file}: {ok} ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
