"""Command-line entry points: the port of ``qspec_tpu/scripts.py``.

    python -m qspec_tpu_torch.scripts serve --model llama3-8b \\
        --num-speculative-tokens 3 --port 8000          # on the card
    python -m qspec_tpu_torch.scripts serve --model tiny --device cpu

``serve`` runs the OpenAI-compatible server (``entrypoints/openai/
api_server.py``) with every EngineArgs flag. The JAX package's ``bench`` and
``demo`` run its own ``bench.py`` / ``demo.py``, which import JAX; the port
has no bench yet (ROADMAP queue 1 item 2), so both are refused.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from qspec_tpu_torch.engine.arg_utils import EngineArgs


def main(argv=None):
    parser = argparse.ArgumentParser(prog="qspec-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="OpenAI-compatible server")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8000)
    serve.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    EngineArgs.add_cli_args(serve)
    for name in ("bench", "demo"):
        sub.add_parser(name, help="not ported")

    args, rest = parser.parse_known_args(argv)
    if args.cmd == "serve" and rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd != "serve":
        print(f"qspec-tpu-torch {args.cmd}: the port has no {args.cmd} yet (the JAX "
              "package's runs its JAX bench.py / demo.py; ROADMAP queue 1 item 2)",
              file=sys.stderr)
        return 2
    from qspec_tpu_torch.entrypoints.openai.api_server import build_server
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    server = build_server(EngineArgs.from_cli_args(args), device=args.device)
    asyncio.run(server.serve_forever(args.host, args.port))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
