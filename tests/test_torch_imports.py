"""The port stands alone: importing qspec_tpu_torch, its engine and every
module under it, and chip_smoke.py, loads neither jax nor qspec_tpu.

Checked in a subprocess: tests/conftest.py imports jax into this process.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "qspec_tpu_torch"

PROBE = r"""
import importlib, json, pkgutil, sys
import qspec_tpu_torch
from qspec_tpu_torch.engine.llm_engine import LLMEngine
for m in pkgutil.walk_packages(qspec_tpu_torch.__path__, "qspec_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "qspec_tpu"
             or m.startswith("qspec_tpu."))
print(json.dumps(bad))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax():
    """No source of the port (nor chip_smoke.py) imports jax or qspec_tpu,
    even in a function body."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "qspec_tpu"), (f, n)


def test_chip_smoke_without_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
