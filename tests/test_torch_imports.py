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
from qspec_tpu_torch.model_loader.grouped import load_awq, load_gptq
from qspec_tpu_torch.model_loader.ct import load_compressed_tensors, make_ct_state_dict
from qspec_tpu_torch.model_loader.gguf import load_gguf, write_gguf
from qspec_tpu_torch.spec_decode.medusa import load_medusa, medusa_propose_tree
from qspec_tpu_torch.spec_decode.eagle import load_eagle, eagle_layer_step
from qspec_tpu_torch.spec_decode.mlp_speculator import load_mlp_speculator
from qspec_tpu_torch.model_loader.families import convert_bloom, convert_mpt
from qspec_tpu_torch.model_loader.loader import (read_safetensors, config_from_hf_dir,
                                                 load_hf_float, load_qspec, quantize_float)
from qspec_tpu_torch.ops.hadamard import random_hadamard_matrix
from qspec_tpu_torch.ops.packing import pack_reference, repack_from_reference
from qspec_tpu_torch.models.llama import pack_proj_weight
from qspec_tpu_torch.ops.ngram import ngram_match_device
from qspec_tpu_torch.lora import init_lora_params, load_peft_adapter, lora_delta
from qspec_tpu_torch.lora.manager import LoRAManager
from qspec_tpu_torch.core.swap import HostSwapPool
from qspec_tpu_torch.prompt_adapter import PromptAdapterManager
from qspec_tpu_torch.beam_search import beam_search
from qspec_tpu_torch import envs, plugins
for m in pkgutil.walk_packages(qspec_tpu_torch.__path__, "qspec_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "qspec_tpu"
             or m.startswith("qspec_tpu."))
port = sorted(m for m in sys.modules if m.startswith("qspec_tpu_torch."))
print(json.dumps([bad, port]))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    # every module was imported, the checkpoint loaders' (the float and
    # QSpec Llama loaders, compressed-tensors and GGUF among them), Medusa's, EAGLE's, MLPSpeculator's,
    # the n-gram matcher's, the grammar compiler's, and the engine
    # surface's (LoRA, swap, prompt adapters, beam search, envs, plugins)
    assert {"qspec_tpu_torch.guided", "qspec_tpu_torch.guided.regex_dfa",
            "qspec_tpu_torch.guided.json_schema", "qspec_tpu_torch.guided.tokenfsm",
            "qspec_tpu_torch.model_loader", "qspec_tpu_torch.model_loader.grouped",
            "qspec_tpu_torch.model_loader.families", "qspec_tpu_torch.model_loader.loader",
            "qspec_tpu_torch.model_loader.ct", "qspec_tpu_torch.model_loader.gguf",
            "qspec_tpu_torch.ops.linear_kernels", "qspec_tpu_torch.ops.ngram",
            "qspec_tpu_torch.engine.model_runner", "qspec_tpu_torch.ops.hadamard",
            "qspec_tpu_torch.ops.packing", "qspec_tpu_torch.entrypoints.llm",
            "qspec_tpu_torch.spec_decode.medusa",
            "qspec_tpu_torch.spec_decode.medusa_tree", "qspec_tpu_torch.spec_decode.eagle",
            "qspec_tpu_torch.spec_decode.mlp_speculator", "qspec_tpu_torch.lora",
            "qspec_tpu_torch.lora.layers", "qspec_tpu_torch.lora.manager",
            "qspec_tpu_torch.core.swap", "qspec_tpu_torch.prompt_adapter",
            "qspec_tpu_torch.beam_search", "qspec_tpu_torch.envs",
            "qspec_tpu_torch.plugins"} <= set(port)


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


SERVER_PROBE = r"""
import json, sys
import qspec_tpu_torch.scripts
import qspec_tpu_torch.entrypoints.openai.api_server
import qspec_tpu_torch.entrypoints.openai.run_batch
import qspec_tpu_torch.engine.async_engine
import qspec_tpu_torch.engine.metrics
import qspec_tpu_torch.tracing
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(tops & {"jax", "jaxlib", "qspec_tpu", "aiohttp", "transformers",
                                "prometheus_client", "opentelemetry"})))
"""


def test_server_modules_import_no_optional_packages():
    """The server, its async engine, metrics and traces load none of jax,
    qspec_tpu, aiohttp, transformers, prometheus_client or opentelemetry
    (the card's machine has none of them): the optional ones are imported
    only where used."""
    out = subprocess.run([sys.executable, "-c", SERVER_PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
