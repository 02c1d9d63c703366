"""Soft-prompt (prompt-tuning) adapters.

Port of ``qspec_tpu/prompt_adapter.py``: a PEFT prompt-tuning checkpoint
is a matrix of ``num_virtual_tokens`` embedding rows prepended to every
prompt of the requests that name it. The engine already serves per-request
embedding rows (``add_request(prompt_embeds=)``), so a soft prompt is
[adapter rows | the prompt's table rows] over placeholder ids 0: no model
or kernel change, any scheme, with LoRA and speculative decoding.

The rows are trained in the float model's basis. On a model that
``quantize_float`` rotated (``params["quarot"]``) they are rotated as its
embedding table was (rows Q) when loaded; elsewhere they are taken in the
served basis, as the JAX package takes them. At splice time they are
scaled by the model's ``embed_scale`` (Gemma), in bf16 as the table's rows
are; the JAX package leaves them unscaled.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from qspec_tpu_torch.lora.layers import Rotation
from qspec_tpu_torch.model_loader.loader import read_safetensors_file
from qspec_tpu_torch.models.llama import embed_rows


class PromptAdapterError(RuntimeError):
    pass


class PromptAdapterManager:
    """Named soft prompts of an engine (``LLMEngine.prompt_adapters``): f32
    rows on the engine's device, in the served basis."""

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self._adapters: Dict[str, torch.Tensor] = {}
        params = engine.runner.params
        self._rotation = (Rotation(engine.config.model, params["quarot"], engine.device)
                          if "quarot" in params else None)

    def load(self, name: str, embeddings) -> int:
        """Register ``embeddings`` [n_virtual, hidden] (float basis) under
        ``name``; returns the virtual token count."""
        H = self._engine.config.model.hidden_size
        emb = torch.as_tensor(np.asarray(embeddings, np.float32)
                              if not isinstance(embeddings, torch.Tensor) else embeddings)
        if emb.ndim != 2 or emb.shape[1] != H:
            raise PromptAdapterError(f"prompt adapter must be [n, {H}], got {tuple(emb.shape)}")
        emb = emb.to(device=self._engine.device, dtype=torch.float32)
        if self._rotation is not None:
            emb = self._rotation.embeddings(emb)
        with self._lock:
            self._adapters[name] = emb
        return emb.shape[0]

    def load_path(self, name: str, path: str) -> int:
        """Load a PEFT prompt-tuning checkpoint (a directory's
        ``adapter_model.safetensors`` / ``.npz``, or the file), whose
        ``prompt_embeddings`` tensor holds the rows."""
        if os.path.isdir(path):
            path = next((os.path.join(path, fn) for fn in ("adapter_model.safetensors",
                                                            "adapter_model.npz")
                         if os.path.exists(os.path.join(path, fn))), path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                sd = {k: z[k] for k in z.files}
        elif path.endswith(".safetensors"):
            sd = read_safetensors_file(path)
        else:
            raise PromptAdapterError(f"unsupported adapter format: {path}")
        key = next((k for k in sd if "prompt_embeddings" in k or k == "embedding.weight"), None)
        if key is None:
            raise PromptAdapterError(f"no prompt_embeddings tensor in {path} "
                                     f"(keys: {sorted(sd)})")
        return self.load(name, sd[key])

    def unload(self, name: str) -> None:
        with self._lock:
            if self._adapters.pop(name, None) is None:
                raise PromptAdapterError(f"adapter {name!r} not loaded")

    def list_adapters(self) -> List[dict]:
        with self._lock:
            return [{"name": n, "virtual_tokens": int(a.shape[0])}
                    for n, a in sorted(self._adapters.items())]

    def get(self, name: str) -> torch.Tensor:
        with self._lock:
            a = self._adapters.get(name)
        if a is None:
            raise PromptAdapterError(f"prompt adapter {name!r} not loaded (loaded: "
                                     f"{[x['name'] for x in self.list_adapters()]})")
        return a

    def splice(self, name: Optional[str], prompt_token_ids: List[int]) -> tuple:
        """(token ids, prompt embeddings [n + T, H] f32) with the adapter's
        rows before the prompt's: placeholder id 0 over the virtual
        positions (never looked up), the table's rows at the prompt's."""
        rows = self.get(name)
        eng = self._engine
        cfg = eng.config.model
        params = eng.runner.params
        virt = rows.to(torch.bfloat16)
        if cfg.embed_scale is not None:
            virt = virt * torch.tensor(cfg.embed_scale, dtype=virt.dtype, device=virt.device)
        real = embed_rows(params, cfg, torch.as_tensor(prompt_token_ids, dtype=torch.int64,
                                                       device=rows.device))
        embeds = torch.cat([virt, real], dim=0).to(torch.float32)
        return [0] * rows.shape[0] + list(prompt_token_ids), embeds
