"""Runtime LoRA adapter lifecycle: load, unload and LRU eviction over the
engine's slot bank.

Port of ``qspec_tpu/lora/manager.py``. The bank (``params["lora"]``,
``lora/layers.py``) is fixed in shape and lives on the engine's device;
installing or evicting an adapter writes its slot in place, and the
manager only decides which named adapter owns which slot. Slot 0 is the
base model and is never handed out. ``LLMEngine.lora`` is the engine's
manager; the OpenAI server's ``/v1/load_lora_adapter`` and
``/v1/unload_lora_adapter`` call it on the engine's worker thread, between
steps.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from qspec_tpu_torch.lora.layers import Rotation, load_peft_adapter
from qspec_tpu_torch.model_loader.loader import read_safetensors_file


class LoRASlotError(RuntimeError):
    pass


class LoRAManager:
    """The name -> slot map over an engine's adapter bank."""

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.RLock()
        params = engine.runner.params
        if "lora" not in params:
            raise LoRASlotError(
                "the engine has no adapter bank: pass params['lora'] = "
                "init_lora_params(cfg, LoRAConfig(...)) when building it")
        bank = params["lora"]["layers"]["qkv"]["A"]
        self.max_slots = int(bank.shape[1])
        self.max_rank = int(bank.shape[-1])
        self._rotation = None
        if "quarot" in params:
            self._rotation = Rotation(engine.config.model, params["quarot"], bank.device)
        # name -> {"slot", "loaded_at", "last_used"}
        self._adapters: Dict[str, dict] = {}

    # ---- queries ------------------------------------------------------
    def list_adapters(self) -> List[dict]:
        with self._lock:
            return [{"name": n, "slot": a["slot"], "loaded_at": a["loaded_at"],
                     "last_used": a["last_used"]}
                    for n, a in sorted(self._adapters.items(), key=lambda kv: kv[1]["slot"])]

    def slot_of(self, name: Optional[str]) -> int:
        """A request's slot for an adapter name (None or "": the base, 0);
        bumps the adapter's LRU clock."""
        if not name:
            return 0
        with self._lock:
            a = self._adapters.get(name)
            if a is None:
                raise LoRASlotError(f"adapter {name!r} not loaded (loaded: "
                                    f"{sorted(self._adapters)})")
            a["last_used"] = time.time()
            return a["slot"]

    # ---- lifecycle ----------------------------------------------------
    def load(self, name: str, state_dict: Dict, *, alpha: Optional[float] = None) -> int:
        """Install a PEFT-style adapter under ``name``; returns its slot. A
        loaded name is overwritten in its slot; with the bank full, the
        least recently used adapter that no queued, running or swapped
        request holds is evicted."""
        with self._lock:
            slot = (self._adapters[name]["slot"] if name in self._adapters
                    else self._free_slot())
            bank = self._engine.runner.params["lora"]
            self._clear_slot(bank, slot)
            load_peft_adapter(bank, self._engine.config.model, slot, state_dict,
                              alpha=alpha, rotation=self._rotation)
            now = time.time()
            self._adapters[name] = {"slot": slot, "loaded_at": now, "last_used": now}
            return slot

    def load_path(self, name: str, path: str, *, alpha: Optional[float] = None) -> int:
        """Load from a PEFT checkpoint: a directory (``adapter_model
        .safetensors`` or ``.npz``; ``lora_alpha`` from its
        ``adapter_config.json`` unless ``alpha`` is given) or one file."""
        if os.path.isdir(path):
            cfg_p = os.path.join(path, "adapter_config.json")
            if alpha is None and os.path.exists(cfg_p):
                with open(cfg_p) as f:
                    alpha = json.load(f).get("lora_alpha")
            path = next((os.path.join(path, fn) for fn in ("adapter_model.safetensors",
                                                            "adapter_model.npz")
                         if os.path.exists(os.path.join(path, fn))), path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                sd = {k: z[k] for k in z.files}
        elif path.endswith(".safetensors"):
            sd = read_safetensors_file(path)
        else:
            raise LoRASlotError(f"unsupported adapter format: {path} (a PEFT directory, "
                                "adapter_model.safetensors or .npz)")
        return self.load(name, sd, alpha=alpha)

    def unload(self, name: str) -> None:
        """Free an adapter's name and zero its slot (no stale delta reaches a
        later tenant). An adapter a request still holds stays loaded."""
        with self._lock:
            a = self._adapters.get(name)
            if a is None:
                raise LoRASlotError(f"adapter {name!r} not loaded")
            if a["slot"] in self._active_slots():
                raise LoRASlotError(f"adapter {name!r} is held by queued or running requests")
            del self._adapters[name]
            self._clear_slot(self._engine.runner.params["lora"], a["slot"])

    # ---- internals ----------------------------------------------------
    def _active_slots(self) -> set:
        sch = self._engine.scheduler
        return {s.lora_id for q in (sch.waiting, sch.running, sch.swapped) for s in q}

    def _free_slot(self) -> int:
        used = {a["slot"] for a in self._adapters.values()}
        free = next((s for s in range(1, self.max_slots) if s not in used), None)
        if free is not None:
            return free
        active = self._active_slots()
        victims = sorted((a["last_used"], n) for n, a in self._adapters.items()
                         if a["slot"] not in active)
        if not victims:
            raise LoRASlotError(f"all {self.max_slots - 1} adapter slots are held by "
                                "queued or running requests")
        return self._adapters.pop(victims[0][1])["slot"]

    @staticmethod
    def _clear_slot(bank, slot: int) -> None:
        for ab in bank["layers"].values():
            ab["A"][:, slot] = 0
            ab["B"][:, slot] = 0
