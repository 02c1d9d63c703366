"""Checkpoint directories: a safetensors reader of the port's own and the
config of a Hugging Face directory.

Port of ``qspec_tpu/model_loader/loader.py::_read_safetensors`` and
``config_from_hf_dir``. The reader needs no ``safetensors`` package: a file
is an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, and the raw little-endian buffers.
It returns torch tensors of the stored dtype (numpy has no bf16; the JAX
reader goes through ``.float()`` instead).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models.registry import resolve

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8}


def read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, CPU tensors of the stored
    dtype viewing one buffer of the file's bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in DTYPES:
            raise NotImplementedError(f"{path}: tensor {name!r} of dtype {meta['dtype']}; "
                                      f"the reader takes {sorted(DTYPES)}")
        dtype, shape = DTYPES[meta["dtype"]], meta["shape"]
        begin, end = meta["data_offsets"]
        if end - begin != dtype.itemsize * int(torch.Size(shape).numel()):
            raise ValueError(f"{path}: tensor {name!r}: {end - begin} bytes for "
                             f"{meta['dtype']} {shape}")
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=begin)
        if begin % dtype.itemsize:
            raw = raw.clone()     # a header not padded to the element size
        out[name] = raw.view(dtype).reshape(shape)
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a ``.safetensors`` file, or of every ``*.safetensors``
    of a directory in sorted order (sharded checkpoints), as the JAX reader
    takes them."""
    if not os.path.isdir(path):
        return read_safetensors_file(path)
    tensors = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors"):
            tensors.update(read_safetensors_file(os.path.join(path, fn)))
    return tensors


def config_from_hf_dir(path: str) -> ModelConfig:
    """The ModelConfig of a Hugging Face checkpoint directory's
    config.json: through the registry when it names ``architectures`` (they
    carry what the model type may lack), else by its model type."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if hf.get("architectures"):
        return resolve(hf)
    return ModelConfig.from_hf_config(hf)
