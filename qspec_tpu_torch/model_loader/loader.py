"""Checkpoint ingestion of llama-keyed checkpoints, and checkpoint
directories.

Port of ``qspec_tpu/model_loader/loader.py``:

- ``read_safetensors`` / ``config_from_hf_dir``: a directory's tensors and
  its config.json. The reader needs no ``safetensors`` package: a file is
  an 8-byte little-endian header length, a JSON header naming each
  tensor's dtype, shape and byte range, and the raw little-endian buffers.
  It returns torch tensors of the stored dtype (numpy has no bf16; the JAX
  reader goes through ``.float()`` instead).
- ``load_hf_float``: a Hugging Face Llama float checkpoint -> the bf16 tree
  (``quant="none"``, gamma norms), served by the bf16 scheme.
- ``quantize_float``: the same checkpoint -> QuaRot-rotated, int4-quantized
  parameters (``quant="w4"``, weightless norms): the norm gammas folded
  into the projections after them, the residual stream rotated by a random
  orthonormal Hadamard Q, the per-head Hadamard on o's input and the
  intermediate one on down's (H_I, whose Paley factor is not symmetric:
  H_28 in 14336 = 28 * 512), so that the model's online Hadamards undo
  them around the quantized activations. The rotations are float32 torch
  products on ``device``, one layer at a time (at Llama-3-8B width the dense
  H_I @ W_down alone is about 1.7 TFLOP a layer), with TF32 off: TF32 would
  round every input to a 10-bit mantissa and move int4 codes wholesale.
  The JAX package does the same algebra in numpy float32; the two agree but
  for the order of a product's sums, so an int4 code may differ by one step
  where w / scale falls within rounding of a tie.
- ``load_qspec``: a reference-format QSpec checkpoint (uint8 [out, in // 2]
  + ``weight_scales``) -> the interchange format (``ops/packing.py``,
  repacked on the device), with
  ``qwen2_quarot``'s q/k/v biases where the config declares ``qkv_bias``
  (the JAX ``load_qspec`` reads no bias and so serves such a checkpoint
  without them: ROADMAP §3).

Scope: the llama graph's dense families (Llama, Mistral, Phi-3, Qwen2,
Qwen3, Gemma, Granite; Helium, and GLM-4 with its fused gate_up_proj and
q/k/v biases, both with the gptj rope) without tensor parallelism, split or
fused (phi-3, GLM-4) q/k/v and gate/up, the qkv bias (split or fused) where the config declares
it, the o and down biases where the checkpoint has them (TeleChat2;
``quantize_float`` rotates them into the residual basis, b -> b Q, where
the JAX one drops them), and in ``load_hf_float`` / ``quantize_float`` the
sparse-MoE layouts (Mixtral's ``block_sparse_moe``, Qwen2-MoE's and
Qwen3-MoE's ``mlp.experts`` with the shared expert and its gate) and Qwen3's
q/k norms, where the config declares them (an undeclared one raises, naming
the config field). ``load_hf_float`` and ``quantize_float`` first map a
remap family's checkpoint (Baichuan, InternLM2, Qwen v1, EXAONE, TeleChat2:
``families.LLAMA_KEY_REMAPS``) onto llama keys; such a layout under a config
of another arch raises, naming the arch that reads it. The other layouts
the JAX loaders take (a gate / up bias, sequence-classification heads,
tensor-parallel layouts, the VLM and audio towers; in ``load_qspec``, as
in the JAX one, experts, q/k norms and the o / down biases) raise
``NotImplementedError`` naming their ROADMAP item. Under QuaRot every width
the rotations need (the hidden size, the head count, the MLP's) must have a
Hadamard construction: one without (Baichuan-13B's 13696 = 2^7 x 107)
raises before any work. The state-dict loaders
``load_hf_float`` and ``quantize_float`` consume the dict they are given (each entry is removed
as it is converted, as ``families.py`` does), so the peak memory stays
near one copy of the float weights; ``load_qspec`` leaves it as it is.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader.families import (LLAMA_KEY_REMAPS, PROJ_KEYS, _Stacker,
                                                   _take, position_params)
from qspec_tpu_torch.lora.layers import quarot_basis
from qspec_tpu_torch.models.llama import (_f32_tensor, check_served, make_hadamards,
                                          pack_lm_head, pack_proj_weight, resolve_device)
from qspec_tpu_torch.models.registry import resolve
from qspec_tpu_torch.ops.hadamard import (decompose_dim, hadamard_f32, hadamard_matrix,
                                          random_hadamard_matrix)
from qspec_tpu_torch.ops.packing import repack_from_reference

# the safetensors dtypes the reader takes (compressed-tensors adds F8_E4M3
# weights and an I64 weight_shape); any other raises, naming itself
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
          "U8": torch.uint8, "F8_E4M3": torch.float8_e4m3fn}


def read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, CPU tensors of the stored
    dtype viewing one buffer of the file's bytes (read into it in one pass,
    without zeroing it first)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = torch.empty(os.path.getsize(path) - 8 - n, dtype=torch.uint8)
        f.readinto(memoryview(buf.numpy()))
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in DTYPES:
            raise NotImplementedError(f"{path}: tensor {name!r} of dtype {meta['dtype']}; "
                                      f"the reader takes {sorted(DTYPES)}")
        dtype, shape = DTYPES[meta["dtype"]], meta["shape"]
        begin, end = meta["data_offsets"]
        if end - begin != dtype.itemsize * int(torch.Size(shape).numel()) or end > buf.numel():
            raise ValueError(f"{path}: tensor {name!r}: bytes {begin}-{end} of "
                             f"{buf.numel()} for {meta['dtype']} {shape}")
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = buf[begin:end]
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


def quantization_config_of(path: str) -> dict:
    """The ``quantization_config`` of a checkpoint directory's config.json
    ({} without one): its ``quant_method`` ("awq", "gptq",
    "compressed-tensors", ...) is what ``LLM(model=<dir>)`` routes by, as
    the JAX package does; a compressed-tensors one's ``format`` picks the
    loader."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f).get("quantization_config") or {}


# ---------------------------------------------------------------------------
# llama-keyed checkpoints
# ---------------------------------------------------------------------------

# key fragments of the layouts the JAX loaders take and the port does not,
# each with what it is and its ROADMAP item
UNPORTED_KEYS = (
    (("mlp.gate_proj.bias", "mlp.up_proj.bias", "mlp.gate_up_proj.bias"),
     "an MLP's gate / up bias (mlp_bias)", "queue 1 item 9"),
    (("score.weight", "score.0.weight", "classifier.weight", "v_head.weight"),
     "a sequence-classification / reward head (score_head)", "queue 1 item 10"),
)
# key fragments of the layouts LLAMA_KEY_REMAPS maps onto llama keys, each
# with the arch that reads it: under a config of that arch the loaders
# remap them first, under any other they raise
REMAP_KEYS = (("self_attn.W_pack.", "baichuan"), ("attention.wqkv.", "internlm2"),
              ("model.tok_embeddings.", "internlm2"), ("attn.c_attn.", "qwen"),
              ("attn.attention.q_proj.", "exaone"), ("self_attention.query.", "telechat2"))
# the o / down biases: read by load_hf_float and quantize_float, not by
# load_qspec (the JAX load_qspec reads no bias)
OD_BIAS_KEYS = ("self_attn.o_proj.bias", "mlp.down_proj.bias")

# key fragments of the layouts load_hf_float and quantize_float take where
# the config declares them, each with what it is and the config field that
# declares it; load_qspec takes only the qkv bias of them (the JAX
# load_qspec reads no expert or q/k norm, and drops the bias)
QKV_BIAS_KEYS = ("self_attn.q_proj.bias", "self_attn.k_proj.bias", "self_attn.v_proj.bias",
                 "self_attn.qkv_proj.bias")
DECLARED_KEYS = (
    ((".mlp.experts.", ".block_sparse_moe.", ".mlp.gate.weight"),
     "a mixture-of-experts MLP (_moe_block)", "num_experts"),
    ((".mlp.shared_expert.", ".mlp.shared_expert_gate."),
     "a shared expert", "shared_expert_intermediate_size"),
    (("self_attn.q_norm.", "self_attn.k_norm."), "per-head q/k norms", "qk_norm"),
    (QKV_BIAS_KEYS, "biased projections (the qkv bias)", "qkv_bias"),
)


def _check_graph(cfg: ModelConfig) -> None:
    """Raise for a graph the llama-keyed loaders do not build: Gemma-2's
    post-block norms under QuaRot (the JAX package refuses them too) and
    DeepSeek-MoE's layout (``families.convert_deepseek``)."""
    if cfg.post_norms and cfg.quant == "w4":
        raise NotImplementedError(
            "QuaRot folds each norm's gamma into the projections after it, and "
            "Gemma-2's post-block norms break that adjacency (the JAX package "
            "refuses it too): serve Gemma-2 as AWQ / GPTQ (load_awq / load_gptq of a "
            "state dict or a directory, or LLM(model=<dir>) of a directory whose "
            "quantization_config names it; ROADMAP queue 1 item 6, done)")
    if cfg.arch == "deepseek":
        check_served(cfg)       # a QuaRot dense prefix of another width: that reason first
        raise NotImplementedError(
            "DeepSeek-MoE (a dense prefix, mlp.shared_experts) is not a llama-keyed "
            "layout: it loads in bf16 through model_loader.families.convert_deepseek "
            "(LLM(model=<dir>, quantization=None))")


def _check_llama_keyed(sd: Dict, cfg: ModelConfig, qspec: bool = False) -> None:
    """Raise for what the port's llama-keyed loaders do not take: Gemma-2's
    post-block norms under QuaRot (the JAX package refuses them too),
    DeepSeek-MoE's layout (``families.convert_deepseek``), the layouts of
    ``UNPORTED_KEYS``, and those of ``DECLARED_KEYS`` where the config does
    not declare them (under ``qspec``: at all, nor an MoE config)."""
    _check_graph(cfg)
    for fragments, what, item in UNPORTED_KEYS:
        hit = next((k for k in sd if any(f in k for f in fragments)), None)
        if hit is not None:
            raise NotImplementedError(f"checkpoint key {hit!r}: {what} is not ported "
                                      f"(ROADMAP {item})")
    for fragment, arch in REMAP_KEYS:
        hit = next((k for k in sd if fragment in k), None)
        if hit is not None:
            raise NotImplementedError(
                f"checkpoint key {hit!r}: a layout that LLAMA_KEY_REMAPS maps onto llama "
                f"keys, read under arch {arch!r} (its config.json's architectures name "
                f"it), not under a config of arch {cfg.arch!r}"
                + ("; load_qspec reads llama keys only" if qspec else ""))
    if qspec:
        hit = next((k for k in sd if any(f in k for f in OD_BIAS_KEYS)), None)
        if hit is not None:
            raise NotImplementedError(f"checkpoint key {hit!r}: load_qspec reads no o / down "
                                      "bias (the JAX load_qspec reads none; ROADMAP queue 1 "
                                      "item 9)")
    if qspec and cfg.num_experts:
        raise NotImplementedError("load_qspec of a mixture-of-experts config: the "
                                  "reference QSpec format has no experts (the JAX "
                                  "load_qspec reads none; ROADMAP queue 1 item 9)")
    for fragments, what, field in DECLARED_KEYS:
        hit = next((k for k in sd if any(f in k for f in fragments)), None)
        if hit is None:
            continue
        if qspec and field != "qkv_bias":
            raise NotImplementedError(f"checkpoint key {hit!r}: {what} is not ported in "
                                      "load_qspec (the JAX load_qspec reads none; "
                                      "ROADMAP queue 1 item 9)")
        if not getattr(cfg, field):
            raise NotImplementedError(
                f"checkpoint key {hit!r}: {what}, which the config does not declare "
                f"({field}={getattr(cfg, field)!r})" + (
                    "; load_qspec reads a qkv bias only where it does (qwen2_quarot); "
                    "other biased layouts: ROADMAP queue 1 item 9" if qspec else ""))


def _qkv_bias(sd: Dict, p: str, take) -> torch.Tensor:
    """Layer prefix ``p``'s q|k|v bias, split or fused (``qkv_proj.bias``),
    each entry through ``take`` (which removes it where the loader consumes
    the dict)."""
    if p + "self_attn.qkv_proj.bias" in sd:
        return take(p + "self_attn.qkv_proj.bias")
    return torch.cat([take(p + f"self_attn.{n}_proj.bias") for n in "qkv"])


def _source(path_or_sd, cfg: Optional[ModelConfig]):
    """(state dict, cfg) of a state dict (its cfg required) or a directory
    (its config.json unless ``cfg`` is given)."""
    if isinstance(path_or_sd, dict):
        if cfg is None:
            raise ValueError("a state dict needs its ModelConfig")
        return path_or_sd, cfg
    return read_safetensors(path_or_sd), cfg or config_from_hf_dir(path_or_sd)


def _remap(sd: Dict, cfg: ModelConfig) -> Dict:
    """A remap family's checkpoint onto llama keys, in place
    (``families.LLAMA_KEY_REMAPS``; the JAX ``quantize_float`` remaps the
    same way, its ``load_family_float`` too)."""
    fn = LLAMA_KEY_REMAPS.get(cfg.arch)
    return sd if fn is None else fn(sd, cfg)


def check_rotatable(cfg: ModelConfig) -> None:
    """Raise, before any work, where QuaRot has no Hadamard for one of the
    widths it rotates: the hidden size (Q), the head count and the MLP's
    width (an MoE's expert and shared-expert widths)."""
    widths = (("hidden size", cfg.hidden_size), ("head count", cfg.num_heads),
              ("MLP width", cfg.expert_intermediate_size if cfg.num_experts
               else cfg.intermediate_size),
              ("shared expert width", cfg.shared_expert_intermediate_size))
    for what, n in widths:
        if not n:
            continue
        try:
            decompose_dim(n) if what != "head count" else hadamard_matrix(n)
        except NotImplementedError:
            raise NotImplementedError(
                f"QuaRot rotation of {cfg.arch!r}: its {what} {n} has no Hadamard "
                "construction (n = K x 2^p needs a Sylvester, Paley or stored H_K; "
                "Baichuan-13B's 13696 = 2^7 x 107 has none), so it cannot be rotated "
                "and quantized; serve it in bf16 (quantization=None)") from None


def _od_biases(sd, num_layers: int) -> tuple:
    """Whether the checkpoint has the o bias and the down bias (OD_BIAS_KEYS):
    where any layer has one, every layer must, or it raises naming them."""
    out = []
    for b in OD_BIAS_KEYS:
        have = [f"model.layers.{li}.{b}" in sd for li in range(num_layers)]
        if any(have) and not all(have):
            raise ValueError(f"{b} on layers {[i for i, h in enumerate(have) if h]} but not "
                             f"on {[i for i, h in enumerate(have) if not h]}: a bias read on "
                             "some layers only would leave the others without it")
        out.append(any(have))
    return tuple(out)


def load_hf_float(path_or_sd, cfg: Optional[ModelConfig] = None, device="cuda"):
    """A Hugging Face Llama float checkpoint (a directory, or a state dict of
    numpy arrays or tensors, consumed) -> (the bf16 tree, cfg with
    ``quant="none"``) on ``device`` (the card unless the caller asks for the
    CPU), the
    JAX ``load_hf_float``'s llama-keyed branch: q|k|v and gate|up
    concatenated (or phi-3's fused ``qkv_proj`` / ``gate_up_proj``), the
    biases it reads (qkv where declared, o and down where present), the
    gammas (plus ``norm_weight_offset``) in bf16, the head tied to the
    embedding's storage when the checkpoint has no ``lm_head.weight``. A
    remap family's checkpoint is mapped onto llama keys first (the JAX
    package's ``load_family_float`` of it)."""
    sd, cfg = _source(path_or_sd, cfg)
    cfg = dataclasses.replace(cfg, quant="none")
    check_served(cfg)
    sd = _remap(sd, cfg)
    _check_llama_keyed(sd, cfg)
    dev = resolve_device(device)
    st = _Stacker(sd, cfg.num_layers, dev)
    o_bias, down_bias = _od_biases(sd, cfg.num_layers)

    def t(name):
        return _take(sd, name, dev).t()

    def norm(name):
        return (_f32_tensor(sd.pop(name), dev) + cfg.norm_weight_offset).to(torch.bfloat16)

    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        if p + "self_attn.qkv_proj.weight" in sd:
            st.put("qkv", li, t(p + "self_attn.qkv_proj.weight"))
        else:
            st.put("qkv", li, torch.cat([t(p + f"self_attn.{n}_proj.weight")
                                         for n in "qkv"], dim=1))
        if cfg.qkv_bias:
            st.put("qkv.b", li, _qkv_bias(sd, p, lambda k: _take(sd, k, dev)))
        st.put("o", li, t(p + "self_attn.o_proj.weight"))
        if o_bias:
            st.put("o.b", li, _take(sd, p + "self_attn.o_proj.bias", dev))
        if down_bias:
            st.put("down.b", li, _take(sd, p + "mlp.down_proj.bias", dev))
        if cfg.num_experts:
            m, names = _moe_names(sd, p)
            st.put("router", li, t(m + "gate.weight"))
            for e in range(cfg.num_experts):
                x = f"{m}experts.{e}."
                st.put("experts_gate_up", (li, e), torch.cat(
                    [t(x + names[0] + ".weight"), t(x + names[1] + ".weight")], dim=1),
                    experts=cfg.num_experts)
                st.put("experts_down", (li, e), t(x + names[2] + ".weight"),
                       experts=cfg.num_experts)
            if cfg.shared_expert_intermediate_size:
                x = m + "shared_expert."
                st.put("shared_gate_up", li, torch.cat([t(x + "gate_proj.weight"),
                                                        t(x + "up_proj.weight")], dim=1))
                st.put("shared_down", li, t(x + "down_proj.weight"))
                if cfg.shared_expert_gated:
                    st.put("shared_gate", li, t(m + "shared_expert_gate.weight"))
        elif p + "mlp.gate_up_proj.weight" in sd:
            st.put("gate_up", li, t(p + "mlp.gate_up_proj.weight"))
        else:
            st.put("gate_up", li, torch.cat([t(p + "mlp.gate_proj.weight"),
                                             t(p + "mlp.up_proj.weight")], dim=1))
        if not cfg.num_experts:
            st.put("down", li, t(p + "mlp.down_proj.weight"))
        st.put("input_norm", li, norm(p + "input_layernorm.weight"))
        st.put("post_norm", li, norm(p + "post_attention_layernorm.weight"))
        if cfg.qk_norm:
            st.put("q_norm", li, norm(p + "self_attn.q_norm.weight"))
            st.put("k_norm", li, norm(p + "self_attn.k_norm.weight"))
    o = st.out
    layers = {name: {"w": o.pop(name)} for name in PROJ_KEYS if name in o}
    for name in ("qkv", "o", "down"):
        if f"{name}.b" in o:
            layers[name]["b"] = o.pop(f"{name}.b")
    layers.update(o)
    embed = _take(sd, "model.embed_tokens.weight", dev)
    head = (_take(sd, "lm_head.weight", dev).t().contiguous() if "lm_head.weight" in sd
            else embed.t())
    params = {"embed": embed, "lm_head": head, "layers": layers,
              "final_norm": norm("model.norm.weight"), **position_params(cfg, dev)}
    return params, cfg


def _moe_names(sd: Dict, p: str):
    """(module prefix, (gate, up, down) names) of layer prefix ``p``'s
    experts: Qwen-MoE's ``mlp.experts.{e}.*_proj`` or Mixtral's
    ``block_sparse_moe.experts.{e}.w1 / w3 / w2``."""
    if f"{p}mlp.experts.0.gate_proj.weight" in sd:
        return p + "mlp.", ("gate_proj", "up_proj", "down_proj")
    return p + "block_sparse_moe.", ("w1", "w3", "w2")


def _require_exact_f32(device: torch.device) -> None:
    """Raise unless float32 products on ``device`` are IEEE float32 (no
    TF32, which keeps 10 mantissa bits of each input)."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("quantize_float needs float32 matmuls without TF32 "
                           "(torch.backends.cuda.matmul.allow_tf32 = False and "
                           "torch.set_float32_matmul_precision('highest')): TF32 "
                           "rounds every input to a 10-bit mantissa")


def quantize_float(path_or_sd, cfg: Optional[ModelConfig] = None, seed: int = 0,
                   bits: Optional[int] = 4, device="cuda"):
    """Offline QuaRot rotation and int4 quantization of a Hugging Face
    Llama float checkpoint (a directory, or a state dict of numpy arrays or
    tensors, consumed) -> (params, cfg with ``quant="w4"``), the JAX
    ``quantize_float``'s dense path. With Q = random_hadamard_matrix(H,
    seed), per layer and in float32 on ``device`` (the card unless the
    caller asks for the CPU):

        qkv      <- Q^T (gamma_in * W_qkv)   (its bias as it is)
        o        <- (H_heads mixing the heads of W_o's rows) Q, its bias b Q
        gate|up  <- Q^T (gamma_post * W)     (each expert's, the shared one's)
        down     <- (H_I W_down) Q, b Q      (each expert's; the shared
                                              expert's by H of its width)
        router, shared_gate <- Q^T (gamma_post * W), in bf16
        embed    <- embed Q;  lm_head <- Q^T (gamma_final * W_lm)

    (the q/k norms stay as they are)
    each projection quantized per output channel and packed
    (``pack_proj_weight``), the head by ``pack_lm_head``; the basis
    (``seed``, the folded gammas) is kept in ``params["quarot"]``
    (``lora.layers.quarot_basis``), so that float-basis LoRA adapters and
    soft prompts can be rotated into it. ``bits=None``
    keeps the rotated weights in bf16 (the rotation algebra without
    quantization). Each layer's float tensors are freed as it is packed.
    A remap family's checkpoint is mapped onto llama keys first, as the JAX
    ``quantize_float`` maps it; the o / down biases it drops are rotated
    here. A width without a Hadamard raises first (``check_rotatable``)."""
    if bits not in (4, None):
        raise ValueError(f"bits={bits!r}: 4 or None")
    sd, cfg = _source(path_or_sd, cfg)
    cfg = dataclasses.replace(cfg, quant="w4")
    check_rotatable(cfg)
    _check_graph(cfg)
    check_served(cfg)
    sd = _remap(sd, cfg)
    _check_llama_keyed(sd, cfg)
    dev = resolve_device(device)
    _require_exact_f32(dev)
    kind = "w4" if bits == 4 else "none"
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    E, Ie, Is = (cfg.num_experts, cfg.expert_intermediate_size,
                 cfg.shared_expert_intermediate_size)
    nh, hd = cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=dev)
    Q = torch.as_tensor(random_hadamard_matrix(H, seed=seed).astype(np.float32), device=dev)
    H_heads = (torch.as_tensor(hadamard_matrix(nh), **f32)
               / torch.tensor(math.sqrt(nh), **f32))
    # the intermediate Hadamard: the MLP's width, or the experts'; the
    # shared expert's of its own width
    H_I = hadamard_f32(Ie if E else I, dev)
    H_S = hadamard_f32(Is, dev) if Is else None

    def t(name):
        return _f32_tensor(sd.pop(name), dev).t()       # [in, out]

    def gamma(name):
        return _f32_tensor(sd.pop(name), dev) + cfg.norm_weight_offset

    st = _Stacker(sd, L, dev)
    put, layers = st.put, st.out
    o_bias, down_bias = _od_biases(sd, L)

    def rotated_bias(name):
        """The o / down bias ``name`` rotated into the residual basis, where
        the checkpoint has them (each layer's then required)."""
        if not (o_bias if name.endswith("o_proj.bias") else down_bias):
            return None
        return _f32_tensor(sd.pop(name), dev) @ Q

    def rotate_in(w):
        """A weight reading the post-attention norm's output: its gamma
        folded in, its input rotated by Q."""
        return Q.T @ (gpost * w)

    gins, gposts = [], []
    for li in range(L):
        p = f"model.layers.{li}."
        gin = gamma(p + "input_layernorm.weight")[:, None]
        gpost = gamma(p + "post_attention_layernorm.weight")[:, None]
        gins.append(gin[:, 0])
        gposts.append(gpost[:, 0])
        if p + "self_attn.qkv_proj.weight" in sd:           # phi-3's fused layout
            qkv = Q.T @ (gin * t(p + "self_attn.qkv_proj.weight"))
        else:
            qkv = torch.cat([Q.T @ (gin * t(p + f"self_attn.{n}_proj.weight"))
                             for n in "qkv"], dim=1)
        # the bias adds after the product: it stays as it is
        bias = (_qkv_bias(sd, p, lambda k: _f32_tensor(sd.pop(k), dev))
                if cfg.qkv_bias else None)
        put("qkv", li, pack_proj_weight(qkv, kind, bias=bias,
                                        col_blocks=(cfg.q_size, cfg.kv_size, cfg.kv_size)))
        del qkv
        # o's input: undo the online per-head Hadamard; its output: Q
        o_w = t(p + "self_attn.o_proj.weight").reshape(nh, hd, H)
        o_w = torch.einsum("jh,hdk->jdk", H_heads, o_w).reshape(nh * hd, H) @ Q
        # a bias on o or down adds to the residual stream: into its basis, b Q
        put("o", li, pack_proj_weight(o_w, kind, bias=rotated_bias(p + "self_attn.o_proj.bias")))
        del o_w
        if E:
            # every expert as the dense MLP; the router and the shared gate
            # read the same rotated, gamma-folded hidden
            m, names = _moe_names(sd, p)
            put("router", li, rotate_in(t(m + "gate.weight")).to(torch.bfloat16))
            for e in range(E):
                x = f"{m}experts.{e}."
                gate_up = torch.cat([rotate_in(t(x + names[0] + ".weight")),
                                     rotate_in(t(x + names[1] + ".weight"))], dim=1)
                put("experts_gate_up", (li, e),
                    pack_proj_weight(gate_up, kind, col_blocks=(Ie, Ie)), experts=E)
                down = (H_I @ t(x + names[2] + ".weight")) @ Q
                put("experts_down", (li, e), pack_proj_weight(down, kind), experts=E)
                del gate_up, down
            if Is:
                x = m + "shared_expert."
                gate_up = torch.cat([rotate_in(t(x + "gate_proj.weight")),
                                     rotate_in(t(x + "up_proj.weight"))], dim=1)
                put("shared_gate_up", li, pack_proj_weight(gate_up, kind, col_blocks=(Is, Is)))
                put("shared_down", li,
                    pack_proj_weight((H_S @ t(x + "down_proj.weight")) @ Q, kind))
                if cfg.shared_expert_gated:
                    put("shared_gate", li, rotate_in(
                        t(m + "shared_expert_gate.weight")).to(torch.bfloat16))
                del gate_up
        else:
            if p + "mlp.gate_up_proj.weight" in sd:         # phi-3's fused layout
                gate_up = rotate_in(t(p + "mlp.gate_up_proj.weight"))
            else:
                gate_up = torch.cat([rotate_in(t(p + "mlp.gate_proj.weight")),
                                     rotate_in(t(p + "mlp.up_proj.weight"))], dim=1)
            put("gate_up", li, pack_proj_weight(gate_up, kind, col_blocks=(I, I)))
            del gate_up
            # the online transform is y_row = a_row @ H_I^T, so the weight
            # takes the untransposed H_I (H_28 is not symmetric)
            down = (H_I @ t(p + "mlp.down_proj.weight")) @ Q
            put("down", li, pack_proj_weight(down, kind,
                                             bias=rotated_bias(p + "mlp.down_proj.bias")))
            del down
        if cfg.qk_norm:
            # after the projection, in the per-head basis the rotations do
            # not touch: the gammas stay live, as they are
            for n in ("q_norm", "k_norm"):
                put(n, li, gamma(p + f"self_attn.{n}.weight").to(torch.bfloat16))

    gfin = gamma("model.norm.weight")[:, None]
    embed = _f32_tensor(sd.pop("model.embed_tokens.weight"), dev)
    lm = t("lm_head.weight") if "lm_head.weight" in sd else embed.t()
    lm_head = pack_lm_head(Q.T @ (gfin * lm), cfg, dev)
    del lm
    params = {"embed": (embed @ Q).to(torch.bfloat16), "lm_head": lm_head,
              "layers": layers, "hadamards": make_hadamards(cfg, dev),
              "quarot": quarot_basis(cfg, seed, torch.stack(gins), torch.stack(gposts)),
              **position_params(cfg, dev)}
    return params, cfg


def load_qspec(path_or_sd, cfg: Optional[ModelConfig] = None, device="cuda"):
    """A reference-format QSpec checkpoint (a directory or a state dict,
    left as it is) -> (params, cfg with ``quant="w4"``) on ``device``
    (the card unless the caller asks for the CPU), the JAX ``load_qspec``
    at ``tp_size=1``: each projection's uint8 [out, in // 2] weight and its
    ``weight_scales`` repacked into the interchange format
    (``repack_from_reference``), the reference's ``o_proj.1.`` /
    ``down_proj.1.`` keys remapped, split or fused q/k/v and gate/up
    concatenated, the float head packed by ``pack_lm_head``; where the
    config declares ``qkv_bias`` (``qwen2_quarot``), the q/k/v biases, split
    or fused, as ``layers["qkv"]["b"]`` (bf16, as the other loaders keep
    them). A checkpoint without ``weight_scales`` (a float one) raises
    KeyError."""
    sd, cfg = _source(path_or_sd, cfg)
    cfg = dataclasses.replace(cfg, quant="w4")
    check_served(cfg)
    sd = {k.replace("o_proj.1.", "o_proj.").replace("down_proj.1.", "down_proj."): v
          for k, v in sd.items()}
    _check_llama_keyed(sd, cfg, qspec=True)
    dev = resolve_device(device)

    def qproj(prefix):
        scales = _f32_tensor(sd[prefix + ".weight_scales"], dev).reshape(-1)
        packed = repack_from_reference(torch.as_tensor(sd[prefix + ".weight"]).to(dev))
        return packed, scales

    def cat(prefixes):
        parts = [qproj(p) for p in prefixes]
        return {"qw": torch.cat([q for q, _ in parts], dim=1),
                "qs": torch.cat([s for _, s in parts])}

    layers, biases = [], []
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        fused_qkv = p + "self_attn.qkv_proj.weight" in sd
        fused_gu = p + "mlp.gate_up_proj.weight" in sd
        if cfg.qkv_bias:
            biases.append(_qkv_bias(sd, p, lambda k: _f32_tensor(sd[k], dev)))
        layers.append({
            "qkv": cat([p + "self_attn.qkv_proj"] if fused_qkv else
                       [p + f"self_attn.{n}_proj" for n in "qkv"]),
            "o": cat([p + "self_attn.o_proj"]),
            "gate_up": cat([p + "mlp.gate_up_proj"] if fused_gu else
                           [p + "mlp.gate_proj", p + "mlp.up_proj"]),
            "down": cat([p + "mlp.down_proj"]),
        })
    lm = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    stacked = {name: {key: torch.stack([layer[name][key] for layer in layers])
                      for key in ("qw", "qs")}
               for name in ("qkv", "o", "gate_up", "down")}
    if biases:
        stacked["qkv"]["b"] = torch.stack(biases).to(torch.bfloat16)
    params = {
        "embed": _f32_tensor(sd["model.embed_tokens.weight"], dev).to(torch.bfloat16),
        "lm_head": pack_lm_head(_f32_tensor(lm, dev).t(), cfg, dev),
        "layers": stacked,
        "hadamards": make_hadamards(cfg, dev),
        **position_params(cfg, dev),
    }
    return params, cfg
