"""compressed-tensors checkpoint ingestion (llm-compressor's output).

Port of ``qspec_tpu/model_loader/ct.py``, in torch on the given device (the
card unless the caller asks for the CPU). Each scheme lands on a path the
port already serves:

* ``pack-quantized`` int4 (group or channel strategy, symmetric or
  asymmetric, zero points plain or packed) -> the grouped-int4
  representation (quant="w4g", ``ops.linear_kernels.matmul_w4a16_g``)
  shared with AWQ / GPTQ, through ``grouped._load_grouped``'s
  ``proj_reader`` hook;
* ``int-quantized`` int8 weights, per-channel or per-tensor symmetric (the
  W8A16 / W8A8 recipes) -> quant="w8" parameters
  (``ops.linear_kernels.matmul_w8a16``, int8 instantiation);
* ``float-quantized`` fp8 e4m3 weights, per-channel or per-tensor
  (llm-compressor's FP8 / FP8_DYNAMIC recipes and ``fbgemm_fp8``
  checkpoints) -> quant="w8" parameters whose ``"w8"`` leaf *is*
  float8_e4m3fn (the fp8 instantiation of the same kernel).

W8A8 recipes serve with bf16 activations, as in the JAX package: quantized
activations are QuaRot's (quant="w4"), and serving them at A16 only raises
fidelity.

Tensor layout (compressed_tensors' pack_to_int32, the de-facto
llm-compressor output):

* ``<proj>.weight_packed`` int32 [N, K // 8]: eight 4-bit values a word,
  little-endian along K, stored as (signed q + 8) unsigned nibbles;
* ``<proj>.weight_scale`` [N, G] (G = K // group_size; 1 for the channel
  and tensor strategies), fp16 / bf16 / f32;
* ``<proj>.weight_zero_point``: absent or zero when symmetric; int [N, G],
  or packed int32 [ceil(N / 8), G] (packed_dim=0), when asymmetric. Zero
  points are SIGNED offsets in q-space: w = (q_signed - zp) * s with
  q_signed = nibble - 8;
* ``<proj>.weight_shape`` [2] = (N, K);
* ``int-quantized``: ``<proj>.weight`` int8 [N, K] + ``weight_scale``
  [N, 1] or one value; ``float-quantized`` the same with an e4m3 weight.

Where the JAX ``_load_channelwise`` drops what a checkpoint carries, the port
reads it: Qwen3's q/k norms (where the config declares ``qk_norm``) and the
o / down biases (``loader.OD_BIAS_KEYS``), as its grouped loader does
(ROADMAP queue 3 keeps these caveats about the reference). An MoE raises
(the JAX loader reads no expert). Per-group int8 / fp8 scales and
act-order ``g_idx`` raise, naming the recipes that are served.

The writers ``make_ct_packed_tensors``, ``make_ct_int8_tensors`` and
``make_ct_fp8_tensors`` quantize a float [K, N] tensor on its device with
the bits of the JAX package's numpy writers; ``make_ct_state_dict`` makes a
whole Hugging Face-named checkpoint of a config on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader.grouped import (_load_grouped, _nibbles, _pack_words,
                                                  _resolve, _t)

FP8 = torch.float8_e4m3fn


def _fp8_tensor(a, device=None) -> torch.Tensor:
    """An fp8 e4m3 array or tensor as a float8_e4m3fn tensor: an ml_dtypes
    float8_e4m3fn array bit for bit (``models.llama._tensor``); an ml_dtypes
    float8_e4m3 one (another encoding, the same values but for its
    infinities) converted, as the JAX loader's ``astype`` does."""
    from qspec_tpu_torch.models.llama import _tensor
    if torch.is_tensor(a):
        t = a
    elif np.asarray(a).dtype.name == "float8_e4m3fn":
        t = _tensor(a, "cpu")
    else:
        t = torch.from_numpy(np.asarray(a, np.float32)).to(FP8)
    return t if device is None else t.to(device)


def _is_fp8(a) -> bool:
    if torch.is_tensor(a):
        return a.dtype == FP8
    return np.asarray(a).dtype.name in ("float8_e4m3fn", "float8_e4m3")


# ---------------------------------------------------------------------------
# pack-quantized int4
# ---------------------------------------------------------------------------


def _unpack_packed_int4(packed: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """weight_packed int32 [N, K // 8] -> unsigned nibbles [K, N] (0..15,
    excess-8: nibble == signed q + 8)."""
    q = _nibbles(packed).reshape(packed.shape[0], -1)[:n, :k]
    return q.t().contiguous()


def _unpack_zero_point(zp_t, n: int, G: int, device) -> torch.Tensor:
    """-> SIGNED zero points [G, N] int16 (0 when symmetric)."""
    if zp_t is None:
        return torch.zeros((G, n), dtype=torch.int16, device=device)
    zp_t = _t(zp_t, device)
    if zp_t.dtype == torch.int32 and zp_t.shape[0] != n:
        # packed along N (packed_dim=0): int32 [ceil(N / 8), G], excess-8
        return _nibbles(zp_t.t()).reshape(G, -1)[:, :n].to(torch.int16) - 8
    return zp_t.to(torch.int16).reshape(n, G).t()


def _ct_reader(sd: dict, device):
    """proj_reader(prefix) -> (q [K, N] unsigned, zp [G, N] unsigned, s [G, N]
    f32) on ``device``, in the AWQ / GPTQ triple convention of grouped.py
    (w = (q - zp) * s with unsigned q and zp)."""

    def reader(prefix: str):
        packed = _t(sd[prefix + ".weight_packed"], device)
        scale = _t(sd[prefix + ".weight_scale"], device).to(torch.float32)
        if prefix + ".weight_shape" in sd:
            n, k = (int(v) for v in _t(sd[prefix + ".weight_shape"]).tolist())
        else:
            n, k = packed.shape[0], packed.shape[1] * 8
        gi = sd.get(prefix + ".weight_g_idx")
        if gi is not None:
            g = k // max(scale.reshape(n, -1).shape[1], 1)
            want = torch.arange(k, device=device) // g
            if not torch.equal(_t(gi, device).to(torch.int64), want):
                raise NotImplementedError(
                    "compressed-tensors act-order (g_idx) checkpoints are not "
                    "supported; re-quantize without activation ordering")
        q = _unpack_packed_int4(packed, n, k)               # [K, N] excess-8
        scale = scale.reshape(n, -1).t()                    # [G, N]
        G = scale.shape[0]
        zp_signed = _unpack_zero_point(sd.get(prefix + ".weight_zero_point"), n, G, device)
        if k % G:
            raise ValueError(f"scale groups {G} do not divide K={k}")
        if G == 1:
            # channel / tensor strategy: expanded to g = 128-style groups so
            # the grouped kernel's (even G, g | K/2) block constraints hold
            G2 = max(2, k // 128) if k % 128 == 0 else 2
            scale = scale.repeat_interleave(G2, dim=0)
            zp_signed = zp_signed.repeat_interleave(G2, dim=0)
        # CT dequant is (q_signed - zp_signed) * s = ((q_u - 8) - zp_s) * s,
        # so the unsigned zero point is zp_signed + 8
        zp = (zp_signed + 8).to(torch.uint8)
        return q, zp, scale.contiguous()

    return reader


def load_ct_packed(path_or_sd, cfg: Optional[ModelConfig] = None, tp_size: int = 1,
                   device="cuda"):
    """A pack-quantized int4 checkpoint -> (grouped-int4 params on
    ``device``, cfg with quant="w4g")."""
    from qspec_tpu_torch.models.llama import resolve_device
    sd, cfg = _resolve(path_or_sd, cfg)
    dev = resolve_device(device)
    return _load_grouped(sd, cfg, "ct", tp_size, dev, proj_reader=_ct_reader(sd, dev))


# ---------------------------------------------------------------------------
# int-quantized / float-quantized channelwise weights
# ---------------------------------------------------------------------------


def _channel_scales(sd: dict, prefix: str, n: int, device) -> torch.Tensor:
    s = _t(sd[prefix + ".weight_scale"], device).to(torch.float32).reshape(-1)
    if s.shape[0] == 1:
        s = s.expand(n).contiguous()
    return s


def load_ct_int8(path_or_sd, cfg: Optional[ModelConfig] = None, tp_size: int = 1,
                 device="cuda"):
    """An int-quantized int8 checkpoint (per-channel or per-tensor
    symmetric) -> (quant="w8" params on ``device``, cfg)."""
    from qspec_tpu_torch.models.llama import resolve_device
    sd, cfg = _resolve(path_or_sd, cfg)
    dev = resolve_device(device)

    def proj(prefix):
        w = _t(sd[prefix + ".weight"], dev).to(torch.int8)           # [N, K]
        s = _channel_scales(sd, prefix, w.shape[0], dev)
        if s.shape[0] != w.shape[0]:
            raise NotImplementedError(
                "per-group int8 weights are not supported; use per-channel "
                "or per-tensor scales (or the pack-quantized int4 format)")
        return w.t(), s

    return _load_channelwise(sd, cfg, proj, tp_size, dev)


def load_ct_fp8(path_or_sd, cfg: Optional[ModelConfig] = None, tp_size: int = 1,
                device="cuda"):
    """A float-quantized (fp8 e4m3) checkpoint, llm-compressor's FP8
    recipes and fbgemm_fp8 (the same tensors, per-channel scale) -> (quant=
    "w8" params whose weight leaves are float8_e4m3fn, on ``device``; cfg)."""
    from qspec_tpu_torch.models.llama import resolve_device
    sd, cfg = _resolve(path_or_sd, cfg)
    dev = resolve_device(device)

    def proj(prefix):
        w = sd[prefix + ".weight"]
        if not _is_fp8(w):
            dt = w.dtype if torch.is_tensor(w) else np.asarray(w).dtype
            raise ValueError(f"{prefix}.weight has dtype {dt}, expected fp8 e4m3 "
                             "for a float-quantized checkpoint")
        w = _fp8_tensor(w, dev)                                      # [N, K]
        s = _channel_scales(sd, prefix, w.shape[0], dev)
        if s.shape[0] != w.shape[0]:
            raise NotImplementedError(
                "per-group fp8 scales are not supported; use per-channel "
                "or per-tensor weight_scale")
        return w.t(), s

    return _load_channelwise(sd, cfg, proj, tp_size, dev)


def _load_channelwise(sd: dict, cfg: ModelConfig, proj, tp_size: int, dev):
    """The body of the byte-per-weight channelwise recipes (int8 / fp8):
    ``proj(prefix) -> (w [K, N] of the storage type, s [N] f32)``. Each
    projection is ``{"w8": [L, K, N], "s8": [L, N] f32}`` (q|k|v and
    gate|up concatenated along N), with a bf16 ``"b"`` where the checkpoint
    has a bias."""
    from qspec_tpu_torch.model_loader.loader import OD_BIAS_KEYS, _od_biases
    from qspec_tpu_torch.models.llama import _head_kind, _make_lm_head, check_served
    from qspec_tpu_torch.ops.rotary import make_rope_cache

    if tp_size != 1:
        raise NotImplementedError("tensor-parallel layouts are not ported "
                                  "(ROADMAP queue 1 item 11)")
    cfg = dataclasses.replace(cfg, quant="w8")
    check_served(cfg)
    od_bias = _od_biases(sd, cfg.num_layers)

    def norm_w(name):
        return (_t(sd[name], dev).to(torch.float32) + cfg.norm_weight_offset
                ).to(torch.bfloat16)

    def bias(*names):
        return torch.cat([_t(sd[n], dev).to(torch.float32) for n in names]
                         ).to(torch.bfloat16)

    L = cfg.num_layers
    stacks: dict = {}

    def put(name, li, w, s, b=None):
        if name not in stacks:
            stacks[name] = {"w8": torch.empty((L, *w.shape), dtype=w.dtype, device=dev),
                            "s8": torch.empty((L, s.shape[0]), dtype=torch.float32,
                                              device=dev)}
            if b is not None:
                stacks[name]["b"] = torch.empty((L, b.shape[0]), dtype=torch.bfloat16,
                                                device=dev)
        stacks[name]["w8"][li] = w
        stacks[name]["s8"][li] = s
        if b is not None:
            stacks[name]["b"][li] = b

    def cat(parts):
        ws, ss = zip(*parts)
        return torch.cat(ws, dim=1), torch.cat(ss)

    layers = {"input_norm": [], "post_norm": [], "q_norm": [], "k_norm": []}
    for i in range(L):
        ln = f"model.layers.{i}."
        p, mp = ln + "self_attn.", ln + "mlp."
        put("qkv", i, *cat([proj(p + n + "_proj") for n in "qkv"]),
            bias(*(p + n + "_proj.bias" for n in "qkv")) if cfg.qkv_bias else None)
        put("o", i, *proj(p + "o_proj"), _t(sd[ln + OD_BIAS_KEYS[0]], dev).to(torch.bfloat16)
            if od_bias[0] else None)
        put("gate_up", i, *cat([proj(mp + "gate_proj"), proj(mp + "up_proj")]))
        put("down", i, *proj(mp + "down_proj"), _t(sd[ln + OD_BIAS_KEYS[1]], dev).to(
            torch.bfloat16) if od_bias[1] else None)
        layers["input_norm"].append(norm_w(ln + "input_layernorm.weight"))
        layers["post_norm"].append(norm_w(ln + "post_attention_layernorm.weight"))
        if cfg.qk_norm:      # Qwen3's per-head q/k norms (the JAX loader reads none)
            layers["q_norm"].append(norm_w(p + "q_norm.weight"))
            layers["k_norm"].append(norm_w(p + "k_norm.weight"))
    out = {name: torch.stack(v) for name, v in layers.items() if v}
    out.update(stacks)
    embed = _t(sd["model.embed_tokens.weight"], dev)
    lm = _t(sd["lm_head.weight"], dev) if "lm_head.weight" in sd else embed
    params = {
        "embed": embed.to(torch.float32).to(torch.bfloat16),
        "lm_head": _make_lm_head(lm.to(torch.float32).t().contiguous(), _head_kind(cfg)),
        "final_norm": norm_w("model.norm.weight"),
        "layers": out,
        "rope_cache": make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings,
                                      cfg.rope_theta, rope_scaling=cfg.rope_scaling,
                                      device=dev),
    }
    return params, cfg


def load_compressed_tensors(path_or_sd, cfg: Optional[ModelConfig] = None,
                            qconfig: Optional[dict] = None, tp_size: int = 1,
                            device="cuda"):
    """A compressed-tensors state dict (with its cfg) or checkpoint
    directory -> (params on ``device``, cfg), dispatched on
    ``quantization_config``'s ``format`` (``qconfig``), or on the sniffed
    tensors where it names
    none."""
    sd, cfg = _resolve(path_or_sd, cfg)
    fmt = (qconfig or {}).get("format")
    if fmt is None:
        if any(k.endswith(".weight_packed") for k in sd):
            fmt = "pack-quantized"
        else:
            fp8 = any(k.endswith("proj.weight") and _is_fp8(v) for k, v in sd.items())
            fmt = "float-quantized" if fp8 else "int-quantized"
    if fmt == "pack-quantized":
        return load_ct_packed(sd, cfg, tp_size, device)
    if fmt == "int-quantized":
        return load_ct_int8(sd, cfg, tp_size, device)
    if fmt in ("float-quantized", "naive-quantized", "fbgemm_fp8"):
        return load_ct_fp8(sd, cfg, tp_size, device)
    raise NotImplementedError(
        f"compressed-tensors format {fmt!r} is not supported (supported: "
        "pack-quantized int4, int-quantized int8, float-quantized fp8)")


# ---------------------------------------------------------------------------
# synthetic-checkpoint writers (tests + tooling; also document the format)
# ---------------------------------------------------------------------------


def _pack_to_int32(vals: torch.Tensor) -> torch.Tensor:
    """Unsigned nibbles [..., K] -> int32 [..., K // 8], little-endian along
    the last axis (compressed_tensors' pack_to_int32)."""
    return _pack_words(vals.reshape(*vals.shape[:-1], -1, 8))


def make_ct_packed_tensors(w, group_size: int = 64, symmetric: bool = True,
                           pack_zp: bool = False):
    """Quantize a float [K, N] weight (a tensor, on its device, or an array)
    into pack-quantized tensors (weight_packed [N, K // 8] + weight_scale
    [N, G] fp16 (+ zero point) + weight_shape); ``group_size`` <= 0 is the
    channel strategy (one group). -> (tensors, the f32 dequantized [K, N])."""
    w = _t(w).to(torch.float32)
    K, N = w.shape
    g = K if group_size <= 0 else group_size
    wg = w.reshape(K // g, g, N)
    if symmetric:
        s = (wg.abs().amax(dim=1) / 7.0).clamp_min(1e-8)            # [G, N]
        q = torch.clamp(torch.round(wg / s[:, None]), -8, 7)
        zp_s = torch.zeros(s.shape, dtype=torch.int16, device=w.device)
    else:
        lo, hi = wg.amin(dim=1), wg.amax(dim=1)
        s = ((hi - lo) / 15.0).clamp_min(1e-8)
        zp_s = torch.clamp(torch.round(-lo / s) - 8, -8, 7).to(torch.int16)
        q = torch.clamp(torch.round(wg / s[:, None]) + zp_s[:, None], -8, 7)
    q = q.reshape(K, N).to(torch.int16)
    out = {"weight_packed": _pack_to_int32((q.t() + 8).to(torch.uint8)),
           "weight_scale": s.t().to(torch.float16).contiguous(),        # [N, G]
           "weight_shape": torch.tensor([N, K], dtype=torch.int64)}
    if not symmetric:
        if pack_zp:
            zpt = zp_s.t()                                              # [N, G]
            zpt = torch.nn.functional.pad(zpt + 8, (0, 0, 0, (-zpt.shape[0]) % 8))
            out["weight_zero_point"] = _pack_to_int32(zpt.t()).t().contiguous()
        else:
            out["weight_zero_point"] = zp_s.t().to(torch.int32).contiguous()
    deq = ((q.reshape(K // g, g, N).to(torch.float32)
            - zp_s[:, None].to(torch.float32)) * s[:, None]).reshape(K, N)
    return out, deq


def make_ct_int8_tensors(w, per_tensor: bool = False):
    """Quantize a float [K, N] weight into int-quantized tensors (weight int8
    [N, K] + weight_scale [N, 1], or [1] per tensor). -> (tensors, the f32
    dequantized [K, N])."""
    w = _t(w).to(torch.float32)
    if per_tensor:
        s = (w.abs().amax() / 127.0).clamp_min(1e-8).reshape(1)
    else:
        s = (w.abs().amax(dim=0) / 127.0).clamp_min(1e-8)             # [N]
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    out = {"weight": q.t().contiguous(),
           "weight_scale": s.reshape(-1, 1) if not per_tensor else s}
    return out, q.to(torch.float32) * s


def make_ct_fp8_tensors(w, per_tensor: bool = False):
    """Quantize a float [K, N] weight into float-quantized tensors (weight
    float8_e4m3fn [N, K] + weight_scale [N, 1], or [1] per tensor): the
    scale maps a channel's (or the tensor's) absmax to e4m3's 448, the top
    of its range (llm-compressor's FP8 recipe). -> (tensors, the f32
    dequantized [K, N])."""
    w = _t(w).to(torch.float32)
    if per_tensor:
        s = (w.abs().amax() / 448.0).clamp_min(1e-12).reshape(1)
    else:
        s = (w.abs().amax(dim=0) / 448.0).clamp_min(1e-12)            # [N]
    q = (w / s[None, :]).to(FP8)
    out = {"weight": q.t().contiguous(),
           "weight_scale": s.reshape(-1, 1) if not per_tensor else s}
    return out, q.to(torch.float32) * s


WRITERS = {"pack-quantized": make_ct_packed_tensors, "int-quantized": make_ct_int8_tensors,
           "float-quantized": make_ct_fp8_tensors}


def make_ct_state_dict(cfg: ModelConfig, fmt: str = "int-quantized", seed: int = 0,
                       device="cuda", **writer_kw) -> dict:
    """A Hugging Face-named compressed-tensors state dict of a Llama of
    ``cfg``'s shapes in ``fmt`` ("pack-quantized", "int-quantized" or
    "float-quantized"), made on ``device`` from a torch.Generator by
    ``grouped.make_grouped_state_dict``'s recipe (the same random draws:
    normal(0.02) weights, 1 + normal(0.05) gammas, float embeddings and
    head), each projection quantized by the format's writer."""
    from qspec_tpu_torch.model_loader.grouped import random_state_dict
    write = WRITERS[fmt]
    return random_state_dict(cfg, lambda w: write(w, **writer_kw)[0], seed, device)
