"""GGUF (llama.cpp) checkpoint ingestion.

Port of ``qspec_tpu/model_loader/gguf.py``. The supported quants land on
paths the port already serves:

* F32 / F16 / BF16 tensors -> bf16 params (quant="none", ``load_hf_float``).
* Q4_0 (block-32 symmetric int4, zero point 8) -> the grouped-int4
  representation (quant="w4g", ``ops.linear_kernels.matmul_w4a16_g``) at
  group size 32, through ``grouped._load_grouped``'s ``proj_reader`` hook:
  the same path AWQ / GPTQ / compressed-tensors take. Every trunk
  projection must be Q4_0 for that (llama.cpp's Q4_0 files keep the output
  head in Q6_K, which is not a trunk projection).
* Q8_0 (block-32 int8) and the K-quants (Q4_K / Q5_K / Q6_K) -> dequantized
  to bf16 at load, bit for bit the JAX package's ``to_float`` (these numpy
  decoders are its own, copied: the port imports nothing of it). The float
  types and Q4_0's nibbles and scales are decoded on the device instead:
  the same values, without a float32 copy of the file on the host.

The container is GGUF v3 (v2 read too): a little-endian header (magic
"GGUF", version, tensor count, metadata count), typed metadata, tensor
infos (name, dims in ggml order: ne[0] is the contiguous in-features axis,
type, offset), then an aligned tensor-data section. A 2-D ggml tensor with
ne = (in, out) reads as [out, in], the Hugging Face Linear layout.
llama.cpp stores attn_q / attn_k rows permuted for its rope
(convert_hf_to_gguf.py's permute); the loader inverts that.

Unlike the JAX loader, which skips any tensor it has no name for, the port
raises naming it (``rope_freqs.weight``, Llama-3.1's rope-scaling factors,
among them): a tensor left out would change the model silently.

``quantize_q4_0`` runs in torch on its tensor's device (the numpy one is too
slow at 8B widths on a host) and gives the JAX writer's bytes; the other
quantizers and ``write_gguf`` are the JAX package's numpy ones.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig

GGUF_MAGIC = b"GGUF"

# metadata value types (spec: gguf_metadata_value_type)
_SCALARS = {
    0: ("<B", 1), 1: ("<b", 1), 2: ("<H", 2), 3: ("<h", 2),
    4: ("<I", 4), 5: ("<i", 4), 6: ("<f", 4), 7: ("<?", 1),
    10: ("<Q", 8), 11: ("<q", 8), 12: ("<d", 8),
}
T_STRING, T_ARRAY = 8, 9

# ggml tensor types (ggml.h enum ggml_type)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
GGML_BF16 = 30

_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
               GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
               GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0", GGML_Q4_K: "Q4_K",
               GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K"}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def scalar(self, fmt: str, size: int):
        v = struct.unpack_from(fmt, self.buf, self.off)[0]
        self.off += size
        return v

    def u32(self):
        return self.scalar("<I", 4)

    def u64(self):
        return self.scalar("<Q", 8)

    def string(self) -> str:
        n = self.u64()
        s = self.buf[self.off:self.off + n].decode("utf-8", errors="replace")
        self.off += n
        return s

    def value(self, vtype: int):
        if vtype in _SCALARS:
            return self.scalar(*_SCALARS[vtype])
        if vtype == T_STRING:
            return self.string()
        if vtype == T_ARRAY:
            etype = self.u32()
            count = self.u64()
            return [self.value(etype) for _ in range(count)]
        raise ValueError(f"unknown GGUF metadata type {vtype}")


def read_gguf(path: str) -> Tuple[dict, Dict[str, dict]]:
    """-> (metadata, tensors) where tensors[name] = {type, shape (numpy
    order, outermost first), data (a memoryview of the file's bytes)}."""
    # a writable buffer, so torch.frombuffer views the tensors' bytes
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(buf)
    r = _Reader(buf)
    # the tensors' bytes as views of the file's (the JAX reader copies each)
    data = memoryview(buf)
    if buf[:4] != GGUF_MAGIC:
        raise ValueError("not a GGUF file")
    r.off = 4
    version = r.u32()
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.u64()
    n_meta = r.u64()
    meta = {}
    for _ in range(n_meta):
        key = r.string()
        vtype = r.u32()
        meta[key] = r.value(vtype)
    infos = []
    for _ in range(n_tensors):
        name = r.string()
        nd = r.u32()
        ne = [r.u64() for _ in range(nd)]
        ttype = r.u32()
        offset = r.u64()
        infos.append((name, ne, ttype, offset))
    align = int(meta.get("general.alignment", 32))
    data_start = (r.off + align - 1) // align * align
    tensors = {}
    for name, ne, ttype, offset in infos:
        n_elems = int(np.prod(ne)) if ne else 1
        nbytes = _tensor_nbytes(ttype, n_elems)
        start = data_start + offset
        tensors[name] = {"type": ttype, "ne": ne,
                         "shape": tuple(int(x) for x in reversed(ne)),
                         "data": data[start:start + nbytes]}
    return meta, tensors


def _tensor_nbytes(ttype: int, n: int) -> int:
    if ttype == GGML_F32:
        return 4 * n
    if ttype in (GGML_F16, GGML_BF16):
        return 2 * n
    if ttype == GGML_Q4_0:
        assert n % 32 == 0
        return (n // 32) * 18
    if ttype == GGML_Q8_0:
        assert n % 32 == 0
        return (n // 32) * 34
    if ttype in (GGML_Q4_K, GGML_Q5_K, GGML_Q6_K):
        assert n % 256 == 0
        per = {GGML_Q4_K: 144, GGML_Q5_K: 176, GGML_Q6_K: 210}[ttype]
        return (n // 256) * per
    raise NotImplementedError(
        f"GGUF quant {_TYPE_NAMES.get(ttype, ttype)} is not supported "
        "(supported: F32/F16/BF16/Q4_0/Q8_0/Q4_K/Q5_K/Q6_K)")


def _dequant_q4_0(raw: bytes, n: int) -> np.ndarray:
    """Q4_0 block: f16 scale d + 16 bytes; byte j holds elem j (low nibble)
    and elem j+16 (high nibble); value = (nibble - 8) * d."""
    nb = n // 32
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 18)
    d = rec[:, :2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = rec[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)     # [nb, 32]
    return (q * d).reshape(n)


def _dequant_q8_0(raw: bytes, n: int) -> np.ndarray:
    nb = n // 32
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 34)
    d = rec[:, :2].copy().view(np.float16).astype(np.float32)
    q = rec[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(n)


def _kq_scales_mins(sb: np.ndarray):
    """Q4_K/Q5_K 12-byte packed 6-bit factors -> (sc [nb, 8], mn [nb, 8]).

    Bit layout from ggml-quants.c get_scale_min_k4: entries 0..3 live in
    bytes j / j+4 (low 6 bits); entries 4..7 take their low nibble from
    byte j+8 and their top two bits from bytes j / j+4."""
    s = sb.astype(np.uint8)
    sc = np.empty((s.shape[0], 8), np.uint8)
    mn = np.empty_like(sc)
    sc[:, :4] = s[:, 0:4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(raw: bytes, n: int) -> np.ndarray:
    """Q4_K super-block (256 elems, 144 B): f16 d, f16 dmin, 12 B packed
    6-bit scales/mins (8 sub-blocks of 32), 128 B nibbles. Per 64-element
    chunk the 32 bytes hold elems 0-31 in low nibbles (scale 2c) and elems
    32-63 in high nibbles (scale 2c+1); value = d*sc*q - dmin*m."""
    nb = n // 256
    rec = np.frombuffer(raw, np.uint8).reshape(nb, 144)
    d = rec[:, 0:2].copy().view(np.float16).astype(np.float32)    # [nb, 1]
    dmin = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _kq_scales_mins(rec[:, 4:16])
    qs = rec[:, 16:].reshape(nb, 4, 32)
    q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
    scale = d * sc.astype(np.float32)                             # [nb, 8]
    off = dmin * mn.astype(np.float32)
    return (scale[..., None] * q - off[..., None]).reshape(n)


def _dequant_q5_k(raw: bytes, n: int) -> np.ndarray:
    """Q5_K (176 B): Q4_K layout plus 32 B of 5th bits; chunk c's low-nibble
    half takes bit (2c) of qh, the high-nibble half bit (2c+1)."""
    nb = n // 256
    rec = np.frombuffer(raw, np.uint8).reshape(nb, 176)
    d = rec[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = rec[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _kq_scales_mins(rec[:, 4:16])
    qh = rec[:, 16:48]                                            # [nb, 32]
    qs = rec[:, 48:].reshape(nb, 4, 32)
    bits = ((qh[:, None, :] >> (np.arange(8)[None, :, None])) & 1)
    q = (np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
         + 16 * bits).astype(np.float32)
    scale = d * sc.astype(np.float32)
    off = dmin * mn.astype(np.float32)
    return (scale[..., None] * q - off[..., None]).reshape(n)


def _dequant_q6_k(raw: bytes, n: int) -> np.ndarray:
    """Q6_K (210 B): 128 B low nibbles, 64 B high 2-bit pairs, 16 int8
    scales (per 16 elems), f16 d; value = d * sc * (q - 32). Within each
    128-element half, quarter qd of 32 elems takes low/high nibbles of
    ql[0:32]/ql[32:64] and bit-pair qd of qh (ggml dequantize_row_q6_K)."""
    nb = n // 256
    rec = np.frombuffer(raw, np.uint8).reshape(nb, 210)
    ql = rec[:, :128].reshape(nb, 2, 2, 32)     # [nb, half, lo/hi32, 32]
    qh = rec[:, 128:192].reshape(nb, 2, 32)     # [nb, half, 32]
    sc = rec[:, 192:208].copy().view(np.int8).astype(np.float32)
    sc = sc.reshape(nb, 2, 8)                   # [nb, half, 8] per-16
    d = rec[:, 208:210].copy().view(np.float16).astype(np.float32)
    lo = np.stack([ql[:, :, 0] & 0xF, ql[:, :, 1] & 0xF,
                   ql[:, :, 0] >> 4, ql[:, :, 1] >> 4], axis=2)
    hi = np.stack([(qh >> s) & 3 for s in (0, 2, 4, 6)], axis=2)
    q = (lo | (hi << 4)).astype(np.float32) - 32  # [nb, half, quarter, 32]
    # quarter qd's 32 elems use scales 2*qd (first 16) and 2*qd+1 (last 16)
    scq = np.repeat(sc.reshape(nb, 2, 8, 1), 16, axis=3).reshape(nb, 2, 4, 32)
    return (d[:, :, None, None] * scq * q).reshape(n)


def to_float(t: dict) -> np.ndarray:
    """Dequantize any supported tensor record -> float32 [shape]."""
    n = int(np.prod(t["ne"])) if t["ne"] else 1
    ty = t["type"]
    if ty == GGML_F32:
        a = np.frombuffer(t["data"], np.float32).copy()
    elif ty == GGML_F16:
        a = np.frombuffer(t["data"], np.float16).astype(np.float32)
    elif ty == GGML_BF16:
        u = np.frombuffer(t["data"], np.uint16).astype(np.uint32) << 16
        a = u.view(np.float32).copy()
    elif ty == GGML_Q4_0:
        a = _dequant_q4_0(t["data"], n)
    elif ty == GGML_Q8_0:
        a = _dequant_q8_0(t["data"], n)
    elif ty == GGML_Q4_K:
        a = _dequant_q4_k(t["data"], n)
    elif ty == GGML_Q5_K:
        a = _dequant_q5_k(t["data"], n)
    elif ty == GGML_Q6_K:
        a = _dequant_q6_k(t["data"], n)
    else:
        raise NotImplementedError(_TYPE_NAMES.get(ty, str(ty)))
    return a.reshape(t["shape"])


def _row_perm(out: int, heads: int) -> torch.Tensor:
    """The row order that inverts llama.cpp's q / k permutation
    (convert_hf_to_gguf's permute: reshape(h, 2, d/2, in).swapaxes(1, 2)),
    back to Hugging Face's: w[_row_perm(...)] for a weight, its bias, or a
    Q4_0 weight's nibbles and block scales alike."""
    return (torch.arange(out).reshape(heads, out // heads // 2, 2, 1)
            .transpose(1, 2).reshape(out))


# the stored float types, moved to the device as they are and widened there
_TORCH_FLOATS = {GGML_F32: torch.float32, GGML_F16: torch.float16,
                 GGML_BF16: torch.bfloat16}


def _bytes_on(t: dict, device) -> torch.Tensor:
    return torch.frombuffer(t["data"], dtype=torch.uint8).to(device)


def _float_on(t: dict, device) -> torch.Tensor:
    """A tensor record as float32 [shape] on ``device``, ``to_float``'s
    values: F32 / F16 / BF16 widened on the device, the quantized types
    dequantized by ``to_float`` on the host."""
    if t["type"] in _TORCH_FLOATS:
        w = _bytes_on(t, device).view(_TORCH_FLOATS[t["type"]]).to(torch.float32)
        return w.reshape(t["shape"])
    return torch.from_numpy(to_float(t)).to(device)


def _q4_0_on(t: dict, device):
    """A Q4_0 record [N, K] -> (q [N, K] uint8 excess-8 nibbles, d [N, K //
    32] f32 block scales) on ``device``: a block is an f16 scale and 16
    bytes, byte j holding element j (low nibble) and j + 16 (high)."""
    out, inn = t["shape"]
    rec = _bytes_on(t, device).reshape(-1, 18)
    d = rec[:, :2].contiguous().view(torch.float16).to(torch.float32)
    qs = rec[:, 2:]
    q = torch.cat([qs & 0xF, qs >> 4], dim=1)
    return q.reshape(out, inn), d.reshape(out, inn // 32)


# gguf name -> HF name (the llama architecture's; the JAX loader's table)
_NAME_MAP = {
    "token_embd.weight": "model.embed_tokens.weight",
    "output.weight": "lm_head.weight",
    "output_norm.weight": "model.norm.weight",
}
_BLK_MAP = {
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_output.weight": "self_attn.o_proj.weight",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
    # qwen2-style attention biases (always float in GGUF)
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.bias": "self_attn.v_proj.bias",
}


def config_from_gguf(meta: dict, tensors: dict) -> ModelConfig:
    """The ModelConfig of a GGUF file's metadata (llama, mistral and qwen2
    architectures, all the llama graph), quant="none" (the loader settles
    the quant)."""
    arch = meta.get("general.architecture", "llama")
    if arch not in ("llama", "mistral", "qwen2"):
        raise NotImplementedError(f"GGUF architecture {arch!r}")

    def p(k, d=None):
        return meta.get(f"{arch}.{k}", d)

    # rope scaling (llama.cpp reads a factor without a type as linear): the
    # JAX loader ignores it and would serve plain rope past the original
    # context; refused here until it maps onto ModelConfig.rope_scaling
    kind, factor = p("rope.scaling.type"), p("rope.scaling.factor", p("rope.scale_linear"))
    if kind not in (None, "none") or factor not in (None, 0.0, 1.0):
        raise NotImplementedError(
            f"GGUF rope scaling (type {kind!r}, factor {factor!r}) is not read by the llama "
            "loader (ROADMAP queue 1 item 8)")
    H = int(p("embedding_length"))
    nh = int(p("attention.head_count"))
    vocab = tensors["token_embd.weight"]["shape"][0]
    return ModelConfig(
        arch="llama", vocab_size=int(vocab), hidden_size=H,
        intermediate_size=int(p("feed_forward_length")), num_layers=int(p("block_count")),
        num_heads=nh, num_kv_heads=int(p("attention.head_count_kv", nh)), head_dim=H // nh,
        rope_theta=float(p("rope.freq_base", 10000.0)),
        rms_norm_eps=float(p("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(p("context_length", 4096)),
        tie_word_embeddings="output.weight" not in tensors,
        qkv_bias=any(k.endswith("attn_q.bias") for k in tensors), quant="none")


def _hf_items(tensors: dict, cfg: ModelConfig):
    """Yield (hf_name, record, heads of a q/k row permutation or None);
    raise for a tensor the tables do not name."""
    for gname, t in tensors.items():
        if gname in _NAME_MAP:
            yield _NAME_MAP[gname], t, None
            continue
        rest = gname.split(".", 2)[2] if gname.startswith("blk.") else None
        if rest not in _BLK_MAP:
            raise NotImplementedError(
                f"GGUF tensor {gname!r} is not read by the llama loader (the JAX "
                "loader skips it silently, which would change the model)")
        i = gname.split(".", 2)[1]
        heads = (cfg.num_heads if rest.startswith("attn_q") else cfg.num_kv_heads
                 if rest.startswith("attn_k") else None)
        yield f"model.layers.{i}.{_BLK_MAP[rest]}", t, heads


def load_gguf(path: str, tp_size: int = 1, device="cuda"):
    """A GGUF file -> (params on ``device``, cfg): a file whose every trunk
    projection is Q4_0 through the grouped-int4 W4A16 path (quant="w4g",
    g = 32), any other (F16 / F32 / BF16 / Q8_0 / K-quants) dequantized to
    bf16 (quant="none", ``load_hf_float``). Serve it with
    ``LLMEngine(EngineConfig(model=cfg, ...), params)``."""
    from qspec_tpu_torch.model_loader.grouped import _load_grouped
    from qspec_tpu_torch.model_loader.loader import load_hf_float
    from qspec_tpu_torch.models.llama import resolve_device

    dev = resolve_device(device)
    meta, tensors = read_gguf(path)
    cfg = config_from_gguf(meta, tensors)
    proj_types = {t["type"] for n, t in tensors.items()
                  if ".weight" in n and n.startswith("blk.") and "norm" not in n}
    sd, triples = {}, {}
    q4 = proj_types == {GGML_Q4_0}
    for hf, t, heads in _hf_items(tensors, cfg):
        perm = None if heads is None else _row_perm(t["shape"][0], heads).to(dev)
        if q4 and "proj" in hf and t["type"] == GGML_Q4_0:
            q, s = _q4_0_on(t, dev)               # [N, K]: blocks run along K
            if perm is not None:
                q, s = q[perm], s[perm]
            triples[hf[:-len(".weight")]] = (
                q.t().contiguous(), torch.full(tuple(s.t().shape), 8, dtype=torch.uint8,
                                               device=dev), s.t().contiguous())
        else:
            w = _float_on(t, dev)
            sd[hf] = w if perm is None else w[perm]
    if "lm_head.weight" not in sd:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    if not q4:
        return load_hf_float(sd, cfg, device=dev)
    return _load_grouped(sd, cfg, "gguf", tp_size, dev, proj_reader=lambda pre: triples[pre])


# ---------------------------------------------------------------------------
# writers (tests + tooling; they document the container format)
# ---------------------------------------------------------------------------


def quantize_q4_0(w) -> bytes:
    """A float array or tensor (contiguous along the last axis) -> Q4_0
    bytes, computed in torch on the tensor's device: the JAX package's
    numpy writer's bytes. ggml's convention: d = (the signed value of the
    block's largest magnitude) / -8, so that value maps to nibble 0 exactly
    and the clip at 15 stays in range."""
    t = w if torch.is_tensor(w) else torch.from_numpy(np.ascontiguousarray(w, np.float32))
    flat = t.to(torch.float32).reshape(-1, 32)
    idx = flat.abs().argmax(dim=1, keepdim=True)
    d = flat.gather(1, idx)[:, 0] / -8.0
    d = torch.where(d == 0, torch.full_like(d, 1e-8), d)
    q = torch.clamp(torch.round(flat / d[:, None]) + 8, 0, 15).to(torch.uint8)
    out = torch.empty((flat.shape[0], 18), dtype=torch.uint8, device=flat.device)
    out[:, :2] = d.to(torch.float16).view(torch.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.cpu().numpy().tobytes()


def _pack_value(vtype: int, v) -> bytes:
    if vtype in _SCALARS:
        return struct.pack(_SCALARS[vtype][0], v)
    if vtype == T_STRING:
        b = v.encode()
        return struct.pack("<Q", len(b)) + b
    raise ValueError(vtype)


def quantize_q8_0(w: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(w, np.float32).reshape(-1, 32)
    d = np.abs(flat).max(axis=1) / 127.0
    d = np.where(d == 0, 1e-8, d)
    q = np.clip(np.rint(flat / d[:, None]), -127, 127).astype(np.int8)
    out = np.empty((flat.shape[0], 34), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def _pack_kq_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _kq_scales_mins: (sc [nb, 8], mn [nb, 8]) 6-bit -> 12 B."""
    out = np.empty((sc.shape[0], 12), np.uint8)
    out[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4)
    return out


def _affine_kq(flat: np.ndarray, qmax: int):
    """Per-32 affine factors for Q4_K/Q5_K: x ~ scale*q - off, q in
    [0, qmax]; -> (d, dmin, sc, mn, scale, off) with 6-bit sc/mn under f16
    super-scales (a direct encoder — ggml's is search-optimized, but any
    in-format values decode identically)."""
    sub = flat.reshape(-1, 8, 32)
    mn_f = np.maximum(0.0, -sub.min(2))                       # [nb, 8]
    sc_f = np.maximum(sub.max(2) + mn_f, 1e-8) / qmax
    d = np.float16(sc_f.max(1) / 63.0).astype(np.float32)     # [nb]
    dmin = np.float16(np.maximum(mn_f.max(1) / 63.0, 1e-8)).astype(np.float32)
    sc = np.clip(np.rint(sc_f / d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.rint(mn_f / dmin[:, None]), 0, 63).astype(np.uint8)
    scale = np.maximum(d[:, None] * sc, 1e-12)
    off = dmin[:, None] * mn
    return d, dmin, sc, mn, scale, off


def quantize_q4_k(w: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(w, np.float32).reshape(-1, 256)
    d, dmin, sc, mn, scale, off = _affine_kq(flat, 15)
    q = np.clip(np.rint((flat.reshape(-1, 8, 32) + off[..., None])
                        / scale[..., None]), 0, 15).astype(np.uint8)
    pairs = q.reshape(-1, 4, 2, 32)                  # [nb, chunk, lo/hi, 32]
    qs = pairs[:, :, 0] | (pairs[:, :, 1] << 4)
    out = np.empty((flat.shape[0], 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = _pack_kq_scales(sc, mn)
    out[:, 16:] = qs.reshape(-1, 128)
    return out.tobytes()


def quantize_q5_k(w: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(w, np.float32).reshape(-1, 256)
    d, dmin, sc, mn, scale, off = _affine_kq(flat, 31)
    q = np.clip(np.rint((flat.reshape(-1, 8, 32) + off[..., None])
                        / scale[..., None]), 0, 31).astype(np.uint8)
    qh = np.zeros((flat.shape[0], 32), np.uint8)
    for s in range(8):
        qh |= ((q[:, s] >> 4) & 1) << s
    pairs = (q & 0xF).reshape(-1, 4, 2, 32)
    qs = pairs[:, :, 0] | (pairs[:, :, 1] << 4)
    out = np.empty((flat.shape[0], 176), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:16] = _pack_kq_scales(sc, mn)
    out[:, 16:48] = qh
    out[:, 48:] = qs.reshape(-1, 128)
    return out.tobytes()


def quantize_q6_k(w: np.ndarray) -> bytes:
    flat = np.ascontiguousarray(w, np.float32).reshape(-1, 256)
    sub = flat.reshape(-1, 16, 16)                   # per-16 symmetric
    s_f = np.maximum(np.abs(sub).max(2), 1e-8) / 32.0
    d = np.float16(s_f.max(1) / 127.0).astype(np.float32)
    sc = np.clip(np.rint(s_f / d[:, None]), 1, 127).astype(np.int8)
    scale = d[:, None, None] * sc[..., None].astype(np.float32)
    q = (np.clip(np.rint(sub / scale), -32, 31) + 32).astype(np.uint8)
    q = q.reshape(-1, 2, 4, 32)                      # [nb, half, quarter, 32]
    ql = np.empty((flat.shape[0], 2, 2, 32), np.uint8)
    ql[:, :, 0] = (q[:, :, 0] & 0xF) | ((q[:, :, 2] & 0xF) << 4)
    ql[:, :, 1] = (q[:, :, 1] & 0xF) | ((q[:, :, 3] & 0xF) << 4)
    qh = ((q[:, :, 0] >> 4) | ((q[:, :, 1] >> 4) << 2)
          | ((q[:, :, 2] >> 4) << 4) | ((q[:, :, 3] >> 4) << 6))
    out = np.empty((flat.shape[0], 210), np.uint8)
    out[:, :128] = ql.reshape(-1, 128)
    out[:, 128:192] = qh.reshape(-1, 64)
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def write_gguf(path: str, meta: dict, tensors: Dict[str, tuple]):
    """tensors[name] = (ggml_type, np_array_or_bytes, ne). Scalar metadata
    types are inferred (int -> uint32, float -> f32, str -> string)."""
    align = 32
    head = bytearray()
    head += GGUF_MAGIC
    head += struct.pack("<IQQ", 3, len(tensors), len(meta))
    for k, v in meta.items():
        kb = k.encode()
        head += struct.pack("<Q", len(kb)) + kb
        if isinstance(v, bool):
            head += struct.pack("<I", 7) + _pack_value(7, v)
        elif isinstance(v, int):
            head += struct.pack("<I", 4) + _pack_value(4, v)
        elif isinstance(v, float):
            head += struct.pack("<I", 6) + _pack_value(6, v)
        else:
            head += struct.pack("<I", T_STRING) + _pack_value(T_STRING, v)
    sizes, offset = [], 0
    for name, (ttype, payload, ne) in tensors.items():
        nb = name.encode()
        head += struct.pack("<Q", len(nb)) + nb
        head += struct.pack("<I", len(ne))
        for d in ne:
            head += struct.pack("<Q", d)
        head += struct.pack("<IQ", ttype, offset)
        n = len(payload) if isinstance(payload, bytes) else payload.nbytes
        sizes.append(n)
        offset += n + (-n) % align
    # the tensors are written one at a time (the JAX writer joins them
    # first: the same bytes, a copy of the whole file less in memory)
    with open(path, "wb") as f:
        f.write(bytes(head) + b"\x00" * ((-len(head)) % align))
        for (_, payload, _), n in zip(tensors.values(), sizes):
            f.write(payload if isinstance(payload, bytes)
                    else np.ascontiguousarray(payload).data)
            f.write(b"\x00" * ((-n) % align))
