"""EAGLE proposer: a one-layer draft transformer over fused (token
embedding, target hidden) features.

Port of ``qspec_tpu/spec_decode/eagle.py``. The draft net is

    f_t        = fc(concat(embed(x_{t+1}), h_t))     # fused feature
    a_t        = rmsnorm(decoder_layer(f_{<=t}))     # ~ h_{t+1}
    p(x_{t+2}) = lm_head(a_t)                        # the target's own head

where h_t is the target's post-final-norm hidden state at position t (a
QuaRot checkpoint's stays in the rotated basis, the one the net is trained
on). The layer attends over the whole context through its own one-layer
paged KV cache over feature positions (``engine/model_runner.py``:
``prefill_eagle_step`` builds it with the prompt, ``eagle_rounds_step``
re-feeds each round's accepted span with its true hidden states, drafts k
tokens and verifies them under the one-hot rule, so greedy EAGLE output is
the target's greedy output for any net).

``params["eagle"] = {"fc": bf16 [2H, H], "layers": a one-layer bf16 Llama
dict ({"qkv": {"w": [1, H, qkv]}, "o", "gate_up", "down", "input_norm":
[1, H], "post_norm": [1, H]}), "rope_cache"}``. The fc and the layer's
projections are plain bf16 products with an f32 result, as in the JAX
package (no Pallas kernel there): ``models/llama.py``'s bf16 scheme, whose
rows are padded on the card so that a row's bits do not depend on the batch.
The layer's norms and its attention are the port's kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models.llama import (_proj_shapes, bf16_matmul, decoder_layer,
                                          resolve_device)
from qspec_tpu_torch.ops.rmsnorm_quant import rmsnorm
from qspec_tpu_torch.ops.rotary import make_rope_cache


def eagle_cfg_for(cfg: ModelConfig) -> ModelConfig:
    """The draft layer's ModelConfig: one bf16 Llama layer of the target's
    widths, with gamma norms and no window (its KV cache's geometry too)."""
    return dataclasses.replace(cfg, num_layers=1, quant="none", sliding_window=None,
                               post_norms=False, lm_head_quant="bf16")


def fuse_features(eagle: dict, embeds: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """f = fc(concat(e, h)): [..., H] x [..., H] -> [..., H] bf16."""
    f = torch.cat([embeds.to(torch.bfloat16), hidden.to(torch.bfloat16)], dim=-1)
    out = bf16_matmul(f.reshape(-1, f.shape[-1]), eagle["fc"])
    return out.reshape(*f.shape[:-1], out.shape[-1])


def eagle_layer_step(eagle: dict, ecfg: ModelConfig, draft_cache, feats: torch.Tensor,
                     batch):
    """The draft layer over a feature block: feats [B, Q, H] bf16, ``batch``
    the AttentionBatch of the feature positions. Returns (a [B, Q, H], the
    weightless rmsnorm of the layer's output, the ~h_{t+1} prediction; the
    draft cache, written in place). The layer hands its MLP output on
    unadded (``decoder_layer``); the final norm adds it."""
    B, Q, H = feats.shape
    x, down, draft_cache = decoder_layer(feats.reshape(B * Q, H), None, eagle["layers"],
                                         draft_cache, 0, ecfg, batch, eagle["rope_cache"],
                                         None, "bf16")
    a, _ = rmsnorm(x, None, eps=ecfg.rms_norm_eps, residual=down)
    return a.reshape(B, Q, H), draft_cache


def _rope(cfg: ModelConfig, device) -> torch.Tensor:
    return make_rope_cache(cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta,
                           rope_scaling=cfg.rope_scaling, device=device)


def init_eagle_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """A random draft net of ``cfg``'s widths made on ``device`` from a
    torch.Generator, as the JAX package initializes one: fc normal scaled by
    (2H) ** -0.5, the projections normal(0.02), unit gammas."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = cfg.hidden_size

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    layers = {name: {"w": normal(1, k, n, std=0.02)}
              for name, (k, n) in _proj_shapes(eagle_cfg_for(cfg)).items()}
    layers["input_norm"] = torch.ones((1, H), dtype=dtype, device=dev)
    layers["post_norm"] = torch.ones((1, H), dtype=dtype, device=dev)
    return {"fc": normal(2 * H, H, std=(2 * H) ** -0.5), "layers": layers,
            "rope_cache": _rope(cfg, dev)}


def load_eagle(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda") -> dict:
    """A trained draft net saved as an .npz (``fc`` and ``layers.<name>[.w]``
    arrays, fp16: the JAX package's benchmarks/train_eagle.py and
    :func:`save_eagle` write it), on ``device``."""
    dev = resolve_device(device)
    layers, fc = {}, None
    with np.load(path) as z:
        for key in z.files:
            t = torch.as_tensor(np.asarray(z[key], np.float32), device=dev).to(dtype)
            if key == "fc":
                fc = t
            elif key.startswith("layers."):
                *parents, leaf = key.split(".")[1:]
                d = layers
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = t
    if fc is None:
        raise KeyError(f"{path}: no 'fc' array, not an EAGLE net")
    return {"fc": fc, "layers": layers, "rope_cache": _rope(cfg, dev)}


def save_eagle(path: str, eagle: dict) -> None:
    """Write ``fc`` and the layer's arrays as fp16, the layout
    :func:`load_eagle` reads."""
    def f16(t):
        return t.detach().to(torch.float32).cpu().numpy().astype(np.float16)

    flat = {"fc": f16(eagle["fc"])}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}.{k}", v)
            else:
                flat[f"{prefix}.{k}"] = f16(v)
    walk("layers", eagle["layers"])
    np.savez(path, **flat)
