"""Multi-LoRA serving: per-request low-rank adapters over the shared base.

Port of ``qspec_tpu/lora/layers.py``. The adapters live in a fixed-shape
slot bank inside the parameters (``params["lora"]``): per target projection
(qkv, o, gate_up, down), A [L, n, in, r] and B [L, n, r, out], slot 0 the
base model (zeros). A batch whose rows use different adapters runs every
adapter's down-projection over every token and masks the rows of the
others (:func:`lora_delta`): with n slots of rank r the extra work is
T (in + out) n r a projection, small beside the base projection, and the
same shapes serve any mix of adapters. These are plain torch ops, as the
JAX package computes them with no Pallas body.

A PEFT adapter is trained in the float model's basis. Under QuaRot
(``quantize_float``), a projection x @ W is served as x' @ W' with
W' = R_in^T diag(gamma) W R_out: R_in the random Hadamard Q for qkv and
gate_up, the head Hadamard for o and H_I for down; R_out Q for o and down
and the identity for qkv and gate_up; gamma the folded norm's weight for
qkv and gate_up. :func:`load_peft_adapter` takes the same path with a
:class:`Rotation` of the basis that ``quantize_float`` records
(``params["quarot"]``): A' = R_in^T diag(gamma) A, B' = B R_out, so the
served delta is the float model's. Without one (``init_params``, ``load_qspec``, where the rotation
is not known) the adapter is installed as it is, in the served basis, as
the JAX package installs every adapter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from qspec_tpu_torch.ops.hadamard import hadamard_f32, hadamard_matrix, random_hadamard_matrix

TARGETS = ("qkv", "o", "gate_up", "down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    max_loras: int = 4          # adapter slots, slot 0 (the base) included
    max_rank: int = 16


def _proj_dims(cfg):
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {"qkv": (H, cfg.qkv_out), "o": (cfg.q_size, H),
            "gate_up": (H, 2 * I), "down": (I, H)}


def init_lora_params(cfg, lora_cfg: LoRAConfig, dtype=torch.bfloat16, device="cuda"):
    """A zero bank on ``device`` (the card unless the caller asks for the
    CPU): per target, A [L, n, in, r] and B [L, n, r, out]."""
    # models/llama.py imports this module for lora_delta
    from qspec_tpu_torch.models.llama import resolve_device
    if cfg.num_experts:
        raise NotImplementedError(
            "LoRA on a mixture-of-experts model is not ported: the JAX package applies "
            "no adapter to its experts' MLP (ROADMAP queue 3)")
    if cfg.attention_type == "mla":
        raise NotImplementedError(
            "LoRA on a multi-head latent attention model (DeepSeek-V2 / V3, MiniCPM3) is "
            "not ported: the JAX package's _mla_attention applies no adapter")
    dev = resolve_device(device)
    n, r = lora_cfg.max_loras, lora_cfg.max_rank
    return {"layers": {
        t: {"A": torch.zeros((cfg.num_layers, n, i, r), dtype=dtype, device=dev),
            "B": torch.zeros((cfg.num_layers, n, r, o), dtype=dtype, device=dev)}
        for t, (i, o) in _proj_dims(cfg).items()}}


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """x [T, in]; A [n, in, r]; B [n, r, out]; ids [T] -> delta [T, out] in
    x's dtype. Each row's delta is x A[id] B[id], from every adapter's
    product masked to the row's own. The products are taken in float64, as
    the Hadamards are: a row's result then does not depend on how the GEMM
    library splits its sums for the batch's row count (greedy speculative
    output stays the oracle's bit for bit), and a row of slot 0 gets an
    exact 0."""
    n, k, r = A.shape
    T = x.shape[0]
    xa = x.to(torch.float64) @ A.to(torch.float64).permute(1, 0, 2).reshape(k, n * r)
    mask = ids.to(torch.int64)[:, None] == torch.arange(n, device=x.device)[None, :]
    xa = (xa.reshape(T, n, r) * mask[:, :, None]).reshape(T, n * r)
    delta = xa @ B.to(torch.float64).reshape(n * r, -1)
    return delta.to(torch.float32).to(x.dtype)


def quarot_basis(cfg, seed: int, input_norm: torch.Tensor, post_norm: torch.Tensor) -> dict:
    """What ``quantize_float`` records beside its parameters
    (``params["quarot"]``) so that float-basis adapters and soft prompts can
    be served: the rotation's seed (a 0-d tensor, so the tree stays one of
    tensors) and the folded gammas, f32 [L, H]."""
    return {"seed": torch.tensor(int(seed), device=input_norm.device),
            "input_norm": input_norm.to(torch.float32),
            "post_norm": post_norm.to(torch.float32)}


class Rotation:
    """The QuaRot factors of a ``basis`` on ``device``, in float32 as
    ``quantize_float`` makes them: Q [H, H], the head Hadamard, H_I."""

    def __init__(self, cfg, basis: dict, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.basis = basis
        self.Q = torch.as_tensor(random_hadamard_matrix(cfg.hidden_size, seed=int(basis["seed"]))
                                 .astype(np.float32), device=device)
        nh = cfg.num_heads
        self.H_heads = (torch.as_tensor(hadamard_matrix(nh), **f32)
                        / torch.tensor(math.sqrt(nh), **f32))
        self.H_I = hadamard_f32(cfg.intermediate_size, device)
        self.cfg = cfg

    def adapter(self, target: str, li: int, A: torch.Tensor, B: torch.Tensor):
        """(A', B') of one layer's float-basis delta A [in, r] B [r, out]."""
        if target in ("qkv", "gate_up"):
            g = self.basis["input_norm" if target == "qkv" else "post_norm"][li]
            return self.Q.T @ (g.to(A.device)[:, None] * A), B
        if target == "o":
            nh, hd = self.cfg.num_heads, self.cfg.head_dim
            a = torch.einsum("jh,hdr->jdr", self.H_heads, A.reshape(nh, hd, -1))
            return a.reshape(nh * hd, -1), B @ self.Q
        return self.H_I @ A, B @ self.Q

    def embeddings(self, rows: torch.Tensor) -> torch.Tensor:
        """Float-basis embedding rows [n, H] in the served basis: rows Q."""
        return rows @ self.Q


def _parts(cfg, target: str):
    """(PEFT module name, column offset, width) of each part of a fused
    target projection."""
    if target == "qkv":
        return [("q_proj", 0, cfg.q_size), ("k_proj", cfg.q_size, cfg.kv_size),
                ("v_proj", cfg.q_size + cfg.kv_size, cfg.kv_size)]
    if target == "gate_up":
        I = cfg.intermediate_size
        return [("gate_proj", 0, I), ("up_proj", I, I)]
    return [({"o": "o_proj", "down": "down_proj"}[target], 0, _proj_dims(cfg)[target][1])]


def load_peft_adapter(lora_params, cfg, slot: int, state_dict: Dict,
                      alpha: Optional[float] = None, rotation: Optional[Rotation] = None):
    """Install a PEFT-style adapter into ``slot`` of the bank, in place.

    ``state_dict`` keys follow PEFT's naming, e.g.
    ``base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight`` ([r,
    in]) and ``...lora_B.weight`` ([out, r]), numpy arrays or tensors. The
    alpha / r scaling is folded into B; projections the adapter lacks stay
    zero. The parts of a fused projection (q / k / v, gate / up) take
    disjoint stripes of the rank, so independent adapters of the parts
    compose exactly. ``rotation``: the model's QuaRot basis (module
    docstring), applied to each layer's A and B; None installs them as
    they are. Returns the bank."""
    bank = lora_params["layers"]
    max_r = bank["qkv"]["A"].shape[-1]
    dev = bank["qkv"]["A"].device
    by_layer: Dict[tuple, torch.Tensor] = {}
    for k, v in state_dict.items():
        if ".layers." not in k or "lora_" not in k:
            continue
        li = int(k.split(".layers.", 1)[1].split(".", 1)[0])
        ab = "A" if "lora_A" in k else "B"
        mod = k.split(f".lora_{ab}", 1)[0].rsplit(".", 1)[-1]
        by_layer[(li, mod, ab)] = torch.as_tensor(np.asarray(v, np.float32)
                                                  if not isinstance(v, torch.Tensor) else v)
    dims = _proj_dims(cfg)
    for t in TARGETS:
        in_f, out_f = dims[t]
        for li in range(cfg.num_layers):
            A_new = torch.zeros((in_f, max_r), dtype=torch.float32, device=dev)
            B_new = torch.zeros((max_r, out_f), dtype=torch.float32, device=dev)
            r_off = 0
            for name, off, width in _parts(cfg, t):
                a, b = by_layer.get((li, name, "A")), by_layer.get((li, name, "B"))
                if a is None or b is None:
                    continue
                r = a.shape[0]
                if r_off + r > max_r:
                    raise ValueError(f"layer {li} {t}: the parts' ranks add up past the "
                                     f"bank's max_rank {max_r}")
                scale = (alpha / r) if alpha else 1.0
                A_new[:, r_off:r_off + r] = a.to(device=dev, dtype=torch.float32).T
                B_new[r_off:r_off + r, off:off + width] = (
                    b.to(device=dev, dtype=torch.float32).T * scale)
                r_off += r
            if not r_off:
                continue
            if rotation is not None:
                A_new, B_new = rotation.adapter(t, li, A_new, B_new)
            bank[t]["A"][li, slot] = A_new.to(bank[t]["A"].dtype)
            bank[t]["B"][li, slot] = B_new.to(bank[t]["B"].dtype)
    return lora_params
