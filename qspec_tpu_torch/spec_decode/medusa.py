"""Medusa heads: multi-token proposals that ride the verify pass.

Port of ``qspec_tpu/spec_decode/medusa.py`` and of ``medusa_propose_tree``
(``qspec_tpu/spec_decode/medusa_tree.py``). K residual-block heads read the
target's post-final-norm hidden state at the last accepted position; head j
proposes the token j + 1 positions past the next one. The heads are a
subtree of the target's parameters (``params["medusa"]``) and the verify
pass returns the hidden state that seeds the next round, so proposing costs
no extra forward pass (``engine/model_runner.py:medusa_rounds_step``).

    r      = h + silu(h @ w1 + b1)          # residual block
    logits = r @ head                       # per-head vocab projection
    proposal = argmax(logits)               # the chain; top-k for a tree

For a QuaRot checkpoint the hidden state stays in the rotated basis (the
final norm is weightless) and the heads are trained on it, so nothing is
rotated at load.

The heads are plain matrix products, as in the JAX package (no Pallas
kernel there): on the card bf16 operands with an f32 result
(``torch.mm(..., out_dtype=torch.float32)``), the JAX package's
``preferred_element_type=f32`` on the TPU; on the CPU f32 throughout, as the
JAX package computes them on its CPU backend.
"""

from __future__ import annotations

import numpy as np
import torch

from qspec_tpu_torch.models.llama import resolve_device
from qspec_tpu_torch.spec_decode.medusa_tree import TreeSpec


def head_logits(medusa: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[B, H] hidden -> [B, K, V] f32 logits of the K heads
    (``{"w1": [K, H, H], "b1": [K, H], "head": [K, H, V]}``)."""
    w1, b1, head = medusa["w1"], medusa["b1"], medusa["head"]
    if not hidden.is_cuda:
        h = hidden.to(torch.float32)
        z = torch.einsum("bh,khg->bkg", h, w1.to(torch.float32)) + b1.to(torch.float32)[None]
        r = h[:, None] + torch.nn.functional.silu(z)
        return torch.einsum("bkg,kgv->bkv", r, head.to(torch.float32))
    h = hidden.to(torch.bfloat16)
    out = []
    for j in range(head.shape[0]):
        z = torch.mm(h, w1[j].to(torch.bfloat16), out_dtype=torch.float32)
        r = h.to(torch.float32) + torch.nn.functional.silu(z + b1[j].to(torch.float32))
        out.append(torch.mm(r.to(torch.bfloat16), head[j].to(torch.bfloat16),
                            out_dtype=torch.float32))
    return torch.stack(out, dim=1)


def medusa_propose(medusa: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Greedy proposals of the K heads: hidden [B, H] (the post-final-norm
    hidden at the last accepted position) -> [B, K] int32, head j's argmax
    (the token j + 1 positions past the next one)."""
    return head_logits(medusa, hidden).argmax(dim=-1).to(torch.int32)


def medusa_propose_tree(medusa: dict, hidden: torch.Tensor, tree: TreeSpec) -> torch.Tensor:
    """Tree-node tokens from one evaluation of the heads: hidden [B, H] (the
    root's) -> [B, T] int32, column i head head_idx[i]'s
    top-(cand_idx[i] + 1) token."""
    top = torch.topk(head_logits(medusa, hidden), tree.max_cand, dim=-1).indices
    return torch.stack([top[:, h, c] for h, c in zip(tree.head_idx, tree.cand_idx)],
                       dim=1).to(torch.int32)


def lm_head_weight(lm_head) -> torch.Tensor:
    """The float [H, V] weight of a head as the model stores it: the int8
    ``{"qw8", "qs"}`` and int4 ``{"qw", "qs"}`` forms dequantized, a dense
    head as it is."""
    if isinstance(lm_head, dict):
        if "qw8" in lm_head:
            return lm_head["qw8"].to(torch.float32) * lm_head["qs"][None, :]
        from qspec_tpu_torch.ops.packing import unpack_int4
        return unpack_int4(lm_head["qw"]).to(torch.float32) * lm_head["qs"][None, :]
    return lm_head.to(torch.float32)


def init_medusa_params(hidden_size: int, vocab_size: int, k: int, seed: int = 0,
                       dtype=torch.bfloat16, lm_head=None, device=None) -> dict:
    """Random (numpy, the JAX package's numbers for the same seed) or
    ``lm_head``-seeded heads. Each head's vocab projection starts from the
    base head [H, V] (a tensor or an array), as the reference's Medusa
    initializes its heads; with w1 = 0 the residual block is the identity,
    so an untrained head proposes the t + 1 token. ``device``: by default
    ``lm_head``'s when it is a tensor, else the CPU."""
    H, V = hidden_size, vocab_size
    if device is None:
        device = lm_head.device if torch.is_tensor(lm_head) else "cpu"
    if lm_head is not None:
        lm = torch.as_tensor(lm_head, device=device).to(dtype)
        head = lm[None].repeat(k, 1, 1)
    else:
        rng = np.random.default_rng(seed)
        head = torch.as_tensor(rng.standard_normal((k, H, V)).astype(np.float32) * 0.02,
                               device=device).to(dtype)
    return {"w1": torch.zeros((k, H, H), dtype=dtype, device=device),
            "b1": torch.zeros((k, H), dtype=dtype, device=device),
            "head": head}


def load_medusa(path: str, dtype=torch.bfloat16, device="cuda") -> dict:
    """Heads saved as an .npz of stacked w1 / b1 / head arrays (the JAX
    package's benchmarks/train_medusa.py writes them), on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return {name: torch.as_tensor(np.asarray(z[name], np.float32), device=dev).to(dtype)
                for name in ("w1", "b1", "head")}
