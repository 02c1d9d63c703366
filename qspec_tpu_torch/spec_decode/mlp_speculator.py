"""MLPSpeculator (IBM's combined token / embedding speculator) proposer.

Port of ``qspec_tpu/spec_decode/mlp_speculator.py``: a recurrent stack of K
small heads where head j predicts the token j + 1 positions past the next
one from the running state, seeded by the target's post-final-norm hidden
state, and the embedding of the previously proposed token:

    state_0 = hidden                     # [B, H]
    if scale_input: state_0 = l2norm(state_0) / sqrt(2)
    for j in 0..K-1:
        s      = state @ proj_j + emb_j[last_token] * (emb_weight / state_weight)
        state  = gelu(l2norm(s) * ln_w[j] + ln_b[j])   # the exact gelu
        last_token = argmax(state @ head_j)

with state_weight = 0.5 ** (0.5 / K) and emb_weight = sqrt((1 - sw ** 2) *
D / 2). proj_0 maps the hidden (H) into the inner width (D), the others are
D x D. The serving shape is Medusa's (``engine/model_runner.py:
medusa_rounds_step``): the verify pass returns the hidden state at the last
emitted token, the chain reads it with that token and writes the next
round's proposals, which verify under the one-hot rule, so greedy output is
the target's for any net.

The products are plain matrix products, as in the JAX package (no Pallas
kernel there): on the card bf16 operands with an f32 result
(``torch.mm(..., out_dtype=torch.float32)``, the JAX package's
``preferred_element_type=f32`` on the TPU); on the CPU f32 throughout, as
the JAX package computes them on its CPU backend.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qspec_tpu_torch.models.llama import resolve_device

SQRT2 = math.sqrt(2.0)
NET_KEYS = ("emb", "proj_first", "proj_rest", "ln_w", "ln_b", "head")


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 x [B, K] @ w [K, N] -> f32."""
    if not x.is_cuda:
        return x @ w.to(torch.float32)
    return torch.mm(x.to(torch.bfloat16), w.to(torch.bfloat16), out_dtype=torch.float32)


def mlp_speculator_propose(net: dict, hidden: torch.Tensor,
                           last_token: torch.Tensor) -> torch.Tensor:
    """Greedy proposals of the K recurrent heads.

    net: {"emb": [K, V, D], "proj_first": [H, D], "proj_rest": [K-1, D, D],
    "ln_w": [K, D], "ln_b": [K, D], "head": [K, D, V]} (+ an "ln0" entry:
    the scale_input prenorm). hidden [B, H]: the post-final-norm hidden at
    the last emitted token; last_token [B]: that token. Returns [B, K]
    int32."""
    K, D = int(net["head"].shape[0]), int(net["head"].shape[1])
    state_weight = 0.5 ** (0.5 / K)
    alpha = math.sqrt((1.0 - state_weight ** 2) * (D / 2.0)) / state_weight
    state = hidden.to(torch.float32)
    if "ln0" in net:
        state = _l2norm(state) / SQRT2
    last = last_token.to(torch.int64)
    toks = []
    for j in range(K):
        z = net["emb"][j][last].to(torch.float32)                        # [B, D]
        w = net["proj_first"] if j == 0 else net["proj_rest"][j - 1]
        s = _mm(state, w) + z * alpha
        s = _l2norm(s) * net["ln_w"][j].to(torch.float32) + net["ln_b"][j].to(torch.float32)
        state = torch.nn.functional.gelu(s)
        last = _mm(state, net["head"][j]).argmax(dim=-1)
        toks.append(last)
    return torch.stack(toks, dim=1).to(torch.int32)


def init_mlp_speculator_params(hidden_size: int, vocab_size: int, k: int,
                               inner_dim: int = None, seed: int = 0,
                               scale_input: bool = False, dtype=torch.bfloat16,
                               device="cuda") -> dict:
    """A random net (normal(0.02) embeddings and projections, unit ln
    weights, zero ln biases). On the CPU its numbers are numpy's, the JAX
    package's for the same seed; on a card it is made there from a
    torch.Generator (an 8B-wide net never passes through host memory)."""
    dev = resolve_device(device)
    H, V = hidden_size, vocab_size
    D = inner_dim or H
    if dev.type == "cpu":
        rng = np.random.default_rng(seed)

        def g(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.02
                                   ).to(dtype)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def g(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    net = {"emb": g(k, V, D), "proj_first": g(H, D), "proj_rest": g(max(k - 1, 0), D, D),
           "ln_w": torch.ones((k, D), dtype=dtype, device=dev),
           "ln_b": torch.zeros((k, D), dtype=dtype, device=dev),
           "head": g(k, D, V)}
    if scale_input:
        net["ln0"] = torch.ones((), dtype=dtype, device=dev)
    return net


def load_mlp_speculator(path: str, dtype=torch.bfloat16, device="cuda") -> dict:
    """A net saved as an .npz of the stacked arrays named as in
    :func:`init_mlp_speculator_params` (the JAX package's
    benchmarks/train_mlp_speculator.py writes it), on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        names = NET_KEYS + (("ln0",) if "ln0" in z.files else ())
        return {name: torch.as_tensor(np.asarray(z[name], np.float32), device=dev).to(dtype)
                for name in names}
