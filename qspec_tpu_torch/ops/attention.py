"""Attention over the paged KV cache.

Port of ``qspec_tpu/ops/attention.py`` (bf16 cache, causal). One chunked
formulation serves every phase:

* decode:  Q = 1 new token per sequence;
* verify:  Q = k + 1 speculative positions per sequence, scored in one pass;
* the draft's Q = 2 backfill step and chunked prefill.

``paged_attention_ref`` is the plain version (gather the pages, dense masked
softmax in f32); ``paged_attention`` dispatches CUDA tensors to the kernel
(``attention_cuda.py``). The JAX package's other options (sliding window,
logit softcap, ALiBi, the Medusa tree mask, int8/fp8 caches) are not ported
yet and raise.
"""

from __future__ import annotations

import torch

from qspec_tpu_torch.ops.kv_cache import PagedKVCache, gather_layer

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, cache: PagedKVCache, layer: int,
                        block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        scale: float, q_positions: torch.Tensor = None) -> torch.Tensor:
    """q: [B, Q, Hq, D]; ctx_lens[b] counts tokens *including* the new ones.

    ``q_positions`` [B, Q] gives each query's absolute position; query i
    attends to kv positions <= its own. When omitted, queries are the *last*
    Q positions (decode/verify windows).
    """
    B, Q, Hq, D = q.shape
    if q_positions is None:
        q_positions = (ctx_lens[:, None] - Q) + torch.arange(Q, device=q.device)[None, :]
    k, v = gather_layer(cache, layer, block_tables)  # [B, Hkv, C, D]
    Hkv = k.shape[1]
    group = Hq // Hkv
    qf = (q.to(torch.float32) * scale).reshape(B, Q, Hkv, group, D)
    scores = torch.einsum("bqhgd,bhcd->bhgqc", qf, k.to(torch.float32))
    C = k.shape[2]
    kv_pos = torch.arange(C, device=q.device)[None, :]
    mask = kv_pos[None] <= q_positions[:, :, None]             # [B, Q, C]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqc,bhcd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Q, Hq, D).to(q.dtype)


def paged_attention(q: torch.Tensor, cache: PagedKVCache, layer: int,
                    block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                    scale: float, q_positions: torch.Tensor = None,
                    window=None, softcap=None, alibi=None,
                    tree=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version on the CPU."""
    if window is not None or softcap is not None or alibi is not None \
            or tree is not None:
        raise NotImplementedError("sliding window, softcap, ALiBi and the "
                                  "tree mask are not ported yet")
    head_dim = q.shape[-1]
    cache_dim = cache.kv_pages.shape[-1]
    if cache_dim != head_dim:
        # small head dims are stored 128-padded (ModelConfig.cache_head_dim):
        # pad q, slice the output; zero lanes are inert in QK dots and V sums
        q = torch.nn.functional.pad(q, (0, cache_dim - head_dim))
    if q.is_cuda:
        from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
        out = paged_attention_cuda(q, cache.kv_pages, block_tables, ctx_lens,
                                   scale, q_positions=q_positions, layer=layer)
    else:
        out = paged_attention_ref(q, cache, layer, block_tables, ctx_lens,
                                  scale, q_positions=q_positions)
    return out[..., :head_dim] if cache_dim != head_dim else out
