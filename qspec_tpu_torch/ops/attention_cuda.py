"""Wrapper of the paged-attention CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``qspec_tpu/ops/attention_pallas.py:paged_attention_pallas``
(bf16 cache, causal core). The plain version it is held against is
``ops/attention.py:paged_attention_ref``.
"""

from __future__ import annotations

import torch

from qspec_tpu_torch import _build


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                         scale: float, q_positions: torch.Tensor = None,
                         layer: int = 0) -> torch.Tensor:
    """q: [B, Q, Hq, 128] bf16; kv_pages: the whole stacked cache
    [L, P, 2, Hkv, S, 128] (layer ``layer`` is read in place);
    block_tables [B, PPS]; ctx_lens [B]. ``q_positions`` [B, Q] must be
    consecutive per row; only column 0 is read (else the queries are the
    last Q positions). Returns [B, Q, Hq, 128] bf16."""
    _build.require(q.is_cuda, "paged_attention_cuda: CUDA tensors")
    B, Q, Hq, D = q.shape
    L, P, two, Hkv, S, D2 = kv_pages.shape
    _build.require(q.dtype == torch.bfloat16 and kv_pages.dtype == torch.bfloat16,
                   "paged_attention_cuda: bf16 q and cache")
    _build.require(D == 128 and D2 == 128 and two == 2,
                   "paged_attention_cuda: head dim 128")
    _build.require(Hq % Hkv == 0 and S % 16 == 0,
                   "paged_attention_cuda: Hq % Hkv == 0 and page size % 16 == 0")
    _build.require(0 <= layer < L, "paged_attention_cuda: layer in range")
    tables = block_tables.to(torch.int32).contiguous()
    ctx = ctx_lens.to(torch.int32).contiguous()
    _build.require(tuple(tables.shape[:1]) == (B,) and tuple(ctx.shape) == (B,),
                   "paged_attention_cuda: block_tables [B, PPS], ctx_lens [B]")
    if q_positions is None:
        q_start = (ctx - Q).contiguous()
    else:
        q_start = q_positions[:, 0].to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    kv_layer = kv_pages[layer]
    _build.cuda_args_ok(q, kv_layer, tables, ctx, q_start, out)
    _build.check("paged_attention", _build.lib().qspec_paged_attention(
        q.data_ptr(), kv_layer.data_ptr(), tables.data_ptr(), ctx.data_ptr(),
        q_start.data_ptr(), out.data_ptr(), B, Q, Hq, Hkv, S, tables.shape[1],
        float(scale), _build.stream_of(q)))
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
