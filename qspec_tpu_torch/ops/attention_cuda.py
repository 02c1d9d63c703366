"""Wrapper of the paged-attention CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``qspec_tpu/ops/attention_pallas.py:paged_attention_pallas``
(causal core and sliding window; bf16, int8, fp8_e4m3 and fp8_e5m2 caches).
The plain version it is held against is ``ops/attention.py:paged_attention_ref``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from qspec_tpu_torch import _build

# entry type -> the kernel's instantiation code (csrc/paged_attention.cu)
KV_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
            torch.float8_e5m2: 3}
# entry types whose pages carry per-token scales
SCALED = (torch.int8, torch.float8_e4m3fn)
# entry type -> the launch counts of its instantiation: ``launches`` is
# raised by one at each launch of that instantiation (ops.kernel_wrappers
# names each), ``window_launches`` also at each launch under a window
LAUNCHES = {dtype: SimpleNamespace(launches=0, window_launches=0)
            for dtype in KV_CODES}
# the sliding-window sentinel (qspec_tpu/ops/attention_pallas.py NO_WINDOW):
# far past any position, so the window never masks and the walk starts at 0
NO_WINDOW = 1 << 30


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                         scale: float, q_positions: torch.Tensor = None,
                         layer: int = 0, kv_scales: torch.Tensor = None,
                         window: int = None) -> torch.Tensor:
    """q: [B, Q, Hq, 128] bf16; kv_pages: the whole stacked cache
    [L, P, 2, Hkv, S, 128] of bf16, int8, fp8_e4m3 or fp8_e5m2 entries
    (layer ``layer`` is read in place); kv_scales [L, P, 2, Hkv, S] f32 for
    int8 and fp8_e4m3, else None; block_tables [B, PPS]; ctx_lens [B].
    ``q_positions`` [B, Q] must be consecutive per row; only column 0 is
    read (else the queries are the last Q positions). ``window``: a query at
    position p sees the kv positions in (p - window, p]; the pages before a
    row's first in-window position are not read. Returns [B, Q, Hq, 128]
    bf16."""
    _build.require(q.is_cuda, "paged_attention_cuda: CUDA tensors")
    B, Q, Hq, D = q.shape
    L, P, two, Hkv, S, D2 = kv_pages.shape
    _build.require(q.dtype == torch.bfloat16 and kv_pages.dtype in KV_CODES,
                   "paged_attention_cuda: bf16 q; bf16, int8 or fp8 cache")
    scaled = kv_pages.dtype in SCALED
    _build.require((kv_scales is not None) == scaled,
                   "paged_attention_cuda: kv_scales exactly for int8 / fp8_e4m3")
    if scaled:
        _build.require(kv_scales.dtype == torch.float32
                       and tuple(kv_scales.shape) == (L, P, 2, Hkv, S),
                       "paged_attention_cuda: kv_scales f32 [L, P, 2, Hkv, S]")
    _build.require(D == 128 and D2 == 128 and two == 2,
                   "paged_attention_cuda: head dim 128")
    _build.require(Hq % Hkv == 0 and S % 16 == 0,
                   "paged_attention_cuda: Hq % Hkv == 0 and page size % 16 == 0")
    _build.require(0 <= layer < L, "paged_attention_cuda: layer in range")
    win = NO_WINDOW if window is None else int(window)
    _build.require(0 < win <= NO_WINDOW, "paged_attention_cuda: window >= 1")
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
    sc_ptr = None
    if scaled:
        sc_layer = kv_scales[layer]
        _build.cuda_args_ok(q, sc_layer)
        sc_ptr = sc_layer.data_ptr()
    _build.check("paged_attention", _build.lib().qspec_paged_attention(
        q.data_ptr(), kv_layer.data_ptr(), sc_ptr, tables.data_ptr(),
        ctx.data_ptr(), q_start.data_ptr(), out.data_ptr(), B, Q, Hq, Hkv, S,
        tables.shape[1], KV_CODES[kv_pages.dtype], float(scale), win,
        _build.stream_of(q)))
    LAUNCHES[kv_pages.dtype].launches += 1
    if window is not None:
        LAUNCHES[kv_pages.dtype].window_launches += 1
    return out
