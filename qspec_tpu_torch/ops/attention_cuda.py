"""Wrapper of the paged-attention CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``qspec_tpu/ops/attention_pallas.py:paged_attention_pallas``
(causal core, sliding window, logit softcap, ALiBi and the Medusa tree mask;
head dims 128 and 256; bf16, int8, fp8_e4m3 and fp8_e5m2 caches).
The plain version it is held against is ``ops/attention.py:paged_attention_ref``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.attention import MAX_TREE_NODES

# entry type -> the kernel's instantiation code (csrc/paged_attention.cu)
KV_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
            torch.float8_e5m2: 3}
# entry types whose pages carry per-token scales
SCALED = (torch.int8, torch.float8_e4m3fn)
# the head dims the kernel is instantiated for (csrc/paged_attention.cu)
HEAD_DIMS = (128, 256)
# entry type -> the launch counts of its instantiations: ``launches`` is
# raised by one at each launch of that entry type (ops.kernel_wrappers names
# each); ``window_launches`` also at each launch under a window,
# ``softcap_launches`` at each launch with a logit softcap,
# ``d256_launches`` at each launch of the head-dim-256 instantiation,
# ``tree_launches`` at each launch under a Medusa tree mask and
# ``alibi_launches`` at each launch of an ALiBi instantiation
LAUNCHES = {dtype: SimpleNamespace(launches=0, window_launches=0,
                                   softcap_launches=0, d256_launches=0,
                                   tree_launches=0, alibi_launches=0)
            for dtype in KV_CODES}
# the sliding-window sentinel (qspec_tpu/ops/attention_pallas.py NO_WINDOW):
# far past any position, so the window never masks and the walk starts at 0
NO_WINDOW = 1 << 30


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                         scale: float, q_positions: torch.Tensor = None,
                         layer: int = 0, kv_scales: torch.Tensor = None,
                         window: int = None, softcap: float = None,
                         alibi: torch.Tensor = None, tree=None) -> torch.Tensor:
    """q: [B, Q, Hq, D] bf16, D 128 or 256; kv_pages: the whole stacked cache
    [L, P, 2, Hkv, S, D] of bf16, int8, fp8_e4m3 or fp8_e5m2 entries
    (layer ``layer`` is read in place); kv_scales [L, P, 2, Hkv, S] f32 for
    int8 and fp8_e4m3, else None; block_tables [B, PPS]; ctx_lens [B].
    ``q_positions`` [B, Q] must be consecutive per row; only column 0 is
    read (else the queries are the last Q positions; under ``tree`` only
    column prefix - 1). ``window``: a query at
    position p sees the kv positions in (p - window, p]; the pages before a
    row's first in-window position are not read. ``softcap``: the scores
    become softcap * tanh(score / softcap) before the mask (Gemma-2's
    attn_logit_softcapping). ``alibi``: [Hq] f32 slopes on q's device;
    slope * (kv_pos - q_pos) is added to the scores before the mask (BLOOM,
    MPT); head dim 128 only, and neither with the softcap nor under a tree
    (the kernel is instantiated where the JAX package reaches ALiBi).
    ``tree``: an ops.attention.TreeMask on q's
    device, the Medusa tree verify rectangle (ops/attention.tree_slot_mask):
    row prefix-1 is the root, at q_positions[:, prefix - 1]; rows past it
    are the T <= 64 tree nodes, node t at slot root + 1 + t, each
    seeing the context up to the root (under the window, past its own AR
    position root + depth less the window) and its ancestors' and its own
    slots. Returns [B, Q, Hq, D] bf16."""
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
    _build.require(D == D2 and D in HEAD_DIMS and two == 2,
                   f"paged_attention_cuda: head dim 128 or 256 (q and cache alike), "
                   f"got q {D}, cache {D2}")
    _build.require(Hq % Hkv == 0 and S % 16 == 0,
                   "paged_attention_cuda: Hq % Hkv == 0 and page size % 16 == 0")
    _build.require(0 <= layer < L, "paged_attention_cuda: layer in range")
    win = NO_WINDOW if window is None else int(window)
    _build.require(0 < win <= NO_WINDOW, "paged_attention_cuda: window >= 1")
    cap = 0.0 if softcap is None else float(softcap)
    _build.require(softcap is None or cap > 0, "paged_attention_cuda: softcap > 0")
    alibi_ptr = None
    if alibi is not None:
        _build.require(D == 128 and softcap is None and tree is None,
                       "paged_attention_cuda: ALiBi at head dim 128, without the "
                       "softcap and the tree mask")
        _build.require(alibi.dtype == torch.float32 and tuple(alibi.shape) == (Hq,),
                       f"paged_attention_cuda: alibi f32 [{Hq}]")
        alibi = alibi.contiguous()
        _build.cuda_args_ok(q, alibi)
        alibi_ptr = alibi.data_ptr()
    tables = block_tables.to(torch.int32).contiguous()
    ctx = ctx_lens.to(torch.int32).contiguous()
    _build.require(tuple(tables.shape[:1]) == (B,) and tuple(ctx.shape) == (B,),
                   "paged_attention_cuda: block_tables [B, PPS], ctx_lens [B]")
    anc_ptr, prefix = None, 0
    if tree is not None:
        prefix = tree.prefix
        _build.require(tree.words is not None,
                       f"paged_attention_cuda: a tree of at most {MAX_TREE_NODES} nodes "
                       "(one 64-bit ancestor word per node)")
        _build.require(q_positions is not None and 1 <= prefix
                       and prefix + tree.words.shape[0] == Q,
                       "paged_attention_cuda: a tree rectangle of prefix + T rows "
                       "with q_positions")
        _build.cuda_args_ok(q, tree.words)
        anc_ptr = tree.words.data_ptr()
        # row 0's slot: the root's position less the prefix rows before it
        # (negative for phantom rows of a short prompt, which see nothing)
        q_start = (q_positions[:, prefix - 1].to(torch.int32) - (prefix - 1)).contiguous()
    elif q_positions is None:
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
        tables.shape[1], KV_CODES[kv_pages.dtype], D, float(scale), cap, win,
        anc_ptr, prefix, alibi_ptr, _build.stream_of(q)))
    count = LAUNCHES[kv_pages.dtype]
    count.launches += 1
    count.window_launches += window is not None
    count.softcap_launches += softcap is not None
    count.d256_launches += D == 256
    count.tree_launches += tree is not None
    count.alibi_launches += alibi is not None
    return out
