"""Attention over the paged KV cache.

Port of ``qspec_tpu/ops/attention.py`` (causal, optionally under a sliding
window, with Gemma-2's logit softcap or with ALiBi, or under the Medusa tree
mask; bf16, int8, fp8_e4m3 and fp8_e5m2 caches; MLA's latent head dims 384
and 640, causal only, over the lanes they need). One chunked formulation
serves every phase:

* decode:  Q = 1 new token per sequence;
* verify:  Q = k + 1 speculative positions per sequence, scored in one pass;
* the draft's Q = 2 backfill step and chunked prefill;
* the Medusa tree verify: [prefix | T tree nodes] in one rectangle.

``paged_attention_ref`` is the plain version (gather the pages, dequantized
to bf16 when the cache is 8-bit, dense masked softmax in f32);
``paged_attention`` dispatches CUDA tensors to the kernel
(``attention_cuda.py``), which reads 8-bit pages and their scales as they
are.

Under the tree mask with a window, a tree node at depth d is bounded as AR
bounds the query at its own position root + d: it sees the context in
(root + d - window, root] and its ancestors' slots (AR's mask wherever the
window is longer than the tree is deep). The JAX package departs from AR
there: its Pallas kernel takes the root as the window's reference and its
plain version ignores the window in tree mode. ALiBi under the tree mask
raises: the JAX kernel would bias a tree row by slot distance, where AR
biases by the node's position.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from qspec_tpu_torch.ops.kv_cache import PagedKVCache, gather_layer

NEG_INF = -1e30
# the most tree nodes the attention kernel takes: one 64-bit ancestor word per node
MAX_TREE_NODES = 64


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes, float32 [n_heads] (``qspec_tpu/ops/attention.py::
    alibi_slopes``, the same float arithmetic; Press et al. 2022). For n a
    power of two the geometric sequence starting at 2^(-8/n) with that
    ratio; otherwise the sequence of the power of two below n, followed by
    the odd elements of the sequence of twice that power."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        out = pow2_slopes(n_heads)
    else:
        base = 2 ** math.floor(math.log2(n_heads))
        out = pow2_slopes(base) + pow2_slopes(2 * base)[0::2][: n_heads - base]
    return np.asarray(out, np.float32)


@dataclasses.dataclass(frozen=True, eq=False)
class TreeMask:
    """A Medusa tree-verify rectangle's mask on one device: rows
    0..prefix-1 are ordinary queries ending at the root (row prefix-1), the
    next T rows the tree's nodes, node t at slot root + 1 + t.
    ``ancestors`` [T, T] bool (ancestors[t, j]: node j is an ancestor of
    node t or t itself; the plain version reads it); ``words`` [T] int64,
    bit j of word t = ancestors[t, j] (the kernel reads them), None past
    MAX_TREE_NODES. Made once per tree by :func:`tree_mask`."""
    prefix: int
    ancestors: torch.Tensor
    words: Optional[torch.Tensor]


def tree_mask(prefix: int, ancestors, device) -> TreeMask:
    """The TreeMask of a TreeSpec's static ``ancestors`` [T, T] bools under
    ``prefix`` rows, on ``device``. A CUDA device takes at most
    MAX_TREE_NODES nodes (the kernel's bound)."""
    rows = [[bool(x) for x in row] for row in ancestors]
    T = len(rows)
    if torch.device(device).type == "cuda" and not 0 < T <= MAX_TREE_NODES:
        raise ValueError(f"paged attention: a tree of 1..{MAX_TREE_NODES} nodes on CUDA "
                         f"(one 64-bit ancestor word per node), got {T}")
    words = None
    if T <= MAX_TREE_NODES:
        vals = [sum(1 << j for j, bit in enumerate(row) if bit) for row in rows]
        words = torch.tensor([w - (1 << 64) if w >= 1 << 63 else w for w in vals],
                             dtype=torch.int64, device=device)   # as int64
    return TreeMask(prefix, torch.tensor(rows, dtype=torch.bool, device=device), words)


def tree_slot_mask(prefix: int, num_q: int, q_start: torch.Tensor, ancestors,
                   C: int, window: int = None) -> torch.Tensor:
    """[B, num_q, C] live mask of a tree-verify rectangle, in slot space
    (``qspec_tpu/ops/attention.py:tree_slot_mask``).

    Queries 0..prefix-1 are consecutive positions ending at the root
    (query prefix-1); queries prefix..num_q-1 are tree nodes stored at
    slots root + 1 + node. A tree query attends every slot up to the root
    plus its ancestors' and its own slots. q_start [B]: the slot of query 0
    (root - prefix + 1). ancestors: [T, T] bools (a tensor or nested
    sequences), ancestors[i][j] = node j is an ancestor of node i or i
    itself. ``window``: the causal part of a row keeps only the positions
    past (its own position - window): a prefix row's position is its slot,
    tree node t's is root + depth(t), depth(t) = the number of its
    ancestors, itself included (AR's bound); the causal bound of a tree row
    stays the root and its ancestor slots stay live.
    """
    dev = q_start.device
    T = num_q - prefix
    anc = torch.as_tensor(ancestors, dtype=torch.bool, device=dev).reshape(T, T)
    kv = torch.arange(C, device=dev)[None, None, :]                  # [1, 1, C]
    rows = torch.arange(num_q, device=dev)[None, :, None]            # [1, Q, 1]
    qs = q_start.to(torch.int64)[:, None, None]                       # [B, 1, 1]
    root = qs + prefix - 1
    bound = torch.where(rows < prefix, qs + rows, root)               # [B, Q, 1]
    node = (rows[0, :, 0] - prefix).clamp(0, T - 1)                  # [Q]
    live = kv <= bound
    if window is not None:
        depth = torch.where(rows[0, :, 0] >= prefix, anc[node].sum(dim=1), 0)
        live = live & (kv > bound + depth[None, :, None] - window)
    kv_node = (kv - root - 1)[:, 0]                                   # [B, C]
    in_tree = (kv_node >= 0) & (kv_node < T)
    # row q's bit for the node stored at each slot: [B, Q, C]
    tree_live = anc[node][:, kv_node.clamp(0, T - 1)].permute(1, 0, 2)
    tree_live = tree_live & in_tree[:, None] & (rows >= prefix)
    return live | tree_live


def paged_attention_ref(q: torch.Tensor, cache: PagedKVCache, layer: int,
                        block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        scale: float, q_positions: torch.Tensor = None,
                        window: int = None, softcap: float = None,
                        alibi: torch.Tensor = None, tree=None,
                        bf16_products: bool = False, lanes: tuple = None) -> torch.Tensor:
    """q: [B, Q, Hq, D]; ctx_lens[b] counts tokens *including* the new ones.

    ``q_positions`` [B, Q] gives each query's absolute position; query i
    attends to kv positions <= its own. When omitted, queries are the *last*
    Q positions (decode/verify windows). ``window`` limits a query at
    position p to the kv positions in (p - window, p] (Mistral's sliding
    window, the windowed draft). ``softcap``: the f32 scores become
    softcap * tanh(score / softcap) after the scale and before the mask
    (Gemma-2's attention-logit cap). ``alibi``: [Hq] f32 slopes
    (:func:`alibi_slopes`); slope * (kv_pos - q_pos) is added to the f32
    scores after the scale, before the softcap and the mask, in the JAX
    Pallas kernel's order. ``tree``: a :class:`TreeMask`, the Medusa
    tree-verify mask of :func:`tree_slot_mask`, its root at
    ``q_positions[:, tree.prefix - 1]``; not with ``alibi``.
    ``bf16_products``: round where the JAX Pallas body rounds for its bf16
    products (``qspec_tpu/ops/attention_pallas.py:128, 208``), over a bf16
    cache: q times the scale to bf16 before the scores, and the
    probabilities to bf16 before P.V, the row sums taken unrounded.
    ``lanes``: (k_dims, v_dims), the function over q's and K's first k_dims
    lanes and V's first v_dims, the output zero past v_dims (MLA's latent
    rows: the kernel reads only those lanes).
    """
    B, Q, Hq, D = q.shape
    if bf16_products and cache.kv_pages.dtype != torch.bfloat16:
        raise ValueError("bf16_products: a bf16 cache only")
    if q_positions is None:
        q_positions = (ctx_lens[:, None] - Q) + torch.arange(Q, device=q.device)[None, :]
    k, v = gather_layer(cache, layer, block_tables)  # [B, Hkv, C, D]
    if lanes is not None:
        k, v, q = k[..., :lanes[0]], v[..., :lanes[1]], q[..., :lanes[0]]
    Hkv = k.shape[1]
    group = Hq // Hkv
    qf = q.to(torch.float32) * scale
    if bf16_products:
        qf = qf.to(torch.bfloat16).to(torch.float32)
    qf = qf.reshape(B, Q, Hkv, group, q.shape[-1])
    scores = torch.einsum("bqhgd,bhcd->bhgqc", qf, k.to(torch.float32))
    C = k.shape[2]
    kv_pos = torch.arange(C, device=q.device)[None, :]
    if alibi is not None:
        _check_alibi(alibi, Hq, tree)
        delta = (kv_pos[None].to(torch.float32)
                 - q_positions[:, :, None].to(torch.float32))       # [B, Q, C]
        sl = alibi.to(torch.float32).reshape(Hkv, group)
        scores = scores + sl[None, :, :, None, None] * delta[:, None, None]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if tree is not None:
        q_start = q_positions[:, tree.prefix - 1] - (tree.prefix - 1)
        mask = tree_slot_mask(tree.prefix, Q, q_start, tree.ancestors, C, window)
    else:
        mask = kv_pos[None] <= q_positions[:, :, None]         # [B, Q, C]
        if window is not None:
            mask = mask & (kv_pos[None] > q_positions[:, :, None] - window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    if bf16_products:
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = p.to(torch.bfloat16).to(torch.float32) / p.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqc,bhcd->bqhgd", probs, v.to(torch.float32))
    out = out.reshape(B, Q, Hq, v.shape[-1]).to(q.dtype)
    return out if out.shape[-1] == D else torch.nn.functional.pad(out, (0, D - out.shape[-1]))


def _check_alibi(alibi: torch.Tensor, num_heads: int, tree) -> None:
    if tree is not None:
        raise NotImplementedError(
            "ALiBi under the Medusa tree mask: the JAX kernel biases a tree row "
            "by its slot's distance, AR by the node's position root + depth; "
            "the port serves neither")
    if tuple(alibi.shape) != (num_heads,):
        raise ValueError(f"alibi: [{num_heads}] slopes, got {tuple(alibi.shape)}")


def paged_attention(q: torch.Tensor, cache: PagedKVCache, layer: int,
                    block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                    scale: float, q_positions: torch.Tensor = None,
                    window=None, softcap=None, alibi=None,
                    tree=None, lanes=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version on the CPU. ``lanes``:
    (k_dims, v_dims) of MLA's latent rows (see ``paged_attention_ref``)."""
    if alibi is not None:
        _check_alibi(alibi, q.shape[2], tree)
    head_dim = q.shape[-1]
    cache_dim = cache.kv_pages.shape[-1]
    if cache_dim != head_dim:
        # small head dims are stored 128-padded (ModelConfig.cache_head_dim):
        # pad q, slice the output; zero lanes are inert in QK dots and V sums
        q = torch.nn.functional.pad(q, (0, cache_dim - head_dim))
    if q.is_cuda:
        from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
        out = paged_attention_cuda(q, cache.kv_pages, block_tables, ctx_lens,
                                   scale, q_positions=q_positions, layer=layer,
                                   kv_scales=cache.kv_scales, window=window,
                                   softcap=softcap, alibi=alibi, tree=tree, lanes=lanes)
    else:
        out = paged_attention_ref(q, cache, layer, block_tables, ctx_lens,
                                  scale, q_positions=q_positions, window=window,
                                  softcap=softcap, alibi=alibi, tree=tree, lanes=lanes)
    return out[..., :head_dim] if cache_dim != head_dim else out
