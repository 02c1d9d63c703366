"""Wrapper of the paged-attention CUDA kernel (``csrc/paged_attention.cu``).

Counterpart of ``qspec_tpu/ops/attention_pallas.py:paged_attention_pallas``
(causal core, sliding window, logit softcap, ALiBi and the Medusa tree mask;
head dims 128 and 256, and MLA's latent head dims 384 and 640 (the causal
core only, over the lanes it needs); bf16, int8, fp8_e4m3 and fp8_e5m2
caches).
The plain version it is held against is ``ops/attention.py:paged_attention_ref``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.attention import MAX_TREE_NODES, NEG_INF, tree_slot_mask
from qspec_tpu_torch.ops.kv_cache import gather_layer

# entry type -> the kernel's instantiation code (csrc/paged_attention.cu)
KV_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
            torch.float8_e5m2: 3}
# entry types whose pages carry per-token scales
SCALED = (torch.int8, torch.float8_e4m3fn)
# the head dims the kernel is instantiated for (csrc/paged_attention.cu):
# 128 and 256, and the MLA kernel's latent head dims 384 and 640
HEAD_DIMS = (128, 256, 384, 640)
MLA_DIMS = (384, 640)
# entry type -> the launch counts of its instantiations: ``launches`` is
# raised by one at each launch of that entry type (ops.kernel_wrappers names
# each); ``window_launches`` also at each launch under a window,
# ``softcap_launches`` at each launch with a logit softcap,
# ``d256_launches`` at each launch of the head-dim-256 instantiation,
# ``d384_launches`` and ``d640_launches`` at each of the MLA kernel's,
# ``tree_launches`` at each launch under a Medusa tree mask and
# ``alibi_launches`` at each launch of an ALiBi instantiation
LAUNCHES = {dtype: SimpleNamespace(launches=0, window_launches=0,
                                   softcap_launches=0, d256_launches=0,
                                   d384_launches=0, d640_launches=0,
                                   tree_launches=0, alibi_launches=0)
            for dtype in KV_CODES}
# the sliding-window sentinel (qspec_tpu/ops/attention_pallas.py NO_WINDOW):
# far past any position, so the window never masks and the walk starts at 0
NO_WINDOW = 1 << 30

# csrc/paged_attention.cu's plan: a block takes ROWS GQA rows (one m16 tile);
# its warps take the SLICE-token slices at SLICE * w mod STEP; a split is the
# fewest whole pages that hold SPLIT_MIN tokens
ROWS = 16
SLICE = 16
STEP = 4 * SLICE
SPLIT_MIN = 256
# a launch of at most this many row tiles takes one split a block (decode,
# verify, the tree: B x Hkv x splits blocks); more tiles take all of a tile's
# splits in one block (prefill). The folds are the same, so is every bit.
MAX_SPLIT_TILES = 4
# the MLA kernel's plan (csrc/paged_attention.cu: MlaShape): a block takes
# MLA_ROWS GQA rows (one 64-row wgmma tile) and reads K's lanes up to
# MLA_K_LANES and V's up to MLA_V_LANES
MLA_ROWS = {384: 64, 640: 64}
MLA_K_LANES = {384: 320, 640: 576}
MLA_V_LANES = {384: 256, 640: 512}
# an MLA split: the fewest whole pages holding MLA_SPLIT_MIN tokens (two
# 64-token steps: a block's walk is a chain of dependent steps, so short
# splits put more blocks on the card)
MLA_SPLIT_MIN = 128
# an MLA launch takes one split a block while its row tiles leave SMs idle
# and that workspace stays under MLA_WS_BYTES; else (prefill) a block walks
# all its splits, folding them through a slab of its own
MLA_WS_BYTES = 1 << 28


def split_tokens(page_size: int, head_dim: int = 128) -> int:
    """Tokens a split: the fewest whole pages holding SPLIT_MIN tokens
    (MLA_SPLIT_MIN at the MLA head dims). Token t lies in split t //
    split_tokens(S, D), whatever B, Q or the card."""
    least = MLA_SPLIT_MIN if head_dim in MLA_DIMS else SPLIT_MIN
    return page_size * -(-least // page_size)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One launch of csrc/paged_attention.cu, from shapes alone: ``split``
    tokens a split, ``n_splits`` of them over the block table,
    ``splits_per_block`` (1, or all), the ``grid`` (row tiles, split blocks,
    B * Hkv) and the floats of the f32 workspace of split states that the
    merge kernel folds (0 when a block takes every split, and then no merge
    kernel runs)."""
    split: int
    n_splits: int
    splits_per_block: int
    grid: tuple
    ws_floats: int


def attention_plan(B: int, Q: int, Hq: int, Hkv: int, D: int, S: int,
                   pages_per_seq: int, sms: int = 132) -> AttentionPlan:
    """The split plan and schedule of a launch. The splits follow from the
    page size, the head dim and the block table's width; the schedule (one
    split a block or all of them) from the row tiles (at the MLA head dims,
    from the blocks against ``sms`` SMs and the workspace's size), and
    changes no bit. At the MLA head dims a block that takes several splits
    folds them through a slab of rows x V lanes f32 of its own in the
    workspace."""
    split = split_tokens(S, D)
    n_splits = max(1, -(-pages_per_seq * S // split))
    G = Hq // Hkv * Q
    if D in MLA_DIMS:
        rows = MLA_ROWS[D]
        tiles = -(-G // rows)
        one = B * Hkv * n_splits * G * (D + 2)
        spb = 1 if n_splits == 1 or (tiles * B * Hkv < sms and 4 * one <= MLA_WS_BYTES) \
            else n_splits
        grid_y = -(-n_splits // spb)
        if grid_y > 1:            # the split states, for the merge kernel
            ws = one
        elif n_splits > 1:        # each block's slabs, for its running fold
            ws = B * Hkv * tiles * rows * MLA_V_LANES[D]
        else:
            ws = 0
        return AttentionPlan(split, n_splits, spb, (tiles, grid_y, B * Hkv), ws)
    tiles = -(-G // ROWS)
    spb = 1 if tiles <= MAX_SPLIT_TILES else n_splits
    grid_y = -(-n_splits // spb)
    return AttentionPlan(split, n_splits, spb, (tiles, grid_y, B * Hkv),
                         B * Hkv * n_splits * G * (D + 2) if grid_y > 1 else 0)


def tile_walk(ctx: int, q_start: int, q_last: int, window: int, S: int,
              pages_per_seq: int) -> list:
    """The token ranges a row tile of the kernel walks, split by split:
    [(split, lo, hi)] in ascending order, from the first in-window page of
    the sequence's first query (``q_start``; page 0 without a window) up to
    its last query ``q_last`` and ctx_len; each warp takes the 16-token
    slices of a range at 16 w mod 64. Empty for ctx_len 0."""
    win = NO_WINDOW if window is None else window
    split = split_tokens(S)
    n_tok = min(ctx, q_last + 1, pages_per_seq * S)
    n_pages = max(1, -(-ctx // S))
    w_first = q_start - win + 1
    first = min(w_first // S if w_first > 0 else 0, n_pages - 1) * S
    return [(s, max(s * split, first), min((s + 1) * split, n_tok))
            for s in range(first // split, -(-n_tok // split) if n_tok > first else 0)]


def warp_slices(lo: int, hi: int, warp: int) -> range:
    """The starts of the 16-token slices of [lo, hi) that warp ``warp`` of
    a block takes: those at 16 * warp mod 64 (lo and hi multiples of 16)."""
    t0 = lo // STEP * STEP + SLICE * warp
    return range(t0 + STEP if t0 < lo else t0, hi, STEP)


def paged_attention_cuda(q: torch.Tensor, kv_pages: torch.Tensor,
                         block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                         scale: float, q_positions: torch.Tensor = None,
                         layer: int = 0, kv_scales: torch.Tensor = None,
                         window: int = None, softcap: float = None,
                         alibi: torch.Tensor = None, tree=None,
                         lanes: tuple = None) -> torch.Tensor:
    """q: [B, Q, Hq, D] bf16, D in HEAD_DIMS; kv_pages: the whole stacked cache
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
    slots. ``lanes``: (k_dims, v_dims), the lanes of K (and q) and of V
    read, at the MLA head dims 384 and 640 only (k_dims % 32 == 0, at most
    MLA_K_LANES; v_dims % 64 == 0, at most MLA_V_LANES); the output's lanes
    past v_dims are zero. Over bf16 and fp8_e5m2 V's lanes are read from
    K's, which MLA writes with the same bits (models/llama.py
    _mla_attention, kv_cache.update_layer); int8 and fp8_e4m3 read the V
    plane. Those dims take no window, softcap, ALiBi or tree (the JAX package
    reaches none of them there). Returns [B, Q, Hq, D] bf16."""
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
                   "paged_attention_cuda: head dim 128 or 256, or MLA's 384 or 640 (q and "
                   f"cache alike), "
                   f"got q {D}, cache {D2}")
    dk, dv = (D, D) if lanes is None else map(int, lanes)
    if D in MLA_DIMS:
        _build.require(window is None and softcap is None and alibi is None and tree is None,
                       f"paged_attention_cuda: head dim {D} (MLA) without a window, "
                       "softcap, ALiBi or tree")
        _build.require(0 < dk <= MLA_K_LANES[D] and dk % 32 == 0
                       and 0 < dv <= MLA_V_LANES[D] and dv % 64 == 0,
                       f"paged_attention_cuda: lanes (k {dk}, v {dv}) at head dim {D}: "
                       f"k_dims % 32 == 0 up to {MLA_K_LANES[D]}, v_dims % 64 == 0 up to "
                       f"{MLA_V_LANES[D]}")
    else:
        _build.require(lanes is None or (dk, dv) == (D, D),
                       f"paged_attention_cuda: lanes at head dim {D} are all {D}")
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
    # the kernel reads row 0's position in place: column 0 of q_positions or,
    # under a tree, the root's position less the prefix rows before it
    # (negative for phantom rows of a short prompt, which see nothing); the
    # last Q positions without q_positions
    pos_ptr, pos_stride, pos_i64, pos_col = None, 0, 0, prefix - 1 if tree is not None else 0
    if q_positions is not None:
        _build.require(q_positions.dim() == 2 and q_positions.shape[0] == B
                       and q_positions.shape[1] > pos_col
                       and q_positions.dtype in (torch.int32, torch.int64)
                       and q_positions.device == q.device,
                       "paged_attention_cuda: q_positions int32 / int64 [B, Q] on q's device")
        col = q_positions[:, pos_col]
        pos_ptr, pos_stride = col.data_ptr(), col.stride(0)
        pos_i64 = int(q_positions.dtype == torch.int64)
    out = torch.empty_like(q)
    if B == 0 or Q == 0:
        return out
    kv_layer = kv_pages[layer]
    _build.cuda_args_ok(q, kv_layer, tables, ctx, out)
    sc_ptr = None
    if scaled:
        sc_layer = kv_scales[layer]
        _build.cuda_args_ok(q, sc_layer)
        sc_ptr = sc_layer.data_ptr()
    plan = attention_plan(B, Q, Hq, Hkv, D, S, tables.shape[1], _build.sm_count(q.device))
    ws = None
    if plan.ws_floats:   # the split blocks' states, for the merge kernel
        ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=q.device)
    _build.check("paged_attention", _build.lib().qspec_paged_attention(
        q.data_ptr(), kv_layer.data_ptr(), sc_ptr, tables.data_ptr(),
        ctx.data_ptr(), pos_ptr, pos_stride, pos_i64, pos_col, out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, Q,
        Hq, Hkv, S, tables.shape[1], plan.split, plan.n_splits,
        plan.splits_per_block, KV_CODES[kv_pages.dtype], D, dk, dv, float(scale), cap, win,
        anc_ptr, prefix, alibi_ptr, kv_layer.shape[0], _build.stream_of(q)))
    count = LAUNCHES[kv_pages.dtype]
    count.launches += 1
    count.window_launches += window is not None
    count.softcap_launches += softcap is not None
    count.d256_launches += D == 256
    count.d384_launches += D == 384
    count.d640_launches += D == 640
    count.tree_launches += tree is not None
    count.alibi_launches += alibi is not None
    return out


def _fold(state, part):
    """The kernel's fold of a softmax state (m, l, o) into another."""
    M, L, O = state
    m, l, o = part
    mn = torch.maximum(M, m)
    a, b = torch.exp(M - mn), torch.exp(m - mn)
    return mn, L * a + l * b, O * a[..., None] + o * b[..., None]


def paged_attention_split_ref(q: torch.Tensor, cache, layer: int,
                              block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                              scale: float, q_positions: torch.Tensor = None,
                              window: int = None, softcap: float = None,
                              alibi: torch.Tensor = None, tree=None) -> torch.Tensor:
    """The kernel's split-then-merge in plain f32 (no bf16 rounding of q or
    p), with ``ops.attention.paged_attention_ref``'s arguments and scores:
    each row walks :func:`tile_walk`'s ranges; in a range, warp w keeps an
    online softmax over the 16-token slices at 16 w mod 64; a split's state
    is the fold of the four warps' in order, the row's the fold of its
    splits in ascending order. Equal to the plain version up to f32
    rounding."""
    B, Q, Hq, D = q.shape
    if q_positions is None:
        q_positions = (ctx_lens[:, None] - Q) + torch.arange(Q, device=q.device)[None, :]
    k, v = gather_layer(cache, layer, block_tables)       # [B, Hkv, C, D]
    Hkv, C = k.shape[1], k.shape[2]
    group = Hq // Hkv
    S = cache.kv_pages.shape[4]
    qf = (q.to(torch.float32) * scale).reshape(B, Q, Hkv, group, D)
    scores = torch.einsum("bqhgd,bhcd->bhgqc", qf, k.to(torch.float32))
    kv_pos = torch.arange(C, device=q.device)[None, :]
    if alibi is not None:
        delta = kv_pos[None].to(torch.float32) - q_positions[:, :, None].to(torch.float32)
        scores = scores + alibi.to(torch.float32).reshape(Hkv, group)[None, :, :, None, None] \
            * delta[:, None, None]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if tree is not None:
        q_start = q_positions[:, tree.prefix - 1] - (tree.prefix - 1)
        mask = tree_slot_mask(tree.prefix, Q, q_start, tree.ancestors, C, window)
    else:
        q_start = q_positions[:, 0]
        mask = kv_pos[None] <= q_positions[:, :, None]
        if window is not None:
            mask = mask & (kv_pos[None] > q_positions[:, :, None] - window)
    mask = mask & (kv_pos[None] < ctx_lens[:, None, None])            # [B, Q, C]
    G = group * Q
    s = scores.reshape(B, Hkv, G, C)
    live = mask[:, None, None].expand(B, 1, group, Q, C).reshape(B, 1, G, C)
    vf = v.to(torch.float32)
    out = torch.zeros(B, Hkv, G, D, dtype=torch.float32, device=q.device)

    def init():
        return (torch.full((Hkv, G), NEG_INF, device=q.device),
                torch.zeros(Hkv, G, device=q.device),
                torch.zeros(Hkv, G, D, device=q.device))
    for b in range(B):
        qs = int(q_start[b])
        state = init()
        for _, lo, hi in tile_walk(int(ctx_lens[b]), qs, qs + Q - 1, window, S,
                                   block_tables.shape[1]):
            part = init()
            for w in range(STEP // SLICE):
                m, l, o = init()
                for t in warp_slices(lo, hi, w):
                    sl, lv = s[b, :, :, t:t + SLICE], live[b, :, :, t:t + SLICE]
                    mn = torch.maximum(m, torch.where(lv, sl, NEG_INF).amax(-1))
                    a = torch.exp(m - mn)
                    p = torch.where(lv, torch.exp(sl - mn[..., None]), 0.0)
                    m, l = mn, l * a + p.sum(-1)
                    o = o * a[..., None] + p @ vf[b, :, t:t + SLICE]
                part = _fold(part, (m, l, o))
            state = _fold(state, part)
        M, L, O = state
        out[b] = torch.where(L[..., None] > 0, O / torch.where(L > 0, L, 1.0)[..., None], 0.0)
    return (out.reshape(B, Hkv, group, Q, D).permute(0, 3, 1, 2, 4)
            .reshape(B, Q, Hq, D).to(q.dtype))
