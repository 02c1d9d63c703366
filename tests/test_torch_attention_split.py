"""The paged-attention kernel's split plan and its split-then-merge, on the CPU.

``csrc/paged_attention.cu`` splits a sequence over blocks at fixed token
positions (``ops/attention_cuda.py:split_tokens``) and folds the splits'
softmax states in ascending order. Here:

- the plan (``tile_walk``, ``warp_slices``, ``attention_plan``: what the
  wrapper sizes the grid and the workspace with) covers each row's live
  tokens exactly once, from the first in-window page, and does not depend on
  B or Q (hypothesis over context, first position, Q, window and page size);
- the plain f32 version of split-then-merge (``paged_attention_split_ref``)
  equals the plain version ``paged_attention_ref`` to 1e-5 (f32 queries:
  only the order of the f32 sums differs) under the window, the tree mask,
  ALiBi, the softcap and over 8-bit caches, at page 16 with contexts across
  several splits;
- with bf16 queries it holds against the JAX Pallas kernel in interpret
  mode at the tolerances of the other attention tests (3e-2 over a bf16
  cache, 4e-2 int8 and fp8_e4m3, 8e-2 fp8_e5m2), the same numpy inputs fed
  to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.attention import alibi_slopes as j_alibi_slopes
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu.spec_decode.medusa_tree import DEFAULT_TREE
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask
from qspec_tpu_torch.ops.attention_cuda import (SLICE, STEP, attention_plan,
                                                paged_attention_split_ref, split_tokens,
                                                tile_walk, warp_slices)
from qspec_tpu_torch.spec_decode.medusa_tree import build_tree

KV_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run faster on one thread, and the suite's parallel
    workers then do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------- the plan

@settings(max_examples=300, deadline=None, database=None)
@given(ctx=st.integers(0, 3000), back=st.integers(0, 40), Q=st.integers(1, 64),
       window=st.one_of(st.none(), st.integers(1, 700)),
       S=st.sampled_from([16, 32, 48, 128, 256]), spare=st.integers(0, 5))
def test_walk_covers_each_live_token_once(ctx, back, Q, window, S, spare):
    """The splits of a tile's walk are disjoint, ascending, each inside one
    split, and start at the first in-window page of the first query; every
    live token of every row is walked exactly once, by one warp, in the
    split its position names; the split of a live token is the same when
    the row is walked alone (Q = 1) or in a tile of Q rows."""
    pps = -(-ctx // S) + spare
    q_start = max(ctx - Q - back, -5)      # negative: a tree's phantom rows
    walk = tile_walk(ctx, q_start, q_start + Q - 1, window, S, pps)
    split = split_tokens(S)
    assert split % S == 0 and split >= 256
    covered = []
    for s, lo, hi in walk:
        assert s * split <= lo < hi <= (s + 1) * split
        assert lo % SLICE == 0
        mine = sorted(t for w in range(STEP // SLICE) for t0 in warp_slices(lo, hi, w)
                      for t in range(t0, min(t0 + SLICE, hi)))
        assert mine == list(range(lo, hi))             # the warps partition the range
        covered += mine
    assert covered == sorted(set(covered))             # ascending, each token once
    if walk:
        n_pages = max(1, -(-ctx // S))
        w_first = q_start - (window or 1 << 30) + 1
        assert walk[0][1] == min(max(w_first // S, 0), n_pages - 1) * S
        assert all(walk[i][2] == walk[i + 1][1] for i in range(len(walk) - 1))
        assert covered[-1] < min(ctx, pps * S)
    tile = {t: s for s, lo, hi in walk for t in range(lo, hi)}
    for i in range(Q):
        p = q_start + i
        live = [t for t in range(min(ctx, pps * S))
                if t <= p and (window is None or t > p - window)]
        alone = {t: s for s, lo, hi in tile_walk(ctx, p, p, window, S, pps)
                 for t in range(lo, hi)}
        assert all(tile[t] == alone[t] == t // split for t in live)


@settings(max_examples=200, deadline=None, database=None)
@given(B=st.integers(1, 64), Q=st.integers(1, 600), group=st.sampled_from([1, 2, 4, 8]),
       Hkv=st.sampled_from([1, 2, 8, 32]), D=st.sampled_from([128, 256]),
       S=st.sampled_from([16, 128]), pps=st.integers(1, 80))
def test_plan_depends_on_positions_only(B, Q, group, Hkv, D, S, pps):
    """The splits (their size and count) follow from the page size and the
    table's width only, not from B, Q or the heads; the schedule takes every
    split of the grid, and a workspace exactly when the blocks of a tile
    split it."""
    plan = attention_plan(B, Q, group * Hkv, Hkv, D, S, pps)
    base = attention_plan(1, 1, 1, 1, 128, S, pps)
    assert (plan.split, plan.n_splits) == (base.split, base.n_splits)
    assert plan.n_splits * plan.split >= pps * S > (plan.n_splits - 1) * plan.split
    tiles, grid_y, bh = plan.grid
    G = group * Q
    assert tiles * 16 >= G > (tiles - 1) * 16 and bh == B * Hkv
    assert plan.splits_per_block in (1, plan.n_splits)
    assert grid_y * plan.splits_per_block >= plan.n_splits
    assert plan.ws_floats == (B * Hkv * plan.n_splits * G * (D + 2) if grid_y > 1 else 0)


# ---------------------------------------------------------------- split-then-merge

def _cache_pair(rng, kv_dtype, P, Hkv, S, D=128):
    """One cache per package, layer 1 filled by update_layer with the same
    bf16 K/V; pages shuffled into per-row tables."""
    T = (P - 1) * S
    k = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    slots = np.arange(T, dtype=np.int32) + S
    jc = jkv.allocate(jkv.KVCacheConfig(2, Hkv, D, P, S, kv_dtype))
    tc = tkv.allocate(tkv.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cpu")
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jc = jkv.update_layer(jc, 1, kj, vj, jnp.asarray(slots))
    tkv.update_layer(tc, 1, torch.tensor(np32(kj)).to(torch.bfloat16),
                     torch.tensor(np32(vj)).to(torch.bfloat16), torch.tensor(slots))
    return jc, tc


def _case(rng, kv_dtype, ctx, Q, Hq=4, Hkv=2, S=16, D=128, q_scale=2.0):
    """Rows of the given contexts over shuffled pages, their last Q positions
    new; queries of std ``q_scale``."""
    pages = [-(-c // S) for c in ctx]
    P = 1 + sum(pages)
    jc, tc = _cache_pair(rng, kv_dtype, P, Hkv, S, D)
    ids = rng.permutation(np.arange(1, P)).astype(np.int32)
    tables = np.zeros((len(ctx), max(pages) + 1), np.int32)
    o = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    q = (rng.standard_normal((len(ctx), Q, Hq, D)) * q_scale).astype(np.float32)
    return jc, tc, tables, np.asarray(ctx, np.int32), q


# contexts across one, two and three splits of 256 (page 16), a row whose
# last query ends a split and one whose first starts one
CTX = (37, 256 + 3, 512 + 11, 256)
OPTIONS = {"plain": {}, "window": {"window": 40}, "window_long": {"window": 300},
           "softcap": {"softcap": 5.0}, "alibi": "alibi"}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("kv_dtype", list(KV_TOL))
def test_split_merge_equals_plain(kv_dtype, option):
    """f32 queries: the split-then-merge and the plain softmax differ only in
    the order of f32 sums (1e-5)."""
    rng = np.random.default_rng(len(option) * 7 + len(kv_dtype))
    Q, Hq = 4, 4
    _, tc, tables, ctx, q = _case(rng, kv_dtype, CTX, Q, Hq=Hq)
    kw = OPTIONS[option]
    if kw == "alibi":
        kw = {"alibi": torch.tensor(j_alibi_slopes(Hq))}
    args = (torch.tensor(q), tc, 1, torch.tensor(tables), torch.tensor(ctx), 128 ** -0.5)
    want = paged_attention_ref(*args, **kw)
    got = paged_attention_split_ref(*args, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def _tree_inputs(rng, kv_dtype, prefix, roots=(300, 17, 520)):
    """The tree-verify rectangle (DEFAULT_TREE after ``prefix`` rows) at the
    given roots, over page 16: its rows cross split boundaries."""
    tspec = build_tree(DEFAULT_TREE)
    T = tspec.num_nodes
    ctx = [r + 1 + T for r in roots]
    jc, tc, tables, ctx, q = _case(rng, kv_dtype, ctx, prefix + T, q_scale=1.0)
    pos = np.asarray(roots, np.int32)
    positions = np.concatenate([(pos - (prefix - 1))[:, None] + np.arange(prefix)[None],
                                pos[:, None] + np.asarray(tspec.depth)[None]], 1)
    return tspec, jc, tc, tables, ctx, q, positions.astype(np.int32)


@pytest.mark.parametrize("kv_dtype,window", [("bfloat16", None), ("int8", None),
                                             ("bfloat16", 280), ("fp8_e5m2", 12)])
def test_split_merge_tree_equals_plain(kv_dtype, window):
    rng = np.random.default_rng(3 if window is None else window)
    tspec, _, tc, tables, ctx, q, pos = _tree_inputs(rng, kv_dtype, prefix=5)
    tree = tree_mask(5, tspec.ancestors, "cpu")
    args = (torch.tensor(q), tc, 1, torch.tensor(tables), torch.tensor(ctx), 128 ** -0.5)
    kw = dict(q_positions=torch.tensor(pos), window=window, tree=tree)
    np.testing.assert_allclose(paged_attention_split_ref(*args, **kw).numpy(),
                               paged_attention_ref(*args, **kw).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype,option,Q", [
    ("bfloat16", "plain", 1), ("bfloat16", "plain", 4), ("int8", "plain", 4),
    ("fp8_e4m3", "window", 4), ("fp8_e5m2", "plain", 2), ("bfloat16", "window", 1),
    ("int8", "softcap", 4), ("bfloat16", "alibi", 4), ("fp8_e4m3", "alibi", 1)])
def test_split_merge_matches_jax_kernel(kv_dtype, option, Q):
    """bf16 queries, the same numpy inputs: the split-then-merge against the
    JAX Pallas kernel in interpret mode (contexts across three splits)."""
    rng = np.random.default_rng(Q * 31 + len(option))
    Hq = 4
    jc, tc, tables, ctx, q = _case(rng, kv_dtype, (300, 45, 530), Q, Hq=Hq)
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.tensor(np32(qj)).to(torch.bfloat16)
    if option == "alibi":
        slopes = j_alibi_slopes(Hq)
        kw, jkw = {"alibi": torch.tensor(slopes)}, {"alibi": jnp.asarray(slopes)}
    else:
        kw = jkw = OPTIONS[option]
    scale = 128 ** -0.5
    want = paged_attention_pallas(qj, jc.kv_pages, jnp.asarray(tables), jnp.asarray(ctx),
                                  scale, layer=jnp.asarray(1, jnp.int32),
                                  kv_scales=jc.kv_scales, **jkw)
    got = paged_attention_split_ref(qt, tc, 1, torch.tensor(tables), torch.tensor(ctx),
                                    scale, **kw)
    tol = KV_TOL[kv_dtype]
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_split_merge_tree_matches_jax_kernel(kv_dtype):
    """The tree rectangle without a window (where the JAX kernel's mask is
    AR's) against the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11)
    tspec, jc, tc, tables, ctx, q, pos = _tree_inputs(rng, kv_dtype, prefix=3)
    qj = jnp.asarray(q, jnp.bfloat16)
    scale = 128 ** -0.5
    want = paged_attention_pallas(qj, jc.kv_pages, jnp.asarray(tables), jnp.asarray(ctx),
                                  scale, q_positions=jnp.asarray(pos),
                                  layer=jnp.asarray(1, jnp.int32), kv_scales=jc.kv_scales,
                                  tree=(3, tspec.ancestors))
    got = paged_attention_split_ref(torch.tensor(np32(qj)).to(torch.bfloat16), tc, 1,
                                    torch.tensor(tables), torch.tensor(ctx), scale,
                                    q_positions=torch.tensor(pos),
                                    tree=tree_mask(3, tspec.ancestors, "cpu"))
    tol = KV_TOL[kv_dtype]
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


def test_split_merge_ctx_zero_and_one_split_rows():
    """A padding row (ctx_len 0) writes zeros; a row whose tokens all lie in
    one split is the single split's softmax."""
    rng = np.random.default_rng(5)
    _, tc, tables, ctx, q = _case(rng, "bfloat16", (0 + 1, 100, 256 + 40), 1)
    ctx[0] = 0
    args = (torch.tensor(q), tc, 1, torch.tensor(tables), torch.tensor(ctx), 128 ** -0.5)
    got = paged_attention_split_ref(*args)
    assert torch.count_nonzero(got[0]) == 0
    want = paged_attention_ref(*args)
    np.testing.assert_allclose(got[1:].numpy(), want[1:].numpy(), atol=1e-5, rtol=1e-5)
