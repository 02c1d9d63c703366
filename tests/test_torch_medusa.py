"""The port's Medusa path on the CPU, held against the JAX package on the same
numpy inputs: the candidate tree, the heads, the one-hot rejection rule, the
tree mask of the attention, the forward's hidden state under the tree, and
the engine's chain and tree rounds, on random heads over the tiny model and
on the trained heads of checkpoints/ (induction_medusa_v2 on its base
medusa_base_v4, quantized by the JAX package).

Tolerances: the tree attention against the JAX Pallas kernel in interpret
mode at that kernel test's atol/rtol 3e-2; the forward at
tests/test_torch_model.py's (relative L2 of the logits 2e-2, argmax changes
only at near-ties within 2e-2); greedy engine tokens equal to the JAX
engine's, or the first difference a near-tie of the JAX logits (top-2 gap
below 2e-2), as tests/test_torch_engine.py holds them.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.attention import paged_attention_ref as j_attention_ref
from qspec_tpu.ops.attention import tree_slot_mask as j_tree_slot_mask
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu.ops.sampling import rejection_sample_onehot as j_onehot
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu.spec_decode import medusa as jmedusa
from qspec_tpu.spec_decode import medusa_tree as jtree
from qspec_tpu_torch import (LLM, CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.kv_cache import gather_layer
from qspec_tpu_torch.ops.attention import (MAX_TREE_NODES, paged_attention_ref, tree_mask,
                                           tree_slot_mask)
from qspec_tpu_torch.ops.sampling import rejection_sample_onehot
from qspec_tpu_torch.spec_decode import medusa as tmedusa
from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree

TIE_GAP = 2e-2
MAX_TOKENS = 24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the tree

@pytest.mark.parametrize("choices", [DEFAULT_TREE, ((0,), (1,), (0, 0), (0, 1), (0, 0, 0)),
                                     ((2,), (0,), (0, 1), (0, 0), (0, 1, 3), (1,))])
def test_build_tree_matches_jax(choices):
    got, want = build_tree(choices), jtree.build_tree(choices)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.max_cand == want.max_cand
    np.testing.assert_array_equal(got.ancestor_array(), want.ancestor_array())


def test_build_tree_rejects_orphans():
    with pytest.raises(AssertionError, match="parent"):
        build_tree(((0,), (1, 0)))


def test_engine_args_tree_and_method():
    args = EngineArgs(num_speculative_tokens=2, speculative_model="[medusa]",
                      spec_medusa_tree="default")
    spec = args.create_engine_config().speculative
    assert spec.method == "medusa"
    assert spec.medusa_tree == tuple(p for p in DEFAULT_TREE if len(p) <= 2)
    spec = EngineArgs(num_speculative_tokens=3, speculative_model="[medusa]",
                      speculative_method="medusa_null",
                      spec_medusa_tree="((0,),(1,),(0,0))").create_engine_config().speculative
    assert spec.method == "medusa_null" and spec.medusa_tree == ((0,), (1,), (0, 0))
    assert EngineArgs(num_speculative_tokens=3).create_engine_config().speculative.method == "qspec"
    with pytest.raises(ValueError):
        EngineArgs(num_speculative_tokens=3, speculative_model="[medusa]",
                   speculative_method="qspec").create_engine_config()
    with pytest.raises(ValueError):
        EngineArgs(speculative_model="[medusa]").create_engine_config()


# ---------------------------------------------------------------- the heads

def _heads(rng, K, H, V):
    return {"w1": rng.standard_normal((K, H, H)).astype(np.float32) * 0.2,
            "b1": rng.standard_normal((K, H)).astype(np.float32) * 0.1,
            "head": rng.standard_normal((K, H, V)).astype(np.float32) * 0.2}


def _tied_or_equal(got, want, logits, gap=1e-4):
    """Equal proposals, except where the deciding logits are within ``gap``."""
    for (b, j) in zip(*np.nonzero(got != want)):
        row = logits[b, j]
        assert abs(row[got[b, j]] - row[want[b, j]]) < gap, (b, j)


def test_medusa_propose_matches_jax():
    rng = np.random.default_rng(0)
    H, V, K, B = 64, 96, 3, 5
    heads = _heads(rng, K, H, V)
    h = rng.standard_normal((B, H)).astype(np.float32)
    want = np.asarray(jmedusa.medusa_propose({k: jnp.asarray(v) for k, v in heads.items()},
                                             jnp.asarray(h)))
    theads = {k: torch.tensor(v) for k, v in heads.items()}
    got = tmedusa.medusa_propose(theads, torch.tensor(h)).numpy()
    assert got.shape == (B, K) and got.dtype == np.int32
    _tied_or_equal(got, want, tmedusa.head_logits(theads, torch.tensor(h)).numpy())
    # the tree: node i is head head_idx[i]'s top-(cand_idx[i]+1) token
    t = build_tree(((0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (0, 0, 0)))
    want = np.asarray(jtree.medusa_propose_tree({k: jnp.asarray(v) for k, v in heads.items()},
                                                jnp.asarray(h), jtree.build_tree(t.choices)))
    got = tmedusa.medusa_propose_tree(theads, torch.tensor(h), t).numpy()
    assert got.shape == (B, t.num_nodes)
    np.testing.assert_array_equal(got, want)


def test_init_medusa_params_matches_jax():
    rng = np.random.default_rng(1)
    H, V = 64, 96
    lm = rng.standard_normal((H, V)).astype(np.float32)
    for kw in ({"seed": 3}, {"lm_head": lm}):
        want = jmedusa.init_medusa_params(H, V, k=3, **kw)
        got = tmedusa.init_medusa_params(H, V, k=3, **kw)
        for name in ("w1", "b1", "head"):
            assert got[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          np.asarray(want[name], np.float32))
    # the lm_head-seeded heads propose the head's own argmax
    h = rng.standard_normal((4, H)).astype(np.float32)
    got = tmedusa.medusa_propose(tmedusa.init_medusa_params(H, V, k=3, lm_head=lm),
                                 torch.tensor(h)).numpy()
    assert (got == np.argmax(h @ lm, axis=-1)[:, None]).mean() > 0.9


def test_lm_head_weight_dequantizes_every_head():
    cfg = ModelConfig.tiny()
    for kind in ("int8", "int4", "bf16"):
        p = tllama.init_params(dataclasses.replace(cfg, lm_head_quant=kind), seed=2,
                               device="cpu")
        w = tmedusa.lm_head_weight(p["lm_head"])
        x = torch.randn(3, cfg.hidden_size, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16)
        ref = tllama.compute_logits(x, p["lm_head"])
        assert tuple(w.shape) == (cfg.hidden_size, cfg.vocab_size)
        torch.testing.assert_close(x.double() @ w.double(), ref.double(), rtol=2e-2, atol=2e-2)


def test_load_medusa_npz(tmp_path):
    rng = np.random.default_rng(2)
    heads = _heads(rng, 2, 16, 32)
    path = tmp_path / "heads.npz"
    np.savez(path, **heads)
    got, want = tmedusa.load_medusa(str(path), device="cpu"), jmedusa.load_medusa(str(path))
    for k in heads:
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


# ---------------------------------------------------------------- sampling

def test_rejection_sample_onehot_matches_jax():
    """The JAX package's accept draws (its uniforms, from its key) injected:
    the same accepted lengths, accepted tokens and their logprobs; with
    one-hot targets (greedy) the whole result, recovery and bonus included."""
    rng = np.random.default_rng(3)
    B, k, V = 8, 4, 24
    logits = rng.standard_normal((B, k + 1, V)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    draft = np.where(rng.random((B, k)) < 0.5, probs[:, :k].argmax(-1),
                     rng.integers(0, V, (B, k))).astype(np.int32)
    draft[1, 2] = -1
    draft[5, 0] = -1
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0], (B, k)))
    onehot = np.eye(V, dtype=np.float32)[probs.argmax(-1)]
    for target in (probs, onehot):
        want = j_onehot(jnp.asarray(draft), jnp.asarray(target), key)
        got = rejection_sample_onehot(torch.tensor(draft), torch.tensor(target),
                                      torch.Generator().manual_seed(0),
                                      uniforms=torch.tensor(u))
        np.testing.assert_array_equal(got.accepted_len.numpy(), np.asarray(want.accepted_len))
        np.testing.assert_array_equal(got.num_draft_accepted.numpy(),
                                      np.asarray(want.num_draft_accepted))
        wt, wl = np.asarray(want.tokens), np.asarray(want.token_logprobs)
        for b in range(B):
            n = int(want.num_draft_accepted[b])
            assert got.tokens[b, :n].tolist() == wt[b, :n].tolist()
            np.testing.assert_allclose(got.token_logprobs[b, :n].numpy(), wl[b, :n], rtol=1e-6)
            assert (got.tokens[b, n + 1:] == -1).all()
        if target is onehot:
            np.testing.assert_array_equal(got.tokens.numpy(), wt)
    # the recovery never resamples the rejected proposal
    target = np.full((1, 2, 3), 1 / 3, np.float32)
    got = rejection_sample_onehot(torch.tensor([[1]]), torch.tensor(target),
                                  torch.Generator().manual_seed(0),
                                  uniforms=torch.ones(1, 1))
    assert got.accepted_len.item() == 1 and got.tokens[0, 0].item() in (0, 2)


# ---------------------------------------------------------------- attention

def _tree_case(rng, prefix, kv_dtype, D=128, B=2, Hq=4, Hkv=2, S=8, P=24):
    """tests/kernels/test_attention.py::test_tree_mask_pallas_matches_ref's
    rectangle: roots 17 and 30, DEFAULT_TREE after ``prefix`` rows."""
    tspec = build_tree(DEFAULT_TREE)
    T = tspec.num_nodes
    if kv_dtype == "bfloat16":
        pages = rng.standard_normal((1, P, 2, Hkv, S, D)).astype(np.float32)
        jpages = jnp.asarray(pages, jnp.bfloat16)
        jcache = jkv.PagedKVCache(jpages)
        tcache = tkv.PagedKVCache(torch.tensor(np.asarray(jpages, np.float32)).to(torch.bfloat16))
    else:
        ints = rng.integers(-127, 128, (1, P, 2, Hkv, S, D)).astype(np.int8)
        sc = (rng.random((1, P, 2, Hkv, S)).astype(np.float32) + 0.5) / 127
        jcache = jkv.PagedKVCache(jnp.asarray(ints), jnp.asarray(sc))
        tcache = tkv.PagedKVCache(torch.tensor(ints), torch.tensor(sc))
    q = jnp.asarray(rng.standard_normal((B, prefix + T, Hq, D)).astype(np.float32), jnp.bfloat16)
    tables = rng.permutation(np.arange(1, 21)).reshape(2, 10).astype(np.int32)
    pos = np.asarray([17, 30], np.int32)
    positions = np.concatenate([(pos - (prefix - 1))[:, None] + np.arange(prefix)[None],
                                pos[:, None] + np.asarray(tspec.depth)[None]], 1).astype(np.int32)
    ctx = (pos + 1 + T).astype(np.int32)
    tq = torch.tensor(np.asarray(q, np.float32)).to(torch.bfloat16)
    return (tspec, (q, jcache, jnp.asarray(tables), jnp.asarray(ctx), jnp.asarray(positions)),
            (tq, tcache, torch.tensor(tables), torch.tensor(ctx), torch.tensor(positions)))


def test_tree_slot_mask_matches_jax():
    t = build_tree(DEFAULT_TREE)
    for prefix in (1, 3, 5):
        qs = np.array([15, 26, 0], np.int32)
        Q = prefix + t.num_nodes
        want = np.asarray(j_tree_slot_mask(prefix, Q, jnp.asarray(qs), t.ancestors, 60))
        got = tree_slot_mask(prefix, Q, torch.tensor(qs), t.ancestors, 60).numpy()
        np.testing.assert_array_equal(got, want)


def tree_rows_ar(q, cache, tables, positions, tspec, prefix, scale, window):
    """The AR oracle of a tree rectangle's tree rows, [B, T, Hq, D] f32:
    node t's row is plain causal attention of its query at position
    root + depth(t) over the context 0..root followed by its path (its
    ancestors and itself, by depth) at consecutive positions, under the
    window: what AR computes when the path's tokens are committed."""
    k, v = (x.double() for x in gather_layer(cache, 0, tables))     # [B, Hkv, C, D]
    B, Q, Hq, D = q.shape
    group = Hq // k.shape[1]
    out = torch.zeros(B, tspec.num_nodes, Hq, D, dtype=torch.float64)
    for b in range(B):
        root = int(positions[b, prefix - 1])
        for t in range(tspec.num_nodes):
            path = sorted((j for j in range(tspec.num_nodes) if tspec.ancestors[t][j]),
                          key=lambda j: tspec.depth[j])
            slots = list(range(root + 1)) + [root + 1 + j for j in path]
            p_q = root + tspec.depth[t]
            keep = [i for i, _ in enumerate(slots) if window is None or i > p_q - window]
            sl = torch.tensor([slots[i] for i in keep])
            for h in range(Hq):
                kk, vv = k[b, h // group, sl], v[b, h // group, sl]
                w = torch.softmax(kk @ q[b, prefix + t, h].double() * scale, dim=0)
                out[b, t, h] = w @ vv
    return out.float()


@pytest.mark.parametrize("prefix,kv_dtype,window", [
    (3, "bfloat16", None), (5, "bfloat16", None), (3, "int8", None), (5, "int8", None),
    (5, "bfloat16", 12), (3, "int8", 9)])
def test_tree_attention_matches_pallas(prefix, kv_dtype, window):
    """The plain version under the tree mask against the JAX Pallas kernel in
    interpret mode wherever the two agree: every row without a window, the
    prefix rows under a window shorter than both contexts. There the JAX
    kernel bounds a tree row's window by the root, which is not AR's mask;
    the port bounds node t by its own position root + depth(t), so its tree
    rows are held against the AR oracle (:func:`tree_rows_ar`) instead."""
    rng = np.random.default_rng(prefix + (window or 0))
    tspec, (q, jcache, jtab, jctx, jpos), (tq, tcache, ttab, tctx, tpos) = _tree_case(
        rng, prefix, kv_dtype)
    tree = (prefix, tspec.ancestors)
    scale = 128 ** -0.5
    want = paged_attention_pallas(q, jcache.kv_pages, jtab, jctx, scale, q_positions=jpos,
                                  kv_scales=jcache.kv_scales, window=window, tree=tree)
    got = paged_attention_ref(tq, tcache, 0, ttab, tctx, scale, q_positions=tpos,
                              window=window, tree=tree_mask(prefix, tspec.ancestors, "cpu"))
    rows = slice(None) if window is None else slice(0, prefix)
    np.testing.assert_allclose(got[:, rows].float().numpy(),
                               np.asarray(want, np.float32)[:, rows], atol=3e-2, rtol=3e-2)
    if window is None:
        # the JAX plain version agrees too where the window plays no part
        jref = j_attention_ref(q, jcache, 0, jtab, jctx, scale, q_positions=jpos, tree=tree)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(jref, np.float32),
                                   atol=3e-2, rtol=3e-2)
    ar = tree_rows_ar(tq, tcache, ttab, tpos, tspec, prefix, scale, window)
    np.testing.assert_allclose(got[:, prefix:].float().numpy(), ar.numpy(),
                               atol=3e-2, rtol=3e-2)


def test_tree_attention_ignores_non_ancestors():
    """The JAX kernel test's structural check on the port: a depth-1 node's
    KV slot changed, its non-descendant rows keep their values and its child
    moves."""
    rng = np.random.default_rng(5)
    prefix = 5
    tspec, _, (tq, tcache, ttab, tctx, tpos) = _tree_case(rng, prefix, "bfloat16")
    tree = tree_mask(prefix, tspec.ancestors, "cpu")
    before = paged_attention_ref(tq, tcache, 0, ttab, tctx, 128 ** -0.5, q_positions=tpos,
                                 tree=tree)
    node = tspec.choices.index((1,))
    slot = 17 + 1 + node
    pages = tcache.kv_pages.clone()
    pages[0, int(ttab[0, slot // 8]), :, :, slot % 8] = 99.0
    after = paged_attention_ref(tq, tkv.PagedKVCache(pages), 0, ttab, tctx, 128 ** -0.5,
                                q_positions=tpos, tree=tree)
    child = prefix + tspec.choices.index((1, 0))
    for r in range(tq.shape[1]):
        if r - prefix in (node, child - prefix):
            continue
        assert torch.equal(before[0, r], after[0, r]), r
    assert not torch.allclose(before[0, child].float(), after[0, child].float(), atol=1e-3)


def test_tree_size_bound_of_the_kernel():
    """The kernel reads one 64-bit ancestor word per node: tree_mask builds
    them once per tree (bit j of word t = ancestors[t][j]) and refuses a
    tree past 64 nodes on a CUDA device, naming the bound; the plain
    version takes any tree."""
    t = build_tree(DEFAULT_TREE)
    m = tree_mask(5, t.ancestors, "cpu")
    assert m.prefix == 5 and m.ancestors.tolist() == [list(r) for r in t.ancestors]
    for i, w in enumerate(m.words.tolist()):
        assert [bool((w >> j) & 1) for j in range(t.num_nodes)] == list(t.ancestors[i])
    wide = build_tree([(i,) for i in range(MAX_TREE_NODES - 1)] + [(0, 0)])
    words = tree_mask(1, wide.ancestors, "cpu").words
    assert words.shape == (64,) and words[-1].item() == 1 - (1 << 63)   # bits 0 and 63
    too_wide = build_tree([(i,) for i in range(MAX_TREE_NODES + 1)])
    assert tree_mask(1, too_wide.ancestors, "cpu").words is None
    with pytest.raises(ValueError, match="64"):
        tree_mask(1, too_wide.ancestors, "cuda")


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def tiny():
    """The tiny QuaRot model of the JAX package (int8 head) with 4 random
    heads, carried over."""
    jcfg = JModel.tiny(quant="w4")
    jparams = jllama.init_params(jcfg, seed=0)
    jparams = {**jparams, "medusa": jmedusa.init_medusa_params(
        jcfg.hidden_size, jcfg.vocab_size, k=4, seed=5)}
    cfg = ModelConfig.tiny(quant="w4")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    return jcfg, jparams, cfg, params


def test_model_forward_tree_and_hidden_match_jax(tiny):
    """A prompt rectangle, then a tree-verify rectangle ([prefix 5 | 10
    nodes], the engine's layout) with return_hidden: logits and hidden
    against the JAX package's model_forward."""
    jcfg, jparams, cfg, params = tiny
    rng = np.random.default_rng(11)
    tspec = build_tree(DEFAULT_TREE)
    B, Q0, S, prefix, T = 2, 20, 16, 5, tspec.num_nodes
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks0 = rng.integers(1, 512, (B, Q0)).astype(np.int32)
    pos0 = np.tile(np.arange(Q0, dtype=np.int32), (B, 1))
    root = Q0 - 1
    ppos = root - (prefix - 1) + np.arange(prefix)
    positions = np.tile(np.concatenate([ppos, root + np.asarray(tspec.depth)]), (B, 1)
                        ).astype(np.int32)
    slots_idx = np.tile(np.concatenate([ppos, root + 1 + np.arange(T)]), (B, 1))
    toks1 = np.concatenate([toks0[:, -prefix:], rng.integers(1, 512, (B, T))], 1).astype(np.int32)
    ctx1 = np.full(B, root + 1 + T, np.int32)
    jc = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                        jcfg.cache_head_dim, 10, S))
    tc = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                        cfg.cache_head_dim, 10, S), "cpu")
    outs = []
    for toks, pos, sidx, ctx, tree in ((toks0, pos0, pos0, np.full(B, Q0, np.int32), None),
                                       (toks1, positions, slots_idx, ctx1,
                                        (prefix, tspec.ancestors))):
        slot = (np.take_along_axis(tables, sidx // S, 1) * S + sidx % S).astype(np.int32)
        jb = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(slot), jnp.asarray(tables),
                                   jnp.asarray(ctx))
        tb = tllama.AttentionBatch(torch.tensor(pos), torch.tensor(slot), torch.tensor(tables),
                                   torch.tensor(ctx))
        jl, jh, jc = jllama.model_forward(jparams, jcfg, jnp.asarray(toks), jc, jb,
                                          return_hidden=True, tree=tree)
        tl, th, tc = tllama.model_forward(
            params, cfg, torch.tensor(toks), tc, tb, return_hidden=True,
            tree=tree and tree_mask(tree[0], tree[1], "cpu"))
        outs.append((np.asarray(jl), tl.numpy(), np.asarray(jh, np.float32), th.float().numpy()))
    for jl, tl, jh, th in outs:
        assert th.shape == jh.shape and tl.shape == jl.shape
        assert np.linalg.norm(tl - jl) / np.linalg.norm(jl) <= 2e-2
        assert np.linalg.norm(th - jh) / np.linalg.norm(jh) <= 2e-2
        pick = tl.argmax(-1)
        gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
        assert gap.max() <= TIE_GAP


# ---------------------------------------------------------------- the engine

def _sched(**over):
    d = dict(max_num_seqs=4, max_model_len=160, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    d.update(over)
    return d


def _prompts(n=3, seed=4):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, 500, size=int(r.integers(6, 40))))) for _ in range(n)]


def run_port(cfg, params, prompts, spec, temp=0.0, max_tokens=MAX_TOKENS, **sched):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched(**sched)),
                                 speculative=spec), params, device="cpu")
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=temp, max_tokens=max_tokens,
                                          ignore_eos=True))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    return [outs[i] for i in range(len(prompts))], eng


def run_jax(jcfg, jparams, prompts, max_tokens=MAX_TOKENS, spec=None, **sched):
    eng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                             scheduler=JSched(**_sched(**sched)), speculative=spec), jparams)
    for p in prompts:
        eng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=max_tokens,
                                           ignore_eos=True))
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in range(len(prompts))], eng


def _jax_last_logits(jcfg, jparams, ids, S=16):
    Q = len(ids)
    n_pages = -(-Q // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, n_pages + 1, S))
    pos = np.arange(Q, dtype=np.int32)[None]
    tables = np.arange(1, n_pages + 1, dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S), jnp.asarray(tables),
                                  jnp.asarray([Q], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32), cache, batch)
    return np.asarray(logits[0, -1])


def _agree_up_to_ties(jcfg, jparams, prompts, ref, got):
    for i, p in enumerate(prompts):
        diff = [j for j, (a, b) in enumerate(zip(ref[i], got[i])) if a != b]
        if diff:
            j = diff[0]
            top2 = np.sort(_jax_last_logits(jcfg, jparams, p + ref[i][:j]))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (i, j, top2)


@pytest.fixture(scope="module")
def jax_ar(tiny):
    """The JAX engine's greedy tokens (AR: greedy Medusa equals them, as the
    JAX package's own tests hold)."""
    jcfg, jparams, _, _ = tiny
    return run_jax(jcfg, jparams, _prompts())[0]


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("tree", [None, DEFAULT_TREE], ids=["chain", "tree"])
def test_greedy_medusa_equals_oracle_and_jax(tiny, jax_ar, tree, rounds):
    """Greedy Medusa (chain k=4, or the tree) == the port's medusa_null
    oracle, bit for bit; and == the JAX engine up to near-ties."""
    jcfg, jparams, cfg, params = tiny
    prompts = _prompts()
    spec, eng = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=4, method="medusa", medusa_tree=tree, rounds_per_step=rounds))
    oracle, _ = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=4, method="medusa_null", medusa_tree=tree,
        rounds_per_step=rounds))
    assert spec == oracle
    assert all(len(t) == MAX_TOKENS for t in spec)
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0 and 0.0 <= m.draft_acceptance_rate <= 1.0
    assert eng.runner.draft_cache is None and eng.runner.spec_rounds_run > 0
    _agree_up_to_ties(jcfg, jparams, prompts, jax_ar, spec)


def test_greedy_medusa_batch_changes_and_preemption(tiny):
    """Two sequences at a time (queueing), a cache too small for all three
    (recompute preemption: the verify prefix is written again from the
    host), lm_head-seeded heads (accepted proposals): the tree still gives
    the oracle's tokens."""
    _, _, cfg, params = tiny
    seeded = {**params, "medusa": tmedusa.init_medusa_params(
        cfg.hidden_size, cfg.vocab_size, 4, lm_head=tmedusa.lm_head_weight(params["lm_head"]))}
    prompts = _prompts(seed=9)
    outs = []
    for method in ("medusa", "medusa_null"):
        spec = SpeculativeConfig(num_speculative_tokens=4, method=method, medusa_tree=DEFAULT_TREE)
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=7),
                                     scheduler=SchedulerConfig(**_sched(max_num_seqs=2)),
                                     speculative=spec), seeded, device="cpu")
        for p in prompts:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                              ignore_eos=True))
        done = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        outs.append([done[i] for i in range(len(prompts))])
        if method == "medusa":
            assert eng.spec_metrics.draft_acceptance_rate > 0
    assert outs[0] == outs[1]
    ref, _ = run_port(cfg, params, prompts, None)
    assert outs[0] == ref


def test_windowed_tree_equals_oracle_past_the_window(tiny):
    """A sliding window of 8 on every layer, contexts well past it, heads
    seeded from lm_head (accepted proposals): greedy tree tokens equal the
    medusa_null oracle's (AR's). Each tree row is bounded as AR bounds its
    node's own position root + depth; bounding it by the root, as the JAX
    kernel does, lets a depth-d node see d positions AR does not, and its
    accepted samples then leave AR's tokens."""
    _, _, cfg, params = tiny
    wcfg = dataclasses.replace(cfg, sliding_window=8)
    seeded = {**params, "medusa": tmedusa.init_medusa_params(
        cfg.hidden_size, cfg.vocab_size, 4, lm_head=tmedusa.lm_head_weight(params["lm_head"]))}
    prompts = _prompts(4, seed=11)
    outs = []
    for method in ("medusa", "medusa_null"):
        out, eng = run_port(wcfg, seeded, prompts, SpeculativeConfig(
            num_speculative_tokens=4, method=method, medusa_tree=DEFAULT_TREE), max_tokens=32)
        outs.append(out)
        if method == "medusa":
            assert eng.spec_metrics.num_draft_accepted > 20
    assert outs[0] == outs[1]


def test_tree_on_prompts_shorter_than_the_prefix(tiny):
    """Prompts of 1-3 tokens put the first rounds' prefix rows before
    position 0 (phantom rows, written to the null page). The port takes the
    root's own position for the mask, so the tree still gives AR's tokens.
    (The JAX package takes row 0's clamped position there, which moves its
    root: its tree and AR differ on such prompts, ROADMAP.md §3.)"""
    _, _, cfg, params = tiny
    prompts = [[7, 9], [3], [11, 12, 13]]
    tree, _ = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=4, method="medusa", medusa_tree=DEFAULT_TREE), max_tokens=12)
    ar, _ = run_port(cfg, params, prompts, None, max_tokens=12)
    assert tree == ar


def test_medusa_sampled_tree_completes(tiny):
    _, _, cfg, params = tiny
    outs, eng = run_port(cfg, params, _prompts(2), SpeculativeConfig(
        num_speculative_tokens=4, method="medusa", medusa_tree=DEFAULT_TREE),
        temp=0.8, max_tokens=20)
    assert [len(t) for t in outs] == [20, 20]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert 0.0 <= eng.spec_metrics.draft_acceptance_rate <= 1.0


def test_medusa_k_exceeding_heads_rejected(tiny):
    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="proposer heads"):
        run_port(cfg, params, _prompts(1), SpeculativeConfig(num_speculative_tokens=9,
                                                             method="medusa"))
    with pytest.raises(ValueError, match="proposer heads"):
        run_port(cfg, params, _prompts(1), SpeculativeConfig(
            num_speculative_tokens=2, method="medusa",
            medusa_tree=((0,), (0, 0), (0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0, 0))))


def test_medusa_requires_heads(tiny):
    _, _, cfg, params = tiny
    bare = {k: v for k, v in params.items() if k != "medusa"}
    with pytest.raises(ValueError, match="medusa"):
        run_port(cfg, bare, _prompts(1), SpeculativeConfig(num_speculative_tokens=2,
                                                           method="medusa"))


def test_tree_guided_rejected(tiny):
    _, _, cfg, params = tiny
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched()),
                                 speculative=SpeculativeConfig(
                                     num_speculative_tokens=4, method="medusa",
                                     medusa_tree=DEFAULT_TREE)), params, device="cpu")
    # the JAX package's ValueError: the tree does not compose with a grammar
    with pytest.raises(ValueError, match="medusa candidate tree"):
        eng.add_request([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4,
                                                  guided_regex="ab+"))


def test_llm_entry_points(tiny, tmp_path):
    """LLM with speculative_model="[medusa]" and the default tree, and with
    an .npz of heads; an .npz of another proposer names that proposer's
    method, and "[eagle]" wants an EAGLE net in params."""
    _, _, cfg, params = tiny
    kw = dict(device="cpu", num_speculative_tokens=4, block_size=16, max_model_len=160,
              max_num_seqs=4, prefill_chunk_size=64, num_pages=32, seed=0)
    prompts = _prompts(2)
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    a = LLM(model="tiny", params=params, speculative_model="[medusa]",
            spec_medusa_tree="default", **kw)
    assert a.llm_engine.runner._mtree.spec.num_nodes == len(DEFAULT_TREE)
    outs_a = [o.output_token_ids for o in a.generate(prompts, sp)]
    path = tmp_path / "heads.npz"
    np.savez(path, **{k: v.float().numpy() for k, v in params["medusa"].items()})
    bare = {k: v for k, v in params.items() if k != "medusa"}
    b = LLM(model="tiny", params=bare, speculative_model=str(path),
            spec_medusa_tree="default", **kw)
    assert b.engine_config.speculative.method == "medusa"
    assert [o.output_token_ids for o in b.generate(prompts, sp)] == outs_a
    np.savez(tmp_path / "other.npz", proj_first=np.zeros(2, np.float32))
    assert EngineArgs(num_speculative_tokens=4, speculative_model=str(tmp_path / "other.npz")
                      ).spec_method() == "mlp_speculator"
    with pytest.raises(ValueError, match="eagle"):
        LLM(model="tiny", params=bare, speculative_model="[eagle]", **kw)


# ---------------------------------------------------------------- real weights

@pytest.fixture(scope="module")
def trained():
    """bench.load_medusa_regime(): medusa_base_v4 quantized by the JAX
    package's quantize_float, with the trained induction_medusa_v2 heads."""
    import bench
    if not os.path.exists(os.path.join(ROOT, "checkpoints", "induction_medusa_v2.npz")):
        pytest.skip("checkpoints/induction_medusa_v2.npz is not in this checkout")
    jcfg, jparams, _ = bench.load_medusa_regime()
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    prompts = bench.induction_prompts(4, 128, cfg.vocab_size, seed=13)
    return jcfg, jparams, cfg, params, prompts


def test_trained_heads_tree_matches_jax(trained):
    """The trained heads on their base: the tree's greedy tokens match the
    JAX engine's (near-ties apart) and the port emits at least 2 tokens per
    tree round and sequence, the JAX package's on-chip bar for this regime."""
    jcfg, jparams, cfg, params, prompts = trained
    k = int(params["medusa"]["head"].shape[0])
    tree = tuple(p for p in DEFAULT_TREE if len(p) <= k)
    sched = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=128,
                 decode_batch_buckets=(4,), prefill_token_buckets=(128,))
    got, eng = run_port(cfg, params, prompts, SpeculativeConfig(
        num_speculative_tokens=k, method="medusa", medusa_tree=tree, rounds_per_step=2),
        max_tokens=32, **sched)
    ref, _ = run_jax(jcfg, jparams, prompts, max_tokens=32, **sched)
    _agree_up_to_ties(jcfg, jparams, prompts, ref, got)
    m = eng.spec_metrics
    per_round = m.num_emitted_tokens / (m.num_emitted_tokens - m.num_draft_accepted)
    assert per_round >= 2.0, (per_round, m.summary())
