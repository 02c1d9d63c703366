"""The sliding window of the port's attention and the windowed draft's ring
pool, on the CPU, the engine's refusals of the sampling knobs no sampler
applies, and the first draft backfill after a prefill, which rewrites the
last prompt position's draft KV as the JAX package's does.

* The windowed plain attention against the JAX package's
  ``paged_attention_ref(window=...)`` and its Pallas kernel in interpret mode,
  at the shapes of tests/kernels/test_attention.py (tolerance 2e-2 against
  the reference, 3e-2 against the kernel, as there).
* Ports of tests/spec_decode/test_ring_draft.py on the port's engine: the
  ring pool is small, the ring draft is bit-exact against the full-pool
  windowed draft (QSPEC_RING_DRAFT=0), greedy spec == AR, rows recycle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.attention import paged_attention_ref as j_attn_ref
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.models.llama import init_params
from qspec_tpu_torch.ops.attention import paged_attention, paged_attention_ref
from qspec_tpu_torch.ops.kv_cache import PagedKVCache


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


def _inputs(rng, Q, P, tables, ctx, B=3, Hq=4, Hkv=2, D=64, S=8):
    """test_attention.py's make_cache and queries, for both packages."""
    jc = jkv.allocate(jkv.KVCacheConfig(num_layers=1, num_kv_heads=Hkv, head_dim=D,
                                        num_pages=P, page_size=S))
    kv = jnp.asarray(rng.standard_normal(jc.kv_pages.shape).astype(np.float32), jnp.bfloat16)
    jc = jc._replace(kv_pages=kv)
    tc = PagedKVCache(torch.tensor(np.asarray(kv, np.float32)).to(torch.bfloat16))
    qj = jnp.asarray(rng.standard_normal((B, Q, Hq, D)).astype(np.float32), jnp.bfloat16)
    qt = torch.tensor(np.asarray(qj, np.float32)).to(torch.bfloat16)
    return jc, tc, qj, qt, jnp.asarray(tables), torch.tensor(tables), jnp.asarray(ctx), \
        torch.tensor(ctx)


@pytest.mark.parametrize("Q,window", [(1, 8), (1, 12), (4, 8), (4, 5)])
def test_window_ref_matches_jax_ref(rng, Q, window):
    S = 8
    tables = rng.permutation(np.arange(1, 13)).reshape(3, 4).astype(np.int32)
    ctx = np.asarray([Q + 3, S + Q, 3 * S + Q], np.int32)
    jc, tc, qj, qt, tj, tt, cj, ct = _inputs(rng, Q, 16, tables, ctx)
    ref = j_attn_ref(qj, jc, 0, tj, cj, 64 ** -0.5, window=window)
    out = paged_attention_ref(qt, tc, 0, tt, ct, 64 ** -0.5, window=window)
    np.testing.assert_allclose(np32(out), np32(ref), atol=2e-2, rtol=2e-2)
    # the window masks: without it the result differs
    full = paged_attention_ref(qt, tc, 0, tt, ct, 64 ** -0.5)
    assert not torch.allclose(full, out, atol=1e-2)


@pytest.mark.parametrize("Q,window", [(1, 8), (4, 8), (4, 21), (1, 40)])
def test_window_matches_jax_kernel(rng, Q, window):
    """The port's dispatch (its plain version on the CPU) against the JAX
    Pallas kernel with its out-of-window page skip, at contexts long enough
    that leading pages are skipped."""
    S = 8
    tables = rng.permutation(np.arange(1, 25)).reshape(3, 8).astype(np.int32)
    ctx = np.asarray([Q + 3, 4 * S + Q, 8 * S - 2], np.int32)
    jc, tc, qj, qt, tj, tt, cj, ct = _inputs(rng, Q, 32, tables, ctx)
    ref = paged_attention_pallas(qj, jc.kv_pages, tj, cj, 64 ** -0.5, window=window)
    out = paged_attention(qt, tc, 0, tt, ct, 64 ** -0.5, window=window)
    np.testing.assert_allclose(np32(out), np32(ref), atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------- the ring

def make_engine(monkeypatch, ring: bool, *, window=24, k=3, rounds=2,
                page_size=16, max_len=256):
    """test_ring_draft.py's engine: the tiny QuaRot model with a windowed
    W4A8 draft."""
    monkeypatch.setenv("QSPEC_RING_DRAFT", "1" if ring else "0")
    mc = ModelConfig.tiny(quant="w4")
    params = init_params(mc, seed=0, device="cpu")
    spec = SpeculativeConfig(num_speculative_tokens=k, rounds_per_step=rounds,
                             draft_scheme="w4a8", draft_kv_window=window)
    return LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=page_size),
                                  scheduler=_sched(max_len), speculative=spec),
                     params, device="cpu"), mc, params


def _sched(max_len=256):
    return SchedulerConfig(max_num_seqs=4, max_model_len=max_len, prefill_chunk_size=64,
                           decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))


def drive(eng, prompts, max_tokens, temp=0.0, seed=7):
    outs = {}
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=temp, max_tokens=max_tokens,
                                          seed=seed, ignore_eos=True))
    steps = 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 500
    return outs


def prompts(n=3):
    r = np.random.default_rng(5)
    return [list(map(int, r.integers(1, 500, size=int(r.integers(8, 40)))))
            for _ in range(n)]


def test_ring_pool_is_small(monkeypatch):
    eng, _, _ = make_engine(monkeypatch, ring=True)
    r = eng.runner
    # window 24 + k 3 + 1 = 28 tokens -> ceil(28/16)+2 = 4 pages per ring
    assert r._ring_pages == 4
    # pool = rows * R + 1 null page, NOT the target's num_pages
    assert r.draft_cache.kv_pages.shape[1] == r._ring_rows * r._ring_pages + 1
    assert r.draft_cache.kv_pages.shape[1] < r.cache.kv_pages.shape[1]
    assert r.ring_cap == (r._ring_pages - 1) * 16
    assert r.draft_cfg.sliding_window == 24 and r.cfg.sliding_window is None


def test_ring_bitexact_vs_full_pool(monkeypatch):
    """Generation long enough to wrap every ring several times: transcripts
    and acceptance counters match the full-pool windowed draft bit for bit.
    (tests/test_torch_grouped.py runs it on a w4g checkpoint.)"""
    ps = prompts()
    n_tok = 120  # >> ring_cap (48 tokens): many wrap-arounds
    eng_full, _, _ = make_engine(monkeypatch, ring=False)
    assert eng_full.runner._ring_pages == 0
    full = drive(eng_full, ps, n_tok)
    m_full = eng_full.spec_metrics
    eng_ring, _, _ = make_engine(monkeypatch, ring=True)
    ring = drive(eng_ring, ps, n_tok)
    m_ring = eng_ring.spec_metrics
    assert ring == full
    assert m_ring.num_draft_tokens == m_full.num_draft_tokens
    assert m_ring.num_draft_accepted == m_full.num_draft_accepted
    assert m_ring.num_emitted_tokens == m_full.num_emitted_tokens
    assert m_ring.num_draft_accepted > 0


def test_ring_greedy_invariant_vs_ar(monkeypatch):
    """Lossless regardless of layout: ring spec == plain AR greedy."""
    ps = prompts()
    eng_ring, mc, params = make_engine(monkeypatch, ring=True)
    ring = drive(eng_ring, ps, 90)
    ar = drive(LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=16),
                                      scheduler=_sched(), speculative=None),
                         params, device="cpu"), ps, 90)
    assert ring == ar


def test_ring_rows_recycle(monkeypatch):
    """More sequences over the engine's lifetime than ring rows: finished
    sequences release their rows, later admissions reuse them."""
    eng, _, _ = make_engine(monkeypatch, ring=True)
    rows = eng.runner._ring_rows
    ps = prompts(3) + prompts(3) + prompts(3)
    # 9 sequences through a 4-row (+1 scratch) ring bank, batches of <= 4
    outs = drive(eng, ps, 30)
    assert len(outs) == 9
    assert len(eng.runner._ring.slot) <= rows - 1
    assert not eng.runner._ring.slot      # every finished sequence let go


def test_preempted_sequence_releases_its_ring_row(monkeypatch):
    """Recompute preemption (a pool too small for all sequences) frees the
    victim's ring row; the output stays the greedy AR output."""
    eng, mc, params = _preempting_engine(monkeypatch)
    freed = []
    free = eng.runner.free_ring_row
    eng.runner.free_ring_row = lambda s: (freed.append(s.seq_id), free(s))
    ps = prompts(4)
    outs, waiting_seen = _drive_preempting(eng, ps)
    ar = drive(LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=16),
                                      scheduler=_sched(), speculative=None),
                         params, device="cpu"), ps, 40)
    assert outs == ar
    assert set(waiting_seen) <= set(freed)
    assert not eng.runner._ring.slot


def _preempting_engine(monkeypatch):
    """A windowed W4A8 ring draft over a KV pool too small for four
    sequences: recompute preemption happens."""
    monkeypatch.setenv("QSPEC_RING_DRAFT", "1")
    mc = ModelConfig.tiny(quant="w4")
    params = init_params(mc, seed=0, device="cpu")
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a8",
                             draft_kv_window=24)
    eng = LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=16, num_pages=10),
                                 scheduler=_sched(), speculative=spec), params, device="cpu")
    return eng, mc, params


def _drive_preempting(eng, ps):
    """Greedy outputs, and the ids of sequences seen preempted with outputs."""
    waiting_seen = []
    outs, steps = {}, 0
    for p in ps:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True))
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        waiting_seen += [s.seq_id for s in eng.scheduler.waiting if s.output_token_ids]
        steps += 1
        assert steps < 500
    assert waiting_seen, "the small pool preempted no sequence"
    return outs, waiting_seen


# ---------------------------------------------------------------- repairs

@pytest.fixture(scope="module")
def tiny_engine():
    mc = ModelConfig.tiny(quant="w4")
    return LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=16, num_pages=8),
                                  scheduler=_sched(), speculative=None),
                     init_params(mc, seed=0, device="cpu"), device="cpu")


def test_repetition_penalty_is_refused(tiny_engine):
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        tiny_engine.add_request([1, 2], SamplingParams(repetition_penalty=1.2))


def test_seeded_sampled_request_is_refused(tiny_engine):
    with pytest.raises(NotImplementedError, match="seed"):
        tiny_engine.add_request([1, 2], SamplingParams(temperature=0.7, seed=3))
    # a greedy request ignores its seed legitimately
    rid = tiny_engine.add_request([1, 2], SamplingParams(temperature=0.0, seed=3,
                                                         max_tokens=2))
    outs = {}
    while tiny_engine.has_unfinished_requests():
        for o in tiny_engine.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    assert len(outs[rid]) == 2


def test_w4g_head_defaults_to_int8():
    """As in the JAX package, every quantized checkpoint's head defaults to
    int8 (matmul_w8a16), w4g's included."""
    for quant in ("w4", "w4g"):
        assert ModelConfig.tiny(quant=quant).resolved_lm_head_quant == "int8"
        assert JModel.tiny(quant=quant).resolved_lm_head_quant == "int8"
    params = init_params(ModelConfig.tiny(quant="w4g"), seed=1, device="cpu", group_size=64)
    assert set(params["lm_head"]) == {"qw8", "qs"}
    assert params["lm_head"]["qw8"].dtype == torch.int8


# ------------------------------------------- the first draft backfill

def _backfill_spy(monkeypatch):
    """Record (positions, slots, block tables) of every Q=2 draft backfill."""
    from qspec_tpu_torch.engine import model_runner as mr
    backfills = []
    real = mr.model_forward

    def spy(params, cfg, tokens, cache, batch, **kw):
        if tokens.shape[1] == 2:
            backfills.append((batch.positions.clone(), batch.slot_mapping.clone(),
                              batch.block_tables.clone(), batch.ctx_lens.clone()))
        return real(params, cfg, tokens, cache, batch, **kw)

    monkeypatch.setattr(mr, "model_forward", spy)
    return backfills


@pytest.mark.parametrize("case", ["fresh", "preempted"])
def test_first_backfill_writes_the_last_prompt_position(monkeypatch, case):
    """Every Q=2 draft backfill, the first after a prefill or a resumed
    sequence's re-prefill included, writes the draft KV at start_pos - 1 to
    that position's own slot (never the null page), as the JAX package's
    does: the draft's path recomputes it."""
    backfills = _backfill_spy(monkeypatch)
    if case == "fresh":
        mc = ModelConfig.tiny(quant="w4")
        eng = LLMEngine(EngineConfig(model=mc, cache=CacheConfig(page_size=16),
                                     scheduler=_sched(),
                                     speculative=SpeculativeConfig(num_speculative_tokens=3)),
                        init_params(mc, seed=0, device="cpu"), device="cpu")
        drive(eng, [list(range(1, 21))], 12)
        # the first round's backfill: the last prompt position, 19
        pos, slot, tables, _ = backfills[0]
        assert pos[0].tolist() == [19, 20]
        assert slot[0, 0].item() == tables[0, 1].item() * 16 + 3 != 0
    else:
        eng, _, _ = _preempting_engine(monkeypatch)
        _drive_preempting(eng, prompts(4))
    assert len(backfills) >= 2
    for pos, slot, tables, ctx in backfills:
        live = (ctx > 0) & (pos[:, 0] >= 0)
        p0 = pos[:, :1].clamp_min(0)
        want = tables.to(torch.int64).gather(1, p0 // 16) * 16 + p0 % 16
        assert live.any()
        assert torch.equal(slot[live, 0], want[live, 0])
        assert (slot[live, 0] != 0).all()


def test_first_backfill_overwrites_like_jax():
    """After the draft prefill, the draft KV at the last prompt position is
    overwritten with a marker in both packages' caches (same tiny weights,
    same prompt); one engine step later both have rewritten it through the
    draft's Q=2 backfill, and the port's slot holds the JAX package's values
    within the KV tolerance (rtol / atol 2e-2 x max|ref|, the logits'
    tolerance of tests/test_torch_grouped.py)."""
    import jax
    from qspec_tpu.config import CacheConfig as JCache
    from qspec_tpu.config import EngineConfig as JEngine
    from qspec_tpu.config import SchedulerConfig as JSched
    from qspec_tpu.config import SpeculativeConfig as JSpec
    from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
    from qspec_tpu.models import llama as jllama
    from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
    from qspec_tpu_torch.models.llama import params_from_numpy

    jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                               device="cpu")
    prompt = list(map(int, np.random.default_rng(3).integers(1, 500, size=21)))
    last = len(prompt) - 1
    sched = dict(max_num_seqs=2, max_model_len=128, prefill_chunk_size=32,
                 decode_batch_buckets=(2,), prefill_token_buckets=(32,))
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**sched),
                              speculative=JSpec(num_speculative_tokens=3,
                                                draft_scheme="w4a16")), jparams)
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**sched),
                                 speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                               draft_scheme="w4a16")),
                    params, device="cpu")
    jeng.add_request(prompt, JSamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True))
    eng.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True))
    jeng.step()                    # the prefill: the target's and the draft's
    eng.step()
    marker = 7.0
    jpage = jeng.scheduler.running[0].page_ids[last // 16]
    page = eng.scheduler.running[0].page_ids[last // 16]
    jr, r = jeng.runner, eng.runner
    jr.draft_cache = jr.draft_cache._replace(
        kv_pages=jr.draft_cache.kv_pages.at[:, jpage, :, :, last % 16].set(marker))
    r.draft_cache.kv_pages[:, page, :, :, last % 16] = marker
    jeng.step()                    # one spec call: its first round backfills
    eng.step()
    ref = np32(np.asarray(jr.draft_cache.kv_pages[:, jpage, :, :, last % 16], np.float32))
    got = np32(r.draft_cache.kv_pages[:, page, :, :, last % 16])
    assert not (ref == marker).any() and not (got == marker).any()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
