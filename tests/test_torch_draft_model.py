"""A separate draft model, and forced acceptance, in the port's engine (CPU).

Port of ``tests/spec_decode/test_draft_model.py``: a smaller independent
model proposes, the target verifies, and rejection sampling keeps greedy
output equal to the greedy AR output and to the ``qspec_null`` oracle of
the same rounds, whatever the draft's quality; with a float draft (the
bf16 scheme, as in the JAX test) and with a QuaRot w4 draft (W4A4), each
with its own KV pool of its own geometry. A w4g target and a float target
take a separate draft too (the JAX package's model runner allows both).
``SpeculativeConfig.force_accept_len`` (the timing mode) emits
min(f + 1, k + 1) tokens a round, and at 0 exactly the oracle's tokens.

Equality with the oracle holds for any draft, so what the draft computes
is held apart: the target as its own separate draft is accepted up to the
token budget (bf16) or exactly as the shared-weights draft is (w4); and on
the trained ``induction_lm_v2`` checkpoint, quantized as the target with
its float model cut to two layers as the draft, the draft tokens and the
accepted lengths of ``spec_rounds_step(draft_params=...)`` equal the JAX
package's on the same numpy inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.engine import model_runner as jmr
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.sampling import SamplingTensors as JSamplingTensors
from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine import model_runner as tmr
from qspec_tpu_torch.engine.llm_engine import LLMEngine
from qspec_tpu_torch.models.llama import init_params, params_from_numpy
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.sampling import SamplingTensors
from qspec_tpu_torch.sampling_params import SamplingParams
from tests.test_torch_quantize_float import INDUCTION, induction_cfg, induction_prompts

MAX_TOKENS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX test's much smaller draft: 1 layer, narrower, same vocabulary
DRAFT = dict(num_layers=1, hidden_size=128, intermediate_size=192, num_heads=2,
             num_kv_heads=2)


@pytest.fixture(scope="module")
def setup():
    mc = ModelConfig.tiny(quant="w4")
    params = init_params(mc, seed=0, device="cpu")
    drafts = {}
    for quant in ("none", "w4"):
        dc = ModelConfig.tiny(quant=quant, **DRAFT)
        drafts[quant] = (dc, init_params(dc, seed=3, device="cpu"))
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
                            decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    return mc, params, drafts, sched


def run_engine(mc, params, sched, spec, prompts, draft_params=None):
    cfg = EngineConfig(model=mc, cache=CacheConfig(page_size=16), scheduler=sched,
                       speculative=spec)
    eng = LLMEngine(cfg, params, device="cpu", draft_params=draft_params)
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    return outs, eng


def prompts(n=4):
    r = np.random.default_rng(11)
    return [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40)))))
            for _ in range(n)]


@pytest.mark.parametrize("draft", ["none", "w4"])
@pytest.mark.parametrize("rounds", [1, 2])
def test_draft_model_greedy_invariant(setup, rounds, draft):
    mc, params, drafts, sched = setup
    dc, dparams = drafts[draft]
    ps = prompts()
    ar, _ = run_engine(mc, params, sched, None, ps)
    out = {}
    for method in ("qspec", "qspec_null"):
        spec = SpeculativeConfig(num_speculative_tokens=3, rounds_per_step=rounds,
                                 draft_model=dc, method=method)
        out[method], eng = run_engine(mc, params, sched, spec, ps, draft_params=dparams)
        runner = eng.runner
        # the draft's own pool (its geometry) and scheme
        assert runner.draft_cache.num_layers == 1
        assert runner.draft_scheme == ("bf16" if draft == "none" else "w4a4")
        assert runner.draft_forwards > 0
    assert out["qspec"] == out["qspec_null"] == ar
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0
    assert 0.0 <= m.draft_acceptance_rate <= 1.0


def test_draft_model_requires_params(setup):
    mc, params, drafts, sched = setup
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_model=drafts["none"][0])
    with pytest.raises(ValueError, match="draft_params"):
        run_engine(mc, params, sched, spec, prompts(1))
    with pytest.raises(ValueError, match="without speculative.draft_model"):
        run_engine(mc, params, sched, SpeculativeConfig(num_speculative_tokens=3),
                   prompts(1), draft_params=drafts["none"][1])


def test_draft_model_vocab_must_match(setup):
    mc, params, _, sched = setup
    dc_bad = ModelConfig.tiny(num_layers=1, vocab_size=256, quant="none")
    spec = SpeculativeConfig(num_speculative_tokens=2, draft_model=dc_bad)
    with pytest.raises(ValueError, match="vocab"):
        run_engine(mc, params, sched, spec, prompts(1),
                   draft_params=init_params(dc_bad, seed=1, device="cpu"))


@pytest.mark.parametrize("target", ["w4g", "none"])
def test_draft_model_for_targets_without_a_w4a4_draft(setup, target):
    """An AWQ (w4g) target and a float target, which have no shared-weights
    W4A4 draft, take a separate W4A4 draft: greedy == their AR."""
    _, _, drafts, sched = setup
    mc = ModelConfig.tiny(quant=target)
    params = init_params(mc, seed=0, device="cpu", group_size=64)
    ps = prompts(2)
    ar, _ = run_engine(mc, params, sched, None, ps)
    dc, dparams = drafts["w4"]
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_model=dc)
    sp, eng = run_engine(mc, params, sched, spec, ps, draft_params=dparams)
    assert sp == ar
    assert eng.runner.verify_scheme == ("bf16" if target == "none" else "w4a16")
    with pytest.raises(ValueError, match="draft"):
        run_engine(mc, params, sched, SpeculativeConfig(num_speculative_tokens=3), ps)


def test_draft_model_refusals(setup):
    mc, params, drafts, sched = setup
    dc, dparams = drafts["none"]
    with pytest.raises(ValueError, match="qspec"):
        run_engine(mc, params, sched, SpeculativeConfig(
            num_speculative_tokens=3, method="ngram", draft_model=dc), prompts(1),
            draft_params=dparams)
    w4g = ModelConfig.tiny(quant="w4g", **DRAFT)
    with pytest.raises(ValueError, match="quant='w4g'"):
        run_engine(mc, params, sched, SpeculativeConfig(num_speculative_tokens=3,
                                                        draft_model=w4g), prompts(1),
                   draft_params=init_params(w4g, seed=1, device="cpu", group_size=64))


@pytest.mark.parametrize("draft", [None, "none", "w4"])
@pytest.mark.parametrize("force", [1, 3])
def test_force_accept_len_tokens_per_round(setup, draft, force):
    """Every round of every live sequence emits min(f + 1, k + 1) tokens,
    short of the token budget: each sequence's MAX_TOKENS - 1 tokens after
    its prefill token come in full rounds and one remainder."""
    mc, params, drafts, sched = setup
    k = 3
    dc, dparams = drafts[draft] if draft else (None, None)
    spec = SpeculativeConfig(num_speculative_tokens=k, draft_model=dc, force_accept_len=force)
    ps = prompts()
    out, eng = run_engine(mc, params, sched, spec, ps, draft_params=dparams)
    per_round = min(force + 1, k + 1)
    full, rest = divmod(MAX_TOKENS - 1, per_round)
    want = {per_round: full * len(ps), **({rest: len(ps)} if rest else {})}
    assert dict(eng.spec_metrics.emitted_per_seq_round) == want
    assert all(len(t) == MAX_TOKENS for t in out.values())


@pytest.mark.parametrize("draft", [None, "w4"])
def test_force_accept_len_zero_is_the_oracle(setup, draft):
    """force_accept_len=0: each round emits the verify's first token, the
    target's greedy token, so the output is exactly qspec_null's."""
    mc, params, drafts, sched = setup
    dc, dparams = drafts[draft] if draft else (None, None)
    ps = prompts()
    oracle, _ = run_engine(mc, params, sched, SpeculativeConfig(
        num_speculative_tokens=3, draft_model=dc, method="qspec_null"), ps,
        draft_params=dparams)
    forced, eng = run_engine(mc, params, sched, SpeculativeConfig(
        num_speculative_tokens=3, draft_model=dc, force_accept_len=0), ps,
        draft_params=dparams)
    assert forced == oracle
    assert set(eng.spec_metrics.emitted_per_seq_round) == {1}


def test_force_accept_len_refusals(setup):
    mc, params, _, sched = setup
    for spec in (SpeculativeConfig(num_speculative_tokens=3, force_accept_len=-1),
                 SpeculativeConfig(num_speculative_tokens=3, method="ngram",
                                   force_accept_len=1)):
        with pytest.raises(ValueError, match="force_accept_len"):
            run_engine(mc, params, sched, spec, prompts(1))


@pytest.mark.parametrize("quant", ["none", "w4"])
def test_target_as_its_own_draft(setup, quant):
    """The target passed as the separate draft, with its own pool: a bf16
    target drafts what it verifies, so every round emits k + 1 tokens short
    of the budget (what force_accept_len=3 emits); a w4 target's separate
    draft runs W4A4 on the same weights as the shared-weights draft, and
    gives the same tokens and every counter the same."""
    _, _, _, sched = setup
    mc = ModelConfig.tiny(quant=quant)
    params = init_params(mc, seed=0, device="cpu")
    ps = prompts()
    ar, _ = run_engine(mc, params, sched, None, ps)
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_model=mc)
    out, eng = run_engine(mc, params, sched, spec, ps, draft_params=params)
    runner, m = eng.runner, eng.spec_metrics
    assert out == ar
    assert runner.draft_params is params and runner.draft_forwards > 0
    assert runner.draft_cache is not runner.cache
    if quant == "none":
        assert runner.draft_scheme == runner.verify_scheme == "bf16"
        full, rest = divmod(MAX_TOKENS - 1, 4)
        assert dict(m.emitted_per_seq_round) == {4: full * len(ps), rest: len(ps)}
        assert m.num_draft_accepted == len(ps) * (3 * full + rest - 1)
    else:
        assert runner.draft_scheme == "w4a4"
        shared, eng2 = run_engine(mc, params, sched,
                                  SpeculativeConfig(num_speculative_tokens=3), ps)
        assert shared == out
        assert eng2.spec_metrics.summary() == m.summary()
        assert eng2.spec_metrics.emitted_per_seq_round == m.emitted_per_seq_round
        assert 0.0 < m.draft_acceptance_rate < 1.0


def _port_of(jparams, jcfg):
    cfg = dataclasses.replace(induction_cfg(ModelConfig), num_layers=jcfg.num_layers,
                              quant=jcfg.quant, lm_head_quant=jcfg.lm_head_quant)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                             device="cpu"), cfg


@pytest.fixture(scope="module")
def induction_pair():
    """induction_lm_v2 quantized by the JAX package (the target) and its
    float model without the last layer (the draft: 2 of 3 layers, its own
    cache geometry), each in both packages from the same arrays."""
    with np.load(INDUCTION.with_suffix(".npz")) as z:
        sd = {k: z[k] for k in z.files}
    jcfg = induction_cfg(JModelConfig)
    dcfg = dataclasses.replace(jcfg, num_layers=jcfg.num_layers - 1)
    last = f".layers.{jcfg.num_layers - 1}."
    jd, dcfg = jloader.load_hf_float({k: v for k, v in sd.items() if last not in k}, dcfg)
    jt, jcfg = jloader.quantize_float(sd, jcfg)
    return (jt, jcfg, *_port_of(jt, jcfg)), (jd, dcfg, *_port_of(jd, dcfg))


def test_spec_rounds_with_draft_params_match_jax(induction_pair):
    """Both packages prefill the target (w4a16) and the draft (bf16) caches
    with the same prompts over the same page tables, then the draft's k
    tokens (its first step the [prev, last] pass) and R rounds of
    spec_rounds_step with draft_params: the first tokens, the draft tokens,
    the emitted tokens and the accepted lengths are equal. The prompts are
    random ids, so the draft is not always right: the lengths include a
    partial round and the budget's end."""
    (jt, jcfg, tt, tcfg), (jd, dcfg, td, tdcfg) = induction_pair
    S, k, R, budget = 16, 3, 6, 20
    rng = np.random.default_rng(4)
    ps = [rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32) for n in (40, 17, 33)]
    B = len(ps)
    n_pages = -(-(max(map(len, ps)) + R * (k + 1) + 1) // S)
    tables = (1 + np.arange(B * n_pages, dtype=np.int32)).reshape(B, n_pages)

    def caches(c):
        kv = (c.num_layers, c.num_kv_heads, c.cache_head_dim, B * n_pages + 1, S)
        return jkv.allocate(jkv.KVCacheConfig(*kv)), tkv.allocate(tkv.KVCacheConfig(*kv), "cpu")

    (jtc, ttc), (jdc, tdc) = caches(jcfg), caches(dcfg)
    first = []
    for b, p in enumerate(ps):
        args = (p[None], np.arange(len(p), dtype=np.int32)[None], tables[b:b + 1],
                np.array([len(p)], np.int32))
        jl, jtc = jmr.prefill_step(jt, jtc, *map(jnp.asarray, args), cfg=jcfg, scheme="w4a16")
        tl, _ = tmr.prefill_step(tt, ttc, *map(torch.tensor, args), cfg=tcfg, scheme="w4a16")
        _, jdc = jmr.prefill_step(jd, jdc, *map(jnp.asarray, args), cfg=dcfg, scheme="bf16")
        tmr.prefill_step(td, tdc, *map(torch.tensor, args), cfg=tdcfg, scheme="bf16")
        first.append(int(np.asarray(jl).argmax(-1)[0]))
        assert int(tl.argmax(-1)[0]) == first[-1]
    last, prev = np.array(first, np.int32), np.array([p[-1] for p in ps], np.int32)
    start = np.array([len(p) for p in ps], np.int32)
    jst = JSamplingTensors(jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B), jnp.zeros(B))
    tst = SamplingTensors(torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
                          torch.zeros(B), needs_filter=False)
    common = (last, start, tables)
    jtoks, _, _ = jmr._draft_impl(jd, jdc, *map(jnp.asarray, common), jst,
                                  jax.random.PRNGKey(0), cfg=dcfg, scheme="bf16", k=k,
                                  prev_tokens=jnp.asarray(prev))
    ttoks, _, _ = tmr._draft_impl(td, tkv.PagedKVCache(tdc.kv_pages.clone()),
                                  *map(torch.tensor, common), tst, torch.Generator(),
                                  cfg=tdcfg, scheme="bf16", k=k, prev_tokens=torch.tensor(prev))
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    args = (last, prev, start, tables, tables, np.full(B, budget, np.int32))
    jr = jmr.spec_rounds_step(jt, jdc, jtc, *map(jnp.asarray, args), jnp.asarray(True), jst,
                              jax.random.PRNGKey(0), draft_params=jd, cfg=jcfg,
                              draft_cfg=dcfg, draft_scheme="bf16", verify_scheme="w4a16",
                              k=k, num_rounds=R)
    tr = tmr.spec_rounds_step(tt, tdc, ttc, *map(torch.tensor, args), True, tst,
                              torch.Generator(), cfg=tcfg, draft_cfg=tdcfg, draft_params=td,
                              draft_scheme="bf16", verify_scheme="w4a16", k=k, num_rounds=R)
    assert tr[0].tolist() == np.asarray(jr[0]).tolist()
    accs = np.asarray(jr[1])
    assert tr[1].tolist() == accs.tolist()
    assert {0, 2, k + 1} <= set(accs.ravel().tolist())
    assert (accs.sum(0) == budget).all()
