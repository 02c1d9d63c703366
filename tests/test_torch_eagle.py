"""The port's EAGLE proposer on the CPU: the JAX package's EAGLE tests
(tests/spec_decode/test_eagle.py) on the port, and the port held against
the JAX package on the same numpy inputs: the fused features and the draft
layer, the prefill and rounds steps, and both engines serving the trained
pair of checkpoints/ (induction_lm_v2 quantized by QuaRot with
induction_eagle_v1).

Tolerances: the features and the layer's output rtol / atol 2e-2 (bf16, the
JAX kernel tests'); tokens and accepted lengths equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.engine import model_runner as jmr
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.sampling import SamplingTensors as JSamplingTensors
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu.spec_decode import eagle as jeagle
from qspec_tpu_torch import (LLM, CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine import model_runner as tmr
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.sampling import SamplingTensors
from qspec_tpu_torch.spec_decode import eagle as teagle
from tests.test_torch_quantize_float import INDUCTION, induction_cfg, induction_prompts

EAGLE_NET = INDUCTION.parent / "induction_eagle_v1.npz"
TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The JAX test's setup: the tiny QuaRot model (int8 head) with a random
    EAGLE net (seed 4), made by the JAX package and carried over."""
    jcfg = JModel.tiny(quant="w4")
    jparams = {**jllama.init_params(jcfg, seed=0), "eagle": jeagle.init_eagle_params(jcfg, seed=4)}
    cfg = ModelConfig.tiny(quant="w4")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    sched = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
                 decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    return jcfg, jparams, cfg, params, sched


def run_engine(cfg, params, sched, spec, prompts, max_tokens=20, temp=0.0, num_pages=None):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**sched), speculative=spec),
                    params, num_pages=num_pages, device="cpu")
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


def prompts(n=4, seed=13):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40))))) for _ in range(n)]


def eagle(k, **kw):
    return SpeculativeConfig(num_speculative_tokens=k, method="eagle", **kw)


# ------------------------------------------------ the JAX package's tests

@pytest.mark.parametrize("k,rounds", [(2, 1), (4, 3)])
def test_greedy_eagle_equals_ar(setup, k, rounds):
    _, _, cfg, params, sched = setup
    ps = prompts()
    ar, _ = run_engine(cfg, params, sched, None, ps)
    sp, eng = run_engine(cfg, params, sched, eagle(k, rounds_per_step=rounds), ps)
    assert ar == sp
    m = eng.spec_metrics
    assert m.num_spec_rounds > 0
    assert 0.0 <= m.draft_acceptance_rate <= 1.0
    # each round: one verify forward and k + 1 passes of the draft layer; a
    # prompt chunk one of each
    r = eng.runner
    assert r.draft_forwards - (k + 1) * r.spec_rounds_run == r.target_forwards - r.spec_rounds_run


def test_eagle_multi_chunk_prompts(setup):
    """Prompts spanning several prefill chunks build the draft KV across
    chunk boundaries (the shifted-token pairing at the seams)."""
    _, _, cfg, params, sched = setup
    r = np.random.default_rng(3)
    ps = [list(map(int, r.integers(1, 500, size=150)))]
    ar, _ = run_engine(cfg, params, sched, None, ps, max_tokens=16)
    sp, _ = run_engine(cfg, params, sched, eagle(3), ps, max_tokens=16)
    assert ar == sp


def test_eagle_after_ar_steps_equals_ar(setup):
    """Speculation disabled while the batch holds 3 or more sequences: the
    first steps decode AR without the span bank, so each sequence's seed is
    stale when its rounds start (the one-position span at the pending
    token); the tokens are AR's all the same."""
    _, _, cfg, params, sched = setup
    ps = prompts()
    lens = [4, 8, 16, 20]
    ar, spec = [], []
    for sp, out in ((None, ar), (eagle(3, disable_by_batch_size=3), spec)):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=SchedulerConfig(**sched), speculative=sp),
                        params, device="cpu")
        for p, n in zip(ps, lens):
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True))
        done = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        out += [done[i] for i in range(len(ps))]
    assert spec == ar and [len(t) for t in spec] == lens
    assert eng.runner.spec_rounds_run > 0


def test_eagle_sampling_completes(setup):
    _, _, cfg, params, sched = setup
    sp, eng = run_engine(cfg, params, sched, eagle(3), prompts(3), max_tokens=12, temp=0.8)
    assert all(len(v) <= 12 for v in sp)
    assert eng.spec_metrics.num_emitted_tokens > 0


def test_eagle_requires_net(setup):
    _, _, cfg, params, sched = setup
    bare = {k: v for k, v in params.items() if k != "eagle"}
    with pytest.raises(ValueError, match="eagle"):
        run_engine(cfg, bare, sched, eagle(2), prompts(1))


def test_eagle_save_load_roundtrip(tmp_path, setup):
    _, jparams, cfg, params, _ = setup
    p = str(tmp_path / "eagle.npz")
    teagle.save_eagle(p, params["eagle"])
    loaded = teagle.load_eagle(p, cfg, device="cpu")
    assert sorted(loaded["layers"]) == sorted(params["eagle"]["layers"])
    torch.testing.assert_close(loaded["fc"].float(), params["eagle"]["fc"].float(), atol=2e-2,
                               rtol=0)
    assert teagle.eagle_cfg_for(cfg).num_layers == 1
    # the JAX package reads the port's file, and the port the JAX package's
    want = jeagle.load_eagle(p, JModel.tiny(quant="w4"))
    np.testing.assert_array_equal(np.asarray(want["fc"], np.float32), loaded["fc"].float().numpy())
    jp = str(tmp_path / "jeagle.npz")
    jeagle.save_eagle(jp, jparams["eagle"])
    back = teagle.load_eagle(jp, cfg, device="cpu")
    for name in ("qkv", "o", "gate_up", "down"):
        np.testing.assert_array_equal(back["layers"][name]["w"].float().numpy(),
                                      np.asarray(jparams["eagle"]["layers"][name]["w"],
                                                 np.float16).astype(np.float32))
    np.testing.assert_array_equal(back["rope_cache"].numpy(),
                                  np.asarray(jparams["eagle"]["rope_cache"]))


def test_eagle_preemption_resume(setup):
    """A preempted-and-recomputed sequence rebuilds its draft KV and span
    and still matches the uninterrupted transcript."""
    _, _, cfg, params, _ = setup
    sched = dict(max_num_seqs=2, max_model_len=192, prefill_chunk_size=64,
                 decode_batch_buckets=(2,), prefill_token_buckets=(64,))
    ps = prompts(2, seed=9)
    ref, _ = run_engine(cfg, params, sched, eagle(3), ps, max_tokens=16)
    # 7 pages hold both prompts but not both sequences to the end
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**sched), speculative=eagle(3)),
                    params, num_pages=7, device="cpu")
    preempt, preempted = eng.scheduler._preempt_one, []

    def counted(*a, **kw):
        preempted.append(preempt(*a, **kw))
        return preempted[-1]
    eng.scheduler._preempt_one = counted
    for p in ps:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True))
    got, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                got[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 600
    assert any(preempted)
    assert [got[i] for i in range(len(ps))] == ref


# ------------------------------------------------ against the JAX package

def test_fuse_features_and_layer_step_match_jax(setup):
    """The fused features and the draft layer over a rectangle of features
    at positions 0..Q-1 (its KV written), then one more position against
    that KV, on the same numpy inputs."""
    jcfg, jparams, cfg, params, _ = setup
    rng = np.random.default_rng(5)
    B, Q, S, H = 2, 12, 16, cfg.hidden_size
    emb = rng.standard_normal((B, Q + 1, H)).astype(np.float32)
    hid = rng.standard_normal((B, Q + 1, H)).astype(np.float32)
    want = np.asarray(jeagle.fuse_features(jparams["eagle"], jnp.asarray(emb, jnp.bfloat16),
                                           jnp.asarray(hid, jnp.bfloat16)), np.float32)
    feats = teagle.fuse_features(params["eagle"], torch.tensor(emb).bfloat16(),
                                 torch.tensor(hid).bfloat16())
    assert feats.dtype == torch.bfloat16
    np.testing.assert_allclose(feats.float().numpy(), want, rtol=TOL, atol=TOL)
    jecfg, ecfg = jeagle.eagle_cfg_for(jcfg), teagle.eagle_cfg_for(cfg)
    assert (ecfg.num_layers, ecfg.quant, ecfg.resolved_lm_head_quant) == (1, "none", "bf16")
    tables = np.array([[1, 2], [3, 4]], np.int32)
    jc = jkv.allocate(jkv.KVCacheConfig(1, jcfg.num_kv_heads, jcfg.cache_head_dim, 5, S))
    tc = tkv.allocate(tkv.KVCacheConfig(1, cfg.num_kv_heads, cfg.cache_head_dim, 5, S), "cpu")
    jf = jnp.asarray(want, jnp.bfloat16)
    for sl in (slice(0, Q), slice(Q, Q + 1)):
        pos = np.tile(np.arange(sl.start, sl.stop, dtype=np.int32), (B, 1))
        slot = (np.take_along_axis(tables, pos // S, 1) * S + pos % S).astype(np.int32)
        ctx = np.full(B, sl.stop, np.int32)
        ja, jc = jeagle.eagle_layer_step(jparams["eagle"], jecfg, jc, jf[:, sl], jllama.AttentionBatch(
            jnp.asarray(pos), jnp.asarray(slot), jnp.asarray(tables), jnp.asarray(ctx)))
        ta, tc = teagle.eagle_layer_step(params["eagle"], ecfg, tc, torch.tensor(
            want[:, sl]).bfloat16(), tllama.AttentionBatch(
            torch.tensor(pos), torch.tensor(slot), torch.tensor(tables), torch.tensor(ctx)))
        np.testing.assert_allclose(ta.float().numpy(), np.asarray(ja, np.float32), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(tc.kv_pages.float().numpy(),
                               np.asarray(jc.kv_pages, np.float32), rtol=TOL, atol=TOL)


def test_model_forward_hidden_at_every_position(setup):
    """return_hidden="all" with logits_indices (EAGLE's prefill): the
    hidden state at every position and the logits at the indices, against
    the JAX package's; the logits are those of the gathered form bit for
    bit, and the hidden at the index is its hidden."""
    jcfg, jparams, cfg, params, _ = setup
    rng = np.random.default_rng(8)
    B, Q, S = 2, 24, 16
    toks = rng.integers(1, 500, (B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    slot = (np.take_along_axis(tables, pos // S, 1) * S + pos % S).astype(np.int32)
    ctx = np.array([Q, Q - 5], np.int32)
    idx = ctx - 1
    jb = jllama.AttentionBatch(*map(jnp.asarray, (pos, slot, tables, ctx)))
    jl, jh, _ = jllama.model_forward(
        jparams, jcfg, jnp.asarray(toks), jkv.allocate(jkv.KVCacheConfig(
            jcfg.num_layers, jcfg.num_kv_heads, jcfg.cache_head_dim, 5, S)), jb,
        logits_indices=jnp.asarray(idx), return_hidden="all")
    out = {}
    for mode in ("all", True):
        tb = tllama.AttentionBatch(*map(torch.tensor, (pos, slot, tables, ctx)))
        tc = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                            cfg.cache_head_dim, 5, S), "cpu")
        out[mode] = tllama.model_forward(params, cfg, torch.tensor(toks), tc, tb,
                                         logits_indices=torch.tensor(idx), return_hidden=mode)
    tl, th, _ = out["all"]
    assert th.shape == (B, Q, cfg.hidden_size) and tl.shape == (B, 1, cfg.vocab_size)
    assert torch.equal(tl, out[True][0])
    assert torch.equal(th[torch.arange(B), torch.tensor(idx)], out[True][1][:, 0])
    jl, jh = np.asarray(jl), np.asarray(jh, np.float32)
    assert np.linalg.norm(tl.numpy() - jl) / np.linalg.norm(jl) <= TOL
    assert np.linalg.norm(th.float().numpy() - jh) / np.linalg.norm(jh) <= TOL


def _jax_port_steps(jcfg, jparams, cfg, params, ps, k, R, budget, S=16):
    """Both packages: prefill_eagle_step per prompt (one chunk each) into
    their caches over the same page tables, the first token by argmax, the
    span seeded from the prefill's hidden, then R rounds of
    eagle_rounds_step. Returns each package's (first tokens, tokens,
    accepted, span bank)."""
    B = len(ps)
    n_pages = -(-(max(map(len, ps)) + R * (k + 1) + 1) // S)
    tables = (1 + np.arange(B * n_pages, dtype=np.int32)).reshape(B, n_pages)
    jecfg, ecfg = jeagle.eagle_cfg_for(jcfg), teagle.eagle_cfg_for(cfg)

    def kv(c, layers):
        return (layers, c.num_kv_heads, c.cache_head_dim, B * n_pages + 1, S)
    jtc = jkv.allocate(jkv.KVCacheConfig(*kv(jcfg, jcfg.num_layers)))
    jdc = jkv.allocate(jkv.KVCacheConfig(*kv(jcfg, 1)))
    ttc = tkv.allocate(tkv.KVCacheConfig(*kv(cfg, cfg.num_layers)), "cpu")
    tdc = tkv.allocate(tkv.KVCacheConfig(*kv(cfg, 1)), "cpu")
    H = cfg.hidden_size
    bank = {"j": [np.zeros((B + 1, k + 1, H), np.float32), np.zeros((B + 1, k + 1), np.int32),
                  np.zeros(B + 1, np.int32), np.zeros(B + 1, np.int32)]}
    bank["t"] = [a.copy() for a in bank["j"]]
    first = {"j": [], "t": []}
    for b, p in enumerate(ps):
        Q = len(p)
        args = (p[None], np.concatenate([p[1:], [0]])[None].astype(np.int32),
                np.array([Q - 1], np.int32), np.arange(Q, dtype=np.int32)[None],
                tables[b:b + 1], np.array([Q], np.int32))
        jl, jh, jtc, jdc = jmr.prefill_eagle_step(jparams, jtc, jdc, *map(jnp.asarray, args),
                                                  cfg=jcfg, ecfg=jecfg, scheme="w4a16")
        tl, th, _, _ = tmr.prefill_eagle_step(params, ttc, tdc, *map(torch.tensor, args),
                                              cfg=cfg, ecfg=ecfg, scheme="w4a16")
        for key, logits, h in (("j", np.asarray(jl), np.asarray(jh, np.float32)),
                               ("t", tl.numpy(), th.float().numpy())):
            first[key].append(int(logits.argmax(-1)[0]))
            bank[key][0][b, 0] = h[0]
            bank[key][1][b, 0] = first[key][-1]
            bank[key][2][b], bank[key][3][b] = Q - 1, 1
    rows = np.arange(B, dtype=np.int32)
    jst = JSamplingTensors(jnp.zeros(B), jnp.zeros(B, jnp.int32), jnp.ones(B), jnp.zeros(B))
    tst = SamplingTensors(torch.zeros(B), torch.zeros(B, dtype=torch.int32), torch.ones(B),
                          torch.zeros(B), needs_filter=False)
    jb = bank["j"]
    jr = jmr.eagle_rounds_step(jparams, jdc, jtc, jnp.asarray(jb[0], jnp.bfloat16),
                               *map(jnp.asarray, (*jb[1:], rows, tables,
                                                  np.full(B, budget, np.int32))),
                               jst, jax.random.PRNGKey(0), cfg=jcfg, ecfg=jecfg,
                               scheme="w4a16", k=k, num_rounds=R)
    tb = [torch.tensor(a) for a in bank["t"]]
    tb[0] = tb[0].bfloat16()
    tr = tmr.eagle_rounds_step(params, tdc, ttc, *tb, torch.tensor(rows), torch.tensor(tables),
                               torch.full((B,), budget, dtype=torch.int32), tst,
                               torch.Generator(), cfg=cfg, ecfg=ecfg, scheme="w4a16", k=k,
                               num_rounds=R)
    jbank = [np.asarray(a, np.float32 if i == 0 else None) for i, a in enumerate(jr[4])]
    tbank = [a.float().numpy() if i == 0 else a.numpy() for i, a in enumerate(tb)]
    return ((first["j"], np.asarray(jr[0]), np.asarray(jr[1]), jbank),
            (first["t"], tr[0].numpy(), tr[1].numpy(), tbank))


def test_eagle_steps_match_jax(setup):
    """prefill_eagle_step and eagle_rounds_step on the tiny model with its
    random net (which accepts no draft: one token a round, the last round
    past the budget emitting none): the first tokens, each round's tokens
    and accepted lengths and the span bank's tokens, positions and lengths
    equal the JAX package's, its hidden states within the tolerance."""
    jcfg, jparams, cfg, params, _ = setup
    rng = np.random.default_rng(4)
    ps = [rng.integers(1, 500, size=n).astype(np.int32) for n in (40, 17, 33)]
    k, R, budget = 3, 13, 12
    (jf, jt, ja, jb), (tf, tt, ta, tb) = _jax_port_steps(jcfg, jparams, cfg, params, ps, k, R,
                                                         budget)
    assert tf == jf
    assert tt.tolist() == jt.tolist()
    assert ta.tolist() == ja.tolist()
    assert (ta.sum(0) == budget).all() and (ta[-1] == 0).all()
    for i in (1, 2, 3):
        assert tb[i][:len(ps)].tolist() == jb[i][:len(ps)].tolist()
    np.testing.assert_allclose(tb[0][:len(ps)], jb[0][:len(ps)], rtol=TOL, atol=TOL)


# ------------------------------------------------ options and entry points

def test_eagle_bf16_target_and_refusals(setup):
    """EAGLE on a bf16 (quant='none') Llama target equals AR, and so does it
    on an AWQ (w4g) one; a tree and a draft window are refused, and so is a
    Gemma-2 target, naming ROADMAP queue 1 item 7."""
    _, _, _, _, sched = setup
    cfg = ModelConfig.tiny(quant="none")
    params = {**tllama.init_params(cfg, seed=1, device="cpu"),
              "eagle": teagle.init_eagle_params(cfg, seed=2, device="cpu")}
    ps = prompts(3, seed=21)
    ar, _ = run_engine(cfg, params, sched, None, ps, max_tokens=12)
    sp, eng = run_engine(cfg, params, sched, eagle(3), ps, max_tokens=12)
    assert sp == ar and eng.runner.verify_scheme == "bf16"
    with pytest.raises(ValueError, match="tree"):
        run_engine(cfg, params, sched, eagle(2, medusa_tree=((0,), (0, 0))), ps)
    with pytest.raises(ValueError, match="draft_kv_window"):
        run_engine(cfg, params, sched, eagle(2, draft_kv_window=32), ps)
    w4g = ModelConfig.tiny(quant="w4g")
    gparams = {**tllama.init_params(w4g, seed=1, device="cpu", group_size=64),
               "eagle": params["eagle"]}
    gar, _ = run_engine(w4g, gparams, sched, None, ps, max_tokens=12)
    gsp, geng = run_engine(w4g, gparams, sched, eagle(2), ps, max_tokens=12)
    assert gsp == gar and geng.runner.verify_scheme == "w4a16"
    gemma2 = dataclasses.replace(w4g, arch="gemma2", post_norms=True)
    with pytest.raises(NotImplementedError, match="gemma2.*item 7"):
        run_engine(gemma2, gparams, sched, eagle(2), ps)


def test_llm_entry_points(setup, tmp_path):
    """LLM(speculative_model="[eagle]") with the net in params, and with a
    net's .npz (no w1, no proj_first: EAGLE), give the same tokens as the
    engine; EngineArgs names the method."""
    _, _, cfg, params, sched = setup
    assert EngineArgs(num_speculative_tokens=3, speculative_model="[eagle]"
                      ).create_engine_config().speculative.method == "eagle"
    kw = dict(device="cpu", num_speculative_tokens=3, block_size=16, max_model_len=256,
              max_num_seqs=4, prefill_chunk_size=64, num_pages=48, seed=0)
    ps = prompts(2)
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    a = LLM(model="tiny", params=params, speculative_model="[eagle]", **kw)
    outs = [o.output_token_ids for o in a.generate(ps, sp)]
    assert a.llm_engine.runner.draft_cfg.num_layers == 1
    path = str(tmp_path / "net.npz")
    teagle.save_eagle(path, params["eagle"])
    bare = {k: v for k, v in params.items() if k != "eagle"}
    b = LLM(model="tiny", params=bare, speculative_model=path, **kw)
    assert b.engine_config.speculative.method == "eagle"
    assert [o.output_token_ids for o in b.generate(ps, sp)] == outs
    ar = LLM(model="tiny", params=bare, **{k: v for k, v in kw.items()
                                          if k != "num_speculative_tokens"})
    assert [o.output_token_ids for o in ar.generate(ps, sp)] == outs
    with pytest.raises(ValueError, match="speculative_method"):
        EngineArgs(num_speculative_tokens=3, speculative_model="[eagle]",
                   speculative_method="qspec").create_engine_config()


# ------------------------------------------------ the trained pair

@pytest.fixture(scope="module")
def trained():
    """bench.load_eagle_regime(): induction_lm_v2 quantized by QuaRot
    (each package's quantize_float: the same codes) with the trained
    induction_eagle_v1 net, in both packages."""
    with np.load(INDUCTION.with_suffix(".npz")) as z:
        sd = {k: z[k] for k in z.files}
    jparams, jcfg = jloader.quantize_float(dict(sd), induction_cfg(JModel))
    jparams = {**jparams, "eagle": jeagle.load_eagle(str(EAGLE_NET), jcfg)}
    params, cfg = tloader.quantize_float(sd, induction_cfg(ModelConfig), device="cpu")
    params["eagle"] = teagle.load_eagle(str(EAGLE_NET), cfg, device="cpu")
    return jcfg, jparams, cfg, params


# the trained pair at k = TRAINED_K: drafted, accepted and emitted tokens,
# measured with both packages on the CPU; tests/test_torch_gpu.py holds the
# card to the same counts
TRAINED_K = 4
TRAINED_COUNTS = (112, 96, 124)
TRAINED_SCHED = dict(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                     decode_batch_buckets=(4,), prefill_token_buckets=(128,))


def test_trained_pair_matches_jax_engine(trained):
    """Both engines serve the trained pair greedily on induction prompts:
    the same tokens (== the port's AR) and the same acceptance, which is
    high (the net was trained for this base)."""
    jcfg, jparams, cfg, params = trained
    ps = induction_prompts(4, 128, cfg.vocab_size, seed=13)
    spec = eagle(TRAINED_K, rounds_per_step=2)
    got, eng = run_engine(cfg, params, TRAINED_SCHED, spec, ps, max_tokens=32)
    ar, _ = run_engine(cfg, params, TRAINED_SCHED, None, ps, max_tokens=32)
    assert got == ar
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**TRAINED_SCHED),
                              speculative=JSpec(num_speculative_tokens=TRAINED_K,
                                                method="eagle", rounds_per_step=2)), jparams)
    for p in ps:
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True))
    want = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                want[o.request_id] = o.output_token_ids
    assert got == [want[i] for i in range(len(ps))]
    m, jm = eng.spec_metrics, jeng.spec_metrics
    counts = (m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens)
    assert counts == (jm.num_draft_tokens, jm.num_draft_accepted, jm.num_emitted_tokens)
    assert counts == TRAINED_COUNTS
