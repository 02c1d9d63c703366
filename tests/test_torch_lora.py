"""The port's multi-LoRA serving against the JAX package's, on the CPU.

``lora_delta`` and ``load_peft_adapter`` against the JAX functions; the
forward with a bank against the JAX ``model_forward`` at w4a16, w4a8 and
w4a4 under ``tests/test_torch_model.py``'s tolerances; the engine (slot 0
is the base, a mixed batch routes per row, greedy QSpec == qspec_null with
adapters, tokens == the JAX engine's outside near-ties); the manager's
lifecycle and LRU (``tests/test_lora.py``'s cases on the port's engine);
the refusals where the JAX package drops the adapter; and the QuaRot
basis: a float-basis adapter rotated into ``quantize_float(bits=None)``'s
parameters gives the float model's logits with the adapter.

Weights: the JAX init_params(ModelConfig.tiny(quant="w4", lm_head_quant=
"bf16"), seed 0) carried over with params_from_numpy; adapters are random
PEFT state dicts from numpy seeds.
"""

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
from qspec_tpu.lora import layers as jlora
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.lora import LoRAConfig, init_lora_params, load_peft_adapter, lora_delta
from qspec_tpu_torch.lora.layers import Rotation
from qspec_tpu_torch.lora.manager import LoRASlotError
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from tests.test_torch_model import REL_TOL, TIE_GAP, W4A4_ARGMAX_AGREE
from tests.test_torch_quantize_float import CFG_KW, hf_model, state_dict

# a step where the port's greedy token may differ from the JAX engine's must
# be a near-tie of the JAX logits (tests/test_torch_engine.py)
ENGINE_TIE_GAP = 2e-2
MAX_TOKENS = 12
PROJS = (("self_attn.q_proj", "q"), ("self_attn.k_proj", "kv"), ("self_attn.v_proj", "kv"),
         ("self_attn.o_proj", "o"), ("mlp.gate_proj", "i"), ("mlp.up_proj", "i"),
         ("mlp.down_proj", "d"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def peft_adapter(cfg, seed, scale=0.5, rank=4, projs=PROJS):
    """A PEFT-style state dict over ``projs`` of every layer (lora_A [r, in],
    lora_B [out, r])."""
    rng = np.random.default_rng(seed)
    dims = {"q": (cfg.hidden_size, cfg.q_size), "kv": (cfg.hidden_size, cfg.kv_size),
            "o": (cfg.q_size, cfg.hidden_size),
            "i": (cfg.hidden_size, cfg.intermediate_size),
            "d": (cfg.intermediate_size, cfg.hidden_size)}
    sd = {}
    for li in range(cfg.num_layers):
        for mod, kind in projs:
            i, o = dims[kind]
            pre = f"base_model.model.model.layers.{li}.{mod}"
            sd[pre + ".lora_A.weight"] = (rng.standard_normal((rank, i)) * scale).astype(np.float32)
            sd[pre + ".lora_B.weight"] = (rng.standard_normal((o, rank)) * scale).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def setup():
    """The JAX and the port's tiny models with the same 3-slot bank (slot
    1 and 2 loaded; alpha 8 on slot 2)."""
    jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
    jparams = dict(jllama.init_params(jcfg, seed=0))
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    ads = [peft_adapter(cfg, 1), peft_adapter(cfg, 2, scale=0.3)]
    jparams["lora"] = jlora.init_lora_params(jcfg, jlora.LoRAConfig(3, 16))
    params["lora"] = init_lora_params(cfg, LoRAConfig(3, 16), device="cpu")
    for slot, (sd, alpha) in enumerate(zip(ads, (None, 8.0)), start=1):
        jparams["lora"] = jlora.load_peft_adapter(jparams["lora"], jcfg, slot, sd, alpha=alpha)
        load_peft_adapter(params["lora"], cfg, slot, sd, alpha=alpha)
    r = np.random.default_rng(7)
    prompts = [list(map(int, r.integers(1, 500, size=int(r.integers(5, 40)))))
               for _ in range(4)]
    return jcfg, jparams, cfg, params, prompts


def _sched(**over):
    d = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    d.update(over)
    return d


def port_engine(cfg, params, spec=None, **sched):
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                  scheduler=SchedulerConfig(**_sched(**sched)),
                                  speculative=spec), params, device="cpu")


def run(eng, prompts, lora_ids=None, max_tokens=MAX_TOKENS, **kw):
    ids = [eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                             ignore_eos=True),
                           lora_id=(lora_ids or [0] * len(prompts))[i], **kw)
           for i, p in enumerate(prompts)]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in ids]


# ------------------------------------------------------------- the functions

def test_lora_delta_matches_jax_and_dense(rng):
    n, k, out, r, T = 3, 64, 96, 8, 5
    A = rng.standard_normal((n, k, r)).astype(np.float32)
    B = rng.standard_normal((n, r, out)).astype(np.float32)
    x = rng.standard_normal((T, k)).astype(np.float32)
    ids = np.array([0, 2, 1, 2, 0], np.int32)
    got = lora_delta(torch.tensor(x), torch.tensor(A), torch.tensor(B), torch.tensor(ids)).numpy()
    ref = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                                      jnp.asarray(ids)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    for t in range(T):
        np.testing.assert_allclose(got[t], x[t] @ A[ids[t]] @ B[ids[t]], rtol=1e-5, atol=1e-5)


def test_slot0_delta_is_exactly_zero():
    A = torch.zeros((3, 16, 4), dtype=torch.bfloat16)
    A[1] = 1.0
    B = torch.ones((3, 4, 8), dtype=torch.bfloat16)
    x = torch.randn(4, 16).to(torch.bfloat16)
    d = lora_delta(x, A, B, torch.tensor([0, 1, 0, 1]))
    assert torch.equal(d[0::2], torch.zeros_like(d[0::2])) and d[1::2].abs().sum() > 0


@pytest.mark.parametrize("alpha", [None, 16.0])
def test_load_peft_adapter_matches_jax(setup, alpha):
    """The bank equals the JAX package's bit for bit: q / k / v (and gate /
    up) in disjoint rank stripes, alpha / r folded into B, the projections
    an adapter lacks (here k, v and up) zero."""
    jcfg, _, cfg, _, _ = setup
    sd = peft_adapter(cfg, 5, projs=(PROJS[0], PROJS[3], PROJS[4], PROJS[6]))
    jbank = jlora.load_peft_adapter(jlora.init_lora_params(jcfg, jlora.LoRAConfig(3, 16)),
                                    jcfg, 2, sd, alpha=alpha)
    bank = load_peft_adapter(init_lora_params(cfg, LoRAConfig(3, 16), device="cpu"), cfg, 2,
                             sd, alpha=alpha)
    for t in ("qkv", "o", "gate_up", "down"):
        for ab in ("A", "B"):
            want = np.asarray(jbank["layers"][t][ab].astype(jnp.float32))
            got = bank["layers"][t][ab].float().numpy()
            np.testing.assert_array_equal(got, want)
            assert np.abs(got[:, 2]).sum() > 0 and not got[:, [0, 1]].any()


def test_load_peft_adapter_rank_overflow_raises(setup):
    _, _, cfg, _, _ = setup
    with pytest.raises(ValueError, match="max_rank"):
        load_peft_adapter(init_lora_params(cfg, LoRAConfig(2, 4), device="cpu"), cfg, 1,
                          peft_adapter(cfg, 3, rank=3))


# --------------------------------------------------------------- the forward

def _forward_both(setup, scheme, lora_ids, S=16, P=10):
    """A prefill rectangle and a verify-shaped step through both packages
    with a bank; the logits of each call."""
    jcfg, jparams, cfg, params, _ = setup
    rng = np.random.default_rng(11)
    B, Q = len(lora_ids), 12
    tables = np.arange(1, 1 + 3 * B, dtype=np.int32).reshape(B, 3)
    steps = [(rng.integers(1, 512, size=(B, Q)), np.tile(np.arange(Q), (B, 1))),
             (rng.integers(1, 512, size=(B, 4)), Q + np.tile(np.arange(4), (B, 1)))]
    jc = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                        jcfg.cache_head_dim, P, S))
    tc = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                        cfg.cache_head_dim, P, S), "cpu")
    ids = np.asarray(lora_ids, np.int32)
    out = []
    for toks, pos in steps:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        ctx = pos[:, -1] + 1
        slot = np.take_along_axis(tables, pos // S, axis=1) * S + pos % S
        jb = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(slot), jnp.asarray(tables),
                                   jnp.asarray(ctx))
        tb = tllama.AttentionBatch(torch.tensor(pos), torch.tensor(slot), torch.tensor(tables),
                                   torch.tensor(ctx))
        jl, jc = jllama.model_forward(jparams, jcfg, jnp.asarray(toks), jc, jb, scheme=scheme,
                                      lora_ids=jnp.asarray(ids))
        tl, tc = tllama.model_forward(params, cfg, torch.tensor(toks), tc, tb, scheme=scheme,
                                      lora_ids=torch.tensor(ids))
        out.append((np.asarray(jl), tl.numpy()))
    return out


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8", "w4a4"])
def test_model_forward_with_bank_matches_jax(setup, scheme):
    for jl, tl in _forward_both(setup, scheme, [0, 1, 2]):
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel
        pick = tl.argmax(-1)
        if scheme == "w4a4":
            assert (pick == jl.argmax(-1)).mean() >= W4A4_ARGMAX_AGREE
        else:
            gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
            assert gap.max() <= TIE_GAP[scheme], gap.max()


def test_bank_row_of_slot0_is_the_base_bit_for_bit(setup):
    """A row of slot 0 in a batch with adapters gives the logits of the
    model without a bank, bit for bit; an adapter's row differs."""
    _, _, cfg, params, _ = setup
    base = {k: v for k, v in params.items() if k != "lora"}
    S, B, Q = 16, 2, 8
    toks = torch.tensor(np.random.default_rng(3).integers(1, 512, size=(B, Q)), dtype=torch.int32)
    pos = torch.arange(Q, dtype=torch.int32)[None].repeat(B, 1)
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    batch = tllama.AttentionBatch(pos, pos + tables * S, tables,
                                  torch.full((B,), Q, dtype=torch.int32))

    def logits(p, ids):
        cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, 4, S), "cpu")
        return tllama.model_forward(p, cfg, toks, cache, batch, scheme="w4a16",
                                    lora_ids=ids)[0]
    ref = logits(base, None)
    got = logits(params, torch.tensor([0, 1]))
    assert torch.equal(got[0], ref[0]) and not torch.equal(got[1], ref[1])


# ---------------------------------------------------------------- the engine

def test_slot0_matches_base_and_mixed_batch_routes(setup):
    _, _, cfg, params, prompts = setup
    base = {k: v for k, v in params.items() if k != "lora"}
    p = prompts[1]
    ref = run(port_engine(cfg, base), [p, p])
    outs = run(port_engine(cfg, params), [p, p, p, p], [0, 1, 2, 1])
    assert outs[0] == ref[0] and outs[1] == outs[3]
    assert outs[1] != outs[0] and outs[2] != outs[0], "an adapter had no effect"
    # each adapter alone gives its mixed-batch row's tokens
    assert run(port_engine(cfg, params), [p], [2]) == [outs[2]]


@pytest.mark.parametrize("scheme", ["w4a4", "w4a8"])
def test_greedy_qspec_with_adapters_equals_oracle(setup, scheme):
    _, _, cfg, params, prompts = setup
    ids = [0, 1, 2, 1]

    def spec(method):
        return SpeculativeConfig(num_speculative_tokens=3, draft_scheme=scheme, method=method)
    eng = port_engine(cfg, params, spec("qspec"))
    got = run(eng, prompts, ids)
    assert got == run(port_engine(cfg, params, spec("qspec_null")), prompts, ids)
    assert got == run(port_engine(cfg, params), prompts, ids)        # plain AR
    assert eng.spec_metrics.num_spec_rounds > 0


def _jax_last_logits(jcfg, jparams, ids, lora_id):
    S, Q = 16, len(ids)
    n = -(-Q // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, n + 1, S))
    pos = np.arange(Q, dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S),
                                  jnp.asarray(np.arange(1, n + 1, dtype=np.int32)[None]),
                                  jnp.asarray([Q], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32), cache,
                                     batch, scheme="w4a16",
                                     lora_ids=jnp.asarray([lora_id], jnp.int32))
    return np.asarray(logits[0, -1])


def test_tokens_match_jax_engine_with_adapters(setup):
    """The JAX engine (AR) and the port's QSpec (W4A8 draft), each request
    under its adapter: equal greedy tokens but at a near-tie of the JAX
    logits."""
    jcfg, jparams, cfg, params, prompts = setup
    ids = [1, 0, 2, 1]
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**_sched())), jparams)
    for p, lid in zip(prompts, ids):
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                            ignore_eos=True), lora_id=lid)
    jout = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                jout[o.request_id] = o.output_token_ids
    port = run(port_engine(cfg, params, SpeculativeConfig(num_speculative_tokens=3,
                                                          draft_scheme="w4a8")), prompts, ids)
    for i, p in enumerate(prompts):
        diff = [j for j, (a, b) in enumerate(zip(jout[i], port[i])) if a != b]
        if diff:
            top2 = np.sort(_jax_last_logits(jcfg, jparams, p + jout[i][:diff[0]], ids[i]))[-2:]
            assert top2[1] - top2[0] < ENGINE_TIE_GAP, (i, diff[0], top2)


def test_adapter_requests_bypass_the_prefix_cache(setup):
    """A prompt of several full pages served first with no adapter, then
    under adapter 1 on the same engine: the adapter's tokens are those of a
    fresh engine (its KV is not the base's cached pages)."""
    _, _, cfg, params, _ = setup
    p = list(map(int, np.random.default_rng(4).integers(1, 500, size=50)))
    eng = port_engine(cfg, params)
    run(eng, [p])
    assert run(eng, [p], [1]) == run(port_engine(cfg, params), [p], [1])


def test_separate_draft_model_runs_no_adapter(setup):
    """A separate draft model drafts without the adapter (as in the JAX
    package); the verify applies it, so greedy output is the AR oracle's."""
    _, _, cfg, params, prompts = setup
    dcfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16", num_layers=1)
    dparams = tllama.init_params(dcfg, seed=3, device="cpu")
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched()),
                                 speculative=SpeculativeConfig(num_speculative_tokens=2,
                                                               draft_model=dcfg)),
                    params, device="cpu", draft_params=dparams)
    assert run(eng, prompts[:2], [1, 2]) == run(port_engine(cfg, params), prompts[:2], [1, 2])


@pytest.mark.parametrize("method", ["ngram", "medusa", "eagle"])
def test_rounds_without_adapters_refuse_them(setup, method):
    """Where the JAX package drops the ids (its n-gram, Medusa and EAGLE
    rounds), a request with an adapter is refused; without one it runs."""
    from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
    from qspec_tpu_torch.spec_decode.medusa import init_medusa_params
    _, _, cfg, params, prompts = setup
    extra = {"medusa": {"medusa": init_medusa_params(cfg.hidden_size, cfg.vocab_size, 3,
                                                     device="cpu")},
             "eagle": {"eagle": init_eagle_params(cfg, seed=0, device="cpu")},
             "ngram": {}}[method]
    eng = port_engine(cfg, {**params, **extra},
                      SpeculativeConfig(num_speculative_tokens=2, method=method))
    with pytest.raises(ValueError, match="adapter"):
        eng.add_request(prompts[0], SamplingParams(max_tokens=2), lora_id=1)
    assert len(run(eng, prompts[:1], max_tokens=3)[0]) == 3


def test_lora_refusals(setup):
    _, _, cfg, params, prompts = setup
    base = {k: v for k, v in params.items() if k != "lora"}
    with pytest.raises(ValueError, match="no adapter bank"):
        port_engine(cfg, base).add_request(prompts[0], lora_id=1)
    with pytest.raises(ValueError, match="slots 1..2"):
        port_engine(cfg, params).add_request(prompts[0], lora_id=3)
    moe = ModelConfig.tiny(quant="w4", num_experts=4, num_experts_per_tok=2)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        init_lora_params(moe, LoRAConfig(), device="cpu")


# ------------------------------------ tests/test_lora.py's lifecycle cases

def _fresh(setup, bank=True):
    _, _, cfg, params, _ = setup
    p = {k: v for k, v in params.items() if k != "lora"}
    if bank:
        p["lora"] = init_lora_params(cfg, LoRAConfig(3, 16), device="cpu")
    return cfg, port_engine(cfg, p)


def test_dynamic_load_unload_roundtrip(setup):
    cfg, eng = _fresh(setup)
    prompt = setup[4][0]
    base_out = run(eng, [prompt])[0]
    slot = eng.lora.load("ad1", peft_adapter(cfg, 8))
    assert slot == 1 and [a["name"] for a in eng.lora.list_adapters()] == ["ad1"]
    ad_out = run(eng, [prompt], lora_name="ad1")[0]
    assert ad_out != base_out, "adapter had no effect"
    eng.lora.unload("ad1")
    assert eng.lora.list_adapters() == []
    with pytest.raises(LoRASlotError):
        eng.lora.slot_of("ad1")
    # the slot is zeroed: a request that still names it gets the base
    assert run(eng, [prompt], [slot])[0] == base_out


def test_dynamic_lru_eviction_and_reload(setup):
    cfg, eng = _fresh(setup)
    s1 = eng.lora.load("a", peft_adapter(cfg, 9))
    s2 = eng.lora.load("b", peft_adapter(cfg, 10))
    assert {s1, s2} == {1, 2}
    eng.lora.slot_of("a")           # "b" is now the least recently used
    s3 = eng.lora.load("c", peft_adapter(cfg, 11))
    assert s3 == s2 and {a["name"] for a in eng.lora.list_adapters()} == {"a", "c"}
    assert eng.lora.load("a", peft_adapter(cfg, 12)) == s1


def test_dynamic_never_evicts_a_held_slot(setup):
    """A queued request's adapter is neither evicted nor unloaded."""
    cfg, eng = _fresh(setup)
    eng.lora.load("a", peft_adapter(cfg, 9))
    eng.lora.load("b", peft_adapter(cfg, 10))
    eng.lora.slot_of("b")
    eng.add_request(setup[4][0], SamplingParams(max_tokens=2), lora_name="a")
    eng.add_request(setup[4][1], SamplingParams(max_tokens=2), lora_name="b")
    with pytest.raises(LoRASlotError, match="held"):
        eng.lora.load("c", peft_adapter(cfg, 11))
    with pytest.raises(LoRASlotError, match="held"):
        eng.lora.unload("a")


def test_dynamic_requires_bank(setup):
    _, eng = _fresh(setup, bank=False)
    with pytest.raises(LoRASlotError):
        eng.lora.list_adapters()


@pytest.mark.parametrize("fmt", ["safetensors", "npz"])
def test_load_path_peft_directory(setup, tmp_path, fmt):
    """A PEFT directory: adapter_model.safetensors (through the port's own
    reader) or .npz, lora_alpha from adapter_config.json; the same bank as
    ``load`` with that alpha."""
    import json

    from safetensors.numpy import save_file
    cfg, eng = _fresh(setup)
    sd = peft_adapter(cfg, 13)
    if fmt == "npz":
        np.savez(tmp_path / "adapter_model.npz", **sd)
    else:
        save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"lora_alpha": 8, "r": 4}))
    slot = eng.lora.load_path("dir", str(tmp_path))
    bank = eng.runner.params["lora"]["layers"]
    want = load_peft_adapter(init_lora_params(cfg, LoRAConfig(3, 16), device="cpu"), cfg, slot,
                             sd, alpha=8)["layers"]
    for t in bank:
        assert torch.equal(bank[t]["B"], want[t]["B"]) and torch.equal(bank[t]["A"], want[t]["A"])


# ------------------------------------------------------------ the QuaRot basis

# relative L2 errors of the logits against Hugging Face's float model with
# the adapter merged into its weights, on the CPU: the port's bf16 forward
# of the float checkpoint with the adapter as trained gave 0.025, the
# rotated model with the rotated adapter 0.020 (bf16 products, rounded
# differently); the two ports' logits 0.032 apart. The adapter installed
# unrotated on the rotated model gave 1.41.
MERGED_REL_TOL = 3e-2
PORTS_REL_TOL = 5e-2


def test_rotated_adapter_on_quantize_float_matches_float_model(rng):
    """quantize_float(bits=None) (the rotation without quantization) with
    the adapter rotated by its recorded basis gives Hugging Face's logits
    with the adapter merged into the weights (alpha / r = 2), as
    load_hf_float with the adapter as trained does; the adapter installed
    unrotated does not."""
    hf = hf_model()
    cfg = ModelConfig(**CFG_KW)
    sd_ad = peft_adapter(cfg, 21, scale=0.15)
    rot, rcfg = tloader.quantize_float(state_dict(hf), cfg, bits=None, device="cpu")
    flt, fcfg = tloader.load_hf_float(state_dict(hf), cfg, device="cpu")
    assert set(rot["quarot"]) == {"seed", "input_norm", "post_norm"}
    for p, c, rotation in ((rot, rcfg, Rotation(rcfg, rot["quarot"], "cpu")), (flt, fcfg, None)):
        p["lora"] = init_lora_params(c, LoRAConfig(3, 16), device="cpu")
        load_peft_adapter(p["lora"], c, 1, sd_ad, alpha=8.0, rotation=rotation)
        load_peft_adapter(p["lora"], c, 2, sd_ad, alpha=8.0)       # unrotated
    tokens = rng.integers(1, 256, size=12).astype(np.int32)

    def logits(p, c, slot, scheme):
        T, S = len(tokens), 16
        P = -(-T // S) + 2
        cache = tkv.allocate(tkv.KVCacheConfig(c.num_layers, c.num_kv_heads,
                                               c.cache_head_dim, P, S), "cpu")
        pos = torch.arange(T)[None]
        batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                      torch.tensor([T], dtype=torch.int32))
        return tllama.model_forward(p, c, torch.tensor(tokens)[None], cache, batch,
                                    scheme=scheme, lora_ids=torch.tensor([slot]))[0][0].numpy()

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    # Hugging Face with W + (alpha / r) B A in every adapted projection
    with torch.no_grad():
        for li, layer in enumerate(hf.model.layers):
            for mod, _ in PROJS:
                pre = f"base_model.model.model.layers.{li}.{mod}"
                layer.get_submodule(mod).weight += 2.0 * torch.tensor(
                    sd_ad[pre + ".lora_B.weight"] @ sd_ad[pre + ".lora_A.weight"])
        merged = hf(torch.tensor(tokens[None].astype(np.int64))).logits[0].numpy()
    got, ref = logits(rot, rcfg, 1, "w4a16"), logits(flt, fcfg, 1, "bf16")
    assert rel(got, merged) < MERGED_REL_TOL and rel(ref, merged) < MERGED_REL_TOL
    assert rel(got, ref) < PORTS_REL_TOL
    assert (merged.argmax(-1) == got.argmax(-1)).mean() >= 0.9
    assert rel(logits(rot, rcfg, 2, "w4a16"), merged) > 10 * MERGED_REL_TOL
