"""Multi-head latent attention (DeepSeek-V2 / V2-Lite / V3, MiniCPM3) on the
CPU, the port against the JAX package and against ``transformers`` 4.57.6.

- The attention at the latent head dims 384 (MiniCPM3's 288 K lanes and 256
  V lanes) and 640 (DeepSeek's 576 / 512), each cache type, query groups
  4 / 1 and 16 / 1, B = 2, Q = 1, 4 and a prefill rectangle of 24, page 16,
  contexts up to 64: the port's plain version over the lanes the kernel
  reads against the JAX package's plain version over every lane, and at
  Q = 4 against its Pallas kernel in interpret mode too (the JAX attention
  tests' tolerances: rtol = atol 3e-2 over bf16, 4e-2 over int8 /
  fp8_e4m3, 8e-2 over fp8_e5m2).
- One ``_mla_attention`` layer, direct q and q-LoRA, on the JAX package's
  converted parameters carried over by ``params_from_numpy``: the block's
  output within rtol = atol 1e-2 of the JAX one (bf16 outputs of f32 sums
  taken in another order), the latent rows written to the cache within one
  bf16 step.
- ``model_forward``: (a) V2 direct q, (b) V2 q-LoRA at head dim 640,
  (c) V2's MoE with routed_scaling_factor 1.5 and a dense first layer,
  (d) V3's noaux_tc with a non-zero selection bias, (e) MiniCPM3 with its
  muP scales at head dim 384: the port's converter gives the JAX
  converter's tree bit for bit, the logits within 1e-2 of the JAX ones
  (bf16 activations between the same ops, f32 sums in another order, so a
  bf16 step here and there: measured 9e-4 to 3.2e-3 on logits of largest
  |x| 0.5-0.8) with the argmax equal wherever JAX's top two are 2e-2
  apart; (a)-(d)
  also within 0.12 of the logit scale of ``transformers`` with the argmax
  on at least 0.9 of the rows (``tests/models/test_deepseek_v2.py``'s
  bound).
- The engine: greedy n-gram (k = 3) == greedy AR through ``LLMEngine``,
  bit for bit, over the latent cache, and the same tokens as the JAX
  engine's greedy AR on the same weights; ``LLM(model=<dir>,
  quantization=None)`` on a DeepSeek-V2, a DeepSeek-V3 and a MiniCPM3
  directory.
- The cache geometry of each family as the JAX package's, every refusal,
  the attention plan at the latent shapes, and MiniCPM3's longrope against
  ``transformers``' initializer.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from qspec_tpu.config import CacheConfig as JCacheConfig
from qspec_tpu.config import EngineConfig as JEngineConfig
from qspec_tpu.config import SchedulerConfig as JSchedulerConfig
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.model_loader import families as jfam
from qspec_tpu.models import llama as jllama
from qspec_tpu.models import registry as jregistry
from qspec_tpu.ops import attention as jattn
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.config import (DEEPSEEK_V2_LITE_HF, DEEPSEEK_V3_HF, MINICPM3_4B_HF,
                                    CacheConfig, EngineConfig, ModelConfig, SchedulerConfig,
                                    SpeculativeConfig)
from qspec_tpu_torch.engine.llm_engine import LLMEngine
from qspec_tpu_torch.lora.layers import LoRAConfig, init_lora_params
from qspec_tpu_torch.model_loader import families as tfam
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.attention import paged_attention, tree_mask
from qspec_tpu_torch.ops.attention_cuda import attention_plan
from qspec_tpu_torch.ops.rotary import make_rope_cache
from tests.test_torch_moe_hf import assert_same_tree

KV = ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"]
ATTN_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}
# stored head dim -> (K lanes r + dr, V lanes r, qk_nope + qk_rope): MiniCPM3's
# latent in 384, DeepSeek's in 640
LATENT = {384: (288, 256, 96), 640: (576, 512, 192)}
TOKENS = list(range(2, 14))
# port against JAX: the logits' max difference, and the JAX top-two margin
# past which the argmax must agree (twice the difference: neither logit of
# the pair can move further)
JAX_TOL = 1e-2
TIE = 2 * JAX_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a jax array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j, np.float32)).to(torch.bfloat16)


def np32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


# ------------------------------------------------------- the latent attention

def latent_caches(rng, kv_dtype, D, T=64, S=16, P=6):
    """One latent cache per package (one layer, one KV head), filled by
    update_layer with MLA's rows: K = [c, 0...] over the K lanes, V = [c[:r],
    0...]."""
    dk, dv, _ = LATENT[D]
    lat = rng.standard_normal((T, 1, dk)).astype(np.float32)
    k = np.zeros((T, 1, D), np.float32)
    v = np.zeros((T, 1, D), np.float32)
    k[..., :dk] = lat
    v[..., :dv] = lat[..., :dv]
    slots = np.arange(T, dtype=np.int32) + S
    jc = jkv.allocate(jkv.KVCacheConfig(1, 1, D, P, S, kv_dtype))
    tc = tkv.allocate(tkv.KVCacheConfig(1, 1, D, P, S, kv_dtype), "cpu")
    kj, kt = bf16_pair(k)
    vj, vt = bf16_pair(v)
    jc = jkv.update_layer(jc, 0, kj, vj, jnp.asarray(slots))
    tkv.update_layer(tc, 0, kt, vt, torch.tensor(slots))
    return jc, tc


@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("D", [384, 640])
def test_update_layer_writes_v_as_k_lanes(rng, D, kv_dtype):
    """What the MLA kernel's V read relies on: both packages' update_layer,
    given MLA's rows (K = [c_kv, k_pe, 0...], V = [c_kv, 0...]), store V's
    first r lanes bit for bit as K's over bf16 and fp8_e5m2 (a cast with no
    scale), and not over int8 and fp8_e4m3, whose per-row absmax scale
    differs between a K row (it also holds k_pe) and its V row. The two
    packages store the same bytes."""
    jc, tc = latent_caches(rng, kv_dtype, D)
    dv = LATENT[D][1]
    jpages = np.asarray(jc.kv_pages.astype(jnp.float32))[0]          # [P, 2, 1, S, D]
    tpages = tc.kv_pages[0].to(torch.float32).numpy()
    np.testing.assert_array_equal(jpages, tpages)
    for pages in (jpages, tpages):
        k_lanes, v_lanes = pages[1:, 0, 0, :, :dv], pages[1:, 1, 0, :, :dv]
        same = np.array_equal(k_lanes, v_lanes)
        assert same == (kv_dtype in ("bfloat16", "fp8_e5m2")), kv_dtype
    if tc.kv_scales is not None:
        np.testing.assert_array_equal(np.asarray(jc.kv_scales)[0], tc.kv_scales[0].numpy())
        assert not np.array_equal(tc.kv_scales[0, 1:, 0].numpy(), tc.kv_scales[0, 1:, 1].numpy())


@pytest.mark.parametrize("Hq", [4, 16])
@pytest.mark.parametrize("kv_dtype", KV)
@pytest.mark.parametrize("D", [384, 640])
def test_latent_attention_matches_jax(rng, D, kv_dtype, Hq):
    """The plain version over the K and V lanes (the kernel's function)
    against the JAX package over every lane, one latent KV row under Hq
    query heads: its paged_attention_ref at Q = 1, 4 and 24, and its Pallas
    kernel in interpret mode at the verify's Q = 4 (the slow one, once a
    case); the output zero past the V lanes."""
    jc, tc = latent_caches(rng, kv_dtype, D)
    dk, dv, dqk = LATENT[D]
    tables = np.array([[1, 2, 3, 4], [1, 2, 3, 4]], np.int32)
    tol = ATTN_TOL[kv_dtype]
    for Q in (1, 4, 24):
        q = np.zeros((2, Q, Hq, D), np.float32)
        q[..., :dk] = rng.standard_normal((2, Q, Hq, dk))
        qj, qt = bf16_pair(q)
        ctx = np.array([Q + 5, 64], np.int32)
        out = paged_attention(qt, tc, 0, torch.tensor(tables), torch.tensor(ctx), dqk ** -0.5,
                              lanes=(dk, dv))
        assert out.shape == (2, Q, Hq, D) and torch.count_nonzero(out[..., dv:]) == 0
        refs = [jattn.paged_attention_ref(qj, jc, 0, jnp.asarray(tables), jnp.asarray(ctx),
                                          dqk ** -0.5)]
        if Q == 4:
            refs.append(paged_attention_pallas(qj, jc.kv_pages, jnp.asarray(tables),
                                               jnp.asarray(ctx), dqk ** -0.5,
                                               kv_scales=jc.kv_scales))
        for ref in refs:
            np.testing.assert_allclose(np32(out), np32(ref), atol=tol, rtol=tol)


# ------------------------------------------------------------- the models

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0, rms_norm_eps=1e-6, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, attention_bias=False,
            tie_word_embeddings=False, first_k_dense_replace=99, n_routed_experts=None,
            q_lora_rank=None)
V3 = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, n_group=2,
          topk_group=1, routed_scaling_factor=2.0, kv_lora_rank=32, q_lora_rank=48,
          qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, first_k_dense_replace=1,
          norm_topk_prob=True, max_position_embeddings=128, rope_theta=10000.0,
          rope_scaling=None, scoring_func="sigmoid", topk_method="noaux_tc",
          attention_bias=False)
# (transformers class, its config): (a)-(d); (e) is MiniCPM3 in DeepSeek-V2's
# keys (no transformers class: remote code), read by the MiniCPM3 registry entry
CASES = {
    "a_v2_direct_q": ("DeepseekV2", BASE),
    "b_v2_q_lora_d640": ("DeepseekV2", {**BASE, "q_lora_rank": 48, "kv_lora_rank": 512,
                                        "qk_rope_head_dim": 16}),
    "c_v2_moe_scaled": ("DeepseekV2", {**BASE, "n_routed_experts": 4, "num_experts_per_tok": 2,
                                       "moe_intermediate_size": 64, "n_shared_experts": 1,
                                       "first_k_dense_replace": 1, "norm_topk_prob": True,
                                       "routed_scaling_factor": 1.5}),
    "d_v3_noaux_tc": ("DeepseekV3", V3),
    "e_minicpm3_d384": ("DeepseekV2", {**BASE, "num_attention_heads": 4,
                                       "num_key_value_heads": 4, "q_lora_rank": 48,
                                       "kv_lora_rank": 256, "qk_nope_head_dim": 16,
                                       "qk_rope_head_dim": 16, "v_head_dim": 16,
                                       "tie_word_embeddings": True}),
}
MINICPM3 = dict(architectures=["MiniCPM3ForCausalLM"], model_type="minicpm3", vocab_size=256,
                hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, q_lora_rank=48,
                kv_lora_rank=256, qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
                scale_emb=12.0, scale_depth=1.4, dim_model_base=32, tie_word_embeddings=True)


@pytest.fixture(scope="module")
def models():
    """name -> (transformers model, config.json dict, numpy state dict):
    norm gammas 1 + 0.1 N(0, 1), V3's selection bias U(-0.5, 0.5)."""
    out = {}
    for i, (name, (kind, kw)) in enumerate(CASES.items()):
        conf_cls = getattr(transformers, f"{kind}Config")
        model_cls = getattr(transformers, f"{kind}ForCausalLM")
        torch.manual_seed(i)
        hf = model_cls(conf_cls(**kw)).eval()
        with torch.no_grad():
            for n, p in hf.named_parameters():
                if "norm" in n:
                    p.copy_(1 + 0.1 * torch.randn_like(p))
            for n, b in hf.named_buffers():
                if n.endswith("e_score_correction_bias"):
                    b.uniform_(-0.5, 0.5)
        hf_dict = ({**MINICPM3} if name.startswith("e_") else
                   {**hf.config.to_dict(), "architectures": [model_cls.__name__]})
        sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
        if name.startswith("e_"):
            sd.pop("lm_head.weight", None)     # MiniCPM3 ties its head
        out[name] = (hf, hf_dict, sd)
    return out


def port_load(sd: dict, hf_dict: dict):
    cfg = tregistry.resolve(hf_dict)
    return tfam.load_family_float({k: torch.tensor(v) for k, v in sd.items()}, cfg,
                                  device="cpu")


def jax_load(sd: dict, hf_dict: dict):
    return jfam.load_family_float(dict(sd), jregistry.resolve(hf_dict))


def port_logits(params, cfg, tokens=TOKENS) -> np.ndarray:
    T, S = len(tokens), 16
    P = -(-T // S) + 2
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.cache_kv_heads,
                                           cfg.cache_head_dim, P, S), "cpu")
    pos = torch.arange(T)[None]
    batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                  torch.tensor([T], dtype=torch.int32))
    logits, _ = tllama.model_forward(params, cfg, torch.tensor(tokens)[None], cache, batch,
                                     scheme="bf16")
    return logits[0].numpy()


def jax_logits(jparams, jcfg, tokens=TOKENS) -> np.ndarray:
    T, S = len(tokens), 16
    P = -(-T // S) + 2
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.cache_kv_heads,
                                           jcfg.cache_head_dim, P, S))
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    batch = jllama.AttentionBatch(pos, pos + S, jnp.arange(1, P, dtype=jnp.int32)[None],
                                  jnp.asarray([T], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray(np.asarray(tokens)[None]),
                                     cache, batch, scheme="bf16")
    return np.asarray(logits[0], np.float32)


def assert_close_to_jax(got, ref):
    assert np.abs(got - ref).max() <= JAX_TOL, np.abs(got - ref).max()
    top2 = np.sort(ref, axis=-1)
    clear = (top2[:, -1] - top2[:, -2]) > TIE
    assert (got.argmax(-1) == ref.argmax(-1))[clear].all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_forward_matches_jax_and_hf(models, name):
    """The port's converter gives the JAX converter's tree bit for bit (the
    rope cache within 1e-6); the port's logits the JAX model_forward's
    (JAX_TOL, argmax equal past TIE) and, through params_from_numpy, the
    JAX tree gives the port's logits; (a)-(d) against transformers at
    tests/models/test_deepseek_v2.py's bound."""
    hf, hf_dict, sd = models[name]
    params, cfg = port_load(sd, hf_dict)
    jparams, jcfg = jax_load(sd, hf_dict)
    assert cfg.attention_type == jcfg.attention_type == "mla" and cfg.quant == "none"
    assert (cfg.cache_kv_heads, cfg.cache_head_dim) == (jcfg.cache_kv_heads,
                                                        jcfg.cache_head_dim)
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "rope_cache"})
    assert set(jparams) == set(params)
    np.testing.assert_allclose(params["rope_cache"].numpy(), np.asarray(jparams["rope_cache"]),
                               atol=1e-6)
    got = port_logits(params, cfg)
    assert_close_to_jax(got, jax_logits(jparams, jcfg))
    carried = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                       device="cpu")
    np.testing.assert_allclose(port_logits(carried, cfg), got, atol=1e-6)
    if name.startswith("e_"):
        assert (cfg.embed_scale, cfg.logits_scaling) == (12.0, 2.0)
        assert cfg.residual_multiplier == pytest.approx(1.4 / 2 ** 0.5)
        assert cfg.cache_head_dim == 384
        return
    with torch.no_grad():
        want = hf(torch.tensor([TOKENS])).logits[0].float().numpy()
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() < 0.12 * scale, (np.abs(got - want).max(), scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def layer_inputs(cfg, T=12, S=16, P=4):
    pos = np.arange(T, dtype=np.int32)[None]
    tables = np.arange(1, P, dtype=np.int32)[None]
    return pos, pos + S, tables, np.array([T], np.int32)


@pytest.mark.parametrize("name", ["a_v2_direct_q", "b_v2_q_lora_d640"])
def test_mla_attention_layer_matches_jax(models, rng, name):
    """One _mla_attention block of layer 0 on the same normed input: the
    port's on the JAX tree carried over by params_from_numpy against
    qspec_tpu.models.llama._mla_attention."""
    _, hf_dict, sd = models[name]
    jparams, jcfg = jax_load(sd, hf_dict)
    cfg = dataclasses.replace(tregistry.resolve(hf_dict), quant="none")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    T, S, P = 12, 16, 4
    xj, xt = bf16_pair(rng.standard_normal((T, cfg.hidden_size)).astype(np.float32))
    pos, slots, tables, ctx = layer_inputs(cfg, T, S, P)
    jc = jkv.allocate(jkv.KVCacheConfig(1, 1, cfg.cache_head_dim, P, S))
    tc = tkv.allocate(tkv.KVCacheConfig(1, 1, cfg.cache_head_dim, P, S), "cpu")
    jb = jllama.AttentionBatch(*(jnp.asarray(a) for a in (pos, slots, tables, ctx)))
    tb = tllama.AttentionBatch(*(torch.tensor(a) for a in (pos, slots, tables, ctx)))
    want, jc = jllama._mla_attention(xj, jparams["layers"], 0, jcfg, jc, 0, jb,
                                     jparams["rope_cache"])
    got = tllama._mla_attention(xt, params["layers"], 0, 0, cfg, tc, tb, params["rope_cache"])
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-2, atol=1e-2)
    # the latent rows: bf16 values a step apart at most
    np.testing.assert_allclose(np32(tc.kv_pages), np32(jc.kv_pages), rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------- the engine

def engine_prompts():
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(2, 250, size=n))) for n in (9, 14)]
    ps[1] = ps[1][:5] * 3
    return ps


def port_run(params, cfg, method):
    spec = None if method is None else SpeculativeConfig(num_speculative_tokens=3,
                                                         method=method)
    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_pages=32),
        scheduler=SchedulerConfig(max_num_seqs=2, max_model_len=64, prefill_chunk_size=32,
                                  decode_batch_buckets=(2,), prefill_token_buckets=(32,)),
        speculative=spec), params, device="cpu", seed=0)
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in engine_prompts()]
    done = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                done[o.request_id] = o.output_token_ids
    return [done[i] for i in ids], eng


def jax_run(jparams, jcfg):
    eng = JLLMEngine(JEngineConfig(
        model=jcfg, cache=JCacheConfig(page_size=16, num_pages=32),
        scheduler=JSchedulerConfig(max_num_seqs=2, max_model_len=64, prefill_chunk_size=32,
                                   decode_batch_buckets=(2,), prefill_token_buckets=(32,))),
        jparams)
    sp = JSamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in engine_prompts()]
    done = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                done[o.request_id] = list(o.output_token_ids)
    return [done[i] for i in ids]


@pytest.mark.parametrize("name", ["a_v2_direct_q", "e_minicpm3_d384"])
def test_engine_ngram_equals_ar_and_jax(models, name):
    """Greedy n-gram (k = 3) == greedy AR through LLMEngine, bit for bit,
    over the latent cache, with drafts accepted; AR's tokens == the JAX
    engine's greedy AR tokens on the same weights."""
    _, hf_dict, sd = models[name]
    params, cfg = port_load(sd, hf_dict)
    ar, _ = port_run(params, cfg, None)
    ngram, eng = port_run(params, cfg, "ngram")
    assert ngram == ar and all(len(t) == 10 for t in ar)
    assert eng.spec_metrics.num_draft_accepted > 0
    assert ar == jax_run(*jax_load(sd, hf_dict))


@pytest.mark.parametrize("name", ["c_v2_moe_scaled", "d_v3_noaux_tc", "e_minicpm3_d384"])
def test_llm_dir_serves_in_bf16(models, name, tmp_path):
    """LLM(model=<dir>, quantization=None) on a DeepSeek-V2 (MoE), a
    DeepSeek-V3 and a MiniCPM3 directory: convert_deepseek_v2 at load,
    greedy n-gram == the state dict's AR tokens; the default quantization
    raises before a weight is read."""
    _, hf_dict, sd = models[name]
    save_file({k: torch.tensor(v) for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_dict))
    with pytest.raises(NotImplementedError, match="bf16"):
        LLM(model=str(tmp_path), device="cpu", max_model_len=64)
    llm = LLM(model=str(tmp_path), quantization=None, num_speculative_tokens=3,
              speculative_model="[ngram]", device="cpu", block_size=16, max_model_len=64,
              max_num_seqs=2, prefill_chunk_size=32)
    params, cfg = port_load(sd, hf_dict)
    assert llm.engine_config.model == cfg
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    got = [o.output_token_ids for o in llm.generate(engine_prompts(), sp)]
    assert got == port_run(params, cfg, None)[0]


# ------------------------------------------------- geometry and refusals

PUBLISHED = {"deepseek-v2-lite": DEEPSEEK_V2_LITE_HF, "deepseek-v3": DEEPSEEK_V3_HF,
             "minicpm3-4b": MINICPM3_4B_HF}
GEOMETRY = {"deepseek-v2-lite": 640, "deepseek-v3": 640, "minicpm3-4b": 384}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_configs_resolve_like_jax(name):
    """Each published config (its rope_scaling left out: yarn, which both
    packages refuse, and MiniCPM3's longrope, which the JAX registry drops)
    resolves field for field as in the JAX registry, by its architecture and
    by its bare model type, to one latent KV head of the JAX package's
    stored width."""
    hf = PUBLISHED[name]
    jcfg, tcfg = jregistry.resolve(hf), tregistry.resolve(hf)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name, f.name)
    assert (tcfg.cache_kv_heads, tcfg.cache_head_dim) == (1, GEOMETRY[name])
    assert (jcfg.cache_kv_heads, jcfg.cache_head_dim) == (1, GEOMETRY[name])
    bare = {k: v for k, v in hf.items() if k != "architectures"}
    assert tregistry.resolve(bare) == tcfg


def test_refusals(models):
    """Every refusal raises naming its reason: yarn and group-limited routing
    (both packages), another V3 topk_method; MLA under any quantization but
    bf16, a window, a softcap or ALiBi; the Medusa tree in model_forward;
    Medusa, MLPSpeculator and EAGLE on an MLA target; a LoRA bank or adapter
    on an MLA model."""
    hf = DEEPSEEK_V2_LITE_HF
    for bad, match in ((dict(rope_scaling={"type": "yarn", "factor": 40}), "yarn"),
                       (dict(topk_method="group_limited_greedy"), "group-limited")):
        for resolve in (jregistry.resolve, tregistry.resolve):
            with pytest.raises(ValueError, match=match):
                resolve({**hf, **bad})
    with pytest.raises(ValueError, match="topk_method"):
        tregistry.resolve({**DEEPSEEK_V3_HF, "topk_method": "group_limited_greedy"})
    _, hf_dict, sd = models["a_v2_direct_q"]
    params, cfg = port_load(sd, hf_dict)
    for quant in ("w4", "w4g", "w8"):
        with pytest.raises(NotImplementedError, match="bf16"):
            tllama.check_served(dataclasses.replace(cfg, quant=quant))
    for over, match in ((dict(sliding_window=16), "window"),
                        (dict(attn_logit_softcap=50.0), "softcap"),
                        (dict(position_embedding="alibi"), "ALiBi")):
        with pytest.raises(NotImplementedError, match=match):
            tllama.check_served(dataclasses.replace(cfg, **over))
    T, S, P = 12, 16, 4
    pos = torch.arange(T)[None]
    batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                  torch.tensor([T], dtype=torch.int32))
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, 1, cfg.cache_head_dim, P, S), "cpu")
    with pytest.raises(NotImplementedError, match="tree"):
        tllama.model_forward(params, cfg, torch.tensor(TOKENS)[None], cache, batch,
                             scheme="bf16", tree=tree_mask(1, [[True]], "cpu"))
    for method in ("medusa", "mlp_speculator", "eagle"):
        with pytest.raises(NotImplementedError, match="latent attention"):
            LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=16),
                                   scheduler=SchedulerConfig(max_num_seqs=2, max_model_len=64),
                                   speculative=SpeculativeConfig(method=method)),
                      params, device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        init_lora_params(cfg, LoRAConfig(max_loras=2, max_rank=4), device="cpu")
    lora = {"lora": {"layers": {}}}
    with pytest.raises(NotImplementedError, match="LoRA"):
        tllama.model_forward({**params, **lora}, cfg, torch.tensor(TOKENS)[None], cache, batch,
                             scheme="bf16", lora_ids=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="MLA"):
        ModelConfig(attention_type="mla", head_dim=100)


def test_attention_plan_at_latent_shapes():
    """The split plan at the latent shapes over a 4096-token block table (S =
    128, 32 pages): splits of 128 tokens (the other head dims' 256), 32 of
    them; a block takes 64 rows. One split a block while the row tiles x B
    leave SMs idle and that workspace (the states of G rows of D + 2 floats a
    split) stays within 256 MB:
    DeepSeek-V2-Lite's verify (G = 64: 1 tile, grid (1, 32, 4), 4 * 32 * 64
    * 642 floats, 21 MB), DeepSeek-V3's (G = 512: 8 tiles, 32 blocks, grid (8,
    32, 4), 4 * 32 * 512 * 642 floats, 168 MB), MiniCPM3's decode and verify
    (G = 40, 160: 1 and 3 tiles, 4 * 32 * G * 386). DeepSeek-V2-Lite's Q = 64
    prefill rectangle (16 tiles x 4 = 64 blocks, but 336 MB of states) and
    DeepSeek-V3's (G = 8192: 128 tiles x 4 = 512 blocks, over 132) take
    every split in one block, the workspace their slabs of 64 rows x 512 V
    lanes."""
    pps, S = 32, 128
    lite = attention_plan(4, 4, 16, 1, 640, S, pps)
    assert (lite.split, lite.n_splits, lite.splits_per_block, lite.grid, lite.ws_floats) == (
        128, 32, 1, (1, 32, 4), 4 * 32 * 64 * 642)
    v3 = attention_plan(4, 4, 128, 1, 640, S, pps)
    assert (v3.splits_per_block, v3.grid, v3.ws_floats) == (1, (8, 32, 4), 4 * 32 * 512 * 642)
    for q_len in (1, 4):
        cpm = attention_plan(4, q_len, 40, 1, 384, S, pps)
        G = 40 * q_len
        assert (cpm.split, cpm.splits_per_block, cpm.grid, cpm.ws_floats) == (
            128, 1, (-(-G // 64), 32, 4), 4 * 32 * G * 386)
    lite_pre = attention_plan(4, 64, 16, 1, 640, S, pps)
    assert (lite_pre.splits_per_block, lite_pre.grid, lite_pre.ws_floats) == (
        32, (16, 1, 4), 4 * 16 * 64 * 512)
    pre = attention_plan(4, 64, 128, 1, 640, S, pps)
    assert (pre.splits_per_block, pre.grid, pre.ws_floats) == (32, (128, 1, 4),
                                                                4 * 128 * 64 * 512)
    assert attention_plan(4, 4, 32, 8, 128, S, pps).split == 256


def test_minicpm3_longrope_against_transformers():
    """MiniCPM3-4B's longrope (its published shape: 16 short and 16 long
    factors over the 32 rope dims, original window 32768 = its
    max_position_embeddings; the factors made from a seed, as the published
    arrays are not in the repository) read by the port's MiniCPM3 entry:
    the rope cache at the rope width equals cos / sin of transformers'
    longrope inverse frequencies times its attention factor (within 1e-6
    plus the angle's share of their float32 rounding, t * f * 2 ** -24);
    the JAX registry drops the scaling."""
    rs = _seeded_longrope()
    hf = {**MINICPM3_4B_HF, "rope_scaling": rs}
    cfg = tregistry.resolve(hf)
    assert cfg.rope_scaling == rs and jregistry.resolve(hf).rope_scaling is None
    cache = make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings, cfg.rope_theta,
                            rope_scaling=cfg.rope_scaling)
    conf = SimpleNamespace(rope_theta=cfg.rope_theta, head_dim=cfg.rope_dim,
                           hidden_size=cfg.hidden_size, num_attention_heads=cfg.num_heads,
                           max_position_embeddings=cfg.max_position_embeddings,
                           original_max_position_embeddings=rs[
                               "original_max_position_embeddings"],
                           rope_scaling=rs)
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS
    inv_freq, factor = ROPE_INIT_FUNCTIONS["longrope"](conf, "cpu")
    t = torch.tensor([0, 1, 7, 1000, 20000, 32767], dtype=torch.float64)
    freqs = t[:, None] * inv_freq.double()[None]
    # transformers keeps its inverse frequencies in float32: their rounding
    # moves the angle t * f by up to t * f * 2 ** -24, and so cos and sin
    tol = (1e-6 + freqs * 2.0 ** -24).numpy()
    for got, want in ((cache[0], freqs.cos()), (cache[1], freqs.sin())):
        err = np.abs(got[t.long()].double().numpy() - (want * factor).numpy())
        assert (err <= tol).all(), (err - tol).max()
    with pytest.raises(AssertionError):
        plain = make_rope_cache(cfg.rope_dim, cfg.max_position_embeddings, cfg.rope_theta)
        np.testing.assert_allclose(plain[0][t.long()].numpy(), cache[0][t.long()].numpy(),
                                   atol=1e-3)


def _seeded_longrope() -> dict:
    r = np.random.default_rng(11)
    short = (1.0 + r.uniform(0.0, 2.0, 16)).round(4).tolist()
    return {"type": "longrope", "short_factor": short,
            "long_factor": [round(4 * s, 4) for s in short],
            "original_max_position_embeddings": 32768}
