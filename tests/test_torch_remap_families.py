"""The llama graph under other key names (Baichuan, InternLM2, Qwen v1,
EXAONE, TeleChat2) against the JAX package, on the CPU.

Each family's tiny checkpoint is a ``transformers`` Llama (hidden 128, 2
layers, 4 query heads over 2 KV heads, or 4 over 4 where the family is
multi-head, intermediate 224 = 28 * 8; norm gammas away from 1) written
in the family's own keys: Baichuan's fused ``W_pack``, InternLM2's
``attention.wqkv`` interleaved per KV group, Qwen v1's ``attn.c_attn`` with
its bias and its swapped ``w1`` / ``w2``, EXAONE's GPT names, TeleChat2's
``key_value`` fused per head with the o / down biases. For each family:

- the port's remap gives the JAX remap's tensors, equal value for value,
  and the source Llama's;
- its config.json resolves to the JAX registry's fields, but for the
  documented readings (ROADMAP §3);
- ``load_hf_float`` gives the JAX ``load_family_float``'s arrays bit for bit
  and its bf16 logits within the dense-family tests' tolerance;
- ``quantize_float`` gives the JAX one's int4 codes within
  ``CODE_DIFF_SHARE`` (TeleChat2's rotated o / down biases beside);
- in the port, greedy QSpec at W4A4 and W4A8 equals AR token for token.

Then one test for each place the port departs from the JAX package, and
the entry points (``LLM(model=<dir>)``, the server) on an InternLM2
directory.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from qspec_tpu.model_loader import families as jfam
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import llama as jllama
from qspec_tpu.models import registry as jregistry
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.config import (CacheConfig, EngineConfig, SchedulerConfig,
                                    SpeculativeConfig)
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.model_loader import families as tfam
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops import rotary as trotary
from tests.test_torch_dense_families import KW, generate, prompts
from tests.test_torch_moe_hf import assert_quantized_tree_like_jax, assert_same_tree
from tests.test_torch_quantize_float import CODE_DIFF_SHARE

H, I, L, NH, V = 128, 224, 2, 4, 256
DH = H // NH
# family -> (KV heads, config.json in the family's own field names)
FAMILIES = {
    "baichuan": (NH, dict(architectures=["BaiChuanForCausalLM"], model_type="baichuan",
                          hidden_size=H, intermediate_size=I, num_attention_heads=NH,
                          num_hidden_layers=L, vocab_size=V, rms_norm_eps=1e-6,
                          max_position_embeddings=128)),
    "internlm2": (2, dict(architectures=["InternLM2ForCausalLM"], model_type="internlm2",
                          hidden_size=H, intermediate_size=I, num_attention_heads=NH,
                          num_key_value_heads=2, num_hidden_layers=L, vocab_size=V,
                          rms_norm_eps=1e-5, rope_theta=1000000, bias=False,
                          rope_scaling={"type": "dynamic", "factor": 2.0},
                          max_position_embeddings=128, tie_word_embeddings=False)),
    "qwen": (NH, dict(architectures=["QWenLMHeadModel"], model_type="qwen", hidden_size=H,
                      intermediate_size=2 * I, num_attention_heads=NH, num_hidden_layers=L,
                      vocab_size=V, kv_channels=DH, layer_norm_epsilon=1e-6,
                      rotary_emb_base=10000, rotary_pct=1.0, seq_length=128,
                      max_position_embeddings=128, use_dynamic_ntk=True, use_logn_attn=True,
                      no_bias=True, tie_word_embeddings=False)),
    "exaone": (2, dict(architectures=["ExaoneForCausalLM"], model_type="exaone", hidden_size=H,
                       intermediate_size=I, num_attention_heads=NH, num_key_value_heads=2,
                       num_layers=L, vocab_size=V, layer_norm_epsilon=1e-5,
                       rope_theta=500000.0, max_position_embeddings=128,
                       activation_function="silu", tie_word_embeddings=False)),
    "telechat2": (NH, dict(architectures=["TeleChat2ForCausalLM"], model_type="telechat",
                           hidden_size=H, ffn_hidden_size=I, n_head=NH, n_layer=L,
                           vocab_size=V, layer_norm_epsilon=1e-5, seq_length=128,
                           tie_word_embeddings=False)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def llama_sd(family: str, seed: int = 0) -> dict:
    """The tiny Llama (the family's KV heads) as numpy float32, its norm
    gammas 1 + 0.1 N(0, 1); TeleChat2's also o / down biases."""
    nkv, _ = FAMILIES[family]
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H, intermediate_size=I, num_hidden_layers=L,
        num_attention_heads=NH, num_key_value_heads=nkv, max_position_embeddings=128,
        tie_word_embeddings=False))
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    r = np.random.default_rng(seed)
    for k in sd:
        if k.endswith("norm.weight"):
            sd[k] = (1 + 0.1 * r.standard_normal(sd[k].shape)).astype(np.float32)
    if family == "qwen":
        for li in range(L):
            for n, w in (("q", H), ("k", H), ("v", H)):
                sd[f"model.layers.{li}.self_attn.{n}_proj.bias"] = \
                    (0.05 * r.standard_normal(w)).astype(np.float32)
    if family == "telechat2":
        for li in range(L):
            for k in ("self_attn.o_proj.bias", "mlp.down_proj.bias"):
                sd[f"model.layers.{li}.{k}"] = (0.05 * r.standard_normal(H)).astype(np.float32)
    return sd


def family_sd(family: str, sd: dict) -> dict:
    """The llama-keyed ``sd`` in the family's own keys (numpy)."""
    nkv = FAMILIES[family][0]
    out = {}
    for li in range(L):
        s = f"model.layers.{li}."
        q, k, v = (sd[s + f"self_attn.{n}_proj.weight"] for n in "qkv")
        if family == "baichuan":
            out[s + "self_attn.W_pack.weight"] = np.concatenate([q, k, v])
            for n in ("self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
                      "input_layernorm", "post_attention_layernorm"):
                out[s + n + ".weight"] = sd[s + n + ".weight"]
        elif family == "internlm2":
            g = NH // nkv
            out[s + "attention.wqkv.weight"] = np.concatenate(
                [q.reshape(nkv, g, DH, H), k.reshape(nkv, 1, DH, H),
                 v.reshape(nkv, 1, DH, H)], axis=1).reshape(-1, H)
            for a, b in (("attention.wo", "self_attn.o_proj"), ("feed_forward.w1", "mlp.gate_proj"),
                         ("feed_forward.w3", "mlp.up_proj"), ("feed_forward.w2", "mlp.down_proj"),
                         ("attention_norm", "input_layernorm"),
                         ("ffn_norm", "post_attention_layernorm")):
                out[s + a + ".weight"] = sd[s + b + ".weight"]
        else:
            p = f"transformer.h.{li}."
            names = {
                "qwen": (("attn.c_proj", "self_attn.o_proj"), ("mlp.w2", "mlp.gate_proj"),
                         ("mlp.w1", "mlp.up_proj"), ("mlp.c_proj", "mlp.down_proj"),
                         ("ln_1", "input_layernorm"), ("ln_2", "post_attention_layernorm")),
                "exaone": (("attn.attention.q_proj", "self_attn.q_proj"),
                           ("attn.attention.k_proj", "self_attn.k_proj"),
                           ("attn.attention.v_proj", "self_attn.v_proj"),
                           ("attn.attention.out_proj", "self_attn.o_proj"),
                           ("mlp.c_fc_0", "mlp.gate_proj"), ("mlp.c_fc_1", "mlp.up_proj"),
                           ("mlp.c_proj", "mlp.down_proj"), ("ln_1", "input_layernorm"),
                           ("ln_2", "post_attention_layernorm")),
                "telechat2": (("self_attention.query", "self_attn.q_proj"),
                              ("self_attention.dense", "self_attn.o_proj"),
                              ("mlp.gate_proj", "mlp.gate_proj"), ("mlp.up_proj", "mlp.up_proj"),
                              ("mlp.down_proj", "mlp.down_proj"),
                              ("input_layernorm", "input_layernorm"),
                              ("post_attention_layernorm", "post_attention_layernorm")),
            }[family]
            for a, b in names:
                out[p + a + ".weight"] = sd[s + b + ".weight"]
                if s + b + ".bias" in sd:
                    out[p + a + ".bias"] = sd[s + b + ".bias"]
            if family == "qwen":
                out[p + "attn.c_attn.weight"] = np.concatenate([q, k, v])
                out[p + "attn.c_attn.bias"] = np.concatenate(
                    [sd[s + f"self_attn.{n}_proj.bias"] for n in "qkv"])
            if family == "telechat2":
                out[p + "self_attention.key_value.weight"] = np.stack(
                    [k.reshape(nkv, DH, H), v.reshape(nkv, DH, H)], axis=1).reshape(-1, H)
    top = {"baichuan": ("model.embed_tokens", "model.norm", "lm_head"),
           "internlm2": ("model.tok_embeddings", "model.norm", "output"),
           "qwen": ("transformer.wte", "transformer.ln_f", "lm_head"),
           "exaone": ("transformer.wte", "transformer.ln_f", "lm_head"),
           "telechat2": ("transformer.word_embeddings", "transformer.ln_f", "lm_head")}[family]
    for a, b in zip(top, ("model.embed_tokens", "model.norm", "lm_head")):
        out[a + ".weight"] = sd[b + ".weight"]
    return out


def cfgs(family: str, **over):
    hf = {**FAMILIES[family][1], **over}
    return jregistry.resolve(hf), tregistry.resolve(hf)


def torch_sd(sd: dict) -> dict:
    return {k: torch.tensor(v) for k, v in sd.items()}


# ------------------------------------------------------------- the remaps


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remap_equals_jax(family):
    """The port's remap (in place, on tensors) gives the JAX remap's
    tensors, and the source Llama's; the family's keys are all consumed."""
    jcfg, tcfg = cfgs(family)
    src = llama_sd(family)
    fsd = family_sd(family, src)
    want = jfam.LLAMA_KEY_REMAPS[family](dict(fsd), jcfg)
    got = torch_sd(fsd)
    assert tfam.LLAMA_KEY_REMAPS[family](got, tcfg) is got
    assert set(got) == set(want) == set(src), set(got) ^ set(src)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), src[k], err_msg=k)


# where the port reads a config otherwise than the JAX registry: the field
# and the port's value (the window of a dynamic NTK rope; Qwen v1's
# use_dynamic_ntk and use_logn_attn recorded as one, its seq_length)
DEVIATIONS = {
    "internlm2": {"rope_scaling": {"type": "dynamic", "factor": 2.0,
                                   "original_max_position_embeddings": 128}},
    "qwen": {"rope_scaling": {"type": "dynamic", "original_max_position_embeddings": 128}},
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_registry_resolves_like_jax(family):
    jcfg, tcfg = cfgs(family)
    assert tcfg.arch == family and tcfg.position_embedding == "rope"
    dev = DEVIATIONS.get(family, {})
    for f in dataclasses.fields(tcfg):
        if f.name in dev:
            assert getattr(tcfg, f.name) == dev[f.name], f.name
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.scaling_window == (128 if family in DEVIATIONS else None)
    # by the bare model type too, as the JAX registry takes it
    bare = {**FAMILIES[family][1], "architectures": [family]}
    assert tregistry.resolve(bare) == tcfg


# ------------------------------------------------------------- the loaders


def jax_bf16_logits(jparams, jcfg, tokens) -> np.ndarray:
    """The JAX model_forward's bf16 logits of one prompt."""
    T, S = len(tokens), 16
    P = -(-T // S) + 2
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, P, S))
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    batch = jllama.AttentionBatch(pos, pos + S, jnp.arange(1, P, dtype=jnp.int32)[None],
                                  jnp.asarray([T], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray(np.asarray(tokens)[None]),
                                     cache, batch, scheme="bf16")
    return np.asarray(logits[0], np.float32)


def assert_logits_close(got, ref):
    """The dense-family tests' tolerance (tests/test_torch_dense_families.py)."""
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(got - got.max(-1, keepdims=True),
                               ref - ref.max(-1, keepdims=True), atol=0.35)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_hf_float_matches_jax(family):
    from tests.test_torch_moe_hf import port_logits
    jcfg, tcfg = cfgs(family)
    fsd = family_sd(family, llama_sd(family))
    params, cfg = tloader.load_hf_float(torch_sd(fsd), tcfg, device="cpu")
    jparams, jq = jfam.load_family_float(dict(fsd), jcfg)
    assert cfg.quant == "none" and cfg.arch == family
    skip = {"rope_cache"}
    assert_same_tree({k: v for k, v in jparams.items() if k not in skip},
                     {k: v for k, v in params.items() if k not in skip})
    if family == "telechat2":
        assert "b" in params["layers"]["o"] and "b" in params["layers"]["down"]
    tokens = np.random.default_rng(3).integers(1, V, size=24)
    assert_logits_close(port_logits(params, cfg, tokens), jax_bf16_logits(jparams, jq, tokens))


@functools.lru_cache(maxsize=None)
def quantized_both(family: str):
    jcfg, tcfg = cfgs(family)
    fsd = family_sd(family, llama_sd(family))
    jp, _ = jloader.quantize_float(dict(fsd), jcfg)
    tp, tq = tloader.quantize_float(torch_sd(fsd), tcfg, device="cpu")
    return jax.tree_util.tree_map(np.asarray, jp), tp, tq


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_float_matches_jax(family):
    """The int4 codes within CODE_DIFF_SHARE of the JAX quantize_float's
    (which remaps the same way), the scales at rtol 1e-5; TeleChat2's o /
    down biases, which the JAX one drops, are the port's own: b Q."""
    jp, tp, tq = quantized_both(family)
    assert tq.quant == "w4" and tq.arch == family
    layers = dict(tp["layers"])
    if family == "telechat2":
        for name in ("o", "down"):
            assert "b" not in jp["layers"][name]
            layers[name] = {k: v for k, v in layers[name].items() if k != "b"}
    counts = [0, 0]
    for key, got in (("layers", layers), ("embed", tp["embed"]), ("lm_head", tp["lm_head"])):
        assert_quantized_tree_like_jax(jp[key], got, counts, key + ".")
    assert counts[0] <= CODE_DIFF_SHARE * counts[1], counts


def run_engine(params, cfg, method, scheme="w4a4", k=3):
    from qspec_tpu_torch.engine.llm_engine import LLMEngine
    spec = (None if method is None
            else SpeculativeConfig(num_speculative_tokens=k, method=method, draft_scheme=scheme))
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=40),
                                 scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=128,
                                                           prefill_chunk_size=64),
                                 speculative=spec), params, device="cpu", seed=0)
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in prompts(V)]
    done = {}
    while eng.has_unfinished_requests():
        for out in eng.step():
            if out.finished:
                done[out.request_id] = out.output_token_ids
    return [done[i] for i in ids], eng


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_qspec_equals_ar(family):
    """Greedy QSpec (k = 3) with the W4A4 and the W4A8 draft gives AR's
    tokens, bit for bit, on the quantized remap family."""
    _, tp, tq = quantized_both(family)
    ar, _ = run_engine(tp, tq, None)
    for scheme in ("w4a4", "w4a8"):
        got, eng = run_engine(tp, tq, "qspec", scheme)
        assert got == ar, (scheme, got, ar)
        assert eng.runner.draft_forwards > 0


# ------------------------------------------------- departures from the JAX package


def test_baichuan_arch_string_picks_rope_or_alibi():
    """BaichuanForCausalLM is Baichuan2-7B (rope) at hidden 4096 and
    Baichuan-13B / Baichuan2-13B (ALiBi) otherwise, as vLLM's baichuan.py
    picks; the JAX registry gives every BaichuanForCausalLM ALiBi.
    BaiChuanForCausalLM (Baichuan-7B) is rope in both."""
    base = dict(model_type="baichuan", intermediate_size=I, num_hidden_layers=L,
                vocab_size=V, max_position_embeddings=128)
    for arch, hidden, port in (("BaichuanForCausalLM", 4096, "rope"),
                               ("BaichuanForCausalLM", 5120, "alibi"),
                               ("BaiChuanForCausalLM", 4096, "rope")):
        hf = {**base, "architectures": [arch], "hidden_size": hidden,
              "num_attention_heads": hidden // 128}
        assert tregistry.resolve(hf).position_embedding == port, (arch, hidden)
        # the choice is the architecture's and the width's, no config.json key's
        assert tregistry.resolve({**hf, "_alibi": True}).position_embedding == port
        want = "alibi" if arch == "BaichuanForCausalLM" else "rope"
        assert jregistry.resolve(hf).position_embedding == want


def test_baichuan_alibi_bf16_matches_jax_and_refuses_quarot():
    """A Baichuan-13B-like checkpoint (BaichuanForCausalLM at hidden 128:
    ALiBi in both packages) in bf16: load_hf_float's tree and logits against
    the JAX load_family_float's; under QuaRot the ALiBi graph raises."""
    from tests.test_torch_moe_hf import port_logits
    hf = {**FAMILIES["baichuan"][1], "architectures": ["BaichuanForCausalLM"]}
    jcfg, tcfg = jregistry.resolve(hf), tregistry.resolve(hf)
    assert tcfg.position_embedding == jcfg.position_embedding == "alibi"
    fsd = family_sd("baichuan", llama_sd("baichuan"))
    params, cfg = tloader.load_hf_float(torch_sd(fsd), tcfg, device="cpu")
    jparams, jq = jfam.load_family_float(dict(fsd), jcfg)
    assert "rope_cache" not in params and params["alibi_slopes"].shape == (NH,)
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "alibi_slopes"})
    tokens = np.random.default_rng(4).integers(1, V, size=24)
    assert_logits_close(port_logits(params, cfg, tokens), jax_bf16_logits(jparams, jq, tokens))
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tloader.quantize_float(torch_sd(fsd), tcfg, device="cpu")


def test_baichuan2_head_rows_are_unit_norm():
    """Baichuan2 (vocab 125696) normalizes its head's rows (NormHead), as
    its modeling code and vLLM do: the remapped head's rows have norm 1 (in
    float32), the bf16 head's within bf16's rounding; the JAX remap leaves
    them as they are. Baichuan's other vocabularies are not touched."""
    vocab = tfam.BAICHUAN2_VOCAB
    hf = {**FAMILIES["baichuan"][1], "vocab_size": vocab, "hidden_size": 64,
          "intermediate_size": 128, "num_hidden_layers": 1,
          "architectures": ["BaichuanForCausalLM"]}
    hf_4096 = {**hf, "hidden_size": 4096}
    tcfg = dataclasses.replace(tregistry.resolve(hf_4096), hidden_size=64,
                               intermediate_size=128, head_dim=16)
    assert tcfg.position_embedding == "rope"
    r = np.random.default_rng(6)
    sd = {"model.layers.0.self_attn.W_pack.weight": r.standard_normal((192, 64)),
          "model.layers.0.self_attn.o_proj.weight": r.standard_normal((64, 64)),
          "model.layers.0.mlp.gate_proj.weight": r.standard_normal((128, 64)),
          "model.layers.0.mlp.up_proj.weight": r.standard_normal((128, 64)),
          "model.layers.0.mlp.down_proj.weight": r.standard_normal((64, 128)),
          "model.layers.0.input_layernorm.weight": np.ones(64),
          "model.layers.0.post_attention_layernorm.weight": np.ones(64),
          "model.embed_tokens.weight": r.standard_normal((vocab, 64)),
          "model.norm.weight": np.ones(64),
          "lm_head.weight": 0.3 * r.standard_normal((vocab, 64))}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    remapped = tfam.baichuan_to_llama_keys(torch_sd(sd), tcfg)
    np.testing.assert_allclose(remapped["lm_head.weight"].norm(dim=1).numpy(), 1.0, atol=1e-6)
    jcfg = dataclasses.replace(jregistry.resolve(hf_4096), hidden_size=64,
                               intermediate_size=128, head_dim=16)
    jhead = jfam.baichuan_to_llama_keys(dict(sd), jcfg)["lm_head.weight"]
    assert np.abs(np.linalg.norm(jhead, axis=1) - 1).max() > 0.5
    params, _ = tloader.load_hf_float(torch_sd(sd), tcfg, device="cpu")
    np.testing.assert_allclose(params["lm_head"].float().norm(dim=0).numpy(), 1.0, atol=1e-2)
    other = tfam.baichuan_to_llama_keys(torch_sd(sd), dataclasses.replace(tcfg, vocab_size=64000))
    np.testing.assert_array_equal(other["lm_head.weight"].numpy(), sd["lm_head.weight"])


def test_telechat2_rotation_keeps_the_o_down_biases():
    """quantize_float(bits=None), the rotation without quantization, gives
    load_hf_float's logits within bf16 rounding: the o / down biases ride
    into the rotated basis (b Q). The JAX rotation drops them, and its
    logits leave the bf16 model's."""
    from tests.test_torch_moe_hf import port_logits
    jcfg, tcfg = cfgs("telechat2")
    fsd = family_sd("telechat2", llama_sd("telechat2"))
    ref_p, ref_cfg = tloader.load_hf_float(torch_sd(fsd), tcfg, device="cpu")
    rot_p, rot_cfg = tloader.quantize_float(torch_sd(fsd), tcfg, bits=None, device="cpu")
    assert "b" in rot_p["layers"]["o"] and "b" in rot_p["layers"]["down"]
    tokens = np.random.default_rng(7).integers(1, V, size=24)
    ref = port_logits(ref_p, ref_cfg, tokens)

    def logits(params, cfg, scheme):
        from tests.test_torch_moe_hf import tkv, tllama
        T, S = len(tokens), 16
        P = -(-T // S) + 2
        cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, P, S), "cpu")
        pos = torch.arange(T)[None]
        batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                      torch.tensor([T], dtype=torch.int32))
        out, _ = tllama.model_forward(params, cfg, torch.tensor(tokens)[None], cache, batch,
                                      scheme=scheme)
        return out[0].numpy()

    got = logits(rot_p, rot_cfg, "w4a16")
    np.testing.assert_allclose(got, ref, atol=0.08)
    jp, jq = jloader.quantize_float(dict(fsd), jcfg, bits=None)
    T, S = len(tokens), 16
    P = -(-T // S) + 2
    cache = jkv.allocate(jkv.KVCacheConfig(L, NH, jq.cache_head_dim, P, S))
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    batch = jllama.AttentionBatch(pos, pos + S, jnp.arange(1, P, dtype=jnp.int32)[None],
                                  jnp.asarray([T], jnp.int32))
    jl, _ = jllama.model_forward(jp, jq, jnp.asarray(tokens[None]), cache, batch,
                                 scheme="w4a16")
    assert np.abs(np.asarray(jl[0]) - ref).max() > 10 * np.abs(got - ref).max()


@pytest.mark.parametrize("name", ["self_attn.o_proj.bias", "mlp.down_proj.bias"])
def test_o_down_bias_on_some_layers_raises(name):
    """The o / down bias is read where any layer has it, and then from every
    layer: a Llama-keyed checkpoint with it on layer 1 but not on layer 0
    raises in both loaders, naming the layers, where a reading by layer 0
    alone would leave layer 1's bias unread. (TeleChat2's remap itself
    requires both biases on every layer.)"""
    tcfg = tregistry.resolve(dict(
        architectures=["LlamaForCausalLM"], model_type="llama", hidden_size=H,
        intermediate_size=I, num_attention_heads=NH, num_key_value_heads=NH,
        num_hidden_layers=L, vocab_size=V, rms_norm_eps=1e-6, max_position_embeddings=128,
        tie_word_embeddings=False))
    sd = dict(llama_sd("telechat2"))
    del sd[f"model.layers.0.{name}"]
    for load in (tloader.load_hf_float, tloader.quantize_float):
        with pytest.raises(ValueError, match=r"on layers \[1\] but not on \[0\]"):
            load(torch_sd(sd), tcfg, device="cpu")


def test_dynamic_rope_and_logn_only_inside_their_window():
    """InternLM2's dynamic NTK rope and Qwen v1's dynamic NTK and logn
    attention act only past their window (max_position_embeddings,
    seq_length), where the port refuses to serve: the rope cache inside it
    is the plain one, a cache past it raises, and so does an engine whose
    max_model_len passes it (EngineConfig, EngineArgs, LLM)."""
    _, tcfg = cfgs("internlm2")
    assert tcfg.scaling_window == 128
    plain = trotary.make_rope_cache(DH, 128, 1e6)
    scaled = trotary.make_rope_cache(DH, 128, 1e6, rope_scaling=tcfg.rope_scaling)
    assert torch.equal(plain, scaled)
    with pytest.raises(NotImplementedError, match="window of 128"):
        trotary.make_rope_cache(DH, 129, 1e6, rope_scaling=tcfg.rope_scaling)
    for family in ("internlm2", "qwen"):
        _, tcfg = cfgs(family)
        EngineConfig(model=tcfg, scheduler=SchedulerConfig(max_model_len=128))
        with pytest.raises(NotImplementedError, match="scaling window of 128"):
            EngineConfig(model=tcfg, scheduler=SchedulerConfig(max_model_len=129))
    # Qwen v1 without its flags has no window; with them its rope cache
    # ends at seq_length
    _, plain_qwen = cfgs("qwen", use_dynamic_ntk=False, use_logn_attn=False,
                         max_position_embeddings=512)
    assert plain_qwen.scaling_window is None and plain_qwen.max_position_embeddings == 512
    _, scaled = cfgs("qwen", use_logn_attn=False, max_position_embeddings=512)
    assert scaled.scaling_window == 128 and scaled.max_position_embeddings == 128


def test_qwen_reads_rotary_emb_base():
    """Qwen v1 names its base rotary_emb_base; the JAX registry reads
    rope_theta, absent there, and so 10000 whatever the checkpoint says. A
    rotary_pct below 1 ropes that share of each head (the JAX registry
    ignores it: tests/test_torch_parallel_families.py holds it)."""
    jcfg, tcfg = cfgs("qwen", rotary_emb_base=50000)
    assert tcfg.rope_theta == 50000 and jcfg.rope_theta == 10000.0
    assert cfgs("qwen", rotary_pct=0.5)[1].rotary_dim == DH // 2


def test_width_without_hadamard_raises_before_any_work(tmp_path):
    """An MLP width with no Hadamard construction (214 = 2 x 107, as
    Baichuan-13B's 13696 = 2^7 x 107) raises in quantize_float before the
    state dict is touched, and in LLM(model=<dir>) under QuaRot before the
    directory is read (it holds no weights here)."""
    hf = {**FAMILIES["baichuan"][1], "intermediate_size": 214}
    tcfg = tregistry.resolve(hf)
    sd = torch_sd(family_sd("baichuan", llama_sd("baichuan")))
    n = len(sd)
    with pytest.raises(NotImplementedError, match="MLP width 214 has no Hadamard"):
        tloader.quantize_float(sd, tcfg, device="cpu")
    assert len(sd) == n
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(NotImplementedError, match="MLP width 214 has no Hadamard"):
        LLM(model=str(tmp_path), **KW)


def test_internlm2_bias_raises():
    with pytest.raises(NotImplementedError, match="bias: true.*item 9"):
        cfgs("internlm2", bias=True)


# ------------------------------------------------------------ entry points


def write_family_dir(path, family: str):
    from safetensors.torch import save_file
    path.mkdir(parents=True, exist_ok=True)
    fsd = family_sd(family, llama_sd(family))
    save_file({k: torch.tensor(v) for k, v in fsd.items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(FAMILIES[family][1]))
    return path


def test_internlm2_dir_through_llm_and_the_server(tmp_path):
    """LLM(model=<InternLM2 dir>) quantizes at load (quantize_float after
    the remap) to the state-dict route's tokens, W4A4 QSpec == AR; one
    completion over build_server on the same directory gives them too."""
    from qspec_tpu_torch.entrypoints.openai.api_server import ServerThread, build_server
    from tests.test_torch_server import post, tokens_of
    d = write_family_dir(tmp_path / "internlm2", "internlm2")
    llm = LLM(model=str(d), num_speculative_tokens=3, **KW)
    assert llm.engine_config.model.arch == "internlm2"
    got = generate(llm, prompts(V))
    _, tp, tq = quantized_both("internlm2")
    ar, _ = run_engine(tp, tq, None)
    assert got == ar
    args = EngineArgs(model=str(d), num_speculative_tokens=3, block_size=16, max_model_len=128,
                      max_num_seqs=4, prefill_chunk_size=64)
    with ServerThread(build_server(args, device="cpu")) as st:
        status, body = post(st.port, "/v1/completions",
                            {"prompt": prompts(V)[1], "max_tokens": 10, "temperature": 0,
                             "logprobs": 1, "ignore_eos": True})
    assert status == 200
    assert tokens_of(body["choices"][0]) == ar[1]
