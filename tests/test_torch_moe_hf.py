"""The sparse-MoE checkpoint routes against Hugging Face and the JAX
package, on the CPU.

Tiny ``transformers`` Mixtral, Qwen2-MoE and Qwen3-MoE models are built in
process (transformers 4.57.6). Their state dicts load through the port's
``load_hf_float``, whose bf16 logits are held against Hugging Face's at
``tests/models/test_mixtral.py:92-100``'s tolerances (log-probs within 0.35,
argmax agreement 0.9), and to the JAX ``load_hf_float``'s arrays bit for
bit; through ``quantize_float`` to the JAX one's arrays (the scales at rtol
1e-5, the int4 codes equal but a bounded share one step away, the bf16
router and shared gate at bf16's rounding, as
``tests/test_torch_quantize_float.py`` holds the dense path). DeepSeek-MoE
(which ``transformers`` does not ship) is a state dict made here in its
names; ``convert_deepseek`` gives the JAX converter's arrays, and QuaRot of
it is refused. The published config.json of each family resolves to the
JAX package's ``ModelConfig`` fields. Last, ``LLM(model=<dir>)`` serves a
Mixtral directory quantized at load (QSpec W4A4 == its oracle) and a
DeepSeek one in bf16 (n-gram == its oracle).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.model_loader import families as jfamilies
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import registry as jregistry
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader import families as tfamilies
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops import kv_cache as tkv
from tests.test_torch_quantize_float import CODE_DIFF_SHARE, codes

COMMON = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32, max_position_embeddings=128,
              rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
# each family's tiny config: 4 experts, top-2; expert widths that the
# Hadamard takes (224 = 28 * 8, 64, 96 = 12 * 8)
HF = {
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(intermediate_size=224, num_local_experts=4, num_experts_per_tok=2,
                     sliding_window=None)),
    "qwen2_moe": (transformers.Qwen2MoeConfig, transformers.Qwen2MoeForCausalLM,
                  dict(intermediate_size=224, moe_intermediate_size=64,
                       shared_expert_intermediate_size=96, num_experts=4,
                       num_experts_per_tok=2, use_sliding_window=False)),
    "qwen3_moe": (transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
                  dict(intermediate_size=224, moe_intermediate_size=64, num_experts=4,
                       num_experts_per_tok=2, norm_topk_prob=True)),
}
KW = dict(device="cpu", block_size=16, max_model_len=128, max_num_seqs=4,
          prefill_chunk_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_model(family: str, seed: int = 0):
    """The tiny HF model (norm gammas and q/k norms away from 1, so the
    folds and the norms are exercised) and its config.json dict."""
    conf_cls, model_cls, over = HF[family]
    torch.manual_seed(seed)
    hf = model_cls(conf_cls(**COMMON, **over)).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn_like(p))
    return hf, hf.config.to_dict()


def sd_np(hf) -> dict:
    return {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def both_cfgs(hf_dict: dict):
    return jregistry.resolve(hf_dict), tregistry.resolve(hf_dict)


def port_logits(params, cfg, tokens):
    T, S = len(tokens), 16
    P = -(-T // S) + 2
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, P, S), "cpu")
    pos = torch.arange(T)[None]
    batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                  torch.tensor([T], dtype=torch.int32))
    logits, _ = tllama.model_forward(params, cfg, torch.tensor(tokens)[None], cache, batch,
                                     scheme="bf16")
    return logits[0].numpy()


def assert_same_tree(jtree, ttree, path=""):
    """Every array of the JAX tree is in the port's, equal value for value."""
    if isinstance(jtree, dict):
        for k, v in jtree.items():
            assert k in ttree, path + k
            assert_same_tree(v, ttree[k], f"{path}{k}.")
        return
    ref = np.asarray(jtree, np.float32)
    got = ttree.float().numpy()
    assert got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.mark.parametrize("family", sorted(HF))
def test_load_hf_float_matches_hf_logits_and_jax_arrays(family):
    hf, hf_dict = hf_model(family)
    jcfg, tcfg = both_cfgs(hf_dict)
    sd = sd_np(hf)
    params, cfg = tloader.load_hf_float(dict(sd), tcfg, device="cpu")
    jparams, _ = jloader.load_hf_float(dict(sd), jcfg)
    skip = {"rope_cache"}
    assert_same_tree({k: v for k, v in jparams.items() if k not in skip},
                     {k: v for k, v in params.items() if k not in skip})
    tokens = np.random.default_rng(3).integers(1, 256, size=16)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens[None], dtype=torch.int64)).logits[0].float().numpy()
    got = port_logits(params, cfg, tokens)
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(got - got.max(-1, keepdims=True),
                               ref - ref.max(-1, keepdims=True), atol=0.35)


def assert_quantized_tree_like_jax(jtree, ttree, counts, path=""):
    """Packed int4 weights: codes one step away at most (counted), scales
    at rtol 1e-5; bf16 arrays (router, shared gate, embedding) at bf16's
    rounding; the rest (q/k norms, biases) equal."""
    if isinstance(jtree, dict):
        if "qw" in jtree:
            d = np.abs(codes(ttree["qw"]) - codes(jtree["qw"]))
            assert d.max() <= 1, path
            counts[0] += int((d > 0).sum())
            counts[1] += d.size
            np.testing.assert_allclose(ttree["qs"].numpy(), np.asarray(jtree["qs"]),
                                       rtol=1e-5, err_msg=path)
            if "b" in jtree:
                np.testing.assert_array_equal(ttree["b"].float().numpy(),
                                              np.asarray(jtree["b"], np.float32))
            return
        for k, v in jtree.items():
            assert k in ttree, path + k
            assert_quantized_tree_like_jax(v, ttree[k], counts, f"{path}{k}.")
        return
    ref = np.asarray(jtree, np.float32)
    got = ttree.float().numpy() if isinstance(ttree, torch.Tensor) else np.asarray(ttree)
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("family", sorted(HF))
def test_quantize_float_matches_jax(family):
    """Every expert rotated, the router and the shared gate folded and
    rotated, the shared expert by its own Hadamard, the qkv bias and the
    q/k norms as they are: the JAX quantize_float's arrays."""
    hf, hf_dict = hf_model(family)
    jcfg, tcfg = both_cfgs(hf_dict)
    sd = sd_np(hf)
    jp, _ = jloader.quantize_float(dict(sd), jcfg)
    tp, qcfg = tloader.quantize_float(dict(sd), tcfg, device="cpu")
    assert qcfg.quant == "w4"
    counts = [0, 0]
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for key in ("layers", "embed", "lm_head"):
        assert_quantized_tree_like_jax(jp[key], tp[key], counts, key + ".")
    assert counts[0] <= CODE_DIFF_SHARE * counts[1], counts
    assert set(tp["hadamards"]) == set(jp["hadamards"])


# ---------------------------------------------------------------- DeepSeek

DEEPSEEK_HF = dict(architectures=["DeepseekForCausalLM"], model_type="deepseek",
                   vocab_size=256, hidden_size=128, intermediate_size=224,
                   moe_intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=4, n_routed_experts=4, n_shared_experts=2,
                   num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1,
                   norm_topk_prob=False, rms_norm_eps=1e-6, rope_theta=10000.0,
                   max_position_embeddings=128, tie_word_embeddings=False)


def deepseek_sd(cfg, seed: int = 0) -> dict:
    """A DeepSeek-MoE state dict in its checkpoint's names (normal 0.05
    weights, gammas 1 + 0.1 N)."""
    rng = np.random.default_rng(seed)
    H, V, I, Ie = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size, \
        cfg.expert_intermediate_size
    Is = cfg.shared_expert_intermediate_size

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def g():
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": g(),
          "lm_head.weight": w(V, H)}
    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        sd.update({p + "self_attn.q_proj.weight": w(cfg.q_size, H),
                   p + "self_attn.k_proj.weight": w(cfg.kv_size, H),
                   p + "self_attn.v_proj.weight": w(cfg.kv_size, H),
                   p + "self_attn.o_proj.weight": w(H, cfg.q_size),
                   p + "input_layernorm.weight": g(), p + "post_attention_layernorm.weight": g()})
        mlps = ([("mlp.", I)] if li < cfg.first_k_dense else
                [(f"mlp.experts.{e}.", Ie) for e in range(cfg.num_experts)]
                + [("mlp.shared_experts.", Is)])
        for m, width in mlps:
            sd.update({p + m + "gate_proj.weight": w(width, H),
                       p + m + "up_proj.weight": w(width, H),
                       p + m + "down_proj.weight": w(H, width)})
        if li >= cfg.first_k_dense:
            sd[p + "mlp.gate.weight"] = w(cfg.num_experts, H)
    return sd


def test_convert_deepseek_matches_jax():
    jcfg, tcfg = both_cfgs(DEEPSEEK_HF)
    assert (tcfg.first_k_dense, tcfg.shared_expert_intermediate_size) == (1, 128)
    assert not tcfg.shared_expert_gated
    sd = deepseek_sd(tcfg)
    jp, jc = jfamilies.load_family_float(dict(sd), jcfg)
    tp, tc = tfamilies.load_family_float(dict(sd), tcfg, device="cpu")
    assert tc.quant == jc.quant == "none"
    skip = {"rope_cache"}
    assert_same_tree({k: v for k, v in jp.items() if k not in skip},
                     {k: v for k, v in tp.items() if k not in skip})
    np.testing.assert_allclose(tp["rope_cache"].numpy(), np.asarray(jp["rope_cache"]),
                               rtol=1e-6, atol=1e-6)
    assert tuple(tp["layers_dense"]["gate_up"]["w"].shape) == (1, 128, 448)


def test_deepseek_quarot_refused(tmp_path):
    """QuaRot of DeepSeek-MoE is refused, naming the reason: its dense
    prefix (width 224) is not the experts' width (64), which the JAX
    package's one intermediate Hadamard cannot rotate, and its layout is
    not llama-keyed; LLM(model=<dir>) under the default quantization
    raises, and serves it in bf16 with quantization=None."""
    _, tcfg = both_cfgs(DEEPSEEK_HF)
    with pytest.raises(NotImplementedError, match="dense prefix.*224.*64"):
        tllama.check_served(dataclasses.replace(tcfg, quant="w4"))
    with pytest.raises(NotImplementedError, match="convert_deepseek"):
        tloader.quantize_float(deepseek_sd(tcfg), dataclasses.replace(
            tcfg, moe_intermediate_size=224), device="cpu")
    d = write_dir(tmp_path / "deepseek", deepseek_sd(tcfg), DEEPSEEK_HF)
    with pytest.raises(NotImplementedError, match="dense prefix.*differs from the experts'"):
        LLM(model=str(d), **KW)


# --------------------------------------------------------------- registry

# the published config.json fields of each family's reference checkpoint
PUBLISHED = {
    "mistralai/Mixtral-8x7B-v0.1": dict(
        architectures=["MixtralForCausalLM"], model_type="mixtral", hidden_act="silu",
        hidden_size=4096, intermediate_size=14336, max_position_embeddings=32768,
        num_attention_heads=32, num_experts_per_tok=2, num_hidden_layers=32,
        num_key_value_heads=8, num_local_experts=8, rms_norm_eps=1e-05,
        rope_theta=1000000.0, sliding_window=None, tie_word_embeddings=False,
        vocab_size=32000),
    "Qwen/Qwen1.5-MoE-A2.7B": dict(
        architectures=["Qwen2MoeForCausalLM"], model_type="qwen2_moe", hidden_act="silu",
        hidden_size=2048, intermediate_size=5632, max_position_embeddings=8192,
        num_attention_heads=16, num_hidden_layers=24, num_key_value_heads=16,
        rms_norm_eps=1e-06, rope_theta=1000000.0, sliding_window=32768,
        use_sliding_window=False, tie_word_embeddings=False, vocab_size=151936,
        decoder_sparse_step=1, moe_intermediate_size=1408,
        shared_expert_intermediate_size=5632, num_experts_per_tok=4, num_experts=60,
        norm_topk_prob=False),
    "Qwen/Qwen3-30B-A3B": dict(
        architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe", attention_bias=False,
        head_dim=128, hidden_act="silu", hidden_size=2048, intermediate_size=6144,
        max_position_embeddings=40960, mlp_only_layers=[], moe_intermediate_size=768,
        norm_topk_prob=True, num_attention_heads=32, num_experts=128,
        num_experts_per_tok=8, num_hidden_layers=48, num_key_value_heads=4,
        rms_norm_eps=1e-06, rope_scaling=None, rope_theta=1000000.0, sliding_window=None,
        tie_word_embeddings=False, vocab_size=151936, decoder_sparse_step=1),
    "deepseek-ai/deepseek-moe-16b-base": dict(
        architectures=["DeepseekForCausalLM"], model_type="deepseek", hidden_size=2048,
        intermediate_size=10944, max_position_embeddings=4096, moe_intermediate_size=1408,
        moe_layer_freq=1, n_routed_experts=64, n_shared_experts=2, norm_topk_prob=False,
        num_attention_heads=16, num_experts_per_tok=6, num_hidden_layers=28,
        num_key_value_heads=16, first_k_dense_replace=1, rms_norm_eps=1e-06,
        rope_theta=10000, tie_word_embeddings=False, vocab_size=102400),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_registry_resolves_like_jax(name):
    hf = PUBLISHED[name]
    jcfg, tcfg = both_cfgs(hf)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (name, f.name)
    # by the bare model type too, as the JAX registry takes it
    bare = {k: v for k, v in hf.items() if k != "architectures"}
    assert tregistry.resolve(bare) == tcfg


def test_presets_match_jax_and_the_published_config():
    for name in ("mixtral_8x7b", "qwen15_moe_a2_7b"):
        t, j = getattr(ModelConfig, name)(), getattr(JModelConfig, name)()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    assert tregistry.resolve(PUBLISHED["mistralai/Mixtral-8x7B-v0.1"]) == \
        ModelConfig.mixtral_8x7b()
    with pytest.raises(ValueError, match="moe_layer_freq"):
        ModelConfig.from_hf_config({**DEEPSEEK_HF, "moe_layer_freq": 2})


# --------------------------------------------------------- LLM(model=<dir>)


def write_dir(path, sd: dict, hf_dict: dict):
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(hf_dict))
    return path


def generate(llm, prompts, max_tokens=10):
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    return [o.output_token_ids for o in llm.generate(prompts, sp)]


def prompts(vocab=256):
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(1, vocab, size=n))) for n in (7, 21, 30)]
    ps[1] = ps[1][:7] * 3
    return ps


def test_mixtral_dir_quantized_at_load_serves_qspec(tmp_path):
    """LLM(model=<Mixtral dir>): no weight_scales, so quantize_float at load
    (chip_smoke.py (G3)'s route); greedy W4A4 QSpec == its oracle."""
    hf, hf_dict = hf_model("mixtral")
    d = write_dir(tmp_path / "mixtral", sd_np(hf), hf_dict)
    toks = {m: generate(LLM(model=str(d), num_speculative_tokens=3, speculative_method=m,
                            **KW), prompts()) for m in ("qspec", "qspec_null")}
    assert toks["qspec"] == toks["qspec_null"]


def test_deepseek_dir_in_bf16_serves_ngram(tmp_path):
    """LLM(model=<DeepSeek dir>, quantization=None): convert_deepseek, the
    dense prefix then the MoE layer; n-gram == its "null" oracle == AR."""
    _, tcfg = both_cfgs(DEEPSEEK_HF)
    d = write_dir(tmp_path / "deepseek", deepseek_sd(tcfg), DEEPSEEK_HF)
    llm = LLM(model=str(d), quantization=None, **KW)
    assert "layers_dense" in llm.llm_engine.runner.params
    ar = generate(llm, prompts())
    spec = {m: generate(LLM(model=str(d), quantization=None, num_speculative_tokens=3,
                            speculative_model="[ngram]", speculative_method=m, **KW),
                        prompts()) for m in ("ngram", "null")}
    assert spec["ngram"] == spec["null"] == ar
