"""``LLM(model=<dir>)``'s checkpoint routes and the loaders' refusals (CPU).

A Hugging Face Llama directory written in process by ``save_pretrained``
loads, as in the JAX package's ``LLM``: with ``quantization=None`` in bf16
(``load_hf_float``), under the default QuaRot quantization through
``quantize_float`` (no ``weight_scales``: ``load_qspec``'s KeyError routes
it there), and a reference-format QSpec directory (uint8 [out, in // 2] +
``weight_scales``, the reference's ``o_proj.1.`` / ``down_proj.1.`` keys)
through ``load_qspec``, to the same arrays as the JAX ``load_qspec`` and as
the port's on the state dict. A separate draft model comes from a directory
(``speculative_model=<dir>``) or as a cfg with its parameters. Every layout
the port's llama-keyed loaders do not take raises, naming its ROADMAP item.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import registry as jregistry
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops.packing import pack_reference, unpack_int4
from tests.test_torch_quantize_float import CODE_DIFF_SHARE

PROJ = ("qkv", "o", "gate_up", "down")
# a tiny Llama at the port's ModelConfig.tiny widths (vocab 512, hidden 256,
# intermediate 448 = 28 * 16, 4 / 2 heads of 64), so "tiny" can verify for
# a draft directory of the same vocabulary
HF_KW = dict(vocab_size=512, hidden_size=256, intermediate_size=448, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=64,
             max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
             tie_word_embeddings=False)
KW = dict(device="cpu", block_size=16, max_model_len=128, max_num_seqs=4,
          prefill_chunk_size=64)
SP = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_dir(path, seed=0, **over):
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**{**HF_KW, **over})).eval()
    with torch.no_grad():      # gammas away from 1, so the folds are exercised
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn_like(p))
    hf.save_pretrained(str(path), safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    return hf_dir(tmp_path_factory.mktemp("llama") / "float")


def prompts():
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(1, 512, size=n))) for n in (7, 21, 30)]
    ps[1] = ps[1][:7] * 3
    return ps


def sd_of(path):
    return tloader.read_safetensors(str(path))


def assert_same_params(a, b):
    for name in PROJ:
        for key in a["layers"][name]:
            assert torch.equal(a["layers"][name][key], b["layers"][name][key]), (name, key)
    assert torch.equal(a["embed"], b["embed"])


def test_float_dir_in_bf16(llama_dir):
    """quantization=None: load_hf_float; n-gram (k = 3) == AR."""
    ar = LLM(model=str(llama_dir), quantization=None, **KW)
    assert ar.engine_config.model.quant == "none"
    ref, _ = tloader.load_hf_float(sd_of(llama_dir), ar.engine_config.model, device="cpu")
    assert_same_params(ar.llm_engine.runner.params, ref)
    want = [o.output_token_ids for o in ar.generate(prompts(), SP)]
    ngram = LLM(model=str(llama_dir), quantization=None, num_speculative_tokens=3,
                speculative_model="[ngram]", **KW)
    assert [o.output_token_ids for o in ngram.generate(prompts(), SP)] == want


def test_float_dir_under_quarot_quantization(llama_dir):
    """The default quantization: no weight_scales, so quantize_float; QSpec
    (W4A4 draft) == its qspec_null oracle; the JAX package quantizes the
    directory to the same codes."""
    llm = LLM(model=str(llama_dir), num_speculative_tokens=3, **KW)
    cfg = llm.engine_config.model
    assert cfg.quant == "w4"
    params = llm.llm_engine.runner.params
    ref, _ = tloader.quantize_float(sd_of(llama_dir), cfg, device="cpu")
    assert_same_params(params, ref)
    jp, _ = jloader.quantize_float(str(llama_dir))
    for name in PROJ:
        np.testing.assert_array_equal(params["layers"][name]["qw"].numpy(),
                                      np.asarray(jp["layers"][name]["qw"]))
    got = [o.output_token_ids for o in llm.generate(prompts(), SP)]
    oracle = LLM(model=str(llama_dir), num_speculative_tokens=3,
                 speculative_method="qspec_null", **KW)
    assert got == [o.output_token_ids for o in oracle.generate(prompts(), SP)]


def reference_state_dict(params, cfg, fused: bool) -> dict:
    """A reference-format QSpec checkpoint of a quantized tree: uint8 [out,
    in // 2] weights and f32 weight_scales (split q / k / v and gate / up,
    or fused), o and down under the reference's Sequential keys
    (``o_proj.1.``, ``down_proj.1.``), the embedding float32."""
    sd = {"model.embed_tokens.weight": params["embed"].float()}
    I = cfg.intermediate_size
    modules = {"qkv": [("self_attn.qkv_proj", cfg.qkv_out)] if fused else
               [("self_attn.q_proj", cfg.q_size), ("self_attn.k_proj", cfg.kv_size),
                ("self_attn.v_proj", cfg.kv_size)],
               "o": [("self_attn.o_proj.1", cfg.hidden_size)],
               "gate_up": [("mlp.gate_up_proj", 2 * I)] if fused else
               [("mlp.gate_proj", I), ("mlp.up_proj", I)],
               "down": [("mlp.down_proj.1", cfg.hidden_size)]}
    for li in range(cfg.num_layers):
        for name, parts in modules.items():
            vals = unpack_int4(params["layers"][name]["qw"][li])       # [in, out]
            scales = params["layers"][name]["qs"][li]
            start = 0
            for module, width in parts:
                key = f"model.layers.{li}.{module}"
                sd[key + ".weight"] = pack_reference(vals[:, start:start + width]).contiguous()
                sd[key + ".weight_scales"] = scales[start:start + width].contiguous()
                start += width
    return sd


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_reference_qspec_dir(llama_dir, tmp_path, fused):
    """A reference-format QSpec directory through LLM == load_qspec on its
    state dict == the tree it was written from, and the JAX load_qspec's
    arrays."""
    src = LLM(model=str(llama_dir), **KW)
    cfg = src.engine_config.model
    sd = reference_state_dict(src.llm_engine.runner.params, cfg, fused)
    sd["lm_head.weight"] = torch.randn(cfg.vocab_size, cfg.hidden_size,
                                     generator=torch.Generator().manual_seed(2))
    d = tmp_path / "qspec"
    d.mkdir()
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text((llama_dir / "config.json").read_text())
    llm = LLM(model=str(d), num_speculative_tokens=3, **KW)
    params = llm.llm_engine.runner.params
    assert_same_params(params, src.llm_engine.runner.params)
    ref, _ = tloader.load_qspec(sd_of(d), cfg, device="cpu")
    assert_same_params(params, ref)
    for key in ("qw8", "qs"):
        assert torch.equal(params["lm_head"][key], ref["lm_head"][key])
        # the kernels take contiguous tensors only (the head comes transposed)
        assert params["lm_head"][key].is_contiguous()
    assert all(t.is_contiguous() for proj in params["layers"].values() for t in proj.values())
    jp, _ = jloader.load_qspec(str(d), JModelConfig(**{
        k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                     "num_layers", "num_heads", "num_kv_heads", "head_dim",
                                     "rope_theta", "max_position_embeddings")}))
    for name in PROJ:
        for key in ("qw", "qs"):
            np.testing.assert_array_equal(params["layers"][name][key].numpy(),
                                          np.asarray(jp["layers"][name][key]))
    np.testing.assert_array_equal(params["lm_head"]["qw8"].numpy(),
                                  np.asarray(jp["lm_head"]["qw8"]))
    got = [o.output_token_ids for o in llm.generate(prompts(), SP)]
    oracle = LLM(model=str(d), num_speculative_tokens=3, speculative_method="qspec_null", **KW)
    assert got == [o.output_token_ids for o in oracle.generate(prompts(), SP)]


def test_draft_model_from_directory(tmp_path):
    """speculative_model=<dir>: a separate draft, quantized at load by
    quantize_float (the JAX package's route for a draft directory), with
    the target "tiny" preset; greedy == qspec_null. The same draft as a cfg
    with its parameters gives the same tokens."""
    d = hf_dir(tmp_path / "draft", seed=1, num_hidden_layers=1)
    args = EngineArgs(model="tiny", num_speculative_tokens=3, speculative_model=str(d))
    assert args.spec_method() == "qspec"
    assert args.create_engine_config().speculative.draft_model is None   # LLM loads it
    llm = LLM(model="tiny", num_speculative_tokens=3, speculative_model=str(d), **KW)
    spec = llm.engine_config.speculative
    assert spec.method == "qspec" and spec.draft_model.quant == "w4"
    runner = llm.llm_engine.runner
    assert runner.draft_cache.num_layers == 1 and runner.draft_scheme == "w4a4"
    got = [o.output_token_ids for o in llm.generate(prompts(), SP)]
    assert runner.draft_forwards > 0
    oracle = LLM(model="tiny", num_speculative_tokens=3, speculative_model=str(d),
                 speculative_method="qspec_null", **KW)
    assert got == [o.output_token_ids for o in oracle.generate(prompts(), SP)]
    dparams, dcfg = tloader.quantize_float(str(d), device="cpu")
    again = LLM(model="tiny", num_speculative_tokens=3, draft_model=dcfg,
                draft_params=dparams, **KW)
    assert [o.output_token_ids for o in again.generate(prompts(), SP)] == got
    with pytest.raises(ValueError, match="draft"):
        LLM(model="tiny", num_speculative_tokens=3, draft_params=dparams, **KW)


# ------------------------------------------------------------------ refusals


def small_sd(seed=0, **over):
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**{**HF_KW, **over}))
    return {k: v.detach() for k, v in hf.state_dict().items()}


CFG = ModelConfig.tiny()
EXTRA = {
    "moe": ("model.layers.0.block_sparse_moe.experts.0.w1.weight", "mixture-of-experts"),
    "qwen2-moe": ("model.layers.0.mlp.experts.0.gate_proj.weight", "mixture-of-experts"),
    "qk_norm": ("model.layers.0.self_attn.q_norm.weight", "q/k norms"),
    "bias": ("model.layers.0.self_attn.q_proj.bias", "biased projections"),
    "baichuan": ("model.layers.0.self_attn.W_pack.weight", "LLAMA_KEY_REMAPS"),
    "internlm2": ("model.layers.0.attention.wqkv.weight", "LLAMA_KEY_REMAPS"),
    "score_head": ("score.weight", "reward head"),
}


# the layouts the state-dict loaders take where the config declares them
# (the MoE MLP, the q/k norms, the qkv bias): under CFG, which declares none,
# they raise naming the config field; load_qspec refuses them as before (the
# JAX load_qspec reads none of them)
DECLARED = {"moe": "num_experts=0", "qwen2-moe": "num_experts=0", "qk_norm": "qk_norm=False",
            "bias": "qkv_bias=False"}


# the remap families' layouts: under CFG (a llama) every loader raises,
# naming the arch that reads them (load_hf_float and quantize_float map
# them onto llama keys under that arch: tests/test_torch_remap_families.py)
REMAPPED = {"baichuan": "baichuan", "internlm2": "internlm2"}


@pytest.mark.parametrize("case", sorted(EXTRA))
@pytest.mark.parametrize("loader", ["quantize_float", "load_hf_float", "load_qspec"])
def test_unported_layouts_raise(case, loader):
    key, what = EXTRA[case]
    sd = small_sd()
    sd[key] = torch.zeros(4)
    match = (f"{what}.*which the config does not declare \\({DECLARED[case]}\\)"
             if case in DECLARED and loader != "load_qspec" else
             f"{what}.*under arch '{REMAPPED[case]}'.*not under a config of arch 'llama'"
             if case in REMAPPED else f"{what}.*ROADMAP queue 1 item")
    with pytest.raises(NotImplementedError, match=match):
        getattr(tloader, loader)(sd, CFG, device="cpu")


def declared_layout(case: str):
    """(state dict, port cfg, JAX cfg) of the full layout of a DECLARED
    case: a tiny Mixtral, Qwen2-MoE or Qwen3-MoE from transformers at the
    tiny Llama's widths, or the tiny Llama with q / k / v biases."""
    if case == "bias":
        sd = small_sd()
        r = np.random.default_rng(2)
        for n, width in (("q", 256), ("k", 128), ("v", 128)):
            for li in range(2):
                sd[f"model.layers.{li}.self_attn.{n}_proj.bias"] = torch.tensor(
                    0.05 * r.standard_normal(width), dtype=torch.float32)
        kw = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
        return sd, ModelConfig(**{**kw, "qkv_bias": True}), JModelConfig(**{**kw, "qkv_bias": True})
    conf, model, over = {
        "moe": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(num_local_experts=4, sliding_window=None)),
        "qwen2-moe": (transformers.Qwen2MoeConfig, transformers.Qwen2MoeForCausalLM,
                      dict(num_experts=4, moe_intermediate_size=128,
                           shared_expert_intermediate_size=192, use_sliding_window=False)),
        "qk_norm": (transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
                    dict(num_experts=4, moe_intermediate_size=128, norm_topk_prob=True)),
    }[case]
    torch.manual_seed(0)
    kw = {k: v for k, v in HF_KW.items() if k != "intermediate_size"}
    hf = model(conf(**kw, intermediate_size=448, num_experts_per_tok=2, **over))
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn_like(p))
    hf_dict = hf.config.to_dict()
    return ({k: v.detach() for k, v in hf.state_dict().items()}, tregistry.resolve(hf_dict),
            jregistry.resolve(hf_dict))


@pytest.mark.parametrize("case", sorted(DECLARED))
@pytest.mark.parametrize("loader", ["quantize_float", "load_hf_float"])
def test_declared_layouts_load(case, loader):
    """Each refusal above has its counterpart: the full layout, under a
    config that declares it, loads to the JAX loader's arrays (load_hf_float
    bit for bit; quantize_float as tests/test_torch_moe_hf.py holds it)."""
    from tests.test_torch_moe_hf import assert_quantized_tree_like_jax, assert_same_tree
    sd, tcfg, jcfg = declared_layout(case)
    np_sd = {k: v.float().numpy() for k, v in sd.items()}
    tp, _ = getattr(tloader, loader)(dict(sd), tcfg, device="cpu")
    jp, _ = getattr(jloader, loader)(dict(np_sd), jcfg)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if loader == "load_hf_float":
        assert_same_tree({k: v for k, v in jp.items() if k != "rope_cache"},
                         {k: v for k, v in tp.items() if k != "rope_cache"})
    else:
        counts = [0, 0]
        assert_quantized_tree_like_jax(jp["layers"], tp["layers"], counts)
        assert counts[0] <= CODE_DIFF_SHARE * counts[1], counts


def test_post_norms_raise_under_quarot():
    """Gemma-2's post-block norms do not compose with the gamma folds (the
    JAX package refuses them too)."""
    gemma = ModelConfig.gemma2_9b(num_layers=2, hidden_size=256, intermediate_size=448,
                                  num_heads=4, num_kv_heads=2, head_dim=64, vocab_size=512)
    with pytest.raises(NotImplementedError, match="post-block norms.*ROADMAP queue 1 item 6"):
        tloader.quantize_float(small_sd(), gemma, device="cpu")
    with pytest.raises(NotImplementedError, match="AWQ / GPTQ"):
        tloader.load_hf_float(small_sd(), gemma, device="cpu")


def test_other_refusals():
    with pytest.raises(ValueError, match="bits"):
        tloader.quantize_float(small_sd(), CFG, bits=8)
    with pytest.raises(KeyError):                         # a float checkpoint
        tloader.load_qspec(small_sd(), CFG, device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        tloader.quantize_float(small_sd())



def test_llama3_8b_config_json():
    """Meta-Llama-3-8B's config.json (config.LLAMA3_8B_HF, the 8B float
    checkpoints chip_smoke.py makes) resolves to the llama3-8b preset."""
    from qspec_tpu_torch.config import LLAMA3_8B_HF
    from qspec_tpu_torch.models.registry import resolve
    assert resolve(LLAMA3_8B_HF) == ModelConfig.llama3_8b()
    assert resolve({**LLAMA3_8B_HF, "num_hidden_layers": 2}).num_layers == 2
