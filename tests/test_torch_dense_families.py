"""The dense families of the llama graph against Hugging Face and the JAX
package, on the CPU: Qwen2, Qwen3, Mistral, Gemma, Phi-3 and Granite, and
the reference's QuaRot architecture names.

Tiny ``transformers`` models (transformers 4.57.6: hidden 128, 2 layers,
4 query heads over 2 KV heads, intermediate 224 = 28 * 8) are built in
process. For each family:

- its config.json resolves, through the port's registry, to the JAX
  registry's ``ModelConfig`` fields (and the published config of the
  family's reference checkpoint too), but for the two readings the port
  takes from Hugging Face (ROADMAP §3): a Qwen2 / Qwen3 window under
  ``use_sliding_window: false``, and Phi-3's top-level
  ``original_max_position_embeddings``;
- ``load_hf_float`` gives the JAX loader's arrays bit for bit, and bf16
  logits within ``tests/test_torch_moe_hf.py``'s tolerances of Hugging
  Face's (log-probs within 0.35, argmax agreement 0.9);
- ``quantize_float`` gives the JAX one's arrays (the int4 codes equal but a
  bounded share one step away, the scales at rtol 1e-5), Gemma's tied head
  and (1+w) fold included;
- ``model_forward`` on the JAX package's quantized parameters gives its
  logits at ``tests/test_torch_model.py``'s scheme tolerances;
- ``LLM(model=<dir>)`` quantizes the directory at load and greedy QSpec
  equals its ``qspec_null`` oracle.

Then Phi-3's longrope cache against the JAX ``make_rope_cache`` past the
original window, Granite's multipliers and its head of 259 columns (padded
for the head kernels, sliced back), the Qwen2 window against Hugging Face,
the QuaRot names, the presets, and the Hadamard factors of the published
MLP widths.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import transformers

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import registry as jregistry
from qspec_tpu.ops import hadamard as jhad
from qspec_tpu.ops import rotary as jrotary
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops import hadamard as thad
from qspec_tpu_torch.ops import linear_kernels as tlk
from qspec_tpu_torch.ops import rotary as trotary
from tests.test_torch_model import REL_TOL, TIE_GAP, W4A4_ARGMAX_AGREE, _forward_both
from tests.test_torch_moe_hf import (assert_quantized_tree_like_jax, assert_same_tree,
                                     port_logits, write_dir)
from tests.test_torch_quantize_float import CODE_DIFF_SHARE

COMMON = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128, rope_theta=10000.0,
              rms_norm_eps=1e-5, intermediate_size=224, tie_word_embeddings=False)
# Phi-3's longrope: 16 factors a list (head dim 32), the original window 64
# of 256 positions
LONGROPE = {"type": "longrope", "short_factor": np.linspace(1.0, 1.5, 16).tolist(),
            "long_factor": np.linspace(1.0, 8.0, 16).tolist()}
FAMILIES = {
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM,
              dict(use_sliding_window=False)),
    "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM, dict(head_dim=32)),
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM,
                dict(sliding_window=16)),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(head_dim=64, hidden_activation="gelu_pytorch_tanh",
                   tie_word_embeddings=True)),
    "phi3": (transformers.Phi3Config, transformers.Phi3ForCausalLM,
             dict(max_position_embeddings=256, original_max_position_embeddings=64,
                  rope_scaling=LONGROPE, pad_token_id=0, bos_token_id=1, eos_token_id=2)),
    # a vocabulary of 259 (not a multiple of 8): the quantized head is padded
    "granite": (transformers.GraniteConfig, transformers.GraniteForCausalLM,
                dict(vocab_size=259, tie_word_embeddings=True, embedding_multiplier=6.0,
                     attention_multiplier=0.3, residual_multiplier=0.22,
                     logits_scaling=4.0)),
}
KW = dict(device="cpu", block_size=16, max_model_len=128, max_num_seqs=4,
          prefill_chunk_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_model(family: str, seed: int = 0, **over):
    """The tiny HF model (norm gammas away from their neutral value, so the
    folds are exercised) and its config.json dict as ``save_pretrained``
    writes it (``architectures`` set; unset fields left out)."""
    conf_cls, model_cls, fam = FAMILIES[family]
    torch.manual_seed(seed)
    hf = model_cls(conf_cls(**{**COMMON, **fam, **over})).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(p + 0.1 * torch.randn_like(p))
    d = {**hf.config.to_dict(), "architectures": [model_cls.__name__]}
    return hf, {k: v for k, v in d.items() if v is not None}


def sd_np(hf) -> dict:
    return {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def both_cfgs(hf_dict: dict):
    """(JAX cfg, port cfg); the JAX one takes the port's longrope scaling
    (with the original window), so the two compute the same model."""
    jcfg, tcfg = jregistry.resolve(hf_dict), tregistry.resolve(hf_dict)
    return dataclasses.replace(jcfg, rope_scaling=tcfg.rope_scaling), tcfg


# where the port reads a config as Hugging Face does, not as the JAX
# package: the field and the port's value
def caveats(hf_dict: dict, tcfg) -> dict:
    out = {}
    if tcfg.arch in ("qwen2", "qwen3") and not hf_dict.get("use_sliding_window", False):
        out["sliding_window"] = None
    rs = hf_dict.get("rope_scaling") or {}
    if rs.get("type", rs.get("rope_type")) == "longrope" and \
            "original_max_position_embeddings" in hf_dict:
        out["rope_scaling"] = {**rs, "original_max_position_embeddings":
                               hf_dict["original_max_position_embeddings"]}
    return out


def assert_resolves_like_jax(hf_dict: dict):
    jcfg, tcfg = jregistry.resolve(hf_dict), tregistry.resolve(hf_dict)
    skip = caveats(hf_dict, tcfg)
    for f in dataclasses.fields(tcfg):
        if f.name in skip:
            assert getattr(tcfg, f.name) == skip[f.name], f.name
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    return jcfg, tcfg


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_registry_resolves_like_jax(family):
    _, hf_dict = hf_model(family)
    _, tcfg = assert_resolves_like_jax(hf_dict)
    assert tcfg.arch == {"qwen2": "qwen2", "qwen3": "qwen3", "gemma": "gemma",
                         "granite": "granite"}.get(family, "llama")
    # by the bare model type too, where the JAX registry takes it
    bare = {k: v for k, v in hf_dict.items() if k != "architectures"}
    if bare["model_type"] in jregistry.supported_architectures():
        assert tregistry.resolve(bare) == tcfg


# the published config.json fields of each family's reference checkpoint
# (Phi-3's 48 longrope factors a list: the count is the published one, the
# values here are placeholders, monotone as the published ones are)
PUBLISHED = {
    "Qwen/Qwen2.5-7B": dict(
        architectures=["Qwen2ForCausalLM"], model_type="qwen2", hidden_act="silu",
        hidden_size=3584, intermediate_size=18944, max_position_embeddings=131072,
        max_window_layers=28, num_attention_heads=28, num_hidden_layers=28,
        num_key_value_heads=4, rms_norm_eps=1e-06, rope_theta=1000000.0,
        sliding_window=131072, tie_word_embeddings=False, use_sliding_window=False,
        vocab_size=152064),
    "Qwen/Qwen3-8B": dict(
        architectures=["Qwen3ForCausalLM"], model_type="qwen3", attention_bias=False,
        head_dim=128, hidden_act="silu", hidden_size=4096, intermediate_size=12288,
        max_position_embeddings=40960, max_window_layers=36, num_attention_heads=32,
        num_hidden_layers=36, num_key_value_heads=8, rms_norm_eps=1e-06, rope_scaling=None,
        rope_theta=1000000, sliding_window=None, tie_word_embeddings=False,
        use_sliding_window=False, vocab_size=151936),
    "mistralai/Mistral-7B-v0.1": dict(
        architectures=["MistralForCausalLM"], model_type="mistral", hidden_act="silu",
        hidden_size=4096, intermediate_size=14336, max_position_embeddings=32768,
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=8,
        rms_norm_eps=1e-05, rope_theta=10000.0, sliding_window=4096,
        tie_word_embeddings=False, vocab_size=32000),
    "google/gemma-7b": dict(
        architectures=["GemmaForCausalLM"], model_type="gemma", attention_bias=False,
        head_dim=256, hidden_act="gelu", hidden_size=3072, intermediate_size=24576,
        max_position_embeddings=8192, num_attention_heads=16, num_hidden_layers=28,
        num_key_value_heads=16, rms_norm_eps=1e-06, rope_scaling=None, rope_theta=10000.0,
        vocab_size=256000),
    "microsoft/Phi-3-mini-128k-instruct": dict(
        architectures=["Phi3ForCausalLM"], model_type="phi3", attention_bias=False,
        hidden_act="silu", hidden_size=3072, intermediate_size=8192,
        max_position_embeddings=131072, original_max_position_embeddings=4096,
        num_attention_heads=32, num_hidden_layers=32, num_key_value_heads=32,
        rms_norm_eps=1e-05, rope_theta=10000.0, sliding_window=262144,
        tie_word_embeddings=False, vocab_size=32064,
        rope_scaling={"type": "longrope",
                      "short_factor": np.linspace(1.0, 2.0, 48).round(4).tolist(),
                      "long_factor": np.geomspace(1.0, 64.0, 48).round(4).tolist()}),
    "ibm-granite/granite-3.0-8b-instruct": dict(
        architectures=["GraniteForCausalLM"], model_type="granite", attention_bias=False,
        attention_multiplier=0.0078125, embedding_multiplier=12.0, hidden_act="silu",
        hidden_size=4096, intermediate_size=12800, logits_scaling=16.0,
        max_position_embeddings=4096, mlp_bias=False, num_attention_heads=32,
        num_hidden_layers=40, num_key_value_heads=8, residual_multiplier=0.22,
        rms_norm_eps=1e-05, rope_scaling=None, rope_theta=10000.0,
        tie_word_embeddings=True, vocab_size=49155),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_configs_resolve_like_jax(name):
    _, tcfg = assert_resolves_like_jax(PUBLISHED[name])
    if name == "Qwen/Qwen2.5-7B":
        # the window the JAX package reads but Hugging Face does not apply
        assert jregistry.resolve(PUBLISHED[name]).sliding_window == 131072
        assert tcfg.sliding_window is None
        assert tcfg == ModelConfig.qwen2_7b(max_position_embeddings=131072,
                                            rms_norm_eps=1e-06)
    if name.startswith("ibm-granite"):
        assert (tcfg.embed_scale, tcfg.residual_multiplier, tcfg.logits_scaling) == \
            (12.0, 0.22, 16.0)
        assert tcfg.query_pre_attn_scalar ** -0.5 == 0.0078125


def test_presets_match_jax():
    for name in ("qwen2_7b", "gemma_7b", "gemma_2b", "llama3_70b"):
        t, j = getattr(ModelConfig, name)(), getattr(JModelConfig, name)()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)


# ---------------------------------------------------------------- loaders


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_hf_float_matches_hf_logits_and_jax_arrays(family):
    hf, hf_dict = hf_model(family)
    jcfg, tcfg = both_cfgs(hf_dict)
    sd = sd_np(hf)
    params, cfg = tloader.load_hf_float(dict(sd), tcfg, device="cpu")
    jparams, _ = jloader.load_hf_float(dict(sd), jcfg)
    skip = {"rope_cache"}
    assert_same_tree({k: v for k, v in jparams.items() if k not in skip},
                     {k: v for k, v in params.items() if k not in skip})
    np.testing.assert_allclose(params["rope_cache"].numpy(), np.asarray(jparams["rope_cache"]),
                               rtol=1e-6, atol=1e-6)
    # 24 tokens: past Mistral's window of 16, inside Phi-3's original 64
    tokens = np.random.default_rng(3).integers(1, 256, size=24)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens[None], dtype=torch.int64)).logits[0].float().numpy()
    got = port_logits(params, cfg, tokens)
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(got - got.max(-1, keepdims=True),
                               ref - ref.max(-1, keepdims=True), atol=0.35)


@functools.lru_cache(maxsize=None)
def quantized_both(family: str):
    """(JAX params, JAX cfg, port params, port cfg) of quantize_float on the
    family's tiny model, once a family (the tests read them only)."""
    hf, hf_dict = hf_model(family)
    jcfg, tcfg = both_cfgs(hf_dict)
    sd = sd_np(hf)
    jp, jq = jloader.quantize_float(dict(sd), jcfg)
    tp, tq = tloader.quantize_float(dict(sd), tcfg, device="cpu")
    return jp, jq, tp, tq


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantize_float_matches_jax(family):
    """The gamma folds (Gemma's 1 + w), the rotations, the qkv bias and the
    q/k norms as they are, the head (tied for Gemma and Granite, folded and
    rotated): the JAX quantize_float's arrays. Granite's head is padded to
    384 columns in the port, codes and scales 0 past its 259."""
    jp, _, tp, tq = quantized_both(family)
    assert tq.quant == "w4"
    jp = jax.tree_util.tree_map(np.asarray, jp)
    head = tp["lm_head"]
    if family == "granite":
        assert tuple(head["qw8"].shape) == (128, 384)
        assert not head["qw8"][:, 259:].any() and not head["qs"][259:].any()
        head = {k: v[..., :259] for k, v in head.items()}
    counts = [0, 0]
    for key, got in (("layers", tp["layers"]), ("embed", tp["embed"]), ("lm_head", head)):
        assert_quantized_tree_like_jax(jp[key], got, counts, key + ".")
    assert counts[0] <= CODE_DIFF_SHARE * counts[1], counts


def jax_models(family: str):
    """(JAX cfg, JAX params, port cfg, port params) of the JAX package's
    quantize_float output, carried over by params_from_numpy."""
    jp, jq, _, tq = quantized_both(family)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jq, jp, tq, tllama.params_from_numpy(tree, tq, device="cpu")


def forward_case(models, scheme):
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    V = models[2].vocab_size
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, V, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    toks2 = rng.integers(1, V, size=(B, 4)).astype(np.int32)
    pos2 = Q + np.tile(np.arange(4, dtype=np.int32), (B, 1))
    return _forward_both(models, scheme, toks, pos, np.full(B, Q, np.int32), tables,
                         steps=[(toks2, pos2, np.full(B, Q + 4, np.int32))])


# every family at the verify scheme; the draft schemes on Qwen2 (the qkv
# bias) and Granite (the multipliers, the padded head), whose quantized
# activations go through the same knobs as the rest's (each case compiles
# the JAX model_forward twice, about 1.4 s)
FORWARD_CASES = ([(f, "w4a16") for f in sorted(FAMILIES)]
                 + [(f, s) for f in ("granite", "qwen2") for s in ("w4a8", "w4a4")])


@pytest.mark.parametrize("family,scheme", FORWARD_CASES)
def test_model_forward_matches_jax(family, scheme):
    """tests/test_torch_model.py's tolerances on a prefill rectangle and a
    verify-shaped step; at W4A4 the argmaxes of both calls pooled."""
    outs = forward_case(jax_models(family), scheme)
    agree = []
    for jl, tl in outs:
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel
        pick = tl.argmax(-1)
        if scheme == "w4a4":
            agree += (pick == jl.argmax(-1)).reshape(-1).tolist()
        else:
            gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
            assert gap.max() <= TIE_GAP[scheme], gap.max()
    if scheme == "w4a4":
        assert np.mean(agree) >= W4A4_ARGMAX_AGREE, np.mean(agree)


def generate(llm, prompts, max_tokens=10):
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    return [o.output_token_ids for o in llm.generate(prompts, sp)]


def prompts(vocab=256):
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(1, vocab, size=n))) for n in (7, 21, 30)]
    ps[1] = ps[1][:7] * 3
    return ps


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dir_quantized_at_load_serves_qspec(family, tmp_path):
    """LLM(model=<dir>): no weight_scales, so quantize_float at load (a
    tied head written as save_pretrained writes it: no lm_head.weight);
    greedy W4A4 QSpec == its qspec_null oracle."""
    hf, hf_dict = hf_model(family)
    sd = sd_np(hf)
    if hf_dict["tie_word_embeddings"]:
        del sd["lm_head.weight"]
    d = write_dir(tmp_path / family, sd, hf_dict)
    toks = {m: generate(LLM(model=str(d), num_speculative_tokens=3, speculative_method=m,
                            **KW), prompts()) for m in ("qspec", "qspec_null")}
    assert toks["qspec"] == toks["qspec_null"]


# ------------------------------------------------------------- the knobs


def test_longrope_cache_matches_jax_past_the_original_window():
    """The per-position choice: short factors below the original window,
    long ones from it on, the attention factor on both; and the plain
    llama3 and unscaled caches unchanged; another scaling raises."""
    rs = {**LONGROPE, "original_max_position_embeddings": 64}
    got = trotary.make_rope_cache(32, 256, 10000.0, rope_scaling=rs).numpy()
    ref = np.asarray(jrotary.make_rope_cache(32, 256, 10000.0, rope_scaling=rs))
    np.testing.assert_array_equal(got, ref)
    assert not np.allclose(got[:, 64:], np.asarray(jrotary.make_rope_cache(
        32, 256, 10000.0, rope_scaling={**rs, "long_factor": rs["short_factor"]}))[:, 64:])
    with pytest.raises(NotImplementedError, match="yarn"):
        trotary.make_rope_cache(32, 256, rope_scaling={"type": "yarn", "factor": 4.0})


def test_granite_multipliers_change_output():
    """tests/models/test_granite.py:87 on the port: the same weights with
    neutral multipliers give other logits (the knobs are not dropped)."""
    hf, hf_dict = hf_model("granite")
    params, cfg = tloader.load_hf_float(sd_np(hf), tregistry.resolve(hf_dict), device="cpu")
    neutral = dataclasses.replace(cfg, residual_multiplier=1.0, logits_scaling=None,
                                  embed_scale=None, query_pre_attn_scalar=None)
    tokens = np.random.default_rng(4).integers(1, 256, size=8)
    a, b = port_logits(params, cfg, tokens), port_logits(params, neutral, tokens)
    assert not np.allclose(a, b, atol=1e-2)
    for f in ("residual_multiplier", "logits_scaling"):
        one = port_logits(params, dataclasses.replace(cfg, **{f: neutral.__dict__[f]}),
                          tokens)
        assert not np.allclose(a, one, atol=1e-3), f


def test_granite_padded_head_logits_equal_the_plain_head():
    """The int8 head of 259 columns, padded to 384 at load: the logits are
    sliced back to 259 and equal, bit for bit, the plain version's on the
    unpadded head."""
    _, _, tp, tq = quantized_both("granite")
    x = torch.randn(5, 128, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = tllama.compute_logits(x, tp["lm_head"], tq.vocab_size)
    head = tp["lm_head"]
    ref = tlk.matmul_w8a16_ref(x, head["qw8"][:, :259], head["qs"][:259],
                               out_dtype=torch.float32)
    assert tuple(got.shape) == (5, 259)
    assert torch.equal(got, ref)


def qwen2_window_model(use: bool, max_window_layers: int):
    hf, hf_dict = hf_model("qwen2", sliding_window=8, use_sliding_window=use,
                           max_window_layers=max_window_layers)
    return hf, {**hf_dict, "sliding_window": 8, "use_sliding_window": use}


@pytest.mark.parametrize("use,max_window_layers", [(False, 2), (True, 0), (True, 2)])
def test_qwen2_window_as_transformers_applies_it(use, max_window_layers):
    """Past the window (24 tokens, window 8): with ``use_sliding_window``
    false, or true but from a layer past the last (max_window_layers 2 of
    2), Hugging Face applies no window and neither does the port; true from
    layer 0, both window every layer. The JAX package reads the window in
    all three (compared with it only under the window elsewhere)."""
    hf, hf_dict = qwen2_window_model(use, max_window_layers)
    tcfg = tregistry.resolve(hf_dict)
    windowed = use and max_window_layers == 0
    assert tcfg.sliding_window == (8 if windowed else None)
    assert jregistry.resolve(hf_dict).sliding_window == 8
    params, cfg = tloader.load_hf_float(sd_np(hf), tcfg, device="cpu")
    tokens = np.random.default_rng(3).integers(1, 256, size=24)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens[None], dtype=torch.int64)).logits[0].float().numpy()
    got = port_logits(params, cfg, tokens)
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(got - got.max(-1, keepdims=True),
                               ref - ref.max(-1, keepdims=True), atol=0.35)
    # the other reading of the window moves the logits past it
    other = port_logits(params, dataclasses.replace(cfg, sliding_window=None if windowed
                                                    else 8), tokens)
    assert np.abs(other[8:] - got[8:]).max() > 0.35


def test_qwen2_window_on_some_layers_raises():
    _, hf_dict = qwen2_window_model(True, 1)
    with pytest.raises(NotImplementedError, match="max_window_layers=1.*item 9"):
        tregistry.resolve(hf_dict)


QUAROT_NAMES = {"QuarotLlamaForCausalLM": "llama", "llama_quarot": "llama",
                "Qwen2QuaRotForCausalLM": "qwen2", "qwen2_quarot": "qwen2"}


@pytest.mark.parametrize("name", sorted(QUAROT_NAMES))
def test_quarot_names_resolve_like_jax(name):
    """The reference's QuaRot architecture names, as ``architectures`` or as
    the bare model type, with a model type that names the QuaRot model too."""
    base = {**COMMON, "model_type": "llama_quarot" if "lama" in name.lower()
            else "qwen2_quarot"}
    forms = [{**base, "architectures": [name]}]
    if name.islower():
        forms.append({**base, "model_type": name})
    for hf in forms:
        jcfg, tcfg = assert_resolves_like_jax(hf)
        assert tcfg.arch == QUAROT_NAMES[name]
        assert tcfg.qkv_bias == (QUAROT_NAMES[name] == "qwen2")


def test_unported_model_types_raise():
    for mt in ("gemma3_text", "granitemoe", "qwen2_vl", "mllama", "falcon_h1"):
        with pytest.raises(NotImplementedError, match="model_type"):
            ModelConfig.from_hf_config({**COMMON, "model_type": mt})


# the published MLP widths the QuaRot intermediate Hadamard rotates: Qwen2-7B,
# Granite-3.0-8B, Qwen3-8B, Gemma-7B, Mistral-7B, Phi-3-mini; and the head
# counts (Qwen2-7B's 28)
WIDTHS = {18944: (148, 128), 12800: (100, 128), 12288: (24, 512), 24576: (48, 512),
          14336: (28, 512), 8192: (16, 512)}


@pytest.mark.parametrize("n", sorted(WIDTHS))
def test_hadamard_factors_of_the_published_widths(n):
    assert thad.decompose_dim(n) == jhad.decompose_dim(n) == WIDTHS[n]
    for f in set(WIDTHS[n]) - {1}:
        h = thad.hadamard_matrix(f)
        np.testing.assert_array_equal(h, np.asarray(jhad.hadamard_matrix(f)))
        np.testing.assert_array_equal(h @ h.T, f * np.eye(f))


def test_head_hadamards_of_the_published_head_counts():
    for nh in (16, 28, 32):
        h = thad.hadamard_matrix(nh)
        np.testing.assert_array_equal(h, np.asarray(jhad.hadamard_matrix(nh)))
        np.testing.assert_array_equal(h @ h.T, nh * np.eye(nh))


def test_qwen2_7b_preset_through_llm_args():
    from qspec_tpu_torch.engine.arg_utils import EngineArgs
    assert EngineArgs(model="qwen2-7b").model_config() == ModelConfig.qwen2_7b()
    assert EngineArgs(model="llama3-70b", quantization="awq").model_config() == \
        ModelConfig.llama3_70b(quant="w4g")
