"""The gptj rope and partial rotary with the families that use them, on the
CPU: the parallel-residual float families GPT-J, GPT-NeoX / Pythia (parallel
and sequential), Phi, StableLM and Cohere, and the llama-keyed GLM-4 and
Helium.

Each family's tiny model is built in process by ``transformers`` 4.57.6
(hidden 64, 2 layers, 4 heads of 16), every LayerNorm / RMSNorm weight
1 + 0.3 N(0, 1), every bias 0.1 N(0, 1) (the head's too) and the q and k
weights 6 times their init (so the attention, and with it the rope, moves
the logits): a norm, a bias or a rotated dim read in the wrong place shows.
For each:

- its config.json resolves in the port as in the JAX registry (rotary
  width, rope style, head bias, parallel block, norms);
- the port's converter (``load_family_float``; ``load_hf_float`` for GLM and
  Helium) gives the JAX converter's tree bit for bit and the JAX
  ``model_forward``'s bf16 logits within the dense-family tolerance; the JAX
  tree carried over by ``params_from_numpy`` gives the port's logits;
- its logits match the ``transformers`` model's at
  ``tests/models/test_gpt_family.py``'s tolerances (argmax > 0.95 but at
  near-ties, atol 0.25 / rtol 0.05), and the same model with the other rope
  pairing or the whole head rotated does not;
- ``LLM(model=<its save_pretrained directory>, quantization=None)`` serves
  it, greedy n-gram (k = 3) == the engine's AR tokens.

Then Helium under QuaRot against the JAX ``quantize_float``, Qwen v1's
partial rotary against the JAX graph given the same width, and every
refusal (ROADMAP queue 1 item 9).
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
import transformers
from transformers.activations import ACT2FN

from qspec_tpu.model_loader import families as jfam
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import registry as jregistry
from qspec_tpu.ops import rotary as jrotary
from qspec_tpu_torch import LLM
from qspec_tpu_torch.model_loader import families as tfam
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.models import registry as tregistry
from tests.test_torch_dense_families import KW, generate
from tests.test_torch_falcon_jais import check_against_hf, hf_logits, repeat_prompts, run
from tests.test_torch_model import REL_TOL, TIE_GAP, W4A4_ARGMAX_AGREE, _forward_both
from tests.test_torch_moe_hf import (assert_quantized_tree_like_jax, assert_same_tree,
                                     port_logits)
from tests.test_torch_quantize_float import CODE_DIFF_SHARE
from tests.test_torch_remap_families import assert_logits_close, jax_bf16_logits

V, H, L, NH = 256, 64, 2, 4
T = transformers
# family -> (config class, model class, config fields)
FAMILIES = {
    "gptj": (T.GPTJConfig, T.GPTJForCausalLM,
             dict(n_embd=H, n_layer=L, n_head=NH, rotary_dim=8, n_positions=128,
                  activation_function="gelu_new")),
    "gpt_neox": (T.GPTNeoXConfig, T.GPTNeoXForCausalLM,
                 dict(rotary_pct=0.25, use_parallel_residual=True)),
    "gpt_neox_seq": (T.GPTNeoXConfig, T.GPTNeoXForCausalLM,
                     dict(rotary_pct=0.5, use_parallel_residual=False)),
    "phi": (T.PhiConfig, T.PhiForCausalLM,
            dict(partial_rotary_factor=0.5, hidden_act="gelu_new")),
    "stablelm": (T.StableLmConfig, T.StableLmForCausalLM,
                 dict(num_key_value_heads=2, partial_rotary_factor=0.25, use_qkv_bias=True)),
    "cohere": (T.CohereConfig, T.CohereForCausalLM,
               dict(num_key_value_heads=2, logit_scale=0.25, use_qk_norm=False,
                    tie_word_embeddings=True)),
    "glm": (T.GlmConfig, T.GlmForCausalLM,
            dict(num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.5,
                 attention_bias=True, pad_token_id=1, eos_token_id=2)),
    "helium": (T.HeliumConfig, T.HeliumForCausalLM, dict(num_key_value_heads=2, head_dim=16)),
}
# the llama-graph fields, for every family but GPT-J (its own names above)
COMMON = dict(hidden_size=H, intermediate_size=128, num_hidden_layers=L,
              num_attention_heads=NH, max_position_embeddings=128)
# (rotary width, rope style, head bias, parallel block, parallel norms) each
# family resolves to
EXPECT = {"gptj": (8, "gptj", True, True, 1), "gpt_neox": (4, "neox", False, True, 2),
          "gpt_neox_seq": (8, "neox", False, False, 2), "phi": (8, "neox", True, True, 1),
          "stablelm": (4, "neox", False, False, 1), "cohere": (None, "gptj", False, True, 1),
          "glm": (8, "gptj", False, False, 1), "helium": (None, "gptj", False, False, 1)}
TOKENS = list(range(2, 26))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def family(name: str):
    """(HF model, config.json dict, numpy state dict) of the tiny model, its
    norm weights 1 + 0.3 N(0, 1), its biases 0.1 N(0, 1), its q and k
    weights (GPT-NeoX: the fused q / k / v) times 6."""
    conf_cls, model_cls, over = FAMILIES[name]
    base = {} if name == "gptj" else COMMON
    torch.manual_seed(0)
    hf = model_cls(conf_cls(**{"vocab_size": V, "tie_word_embeddings": False, **base,
                               **over})).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "norm" in n or ".ln_" in n:
                p.copy_(n.endswith("weight") + 0.3 * torch.randn_like(p))
            elif n.endswith(".bias"):
                p.copy_(0.1 * torch.randn_like(p))
            if any(k in n for k in ("q_proj.weight", "k_proj.weight", "query_key_value.weight")):
                # sharper attention, so that the positions the rope encodes
                # move the logits
                p.mul_(6.0)
    hf_dict = {**hf.config.to_dict(), "architectures": [model_cls.__name__]}
    return hf, hf_dict, {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def llama_keyed(name: str) -> bool:
    return name in ("glm", "helium")


def port_load(name: str, cfg=None):
    """The port's bf16 tree and cfg of the tiny model (state dict consumed)."""
    _, hf_dict, sd = family(name)
    cfg = cfg or tregistry.resolve(hf_dict)
    sd = {k: torch.tensor(v) for k, v in sd.items()}
    if llama_keyed(name):
        return tloader.load_hf_float(sd, cfg, device="cpu")
    return tfam.load_family_float(sd, cfg, device="cpu")


def jax_load(name: str):
    _, hf_dict, sd = family(name)
    jcfg = jregistry.resolve(hf_dict)
    load = jloader.load_hf_float if llama_keyed(name) else jfam.load_family_float
    return load(dict(sd), jcfg)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_resolves_like_jax(name):
    """The port reads the config.json as the JAX registry does: the rotary
    width, the pairing, the head bias, the parallel block and its norms,
    the norm and MLP kinds, the biases and Cohere's logit scale; gelu_new
    reads as the tanh gelu it is."""
    _, hf_dict, _ = family(name)
    jcfg, tcfg = jregistry.resolve(hf_dict), tregistry.resolve(hf_dict)
    assert (tcfg.rotary_dim, tcfg.rope_style, tcfg.lm_head_bias, tcfg.parallel_block,
            tcfg.parallel_norms) == EXPECT[name]
    for f in ("rotary_dim", "rope_style", "lm_head_bias", "parallel_block", "norm_type",
              "mlp_gated", "linear_bias", "qkv_bias", "logits_scaling", "tie_word_embeddings",
              "num_heads", "num_kv_heads", "head_dim", "intermediate_size", "rope_theta",
              "rms_norm_eps", "quant"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    if tcfg.parallel_block:
        assert tcfg.parallel_norms == jcfg.parallel_norms
    assert tcfg.hidden_act == {"gelu_new": "gelu_tanh"}.get(jcfg.hidden_act, jcfg.hidden_act)
    assert tcfg.rope_dim == (tcfg.rotary_dim or tcfg.head_dim)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_vs_hf(name):
    """The port's logits against transformers', within a 0.02 max
    difference (the bf16 trunk's 0.001-0.005) and check_against_hf's
    tolerances; the other pairing, or the whole head rotated, is more than
    4 times as far off (so the check sees the rope)."""
    hf, _, _ = family(name)
    params, cfg = port_load(name)
    want = hf_logits(hf, TOKENS)
    got = port_logits(params, cfg, TOKENS)
    check_against_hf(got, want)
    err = np.abs(got - want).max()
    assert err < 0.02
    other = dataclasses.replace(cfg, rope_style={"neox": "gptj", "gptj": "neox"}[cfg.rope_style])
    assert np.abs(port_logits(params, other, TOKENS) - want).max() > 4 * err
    if cfg.rotary_dim is not None:
        whole = {**params, "rope_cache": tllama.make_rope_cache(cfg.head_dim, 128,
                                                                cfg.rope_theta)}
        assert np.abs(port_logits(whole, cfg, TOKENS) - want).max() > 4 * err


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_vs_jax(name):
    """The JAX converter's tree bit for bit (the rope cache at its partial
    width within 1e-6), its bf16 logits within the dense-family tolerance,
    and the JAX tree through params_from_numpy gives the port's logits."""
    params, cfg = port_load(name)
    jparams, jcfg = jax_load(name)
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "rope_cache"})
    assert set(jparams) == set(params)
    assert params["rope_cache"].shape == (2, cfg.max_position_embeddings, cfg.rope_dim // 2)
    np.testing.assert_allclose(params["rope_cache"].numpy(), np.asarray(jparams["rope_cache"]),
                               atol=1e-6)
    got = port_logits(params, cfg, TOKENS)
    assert_logits_close(got, jax_bf16_logits(jparams, jcfg, TOKENS))
    carried = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                       device="cpu")
    np.testing.assert_allclose(port_logits(carried, cfg, TOKENS), got, atol=1e-6)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dir_through_llm_ngram_equals_ar(name, tmp_path):
    """LLM(model=<save_pretrained dir>, quantization=None): the family's
    converter (or the llama-keyed loader) at load, greedy n-gram (k = 3) ==
    the engine's AR tokens on the state dict's parameters, drafts proposed."""
    hf, _, _ = family(name)
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert json.loads((tmp_path / "config.json").read_text())["architectures"] == [
        FAMILIES[name][1].__name__]
    llm = LLM(model=str(tmp_path), quantization=None, num_speculative_tokens=3,
              speculative_model="[ngram]", **KW)
    params, cfg = port_load(name)
    assert llm.engine_config.model == dataclasses.replace(cfg, lm_head_quant="auto")
    ar, _ = run(params, cfg, None, repeat_prompts())
    assert generate(llm, repeat_prompts(), max_tokens=12) == ar
    assert llm.spec_metrics.num_draft_tokens > 0


def test_layernorm_families_refuse_quarot(tmp_path):
    """A LayerNorm family under the default quantization="qspec" raises:
    the QuaRot pipeline folds RMSNorm gammas only (as in the JAX package,
    which serves these families as bf16 checkpoints)."""
    hf, _, _ = family("gptj")
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    with pytest.raises(NotImplementedError, match="bf16 weights"):
        LLM(model=str(tmp_path), **KW)


# (family, the layer key taken out of its state dict, or (key, shape) put in):
# a bias or a beta on some layers only
PARTIAL = {
    "phi_dense_bias_layer0": ("phi", "model.layers.0.self_attn.dense.bias"),
    "neox_dense_bias_layer1": ("gpt_neox", "gpt_neox.layers.1.attention.dense.bias"),
    "stablelm_k_bias_layer1": ("stablelm", "model.layers.1.self_attn.k_proj.bias"),
    "gptj_ln_1_beta_layer1": ("gptj", "transformer.h.1.ln_1.bias"),
    "mpt_norm_1_beta_layer0_only": ("mpt", ("transformer.blocks.0.norm_1.bias", (64,))),
}


@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_bias_on_some_layers_raises(case):
    """A projection bias or a LayerNorm beta that only some layers carry
    raises a ValueError naming the layers, before a stack is filled: a bias
    decided from layer 0 alone would drop a later layer's, or leave a
    layer's row of the stack unset."""
    from tests.test_torch_alibi import _hf_mpt
    name, edit = PARTIAL[case]
    if name == "mpt":
        hf, hf_dict = _hf_mpt()
        sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    else:
        _, hf_dict, np_sd = family(name)
        sd = {k: torch.tensor(v) for k, v in np_sd.items()}
    if isinstance(edit, str):
        del sd[edit]
    else:
        sd[edit[0]] = torch.zeros(edit[1])
    with pytest.raises(ValueError, match=r"on layers \[\d\] but not on \[\d\]"):
        tfam.load_family_float(sd, tregistry.resolve(hf_dict), device="cpu")


# --------------------------------------------------- Helium under QuaRot


@functools.lru_cache(maxsize=None)
def helium_quantized():
    _, hf_dict, sd = family("helium")
    jp, jq = jloader.quantize_float(dict(sd), jregistry.resolve(hf_dict))
    tp, tq = tloader.quantize_float({k: torch.tensor(v) for k, v in sd.items()},
                                    tregistry.resolve(hf_dict), device="cpu")
    return jax.tree_util.tree_map(np.asarray, jp), jq, tp, tq


def test_helium_quantize_float_matches_jax():
    """The int4 codes of the JAX quantize_float, but for CODE_DIFF_SHARE of
    them one step off (sum order), the scales at rtol 1e-5; the cfg keeps
    the gptj rope."""
    jp, _, tp, tq = helium_quantized()
    assert tq.quant == "w4" and tq.rope_style == "gptj" and tq.arch == "helium"
    counts = [0, 0]
    for key in ("layers", "embed", "lm_head"):
        assert_quantized_tree_like_jax(jp[key], tp[key], counts, key + ".")
    assert counts[0] <= CODE_DIFF_SHARE * counts[1], counts


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8", "w4a4"])
def test_helium_quarot_forward_matches_jax(scheme):
    """The JAX quantize_float's params, carried over, through both
    model_forwards (the JAX Pallas kernels in interpret mode): a prefill
    rectangle and a verify-shaped step at tests/test_torch_model.py's
    tolerances: relative L2 within REL_TOL (W4A16 2e-2; W4A4 0.3, where a
    per-token int4 activation code one step apart moves a row: 0.11 here),
    the port's argmax within TIE_GAP of the JAX maximum, and at W4A4 the
    argmaxes of both calls agreeing on W4A4_ARGMAX_AGREE of the rows."""
    jp, jq, _, tq = helium_quantized()
    models = (jq, jax.tree_util.tree_map(jax.numpy.asarray, jp), tq,
              tllama.params_from_numpy(jp, tq, device="cpu"))
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, V, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    step = (rng.integers(1, V, size=(B, 4)).astype(np.int32),
            Q + np.tile(np.arange(4, dtype=np.int32), (B, 1)), np.full(B, Q + 4, np.int32))
    agree = []
    for jl, tl in _forward_both(models, scheme, toks, pos, np.full(B, Q, np.int32), tables,
                                steps=[step]):
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel
        pick = tl.argmax(-1)
        if scheme in TIE_GAP:
            gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
            assert gap.max() <= TIE_GAP[scheme]
        agree += (pick == jl.argmax(-1)).reshape(-1).tolist()
    if scheme == "w4a4":
        assert np.mean(agree) >= W4A4_ARGMAX_AGREE


def test_helium_quarot_qspec_equals_ar():
    """Greedy QSpec (k = 3) at W4A4 on the quantized Helium gives AR's
    tokens, bit for bit."""
    _, _, tp, tq = helium_quantized()
    ar, _ = run(tp, tq, None, repeat_prompts())
    got, eng = run(tp, tq, "qspec", repeat_prompts())
    assert got == ar
    assert eng.runner.draft_forwards > 0


# ------------------------------------------------- Qwen v1's partial rotary


def test_qwen1_partial_rotary_matches_jax_given_the_width():
    """Qwen v1 with rotary_pct 0.5 ropes the first half of each head (its
    modeling code's rotary_ndims): the port's logits equal the JAX graph's
    given the same rotary_dim and cache within the dense-family tolerance;
    the JAX registry ignores rotary_pct (the whole head, ROADMAP §3), which
    the port's logits are far from."""
    from tests.test_torch_remap_families import cfgs, family_sd, llama_sd, torch_sd
    jcfg, tcfg = cfgs("qwen", rotary_pct=0.5)
    assert tcfg.rotary_dim == tcfg.head_dim // 2 and jcfg.rotary_dim is None
    fsd = family_sd("qwen", llama_sd("qwen"))
    params, cfg = tloader.load_hf_float(torch_sd(fsd), tcfg, device="cpu")
    assert params["rope_cache"].shape[-1] == cfg.head_dim // 4
    jparams, jq = jfam.load_family_float(dict(fsd), jcfg)
    tokens = np.random.default_rng(3).integers(1, 256, size=24)
    got = port_logits(params, cfg, tokens)
    whole = jax_bf16_logits(jparams, jq, tokens)
    jparams["rope_cache"] = jrotary.make_rope_cache(cfg.rotary_dim, jq.max_position_embeddings,
                                                    jq.rope_theta)
    same = jax_bf16_logits(jparams, dataclasses.replace(jq, rotary_dim=cfg.rotary_dim), tokens)
    assert_logits_close(got, same)
    assert np.abs(got - whole).max() > 3 * np.abs(got - same).max()


# ------------------------------------------------------------ refusals

REFUSALS = {
    "cohere_qk_norm": ("cohere", dict(use_qk_norm=True), "use_qk_norm"),
    "cohere2": ("cohere", dict(architectures=["Cohere2ForCausalLM"], model_type="cohere2"),
                "Cohere2"),
    "stablelm_qk_layernorm": ("stablelm", dict(qk_layernorm=True), "qk_layernorm"),
    "stablelm_parallel": ("stablelm", dict(use_parallel_residual=True), "use_parallel_residual"),
    "phi_qk_layernorm": ("phi", dict(qk_layernorm=True), "qk_layernorm"),
    "glm4": ("glm", dict(architectures=["Glm4ForCausalLM"], model_type="glm4"), "GLM-4-0414"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_9(case, tmp_path):
    """Each layout the port lacks raises NotImplementedError naming ROADMAP
    queue 1 item 9: from the registry, and from LLM(model=<dir>) before the
    directory's weights are read (it holds only its config.json)."""
    base, over, what = REFUSALS[case]
    hf = {**family(base)[1], **over}
    with pytest.raises(NotImplementedError, match=f"{what}.*queue 1 item 9"):
        tregistry.resolve(hf)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        LLM(model=str(tmp_path), quantization=None, **KW)


def test_activation_names():
    """gelu_new, gelu_fast and gelu_pytorch_tanh are the tanh gelu (one
    formula; GPT-NeoX-20B ships gelu_fast, which the JAX package's _plain_act
    runs as silu: ROADMAP §3); an unknown activation raises."""
    from qspec_tpu_torch.config import ModelConfig, _act
    x = torch.linspace(-4, 4, 101)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    for name in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        assert _act(name) == "gelu_tanh"
        torch.testing.assert_close(ACT2FN[name](x), tanh, atol=1e-6, rtol=1e-6)
    neox = {**family("gpt_neox")[1], "hidden_act": "gelu_fast"}
    assert tregistry.resolve(neox).hidden_act == "gelu_tanh"
    with pytest.raises(NotImplementedError, match="hidden_act"):
        tregistry.resolve({**family("gpt_neox")[1], "hidden_act": "relu2"})
    with pytest.raises(ValueError, match="rotary_dim"):
        ModelConfig.tiny(rotary_dim=7)
