"""Falcon's parallel blocks and the ALiBi float families (Falcon, JAIS)
against Hugging Face and the JAX package, on the CPU.

Falcon in its three layouts, built in process by ``transformers`` 4.57.6
(hidden 64, 2 layers, 4 heads of 16) with every LayerNorm's weight and
bias perturbed (std 0.3), so a norm read in the wrong place shows:

- "7b": multi-query (one KV head), parallel blocks sharing one norm, rope;
- "40b": ``new_decoder_architecture`` GQA (2 KV heads, rows interleaved per
  group), parallel blocks with ``ln_attn`` and ``ln_mlp``;
- "rw": falcon-rw, multi-head rows interleaved per head, sequential blocks,
  ALiBi and biases.

Each converted by ``load_family_float`` is held against
``transformers.FalconForCausalLM`` at ``tests/models/test_gpt_family.py``'s
``check_against_hf`` tolerances, and against the JAX converter where the
JAX package is right (the 7B layout; the 40B one with ``ln_mlp`` equal to
``ln_attn``; falcon-rw's tree and, with the JAX package's unscaled slopes,
its logits). JAIS is held against the JAX ``convert_jais`` (its muP scales
non-trivial) with the swiglu pair as JAIS computes it. The parallel block at
one and two norms against the JAX ``decoder_layer``; in the port, n-gram
speculation == AR for each; ``LLM(model=<Falcon dir>)`` in bf16.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
import transformers

from qspec_tpu.model_loader import families as jfam
from qspec_tpu.models import registry as jregistry
from qspec_tpu.ops import attention as jattn
from qspec_tpu_torch import LLM
from qspec_tpu_torch.config import (CacheConfig, EngineConfig, SchedulerConfig,
                                    SpeculativeConfig)
from qspec_tpu_torch.model_loader import families as tfam
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops import attention as tattn
from tests.test_torch_dense_families import KW, generate
from tests.test_torch_moe_hf import assert_same_tree, port_logits
from tests.test_torch_remap_families import jax_bf16_logits

V, H, L, NH = 256, 64, 2, 4
LAYOUTS = {
    "7b": dict(multi_query=True, new_decoder_architecture=False, parallel_attn=True,
               bias=False, alibi=False),
    "40b": dict(num_kv_heads=2, multi_query=True, new_decoder_architecture=True,
                parallel_attn=True, bias=False, alibi=False),
    "rw": dict(multi_query=False, new_decoder_architecture=False, parallel_attn=False,
               bias=True, alibi=True),
}
TOKENS = list(range(2, 26))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def falcon(layout: str, tie_mlp_norm: bool = False):
    """(HF model, config.json dict, numpy state dict); every LayerNorm's
    weight 1 + 0.3 N(0, 1) and bias 0.3 N(0, 1); ``tie_mlp_norm``: 40B's
    ln_mlp a copy of ln_attn."""
    hf_cfg = transformers.FalconConfig(vocab_size=V, hidden_size=H, num_hidden_layers=L,
                                       num_attention_heads=NH, rope_theta=10000.0,
                                       max_position_embeddings=128, **LAYOUTS[layout])
    torch.manual_seed(0)
    hf = transformers.FalconForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "ln" in name or "layernorm" in name:
                p.copy_((name.endswith("weight")) + 0.3 * torch.randn_like(p))
        if tie_mlp_norm:
            for layer in hf.transformer.h:
                layer.ln_mlp.load_state_dict(layer.ln_attn.state_dict())
    hf_dict = {**hf_cfg.to_dict(), "architectures": ["FalconForCausalLM"]}
    return hf, hf_dict, {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}


def hf_logits(hf, tokens=TOKENS):
    with torch.no_grad():
        return hf(torch.tensor([tokens])).logits[0].float().numpy()


def check_against_hf(got, want, atol=0.25):
    """``tests/models/test_gpt_family.py::check_against_hf``'s tolerances: the
    top-1 everywhere but at genuine near-ties (top-2 margin under 0.01),
    and the logits at atol 0.25, rtol 0.05."""
    top2 = np.sort(want, axis=-1)
    tied = (top2[:, -1] - top2[:, -2]) < 0.01
    agree = (got.argmax(-1) == want.argmax(-1)) | tied
    assert agree.mean() > 0.95, (got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0.05)


def port_falcon(layout: str, tie_mlp_norm: bool = False):
    _, hf_dict, sd = falcon(layout, tie_mlp_norm)
    return tfam.load_family_float({k: torch.tensor(v) for k, v in sd.items()},
                                  tregistry.resolve(hf_dict), device="cpu")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_falcon_vs_hf(layout):
    """Each layout against transformers, its norms perturbed: the 40B
    layout's MLP reads ln_mlp (parallel_norms=2), falcon-rw's ALiBi slopes
    carry Falcon's 1 / sqrt(d)."""
    hf, hf_dict, _ = falcon(layout)
    params, cfg = port_falcon(layout)
    assert cfg.parallel_block == (layout != "rw")
    assert cfg.parallel_norms == (2 if layout == "40b" else 1)
    assert cfg.num_kv_heads == {"7b": 1, "40b": 2, "rw": NH}[layout]
    assert ("post_norm" in params["layers"]) == (layout != "7b")
    got, want = port_logits(params, cfg, TOKENS), hf_logits(hf)
    check_against_hf(got, want)
    # tighter than check_against_hf's 0.25, so that falcon-rw's slopes
    # without the 1 / sqrt(d) (0.10 off here) or the 40B layout's MLP on
    # ln_attn (0.41) fail; the bf16 trunk is 0.006 off
    assert np.abs(got - want).max() < 0.04


def test_falcon_7b_vs_jax():
    """The multi-query layout: the JAX converter's tree bit for bit, its
    bf16 logits within the dense-family tolerance."""
    from tests.test_torch_remap_families import assert_logits_close
    _, hf_dict, sd = falcon("7b")
    params, cfg = port_falcon("7b")
    jparams, jcfg = jfam.load_family_float(dict(sd), jregistry.resolve(hf_dict))
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "rope_cache"})
    assert_logits_close(port_logits(params, cfg, TOKENS), jax_bf16_logits(jparams, jcfg, TOKENS))


def test_falcon_40b_two_norms_vs_jax():
    """The new-decoder layout: with ln_mlp == ln_attn the JAX converter
    (which reads ln_attn only) is the same model, and agrees; with them
    apart it leaves Hugging Face (finding: its MLP reads the attention's
    norm), while the JAX graph given parallel_norms=2 and ln_mlp as its
    post_norm agrees with the port again."""
    from tests.test_torch_remap_families import assert_logits_close
    hf, hf_dict, sd = falcon("40b", tie_mlp_norm=True)
    params, cfg = port_falcon("40b", tie_mlp_norm=True)
    jparams, jcfg = jfam.load_family_float(dict(sd), jregistry.resolve(hf_dict))
    assert jcfg.parallel_norms == 1 and cfg.parallel_norms == 2
    want = hf_logits(hf)
    check_against_hf(port_logits(params, cfg, TOKENS), want)
    assert_logits_close(port_logits(params, cfg, TOKENS), jax_bf16_logits(jparams, jcfg, TOKENS))
    # ln_mlp apart from ln_attn
    hf, hf_dict, sd = falcon("40b")
    params, cfg = port_falcon("40b")
    jparams, jcfg = jfam.load_family_float(dict(sd), jregistry.resolve(hf_dict))
    want, got = hf_logits(hf), port_logits(params, cfg, TOKENS)
    jax_one_norm = jax_bf16_logits(jparams, jcfg, TOKENS)
    assert np.abs(jax_one_norm - want).max() > 4 * np.abs(got - want).max()
    jparams["layers"]["post_norm"] = params["layers"]["post_norm"].float().numpy()
    jparams["layers"]["post_norm_b"] = params["layers"]["post_norm_b"].float().numpy()
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, jparams)
    jparams["layers"]["post_norm"] = jparams["layers"]["post_norm"].astype(jax.numpy.bfloat16)
    jparams["layers"]["post_norm_b"] = jparams["layers"]["post_norm_b"].astype(
        jax.numpy.bfloat16)
    two = jax_bf16_logits(jparams, dataclasses.replace(jcfg, parallel_norms=2), TOKENS)
    assert_logits_close(got, two)


def test_falcon_rw_vs_jax():
    """falcon-rw: the JAX converter's tree (the per-head de-interleave of
    the weight and its bias, the sequential norms) bit for bit; its logits
    with the port's slopes set to the JAX package's unscaled ones, which
    Hugging Face's are not (they carry 1 / sqrt(d))."""
    from tests.test_torch_remap_families import assert_logits_close
    _, hf_dict, sd = falcon("rw")
    params, cfg = port_falcon("rw")
    jparams, jcfg = jfam.load_family_float(dict(sd), jregistry.resolve(hf_dict))
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "alibi_slopes"})
    unscaled = tattn.alibi_slopes(NH)
    np.testing.assert_allclose(params["alibi_slopes"].numpy(), unscaled / 4.0, rtol=1e-6)
    jax_params = {**params, "alibi_slopes": torch.tensor(unscaled)}
    assert_logits_close(port_logits(jax_params, cfg, TOKENS),
                        jax_bf16_logits(jparams, jcfg, TOKENS))


@pytest.mark.parametrize("n", [40, 12, 71, 64])
def test_alibi_slopes_match_jax(n):
    """Non-power-of-two head counts (Baichuan-13B's and JAIS-13B's 40)."""
    np.testing.assert_array_equal(tattn.alibi_slopes(n), np.asarray(jattn.alibi_slopes(n)))


# ------------------------------------------------------------------- JAIS

JAIS_HF = dict(architectures=["JAISLMHeadModel"], model_type="jais", n_embd=H, n_head=NH,
               n_layer=L, n_inner=128, vocab_size=V, n_positions=128,
               position_embedding_type="alibi", activation_function="swiglu",
               embeddings_scale=14.6, width_scale=0.25, scale_qk_dot_by_d=True,
               layer_norm_epsilon=1e-5)


@functools.lru_cache(maxsize=None)
def jais_sd() -> dict:
    """A tiny JAIS checkpoint in its own keys (Conv1D weights [in, out])."""
    r = np.random.default_rng(8)
    In = JAIS_HF["n_inner"]

    def w(*shape, s=0.05):
        return (s * r.standard_normal(shape)).astype(np.float32)

    sd = {"transformer.wte.weight": w(V, H, s=0.02),
          "transformer.ln_f.weight": 1 + w(H, s=0.3), "transformer.ln_f.bias": w(H, s=0.3),
          "transformer.relative_pe.slopes": np.zeros((NH, 1), np.float32)}
    for li in range(L):
        p = f"transformer.h.{li}."
        for n in ("ln_1", "ln_2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + w(H, s=0.3), w(H, s=0.3)
        for n, (k, m) in {"attn.c_attn": (H, 3 * H), "attn.c_proj": (H, H),
                          "mlp.c_fc": (H, In), "mlp.c_fc2": (H, In),
                          "mlp.c_proj": (In, H)}.items():
            sd[p + n + ".weight"], sd[p + n + ".bias"] = w(k, m), w(m, s=0.01)
    return sd


def port_jais():
    sd = {k: torch.tensor(v) for k, v in jais_sd().items()}
    return tfam.load_family_float(sd, tregistry.resolve(JAIS_HF), device="cpu")


def test_jais_vs_jax():
    """The JAX convert_jais on the same checkpoint with c_fc and c_fc2
    named the other way round (the JAX converter takes c_fc as the gate;
    JAIS computes c_fc(x) * silu(c_fc2(x))) is the port's model: the tree
    bit for bit, the bf16 logits within the dense-family tolerance, the muP
    scales in the config."""
    from tests.test_torch_remap_families import assert_logits_close
    params, cfg = port_jais()
    jcfg = jregistry.resolve(JAIS_HF)
    for f in ("embed_scale", "logits_scaling", "query_pre_attn_scalar", "position_embedding",
              "mlp_gated", "linear_bias", "tie_word_embeddings", "intermediate_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.embed_scale, cfg.logits_scaling, cfg.query_pre_attn_scalar) == (14.6, 4.0, 256)
    swapped = {k.replace("mlp.c_fc.", "mlp.X.").replace("mlp.c_fc2.", "mlp.c_fc.")
               .replace("mlp.X.", "mlp.c_fc2."): v for k, v in jais_sd().items()}
    jparams, jq = jfam.load_family_float(swapped, jcfg)
    assert_same_tree({k: v for k, v in jparams.items() if k != "rope_cache"},
                     {k: v for k, v in params.items() if k != "alibi_slopes"})
    In = JAIS_HF["n_inner"]
    np.testing.assert_array_equal(params["layers"]["gate_up"]["w"][0, :, :In].float().numpy(),
                                  jais_sd()["transformer.h.0.mlp.c_fc2.weight"].astype(
                                      jax.numpy.bfloat16).astype(np.float32))
    assert_logits_close(port_logits(params, cfg, TOKENS), jax_bf16_logits(jparams, jq, TOKENS))


def test_jais_refusals():
    with pytest.raises(NotImplementedError, match="learned positions"):
        tregistry.resolve({**JAIS_HF, "position_embedding_type": "learned"})
    with pytest.raises(NotImplementedError, match="alibi_scaling"):
        tregistry.resolve({**JAIS_HF, "alibi_scaling": {"type": "linear", "factor": 2.0}})


# ------------------------------------------------------------- the engine


def run(params, cfg, method, prompts):
    from qspec_tpu_torch.engine.llm_engine import LLMEngine
    from qspec_tpu_torch.sampling_params import SamplingParams
    spec = None if method is None else SpeculativeConfig(num_speculative_tokens=3, method=method)
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16, num_pages=40),
                                 scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=128,
                                                           prefill_chunk_size=64),
                                 speculative=spec), params, device="cpu", seed=0)
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in prompts]
    done = {}
    while eng.has_unfinished_requests():
        for out in eng.step():
            if out.finished:
                done[out.request_id] = out.output_token_ids
    return [done[i] for i in ids], eng


def repeat_prompts():
    r = np.random.default_rng(9)
    ps = [list(map(int, r.integers(1, V, size=n))) for n in (9, 24, 30)]
    ps[1] = ps[1][:6] * 4
    ps[2] = ps[2][:10] * 3
    return ps


@pytest.mark.parametrize("family", ["7b", "40b", "rw", "jais"])
def test_ngram_equals_ar(family):
    """n-gram prompt lookup (k = 3) gives AR's greedy tokens, with drafts
    accepted (the prompts repeat spans)."""
    params, cfg = port_jais() if family == "jais" else port_falcon(family)
    ar, _ = run(params, cfg, None, repeat_prompts())
    got, eng = run(params, cfg, "ngram", repeat_prompts())
    assert got == ar
    assert eng.spec_metrics.num_draft_tokens > 0


def test_falcon_dir_through_llm(tmp_path):
    """LLM(model=<Falcon-40B-layout dir>, quantization=None): the family
    converter at load, n-gram == the state dict's AR tokens."""
    hf, hf_dict, _ = falcon("40b")
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    assert cfg_json["architectures"] == ["FalconForCausalLM"]
    llm = LLM(model=str(tmp_path), quantization=None, num_speculative_tokens=3,
              speculative_model="[ngram]", **KW)
    assert llm.engine_config.model.parallel_norms == 2
    params, cfg = port_falcon("40b")
    ar, _ = run(params, cfg, None, repeat_prompts())
    assert generate(llm, repeat_prompts(), max_tokens=12) == ar
