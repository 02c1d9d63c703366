"""Checkpoint directories that ship quantized, on the CPU: AWQ / GPTQ
directories and the reference's QuaRot QSpec format with Qwen2's biases.

- AWQ and GPTQ directories (config.json with its ``quantization_config``,
  ``model.safetensors`` written from ``make_awq_tensors`` /
  ``make_gptq_tensors`` through ``make_grouped_state_dict``) at a tiny
  Qwen2's widths, with its q/k/v biases: ``load_awq`` / ``load_gptq`` of the
  directory give the state-dict route's arrays and the JAX loaders' arrays
  of the same directory, bit for bit, the bias included;
- ``EngineArgs`` and ``LLM(model=<dir>)`` route by
  ``quantization_config.quant_method``, as the JAX package does: AWQ / GPTQ
  to the grouped loader (greedy QSpec with the W4A16 draft == its oracle),
  compressed-tensors refused naming ROADMAP item 8;
- a ``qwen2_quarot`` QSpec-format directory (uint8 [out, in // 2] +
  ``weight_scales``, the o / down weights under the reference's
  ``o_proj.1.`` / ``down_proj.1.`` keys, the q/k/v biases, split or fused):
  ``load_qspec`` gives the JAX ``load_qspec``'s int4 arrays exactly, and the
  biases, which the JAX loader drops (ROADMAP §3): the port's logits equal
  the JAX package's on its params with the biases inserted as ``"b"``; a
  ``QuarotLlamaForCausalLM`` directory serves through ``LLM(model=<dir>)``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu_torch import LLM, SamplingParams
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import registry as tregistry
from qspec_tpu_torch.ops.packing import pack_reference, unpack_int4
from tests.test_torch_model import REL_TOL, TIE_GAP, _forward_both

QWEN2 = dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2", vocab_size=256,
             hidden_size=128, intermediate_size=224, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
             use_sliding_window=False)
GROUP = 32
KW = dict(device="cpu", block_size=16, max_model_len=128, max_num_seqs=4,
          prefill_chunk_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write(path, sd: dict, hf: dict):
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


def grouped_dir(tmp_path, fmt: str):
    """(directory, state dict, port cfg) of a tiny Qwen2 in ``fmt``."""
    cfg = tregistry.resolve(QWEN2)
    sd = tg.make_grouped_state_dict(cfg, fmt, group_size=GROUP, seed=3, device="cpu")
    qc = {"quant_method": fmt, "bits": 4, "group_size": GROUP}
    qc.update({"version": "gemm", "zero_point": True} if fmt == "awq" else {"desc_act": False})
    return write(tmp_path / fmt, sd, {**QWEN2, "quantization_config": qc}), sd, cfg


def assert_tree_equal(a, b, path=""):
    """Two trees of tensors / arrays with the same keys, equal value for value."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}{k}.")
        return
    x = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    y = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert x.shape == y.shape, path
    np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("fmt", ["awq", "gptq"])
def test_grouped_dir_loads_like_the_state_dict_and_jax(tmp_path, fmt):
    d, sd, cfg = grouped_dir(tmp_path, fmt)
    load, jload = (tg.load_awq, jg.load_awq) if fmt == "awq" else (tg.load_gptq, jg.load_gptq)
    tp, tcfg = load(d, device="cpu")
    assert tcfg.quant == "w4g" and tcfg.arch == "qwen2" and tcfg.qkv_bias
    ref, _ = load(dict(sd), cfg, device="cpu")
    assert_tree_equal(ref, tp)
    assert tuple(tp["layers"]["qkv"]["b"].shape) == (2, cfg.qkv_out)
    assert tp["layers"]["qkv"]["b"].dtype == torch.bfloat16
    jp, jcfg = jload(d)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    assert jcfg.quant == "w4g"
    skip = {"rope_cache"}
    assert_tree_equal({k: v for k, v in jp.items() if k not in skip},
                      {k: v for k, v in tp.items() if k not in skip})
    np.testing.assert_allclose(tp["rope_cache"].numpy(), jp["rope_cache"], rtol=1e-6,
                               atol=1e-6)


def test_qwen3_grouped_dir_keeps_its_qk_norms(tmp_path):
    """A Qwen3's per-head q/k norms come along from an AWQ directory (the
    JAX grouped loader reads none, ROADMAP §3), as bf16 [L, head_dim]."""
    hf = {**QWEN2, "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
          "head_dim": 32, "quantization_config": {"quant_method": "awq"}}
    cfg = tregistry.resolve(hf)
    assert cfg.qk_norm and not cfg.qkv_bias
    sd = tg.make_grouped_state_dict(cfg, "awq", group_size=GROUP, seed=4, device="cpu")
    tp, _ = tg.load_awq(write(tmp_path / "qwen3", sd, hf), device="cpu")
    for n in ("q_norm", "k_norm"):
        want = torch.stack([sd[f"model.layers.{i}.self_attn.{n}.weight"] for i in range(2)])
        assert torch.equal(tp["layers"][n], want.to(torch.bfloat16))


def generate(llm, prompts, max_tokens=10):
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    return [o.output_token_ids for o in llm.generate(prompts, sp)]


def prompts(vocab=256):
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(1, vocab, size=n))) for n in (7, 21, 30)]
    ps[1] = ps[1][:7] * 3
    return ps


@pytest.mark.parametrize("fmt", ["awq", "gptq"])
def test_llm_routes_a_grouped_dir_by_its_quant_method(tmp_path, fmt):
    """Whatever ``quantization`` says (its default "qspec" too), the
    directory's quant_method selects the grouped loader, as in the JAX
    package; naming the other method raises. Greedy QSpec with the W4A16
    draft (the same weights) == qspec_null."""
    d, _, cfg = grouped_dir(tmp_path, fmt)
    for q in ("qspec", fmt, None):
        assert EngineArgs(model=d, quantization=q).model_config() == \
            dataclasses.replace(cfg, quant="w4g")
    with pytest.raises(ValueError, match="names"):
        EngineArgs(model=d, quantization="gptq" if fmt == "awq" else "awq").model_config()
    toks = {}
    for m in ("qspec", "qspec_null"):
        llm = LLM(model=d, num_speculative_tokens=3, speculative_draft_scheme="w4a16",
                  speculative_method=m, **KW)
        assert llm.engine_config.model.quant == "w4g"
        assert "b" in llm.llm_engine.runner.params["layers"]["qkv"]
        toks[m] = generate(llm, prompts())
    assert toks["qspec"] == toks["qspec_null"]


def test_other_quant_methods_and_a_float_dir_asked_as_awq_raise(tmp_path):
    d, sd, _ = grouped_dir(tmp_path, "awq")
    # a compressed-tensors directory is routed (model_loader.ct), its quant
    # from its format (its loader settles it); another method still raises
    for fmt, quant in (("pack-quantized", "w4g"), ("int-quantized", "w8"),
                       ("float-quantized", "w8")):
        ct = write(tmp_path / f"ct-{fmt}", sd, {**QWEN2, "quantization_config": {
            "quant_method": "compressed-tensors", "format": fmt}})
        assert EngineArgs(model=ct).model_config().quant == quant
    with pytest.raises(ValueError, match="names 'compressed-tensors'"):
        EngineArgs(model=ct, quantization="awq").model_config()
    bnb = write(tmp_path / "bnb", sd, {**QWEN2, "quantization_config": {
        "quant_method": "bitsandbytes"}})
    with pytest.raises(NotImplementedError, match="'bitsandbytes' is not ported"):
        EngineArgs(model=bnb).model_config()
    # a GGUF file's way in is the JAX package's: load_gguf, then LLMEngine
    with pytest.raises(NotImplementedError, match="gguf.load_gguf.*LLMEngine"):
        EngineArgs(model=str(tmp_path / "model.gguf")).model_config()
    flt = write(tmp_path / "float", {"x": torch.zeros(1)}, QWEN2)
    for q in ("awq", "gptq"):
        with pytest.raises(ValueError, match="no AWQ / GPTQ quantization_config"):
            EngineArgs(model=flt, quantization=q).model_config()


# --------------------------------------------------- the reference QSpec format


def hf_qwen2():
    conf = {k: v for k, v in QWEN2.items() if k not in ("architectures", "model_type")}
    torch.manual_seed(0)
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**conf)).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(p + 0.1 * torch.randn_like(p))
            if name.endswith("bias"):
                p.copy_(0.2 * torch.randn_like(p))
    return {k: v.detach().float() for k, v in hf.state_dict().items()}


def reference_qspec_sd(params, cfg, fused_qkv: bool = False) -> dict:
    """A reference-format QSpec state dict from quantized params: each
    projection's int4 values as uint8 [out, in // 2] with its
    ``weight_scales``, o / down under ``o_proj.1.`` / ``down_proj.1.``, the
    q/k/v biases (split, or fused with the weight), the embedding and the
    float head."""
    sd = {"model.embed_tokens.weight": params["embed"],
          "lm_head.weight": params["lm_head"].t().contiguous()}
    qkv = ((("self_attn.qkv_proj", cfg.qkv_out),) if fused_qkv else
           (("self_attn.q_proj", cfg.q_size), ("self_attn.k_proj", cfg.kv_size),
            ("self_attn.v_proj", cfg.kv_size)))
    modules = {"qkv": qkv, "o": (("self_attn.o_proj.1", cfg.hidden_size),),
               "gate_up": (("mlp.gate_proj", cfg.intermediate_size),
                           ("mlp.up_proj", cfg.intermediate_size)),
               "down": (("mlp.down_proj.1", cfg.hidden_size),)}
    for li in range(cfg.num_layers):
        for name, parts in modules.items():
            layer = params["layers"][name]
            vals, start = unpack_int4(layer["qw"][li]), 0
            for module, width in parts:
                key = f"model.layers.{li}.{module}"
                sd[key + ".weight"] = pack_reference(vals[:, start:start + width])
                sd[key + ".weight_scales"] = layer["qs"][li, start:start + width]
                if "b" in layer:
                    sd[key + ".bias"] = layer["b"][li, start:start + width]
                start += width
    return sd


def qwen2_quarot_dir(tmp_path, fused_qkv=False):
    """A qwen2_quarot directory quantized from the tiny HF Qwen2 (bf16 head)
    and the params it came from."""
    cfg = dataclasses.replace(tregistry.resolve(QWEN2), lm_head_quant="bf16")
    params, qcfg = tloader.quantize_float(hf_qwen2(), cfg, device="cpu")
    sd = reference_qspec_sd(params, qcfg, fused_qkv)
    hf = {**QWEN2, "architectures": ["Qwen2QuaRotForCausalLM"], "model_type": "qwen2_quarot"}
    name = "qwen2_quarot" + ("_fused" if fused_qkv else "")
    return write(tmp_path / name, sd, hf), params


def test_qwen2_quarot_qspec_dir_keeps_its_biases(tmp_path):
    """load_qspec: the int4 arrays equal the JAX load_qspec's exactly, the
    biases come along (split and fused load alike); the logits equal the JAX
    package's on its params with the biases inserted, and differ from its
    params as its loader leaves them (no bias)."""
    d, params = qwen2_quarot_dir(tmp_path)
    tp, tcfg = tloader.load_qspec(d, device="cpu")
    assert tcfg.arch == "qwen2" and tcfg.qkv_bias and tcfg.quant == "w4"
    jp, jcfg = jloader.load_qspec(d)
    assert "b" not in jp["layers"]["qkv"]
    for name in ("qkv", "o", "gate_up", "down"):
        for key in ("qw", "qs"):
            np.testing.assert_array_equal(tp["layers"][name][key].numpy(),
                                          np.asarray(jp["layers"][name][key]))
            assert torch.equal(tp["layers"][name][key], params["layers"][name][key])
    assert torch.equal(tp["layers"]["qkv"]["b"], params["layers"]["qkv"]["b"])
    fused, _ = qwen2_quarot_dir(tmp_path, fused_qkv=True)
    assert_tree_equal(tloader.load_qspec(fused, device="cpu")[0]["layers"], tp["layers"])
    bias = np.asarray(tp["layers"]["qkv"]["b"].float().numpy())
    with_b = {**jp, "layers": {**jp["layers"], "qkv": {
        **jp["layers"]["qkv"], "b": jnp.asarray(bias, jnp.bfloat16)}}}
    rng = np.random.default_rng(11)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, 256, size=(2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    ctx = np.full(2, 12, np.int32)
    (jl, tl), = _forward_both((jcfg, with_b, tcfg, tp), "w4a16", toks, pos, ctx, tables)
    rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
    assert rel <= REL_TOL["w4a16"], rel
    gap = jl.max(-1) - np.take_along_axis(jl, tl.argmax(-1)[..., None], -1)[..., 0]
    assert gap.max() <= TIE_GAP["w4a16"], gap.max()
    (dropped, _), = _forward_both((jcfg, jp, tcfg, tp), "w4a16", toks, pos, ctx, tables)
    assert np.linalg.norm(tl - dropped) / np.linalg.norm(dropped) > 10 * REL_TOL["w4a16"]


def test_undeclared_qspec_bias_raises(tmp_path):
    d, _ = qwen2_quarot_dir(tmp_path)
    sd = tloader.read_safetensors(d)
    with pytest.raises(NotImplementedError, match="qkv_bias=False.*qwen2_quarot"):
        tloader.load_qspec(sd, dataclasses.replace(tregistry.resolve(QWEN2), qkv_bias=False),
                           device="cpu")


@pytest.mark.parametrize("arch", ["Qwen2QuaRotForCausalLM", "QuarotLlamaForCausalLM"])
def test_reference_quarot_dirs_serve_through_llm(tmp_path, arch):
    """LLM(model=<dir>) of a reference QSpec directory named by the
    reference's QuaRot architecture: load_qspec (weight_scales), greedy W4A4
    QSpec == qspec_null."""
    if arch == "Qwen2QuaRotForCausalLM":
        d, _ = qwen2_quarot_dir(tmp_path)
    else:
        cfg = dataclasses.replace(tregistry.resolve({**QWEN2, "architectures": [arch],
                                                     "model_type": "llama_quarot"}),
                                  lm_head_quant="bf16")
        sd = {k: v for k, v in hf_qwen2().items() if not k.endswith(".bias")}
        params, qcfg = tloader.quantize_float(sd, cfg, device="cpu")
        d = write(tmp_path / "llama_quarot", reference_qspec_sd(params, qcfg),
                  {**QWEN2, "architectures": [arch], "model_type": "llama_quarot"})
    toks = {}
    for m in ("qspec", "qspec_null"):
        llm = LLM(model=d, num_speculative_tokens=3, speculative_method=m, **KW)
        cfg = llm.engine_config.model
        assert cfg.quant == "w4" and cfg.arch == ("qwen2" if "Qwen2" in arch else "llama")
        assert ("b" in llm.llm_engine.runner.params["layers"]["qkv"]) == cfg.qkv_bias
        toks[m] = generate(llm, prompts())
    assert toks["qspec"] == toks["qspec_null"]
