"""The port's compressed-tensors ingestion (model_loader/ct.py) against the
JAX package's, on the CPU: the writers' bits, the loaders' trees, the
prefill logits of every format, the format dispatch and its refusals, and
greedy speculative decoding on the loaded checkpoints.

The cases are tests/models/test_compressed_tensors.py's: pack-quantized at
g = 64 symmetric, asymmetric and with packed zero points, and the channel
strategy; int-quantized int8 and float-quantized fp8, each per channel and
per tensor. The same numpy state dict (the JAX writers' output) goes into
both packages' loaders. The logits are held at rtol / atol 2e-2 x max|ref|,
the JAX kernel tests' tolerance: the JAX CPU reference of the W8A16 GEMM
scales the weights before its dot (qspec_tpu/ops/linear_kernels.py:631-637)
and the port after, so equality is not expected there.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.model_loader import ct as jct
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.model_loader import ct as tct
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv

TOL = 2e-2
JCFG = JModel(vocab_size=512, hidden_size=128, intermediate_size=192, num_layers=2,
              num_heads=2, num_kv_heads=2, head_dim=64, quant="none",
              weightless_norm=False, lm_head_quant="bf16", max_position_embeddings=128)
TCFG = ModelConfig(vocab_size=512, hidden_size=128, intermediate_size=192, num_layers=2,
                   num_heads=2, num_kv_heads=2, head_dim=64, quant="none",
                   lm_head_quant="bf16", max_position_embeddings=128)

# (label, writer format, writer arguments, the quant the loader settles)
CASES = [
    ("packed-g64-sym", "packed", dict(group_size=64, symmetric=True), "w4g"),
    ("packed-g64-asym", "packed", dict(group_size=64, symmetric=False), "w4g"),
    ("packed-g64-asym-packed-zp", "packed",
     dict(group_size=64, symmetric=False, pack_zp=True), "w4g"),
    ("packed-channel", "packed", dict(group_size=0, symmetric=True), "w4g"),
    ("int8-channel", "int8", dict(per_tensor=False), "w8"),
    ("int8-tensor", "int8", dict(per_tensor=True), "w8"),
    ("fp8-channel", "fp8", dict(per_tensor=False), "w8"),
    ("fp8-tensor", "fp8", dict(per_tensor=True), "w8"),
]
IDS = [c[0] for c in CASES]
WRITERS = {"packed": (jct.make_ct_packed_tensors, tct.make_ct_packed_tensors),
           "int8": (jct.make_ct_int8_tensors, tct.make_ct_int8_tensors),
           "fp8": (jct.make_ct_fp8_tensors, tct.make_ct_fp8_tensors)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    """An array's or tensor's bytes as a uint8 array (fp8 compared bit for bit)."""
    if torch.is_tensor(a):
        a = a.contiguous()
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _float_sd(seed=0):
    """tests/models/test_compressed_tensors.py's tiny llama, with gammas away
    from 1 so that they count."""
    rng = np.random.default_rng(seed)
    H, I, V = JCFG.hidden_size, JCFG.intermediate_size, JCFG.vocab_size

    def d(i, o):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    def gamma():
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    sd = {"model.embed_tokens.weight": d(H, V), "model.norm.weight": gamma(),
          "lm_head.weight": d(H, V)}
    for i in range(JCFG.num_layers):
        p = f"model.layers.{i}."
        for name, (a, b) in {"self_attn.q_proj": (H, JCFG.q_size),
                             "self_attn.k_proj": (H, JCFG.kv_size),
                             "self_attn.v_proj": (H, JCFG.kv_size),
                             "self_attn.o_proj": (JCFG.q_size, H),
                             "mlp.gate_proj": (H, I), "mlp.up_proj": (H, I),
                             "mlp.down_proj": (I, H)}.items():
            sd[p + name + ".weight"] = d(a, b)
        sd[p + "input_layernorm.weight"] = gamma()
        sd[p + "post_attention_layernorm.weight"] = gamma()
    return sd


def _quantize_sd(sd, fmt, **kw):
    """Every projection through the JAX writer of ``fmt``."""
    write = WRITERS[fmt][0]
    qsd = {}
    for key, v in sd.items():
        if key.endswith(".weight") and "proj" in key:
            base = key[:-len(".weight")]
            for name, val in write(v.T.astype(np.float32), **kw)[0].items():
                qsd[base + "." + name] = val
        else:
            qsd[key] = v
    return qsd


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def loaded(request):
    """(case, the numpy state dict, the JAX params + cfg, the port's params
    by its own loader + cfg)."""
    label, fmt, kw, quant = request.param
    qsd = _quantize_sd(_float_sd(seed=3), fmt, **kw)
    jparams, jcfg = jct.load_compressed_tensors(dict(qsd), JCFG)
    params, cfg = tct.load_compressed_tensors(dict(qsd), TCFG, device="cpu")
    assert jcfg.quant == cfg.quant == quant
    return request.param, qsd, jparams, jcfg, params, cfg


# ---------------------------------------------------------------- writers

@pytest.mark.parametrize("label,fmt,kw,quant", CASES, ids=IDS)
def test_writers_match_jax(label, fmt, kw, quant):
    """The port's torch writers (what makes 8B-wide checkpoints on the card)
    give the JAX package's numpy writers' tensors, bit for bit, and their
    dequantized twins."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((256, 192)).astype(np.float32) * 0.05
    jw, tw = WRITERS[fmt]
    jt, jdeq = jw(w, **kw)
    tt, tdeq = tw(torch.from_numpy(w), **kw)
    assert jt.keys() == tt.keys()
    for key in jt:
        assert tuple(tt[key].shape) == np.asarray(jt[key]).shape, key
        np.testing.assert_array_equal(bits(tt[key]), bits(jt[key]), err_msg=key)
    np.testing.assert_array_equal(tdeq.numpy(), np.asarray(jdeq, np.float32))


# ---------------------------------------------------------------- loaders

def test_loader_matches_jax_tree(loaded):
    """params_from_numpy of the JAX tree equals the port loader's own tree,
    the fp8 leaves bit for bit."""
    (label, fmt, _, quant), _, jparams, _, params, cfg = loaded
    carried = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                       device="cpu")
    keys = ("w8", "s8") if quant == "w8" else ("qw", "qs_g", "qo_g")
    for name in ("qkv", "o", "gate_up", "down"):
        assert sorted(params["layers"][name]) == sorted(keys)
        for key in keys:
            a, b = params["layers"][name][key], carried["layers"][name][key]
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{name}.{key}")
    if fmt == "fp8":
        assert params["layers"]["qkv"]["w8"].dtype == torch.float8_e4m3fn
    for key in ("input_norm", "post_norm"):
        assert torch.equal(params["layers"][key], carried["layers"][key])
    for key in ("embed", "lm_head", "final_norm", "rope_cache"):
        assert torch.equal(params[key], carried[key]), key


def _prefill_inputs():
    rng = np.random.default_rng(7)
    T = 20
    toks = np.zeros((1, 32), np.int32)
    toks[0, :T] = rng.integers(1, 500, size=T)
    pos = np.arange(32, dtype=np.int32)[None]
    tables = np.zeros((1, 4), np.int32)
    tables[0, :2] = [1, 2]
    return toks, pos, tables, np.asarray([T], np.int32)


def _jax_logits(params, cfg):
    from qspec_tpu.engine.model_runner import prefill_step
    from qspec_tpu.ops import kv_cache as jkv
    kcfg = jkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                             num_pages=8, page_size=16)
    toks, pos, tables, ctx = _prefill_inputs()
    lg, _ = prefill_step(params, jkv.allocate(kcfg), jnp.asarray(toks), jnp.asarray(pos),
                         jnp.asarray(tables), jnp.asarray(ctx), cfg=cfg, scheme="w4a16")
    return np.asarray(lg, np.float32)


def _port_logits(params, cfg):
    from qspec_tpu_torch.engine.model_runner import prefill_step
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, 8, 16), "cpu")
    toks, pos, tables, ctx = (torch.tensor(a) for a in _prefill_inputs())
    lg, _ = prefill_step(params, cache, toks, pos, tables, ctx, cfg=cfg, scheme="w4a16")
    return lg.to(torch.float32).numpy()


def test_logits_match_jax(loaded):
    """Each format's prefill logits against the JAX package's on the same
    checkpoint."""
    _, _, jparams, jcfg, params, cfg = loaded
    ref = _jax_logits(jparams, jcfg)
    got = _port_logits(params, cfg)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max())


# ---------------------------------------------------------------- dispatch

def test_dispatch_and_refusals():
    """An explicit format dispatches as the sniffed one; an unknown format,
    float-quantized on int8 weights, act-order g_idx, per-group int8 scales
    and an MoE raise, each naming itself."""
    sd = _float_sd(seed=6)
    fp8 = _quantize_sd(sd, "fp8")
    params, cfg = tct.load_compressed_tensors(dict(fp8), TCFG, device="cpu",
                                              qconfig={"format": "float-quantized"})
    assert cfg.quant == "w8" and params["layers"]["o"]["w8"].dtype == torch.float8_e4m3fn
    i8 = _quantize_sd(sd, "int8")
    with pytest.raises(NotImplementedError, match="marlin-24"):
        tct.load_compressed_tensors(dict(i8), TCFG, qconfig={"format": "marlin-24"},
                                    device="cpu")
    with pytest.raises(ValueError, match="fp8"):
        tct.load_compressed_tensors(dict(i8), TCFG, qconfig={"format": "float-quantized"},
                                    device="cpu")
    packed = _quantize_sd(sd, "packed", group_size=64)
    key = "model.layers.0.self_attn.q_proj.weight_g_idx"
    packed[key] = np.arange(JCFG.hidden_size)[::-1] // 64
    with pytest.raises(NotImplementedError, match="act-order"):
        tct.load_compressed_tensors(dict(packed), TCFG, device="cpu")
    group = dict(i8)
    s = "model.layers.0.mlp.down_proj.weight_scale"
    group[s] = np.ones((JCFG.hidden_size, 3), np.float32)
    with pytest.raises(NotImplementedError, match="per-group int8"):
        tct.load_compressed_tensors(group, TCFG, device="cpu")
    moe = ModelConfig.mixtral_8x7b()
    with pytest.raises(NotImplementedError, match="item 9"):
        tllama.check_served(moe.__class__(**{**moe.__dict__, "quant": "w8"}))


@pytest.mark.parametrize("fmt,kw", [("int8", {}), ("packed", dict(group_size=64))])
def test_reads_what_the_reference_drops(fmt, kw):
    """The o / down biases, which the JAX _load_channelwise and
    _load_grouped drop, and Qwen3's q/k norms, which _load_channelwise
    drops, are read into the tree and change the logits."""
    sd = _quantize_sd(_float_sd(seed=8), fmt, **kw)
    rng = np.random.default_rng(9)
    biased = dict(sd)
    for li in range(JCFG.num_layers):
        for b in ("self_attn.o_proj.bias", "mlp.down_proj.bias"):
            biased[f"model.layers.{li}.{b}"] = (rng.standard_normal(JCFG.hidden_size)
                                                * 0.1).astype(np.float32)
    params, cfg = tct.load_compressed_tensors(dict(biased), TCFG, device="cpu")
    assert params["layers"]["o"]["b"].shape == (JCFG.num_layers, JCFG.hidden_size)
    plain, _ = tct.load_compressed_tensors(dict(sd), TCFG, device="cpu")
    assert "b" not in plain["layers"]["o"]
    assert not np.allclose(_port_logits(params, cfg), _port_logits(plain, cfg))
    q3 = ModelConfig(**{**TCFG.__dict__, "qk_norm": True})
    normed = dict(sd)
    for li in range(JCFG.num_layers):
        for n in "qk":
            normed[f"model.layers.{li}.self_attn.{n}_norm.weight"] = (
                1 + 0.1 * rng.standard_normal(JCFG.head_dim)).astype(np.float32)
    params, cfg = tct.load_compressed_tensors(normed, q3, device="cpu")
    assert params["layers"]["q_norm"].shape == (JCFG.num_layers, JCFG.head_dim)


def test_fp8_tensor_carries_bits():
    """An ml_dtypes fp8 array reaches the port bit for bit (every code, NaN
    codes too), through params_from_numpy's _tensor and the loader's own."""
    a = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).reshape(16, 16)
    for t in (tllama._tensor(a, "cpu"), tct._fp8_tensor(a)):
        assert t.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(bits(t), a.view(np.uint8))


# ---------------------------------------------------------------- engine

SCHED = dict(max_num_seqs=2, max_model_len=128, prefill_chunk_size=32,
             decode_batch_buckets=(2,), prefill_token_buckets=(32,))


def _generate(cfg, params, spec=None, max_tokens=12):
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**SCHED), speculative=spec),
                    params, device="cpu")
    rng = np.random.default_rng(11)
    ps = [[int(t) for t in rng.integers(1, 500, size=n)] for n in (12, 40)]
    ids = [eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                             ignore_eos=True)) for p in ps]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in ids], eng


@pytest.mark.parametrize("label,fmt,kw", [("packed", "packed", dict(group_size=64)),
                                          ("int8", "int8", {}), ("fp8", "fp8", {})])
def test_greedy_speculation_equals_its_oracle(label, fmt, kw):
    """On each loaded format greedy n-gram equals AR, and QSpec's windowed
    W4A16 draft (the target's own weights) equals qspec_null and AR; a
    W4A8 draft on a w8 checkpoint raises."""
    params, cfg = tct.load_compressed_tensors(_quantize_sd(_float_sd(seed=4), fmt, **kw),
                                              TCFG, device="cpu")
    ar, _ = _generate(cfg, params)
    ng, _ = _generate(cfg, params, SpeculativeConfig(num_speculative_tokens=3,
                                                     method="ngram"))
    assert ng == ar
    for method in ("qspec", "qspec_null"):
        sp, eng = _generate(cfg, params, SpeculativeConfig(
            num_speculative_tokens=3, draft_scheme="w4a16", draft_kv_window=32,
            method=method))
        assert sp == ar, method
    assert eng.runner.verify_scheme == "w4a16"
    if cfg.quant == "w8":
        with pytest.raises(ValueError, match="w4g/w8"):
            _generate(cfg, params, SpeculativeConfig(num_speculative_tokens=3,
                                                     draft_scheme="w4a8"))


# ---------------------------------------------------------------- directories

TINY_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 512,
           "hidden_size": 128, "intermediate_size": 192, "num_hidden_layers": 2,
           "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 64,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 128,
           "tie_word_embeddings": False}


@pytest.mark.parametrize("fmt,quant", [("float-quantized", "w8"), ("int-quantized", "w8"),
                                       ("pack-quantized", "w4g")])
def test_directory_routes_through_llm(tmp_path, fmt, quant):
    """A compressed-tensors directory (config.json with its
    quantization_config, model.safetensors written by chip_smoke's writer,
    F8_E4M3 / I8 / I32 / I64 / F16 tensors read back by the port's reader)
    through LLM(model=<dir>) and the server's build_server: the loader's
    cfg and tensors, bit for bit the state-dict route's, and the same
    replies."""
    import json

    import chip_smoke
    from qspec_tpu_torch import LLM
    from qspec_tpu_torch.engine.arg_utils import EngineArgs
    from qspec_tpu_torch.entrypoints.openai.api_server import build_server
    from qspec_tpu_torch.models.registry import resolve
    cfg = resolve(TINY_HF)
    sd = tct.make_ct_state_dict(cfg, fmt, seed=2, device="cpu",
                                **({"group_size": 64} if fmt == "pack-quantized" else {}))
    d = tmp_path / "ct"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({**TINY_HF, "quantization_config": {
        "quant_method": "compressed-tensors", "format": fmt}}))
    chip_smoke.write_safetensors(str(d / "model.safetensors"), sd)
    own, own_cfg = tct.load_compressed_tensors(sd, cfg, device="cpu")
    kw = dict(device="cpu", num_speculative_tokens=3, speculative_draft_scheme="w4a16",
              spec_draft_kv_window=32, max_model_len=128, max_num_seqs=2, block_size=16)
    llm = LLM(model=str(d), **kw)
    assert llm.engine_config.model == own_cfg and own_cfg.quant == quant
    loaded = llm.llm_engine.runner.params["layers"]
    for name in ("qkv", "o", "gate_up", "down"):
        for key, t in own["layers"][name].items():
            np.testing.assert_array_equal(bits(loaded[name][key]), bits(t))
    sp = SamplingParams(temperature=0.0, max_tokens=10, ignore_eos=True)
    ps = [[5, 9, 11, 40, 41, 7], [300, 2, 3]]
    got = [o.output_token_ids for o in llm.generate(ps, sp)]
    ref = LLM(model=str(d), params=own, **kw)
    assert [o.output_token_ids for o in ref.generate(ps, sp)] == got
    server = build_server(EngineArgs(model=str(d), max_model_len=128, max_num_seqs=2),
                          device="cpu")
    assert server.engine.engine.runner.cfg.quant == quant


# ---------------------------------------------------------------- the GEMM

@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n,stacked", [(4, 256, 384, False), (16, 512, 256, True),
                                           (3000, 1024, 128, False)])
def test_w8a16_matches_jax_kernel(kind, m, k, n, stacked):
    """matmul_w8a16 over int8 and float8_e4m3fn weights (the port's plain
    version on the CPU) against the JAX package's on the same weights: its
    Pallas body in interpret mode, plain and layer-stacked, and its XLA
    branch past BIGM_BYTES (m = 3000 at K = 1024); rtol / atol 2e-2 x
    max|ref|."""
    from qspec_tpu.ops.linear_kernels import matmul_w8a16 as j_matmul
    from qspec_tpu_torch.ops.linear_kernels import matmul_w8a16
    rng = np.random.default_rng(11)
    layers = 2 if stacked else 1
    ws = [rng.standard_normal((k, n)).astype(np.float32) * 0.05 for _ in range(layers)]
    write = WRITERS[kind][0]
    parts = [write(w)[0] for w in ws]
    jw = np.stack([p["weight"].T for p in parts])            # [L, K, N]
    js = np.stack([np.asarray(p["weight_scale"], np.float32).reshape(-1) for p in parts])
    tw = torch.stack([tct._fp8_tensor(a) if kind == "fp8" else torch.from_numpy(a.copy())
                      for a in jw])
    ts = torch.from_numpy(js)
    x = jnp.asarray(rng.standard_normal((m, k)) * 0.5, jnp.bfloat16)
    xt = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
    for li in range(layers):
        if stacked:
            ref = j_matmul(x, jnp.asarray(jw), jnp.asarray(js), out_dtype=jnp.float32,
                           layer_idx=jnp.asarray(li))
            got = matmul_w8a16(xt, tw, ts, out_dtype=torch.float32, layer_idx=li)
        else:
            ref = j_matmul(x, jnp.asarray(jw[0]), jnp.asarray(js[0]), out_dtype=jnp.float32)
            got = matmul_w8a16(xt, tw[0], ts[0], out_dtype=torch.float32)
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_w8a16_refuses_other_weight_types():
    """A weight that is neither int8 nor float8_e4m3fn raises, on the CPU
    too (never a silent plain product)."""
    from qspec_tpu_torch.ops.linear_kernels import matmul_w8a16
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    for dt in (torch.bfloat16, torch.float8_e5m2, torch.uint8):
        with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
            matmul_w8a16(x, torch.zeros(32, 16).to(dt), torch.ones(16))
