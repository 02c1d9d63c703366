"""The port's grouped-int4 (AWQ / GPTQ, quant="w4g") path against the JAX
package's, on the CPU: the format unpackers and writers, the grouped GEMM
(the JAX Pallas kernel in interpret mode, its prefill branch and its jnp
reference), the w4g model's logits, and greedy tokens through the engine
with the windowed W4A16 draft.

Inputs are made with numpy seeds and handed to both packages. Tolerances
are the JAX package's own: the GEMM rtol/atol 2e-2 x max|ref|
(tests/kernels/test_w4a16_grouped.py), 5e-2 against the float dequant
oracle; the logits a relative L2 of 2e-2 with disagreeing argmaxes only at a
near-tie (tests/test_torch_model.py, w4a16).
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
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.model_loader.loader import load_hf_float
from qspec_tpu.ops.linear_kernels import matmul_w4a16_g as j_matmul_g
from qspec_tpu.ops.linear_kernels import matmul_w4a16_g_ref as j_matmul_g_ref
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.linear_kernels import matmul_w4a16_g, matmul_w4a16_g_ref

TIE_GAP = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run faster on one thread, and the suite's parallel
    workers then do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _dequant(q, zp, s, g):
    return (q.astype(np.float32) - np.repeat(zp, g, axis=0)) * np.repeat(s, g, axis=0)


def _proj(rng, k, n, g):
    """One random projection: the JAX pack and the port's (bit-equal)."""
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    q, zp, s = jg._group_quantize(w, g, 0)
    jp = jg.pack_grouped_proj(q, zp, s)
    tp = tg.pack_grouped_proj(q, zp, s)
    for key in ("qw", "qs_g", "qo_g"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    return (q, zp, s), jp, tp


def _x(rng, m, k):
    """bf16 activations as a jax array and a torch tensor of the same values."""
    j = jnp.asarray(rng.standard_normal((m, k)) * 0.5, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------- formats

@pytest.mark.parametrize("fmt", ["awq", "gptq"])
@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("shape", [(256, 128), (512, 384)])
def test_format_roundtrip(fmt, g, shape):
    """The port's writers (torch, what makes 8B-wide checkpoints on the
    card) give the JAX package's numpy writers' bits; its unpackers recover
    the exact q / zp / s triples, as the JAX unpackers do."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    q0, zp0, s0 = jg._group_quantize(w, g, 0)
    if fmt == "awq":
        t, jt = tg.make_awq_tensors(torch.tensor(w), g), jg.make_awq_tensors(w, g)
        q, zp, s = tg.unpack_awq(t["qweight"], t["qzeros"], t["scales"])
    else:
        t, jt = tg.make_gptq_tensors(torch.tensor(w), g), jg.make_gptq_tensors(w, g)
        q, zp, s = tg.unpack_gptq(t["qweight"], t["qzeros"], t["scales"], t["g_idx"])
    assert t.keys() == jt.keys()
    for key in t:
        assert t[key].dtype == torch.from_numpy(np.asarray(jt[key])).dtype
        np.testing.assert_array_equal(t[key].numpy(), jt[key])
    np.testing.assert_array_equal(q.numpy(), q0)
    np.testing.assert_array_equal(zp.numpy(), zp0)
    np.testing.assert_allclose(s.numpy(), s0.astype(np.float16).astype(np.float32))


def test_gptq_act_order_rejected():
    rng = np.random.default_rng(1)
    t = tg.make_gptq_tensors(torch.tensor(rng.standard_normal((256, 128)),
                                          dtype=torch.float32), 128)
    bad = t["g_idx"].flip(0)
    with pytest.raises(NotImplementedError, match="act-order"):
        tg.unpack_gptq(t["qweight"], t["qzeros"], t["scales"], bad)


def test_load_from_a_path_is_not_ported():
    """A path is read as a checkpoint directory (the directory form:
    tests/test_torch_grouped_dirs.py), so a missing one raises
    FileNotFoundError; a state dict needs its ModelConfig."""
    with pytest.raises(FileNotFoundError, match="awq-checkpoint"):
        tg.load_awq("/nonexistent/awq-checkpoint", ModelConfig.tiny(quant="w4g"),
                    device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        tg.load_gptq({}, device="cpu")


def test_pack_grouped_proj_tp_layouts():
    """col_blocks / shard_in rearrangements give the JAX package's bits."""
    rng = np.random.default_rng(5)
    k, g, tp = 512, 128, 2
    nq, nk = 256, 128
    w = rng.standard_normal((k, nq + 2 * nk)).astype(np.float32) * 0.1
    q, zp, s = jg._group_quantize(w, g, 0)
    for kw in (dict(col_blocks=(nq, nk, nk), tp_size=tp), dict(shard_in=True, tp_size=tp)):
        tp_ = tg.pack_grouped_proj(q, zp, s, **kw)
        jp = jg.pack_grouped_proj(q, zp, s, **kw)
        for key in ("qw", "qs_g", "qo_g"):
            np.testing.assert_array_equal(tp_[key].numpy(), np.asarray(jp[key]))


# ---------------------------------------------------------------- the GEMM

@pytest.mark.parametrize("m,k,n,g", [(1, 256, 128, 64), (8, 512, 384, 128),
                                     (17, 1024, 512, 128), (64, 256, 256, 32)])
def test_grouped_ref_matches_dequant_oracle(m, k, n, g):
    rng = np.random.default_rng(2)
    (q, zp, s), jp, tp = _proj(rng, k, n, g)
    xj, xt = _x(rng, m, k)
    got = np32(matmul_w4a16_g_ref(xt, tp["qw"], tp["qs_g"], tp["qo_g"],
                                  out_dtype=torch.float32))
    want = np32(xj) @ _dequant(q, zp, s, g)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05 * np.abs(want).max())
    jref = np32(j_matmul_g_ref(xj, jp["qw"], jp["qs_g"], jp["qo_g"], out_dtype=jnp.float32))
    np.testing.assert_allclose(got, jref, rtol=2e-2, atol=2e-2 * np.abs(jref).max())


@pytest.mark.parametrize("m,k,n,g", [(1, 256, 128, 128), (8, 512, 384, 64),
                                     (33, 512, 1536, 128)])
def test_grouped_matches_jax_kernel(m, k, n, g):
    """The port's matmul_w4a16_g (its plain version on the CPU) against the
    JAX package's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    _, jp, tp = _proj(rng, k, n, g)
    xj, xt = _x(rng, m, k)
    ref = np32(j_matmul_g(xj, jp["qw"], jp["qs_g"], jp["qo_g"], out_dtype=jnp.float32))
    got = matmul_w4a16_g(xt, tp["qw"], tp["qs_g"], tp["qo_g"], out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    bf = matmul_w4a16_g(xt, tp["qw"], tp["qs_g"], tp["qo_g"])
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(bf), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


def test_grouped_matches_jax_bigm_branch():
    """At prefill widths the JAX package takes its dequantize-once branch
    (_w4a16_g_bigm); the port's plain version agrees with it."""
    m, k, n, g = 10496, 512, 384, 64     # m * 2k bytes > 5 MB
    rng = np.random.default_rng(7)
    _, jp, tp = _proj(rng, k, n, g)
    xj, xt = _x(rng, m, k)
    ref = np32(j_matmul_g(xj, jp["qw"], jp["qs_g"], jp["qo_g"], out_dtype=jnp.float32))
    got = np32(matmul_w4a16_g(xt[::41].contiguous(), tp["qw"], tp["qs_g"], tp["qo_g"],
                              out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref[::41], rtol=2e-2, atol=2e-2 * np.abs(ref).max())


def test_grouped_stacked_layers():
    rng = np.random.default_rng(4)
    k, n, g, L = 256, 256, 128, 3
    projs = [_proj(rng, k, n, g) for _ in range(L)]
    stacked = {key: torch.stack([p[2][key] for p in projs]) for key in ("qw", "qs_g", "qo_g")}
    xj, xt = _x(rng, 4, k)
    for li, (_, jp, _) in enumerate(projs):
        ref = np32(j_matmul_g_ref(xj, jp["qw"], jp["qs_g"], jp["qo_g"], out_dtype=jnp.float32))
        got = np32(matmul_w4a16_g(xt, stacked["qw"], stacked["qs_g"], stacked["qo_g"],
                                  layer_idx=li, out_dtype=torch.float32))
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


# ---------------------------------------------------------------- the model

# tests/models/test_awq_gptq.py's tiny llama, as the port's w4g config
JCFG = JModel(vocab_size=512, hidden_size=128, intermediate_size=192, num_layers=2,
              num_heads=2, num_kv_heads=2, head_dim=64, quant="none",
              weightless_norm=False, lm_head_quant="bf16", max_position_embeddings=128)
TCFG = ModelConfig(vocab_size=512, hidden_size=128, intermediate_size=192, num_layers=2,
                   num_heads=2, num_kv_heads=2, head_dim=64, quant="w4g",
                   lm_head_quant="bf16", max_position_embeddings=128)


def _float_sd(seed=0):
    """HF-named float state dict of the tiny llama (test_awq_gptq's), with
    norm gammas away from 1 so that they count."""
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


def _quantize_sd(sd, fmt, g=64):
    """Every projection as fmt-format tensors, and the dequantized float twin
    for the oracle model."""
    qsd, deq_sd = {}, {}
    for key, v in sd.items():
        if key.endswith(".weight") and "proj" in key:
            t = (jg.make_awq_tensors if fmt == "awq" else jg.make_gptq_tensors)(v.T, g)
            base = key[:-len(".weight")]
            for name, val in t.items():
                qsd[base + "." + name] = val
            if fmt == "awq":
                q, zp, s = jg.unpack_awq(t["qweight"], t["qzeros"], t["scales"])
            else:
                q, zp, s = jg.unpack_gptq(t["qweight"], t["qzeros"], t["scales"], t["g_idx"])
            deq_sd[key] = _dequant(q, zp, s, g).T.astype(np.float32)
        else:
            qsd[key] = deq_sd[key] = v
    return qsd, deq_sd


@pytest.fixture(scope="module", params=["awq", "gptq"])
def w4g(request):
    """(fmt, JAX params + cfg, the port's params by params_from_numpy and by
    its own loader, the dequantized float state dict)."""
    fmt = request.param
    qsd, deq_sd = _quantize_sd(_float_sd(), fmt)
    jparams, jcfg = (jg.load_awq if fmt == "awq" else jg.load_gptq)(qsd, JCFG)
    carried = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                       TCFG, device="cpu")
    own, cfg = (tg.load_awq if fmt == "awq" else tg.load_gptq)(qsd, TCFG, device="cpu")
    assert cfg.quant == "w4g"
    return fmt, jparams, jcfg, carried, own, deq_sd


def test_loader_matches_jax_tree(w4g):
    """The port's load_awq / load_gptq give the JAX loader's tree, bit for
    bit (params_from_numpy carries that tree across unchanged)."""
    _, _, _, carried, own, _ = w4g
    for name in ("qkv", "o", "gate_up", "down"):
        for key in ("qw", "qs_g", "qo_g"):
            assert torch.equal(own["layers"][name][key], carried["layers"][name][key])
    for key in ("input_norm", "post_norm"):
        assert torch.equal(own["layers"][key], carried["layers"][key])
    for key in ("embed", "lm_head", "final_norm", "rope_cache"):
        assert torch.equal(own[key], carried[key]), key
    assert "hadamards" not in own
    # the kernels take contiguous tensors only
    leaves = [own["embed"], own["final_norm"], *own["layers"]["input_norm"],
              *[t for name in ("qkv", "o", "gate_up", "down") for t in own["layers"][name].values()]]
    assert all(t.is_contiguous() for t in leaves)


def test_int8_head_is_contiguous():
    """The loader's default head (int8, from the transposed float lm_head)
    is laid out [H, V] contiguously, as matmul_w8a16 takes it."""
    cfg = ModelConfig.tiny(quant="w4g")
    params = tllama.init_params(cfg, seed=0, device="cpu", group_size=64)
    assert set(params["lm_head"]) == {"qw8", "qs"}
    assert all(t.is_contiguous() for t in params["lm_head"].values())
    assert tuple(params["lm_head"]["qw8"].shape) == (cfg.hidden_size, cfg.vocab_size)


def _prefill_inputs():
    rng = np.random.default_rng(7)
    T = 20
    toks = np.zeros((1, 32), np.int32)
    toks[0, :T] = rng.integers(1, 500, size=T)
    pos = np.arange(32, dtype=np.int32)[None]
    tables = np.zeros((1, 4), np.int32)
    tables[0, :2] = [1, 2]
    return toks, pos, tables, np.asarray([T], np.int32)


def _jax_logits(params, cfg, scheme):
    from qspec_tpu.engine.model_runner import prefill_step
    from qspec_tpu.ops import kv_cache as jkv
    kcfg = jkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                             num_pages=8, page_size=16)
    toks, pos, tables, ctx = _prefill_inputs()
    lg, _ = prefill_step(params, jkv.allocate(kcfg), jnp.asarray(toks), jnp.asarray(pos),
                         jnp.asarray(tables), jnp.asarray(ctx), cfg=cfg, scheme=scheme)
    return np.asarray(lg, np.float32)


def _port_logits(params):
    from qspec_tpu_torch.engine.model_runner import prefill_step
    cache = tkv.allocate(tkv.KVCacheConfig(TCFG.num_layers, TCFG.num_kv_heads,
                                           TCFG.cache_head_dim, 8, 16), "cpu")
    toks, pos, tables, ctx = (torch.tensor(a) for a in _prefill_inputs())
    lg, _ = prefill_step(params, cache, toks, pos, tables, ctx, cfg=TCFG, scheme="w4a16")
    return np32(lg)


def test_w4g_logits_match_jax(w4g):
    """The w4g forward (gamma norms through rmsnorm, no rotations, the
    grouped GEMM) against the JAX prefill_step on the same checkpoint."""
    _, jparams, jcfg, carried, own, _ = w4g
    ref = _jax_logits(jparams, jcfg, "w4a16")
    for params in (carried, own):
        got = _port_logits(params)
        assert got.shape == ref.shape and np.isfinite(got).all()
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 2e-2, rel
        for r in np.nonzero(got.argmax(-1) != ref.argmax(-1))[0]:
            assert ref[r].max() - ref[r, got[r].argmax()] < TIE_GAP


def test_w4g_logits_match_dequant_oracle(w4g):
    """The port's w4g logits against the JAX package's bf16 model built from
    the exactly dequantized weights (test_awq_gptq's oracle and bound)."""
    _, _, _, _, own, deq_sd = w4g
    params_f, cfg_f = load_hf_float(deq_sd, JCFG)
    want = _jax_logits(params_f, cfg_f, "bf16")
    got = _port_logits(own)
    assert np.abs(got - want).max() < 0.15 * max(np.abs(want).max(), 1.0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _generate(eng, prompts, max_tokens, sp=SamplingParams):
    """Greedy tokens of each prompt (``sp``: the engine's SamplingParams)."""
    for p in prompts:
        eng.add_request(p, sp(temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 500
    return [outs[i] for i in range(len(prompts))]


def _sched(**over):
    d = dict(max_num_seqs=2, max_model_len=128, prefill_chunk_size=32,
             decode_batch_buckets=(2,), prefill_token_buckets=(32,))
    d.update(over)
    return d


@pytest.mark.parametrize("draft_scheme", ["w4a4", "w4a8"])
def test_qspec_quantized_draft_rejected_on_w4g(w4g, draft_scheme):
    _, _, _, _, own, _ = w4g
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme=draft_scheme)
    with pytest.raises(ValueError, match="w4g"):
        LLMEngine(EngineConfig(model=TCFG, cache=CacheConfig(page_size=16),
                               scheduler=SchedulerConfig(**_sched()), speculative=spec),
                  own, device="cpu")


def test_windowed_w4a16_draft_tokens_match_jax_engine(w4g):
    """Greedy tokens of the port's engine, QSpec with the windowed W4A16
    draft on its ring pool, against the JAX LLMEngine's with the same draft
    on the same checkpoint. They agree up to a near-tie in the JAX logits."""
    from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
    from qspec_tpu.models import llama as jllama
    from qspec_tpu.ops import kv_cache as jkv
    from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
    _, jparams, jcfg, _, own, _ = w4g
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in (12, 27)]
    n_tok = 24

    def drive(eng, sp):
        return _generate(eng, prompts, n_tok, sp)

    jspec = JSpec(num_speculative_tokens=3, draft_scheme="w4a16", draft_kv_window=16)
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**_sched()), speculative=jspec), jparams)
    ref = drive(jeng, JSamplingParams)
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a16",
                             draft_kv_window=16)
    eng = LLMEngine(EngineConfig(model=TCFG, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**_sched()), speculative=spec),
                    own, device="cpu")
    assert eng.runner._ring_pages == 4     # ceil((16 + 3 + 1) / 16) + 2
    got = drive(eng, SamplingParams)
    assert eng.spec_metrics.num_spec_rounds > 0
    assert all(len(t) == n_tok for t in got)
    for p, a, b in zip(prompts, ref, got):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            j = diff[0]
            ids = p + a[:j]
            S = 16
            cache = jkv.allocate(jkv.KVCacheConfig(
                jcfg.num_layers, jcfg.num_kv_heads, jcfg.cache_head_dim,
                -(-len(ids) // S) + 1, S))
            pos = np.arange(len(ids), dtype=np.int32)[None]
            tables = np.arange(1, -(-len(ids) // S) + 1, dtype=np.int32)[None]
            batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S),
                                          jnp.asarray(tables),
                                          jnp.asarray([len(ids)], jnp.int32))
            logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                                             cache, batch, scheme="w4a16")
            top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (j, top2)


def test_windowed_w4a16_ring_bitexact_vs_full_pool(monkeypatch):
    """The slice's draft on its ring pool against the same draft on a full
    pool (QSPEC_RING_DRAFT=0): tests/spec_decode/test_ring_draft.py's
    bit-exactness on a w4g checkpoint (random AWQ weights, g = 64), long
    enough to wrap every ring several times; and greedy spec == AR."""
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.tiny(quant="w4g")
    params = init_params(cfg, seed=0, device="cpu", group_size=64)
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(1, 500, size=int(r.integers(8, 40))))) for _ in range(3)]
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
                            decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))
    spec = SpeculativeConfig(num_speculative_tokens=3, rounds_per_step=2,
                             draft_scheme="w4a16", draft_kv_window=24)
    runs = {}
    for ring in ("0", "1", None):
        if ring is not None:
            monkeypatch.setenv("QSPEC_RING_DRAFT", ring)
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=sched,
                                     speculative=None if ring is None else spec),
                        params, device="cpu")
        runs[ring] = (_generate(eng, ps, 120), eng)
    (full, e_full), (ring, e_ring), (ar, _) = runs["0"], runs["1"], runs[None]
    assert e_full.runner._ring_pages == 0 and e_ring.runner._ring_pages == 4
    assert ring == full == ar
    m_full, m_ring = e_full.spec_metrics, e_ring.spec_metrics
    assert m_ring.num_draft_tokens == m_full.num_draft_tokens
    assert m_ring.num_draft_accepted == m_full.num_draft_accepted > 0
    assert m_ring.num_emitted_tokens == m_full.num_emitted_tokens
