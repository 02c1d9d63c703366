"""The port's Gemma-2 slice against the JAX package's, on the CPU: the
config and registry, the attention's logit softcap at head dims 128 and 256,
the KV cache at head dim 256, the grouped-int4 (AWQ) Gemma-2 forward, and
greedy tokens through the engine with the W4A16 draft.

Models are tiny Hugging Face Gemma2Configs built in-process, as in
tests/models/test_gemma2.py (head dim 32, window 16, query_pre_attn_scalar
24, softcaps 50 / 30, tied embeddings; T > window, so the alternation
matters), with an MLP of 256 so that the AWQ group size 32 divides K and K/2.
Their float weights are quantized by the JAX package's AWQ writer and loaded
by both packages' load_awq. Tolerances: the attention 2e-2 against the JAX
Pallas kernel in interpret mode (3e-2 over an int8 cache) and 2e-2 against
the JAX plain version, as tests/test_torch_window.py; logits rtol / atol 2e-2 x max|ref|
(tests/test_torch_grouped.py's GEMM tolerance); greedy tokens equal but at a
near-tie of the JAX logits (top-2 gap < 2e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from qspec_tpu.config import CacheConfig as JCache
from qspec_tpu.config import EngineConfig as JEngine
from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.config import SchedulerConfig as JSched
from qspec_tpu.config import SpeculativeConfig as JSpec
from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.models import llama as jllama
from qspec_tpu.models.registry import resolve as j_resolve
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.attention import paged_attention_ref as j_attn_ref
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.config import GEMMA2_9B_HF
from qspec_tpu_torch.engine.arg_utils import EngineArgs
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.models.registry import resolve
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops.attention import paged_attention

TIE_GAP = 2e-2
GROUP = 32


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


def hf_config(head_dim=32, layers=3, **over):
    """tests/models/test_gemma2.py's build_hf config, MLP 256."""
    d = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=2,
             head_dim=head_dim, max_position_embeddings=128, rope_theta=10000.0,
             rms_norm_eps=1e-5, sliding_window=16, query_pre_attn_scalar=24,
             attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
             tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh",
             attention_dropout=0.0, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    d.update(over)
    return transformers.Gemma2Config(**d)


# ---------------------------------------------------------------- config

def _port_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("which", ["tiny", "9b", "llama"])
def test_config_and_registry_match_jax(which):
    """from_hf_config and resolve give the JAX package's value of every
    field the port has."""
    if which == "tiny":
        hf = hf_config().to_dict()
    elif which == "9b":
        hf = dict(GEMMA2_9B_HF)
    else:
        hf = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
              "vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "rope_theta": 500000.0,
              "rms_norm_eps": 1e-5, "hidden_act": "silu",
              "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                               "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192}}
    for port, jax_cfg in ((ModelConfig.from_hf_config(hf), JModel.from_hf_config(hf)),
                          (resolve(hf), j_resolve(hf))):
        for name, value in _port_fields(port).items():
            assert value == getattr(jax_cfg, name), name
    cfg = resolve(hf)
    if which != "llama":
        assert cfg.arch == "gemma2" and cfg.post_norms and cfg.sliding_window_pattern == 2
        assert cfg.hidden_act == "gelu_tanh" and cfg.norm_weight_offset == 1.0
    if which == "9b":
        cfg = ModelConfig.gemma2_9b(quant="w4g")
        assert (cfg.num_layers, cfg.hidden_size, cfg.head_dim, cfg.vocab_size) == (
            42, 3584, 256, 256000)
        assert cfg.quant == "w4g"
        assert EngineArgs(model="gemma2-9b", quantization="awq").model_config() == cfg


def test_other_architectures_raise():
    """Families the port does not serve raise."""
    for hf in ({"architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text"},
               {"architectures": ["GraniteMoeForCausalLM"], "model_type": "granitemoe"}):
        with pytest.raises(NotImplementedError):
            resolve(hf)
        with pytest.raises(NotImplementedError):
            ModelConfig.from_hf_config(hf)


# ---------------------------------------------------------------- attention

def _attn_case(D, Q, kv_dtype, mag):
    """Both packages' caches over the same bytes (filled by the JAX
    update_layer) and queries; q and K of standard deviation ``mag``."""
    rng = np.random.default_rng(D + Q)
    S, T = 8, 56
    jc = jkv.allocate(jkv.KVCacheConfig(num_layers=1, num_kv_heads=2, head_dim=D,
                                        num_pages=8, page_size=S, dtype=kv_dtype))
    k = rng.standard_normal((T, 2, D)).astype(np.float32) * mag
    v = rng.standard_normal((T, 2, D)).astype(np.float32)
    jc = jkv.update_layer(jc, 0, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                          jnp.arange(T) + S)
    pages = torch.from_numpy(np.array(jc.kv_pages).view(np.uint8)).view(
        tkv.kv_entry_dtype(kv_dtype))
    tc = tkv.PagedKVCache(pages, None if jc.kv_scales is None
                          else torch.tensor(np.asarray(jc.kv_scales)))
    qj = jnp.asarray(rng.standard_normal((2, Q, 4, D)) * mag, jnp.bfloat16)
    qt = torch.tensor(np.asarray(qj, np.float32)).to(torch.bfloat16)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    ctx = np.asarray([29, 20], np.int32)
    return jc, tc, qj, qt, tables, ctx


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_softcap_attention_matches_jax(D, Q, kv_dtype):
    """The port's attention with the softcap (its dispatch on CPU tensors),
    with and without a window, on the same cache bytes: against the JAX
    Pallas kernel in interpret mode at the JAX kernel test's data (standard
    normal) with a cap that bites there (1.0), 2e-2 (3e-2 over int8); and
    against the JAX plain version at scores three times larger (cap 5), 2e-2.
    (The Pallas body rounds the scaled q and the probabilities to bf16, which
    at the larger scores moves it up to 0.06 from both f32 versions.)"""
    tol = 2e-2 if kv_dtype == "bfloat16" else 3e-2
    for mag, cap in ((1, 1.0), (3, 5.0)):
        jc, tc, qj, qt, tables, ctx = _attn_case(D, Q, kv_dtype, mag)
        for window in (None, 8):
            args = (jnp.asarray(tables), jnp.asarray(ctx), D ** -0.5)
            if mag == 1:
                ref = paged_attention_pallas(qj, jc.kv_pages, *args, kv_scales=jc.kv_scales,
                                             window=window, softcap=cap)
            else:
                ref = j_attn_ref(qj, jc, 0, *args, window=window, softcap=cap)
            out = paged_attention(qt, tc, 0, torch.tensor(tables), torch.tensor(ctx),
                                  D ** -0.5, window=window, softcap=cap)
            np.testing.assert_allclose(np32(out), np32(ref), atol=tol, rtol=tol)
            # the cap changes the result at these scores
            uncapped = paged_attention(qt, tc, 0, torch.tensor(tables), torch.tensor(ctx),
                                       D ** -0.5, window=window)
            assert not torch.allclose(uncapped, out, atol=5e-2)


@pytest.mark.parametrize("kv_dtype", tkv.KV_DTYPES)
def test_kv_cache_takes_head_dim_256(kv_dtype):
    """update_layer writes a 256-wide head unpadded (cache_head_dim 256),
    with the JAX package's stored bytes and scales; gather_layer reads it
    back as the JAX package does."""
    cfg = ModelConfig.gemma2_9b(quant="w4g")
    assert cfg.cache_head_dim == cfg.head_dim == 256
    rng = np.random.default_rng(1)
    T, H, D, S = 20, 2, 256, 8
    k = rng.standard_normal((T, H, D)).astype(np.float32)
    v = rng.standard_normal((T, H, D)).astype(np.float32)
    slots = rng.permutation(np.arange(S, 5 * S))[:T]
    jc = jkv.update_layer(jkv.allocate(jkv.KVCacheConfig(2, H, D, 5, S, kv_dtype)), 1,
                          jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                          jnp.asarray(slots))
    tc = tkv.update_layer(tkv.allocate(tkv.KVCacheConfig(2, H, D, 5, S, kv_dtype), "cpu"), 1,
                          torch.tensor(k).to(torch.bfloat16), torch.tensor(v).to(torch.bfloat16),
                          torch.tensor(slots))
    assert tuple(tc.kv_pages.shape) == (2, 5, 2, H, S, D)
    np.testing.assert_array_equal(tc.kv_pages.view(torch.uint8).numpy(),
                                  np.asarray(jc.kv_pages).view(np.uint8))
    if tc.kv_scales is not None:
        np.testing.assert_array_equal(tc.kv_scales.numpy(), np.asarray(jc.kv_scales))
    tables = np.asarray([[1, 2, 3, 4]], np.int32)
    for got, want in zip(tkv.gather_layer(tc, 1, torch.tensor(tables)),
                         jkv.gather_layer(jc, 1, jnp.asarray(tables))):
        np.testing.assert_array_equal(np32(got), np32(want))


# ---------------------------------------------------------------- the model

def _awq_checkpoint(head_dim=32, seed=0):
    """A tiny HF Gemma-2's float state dict, every projection AWQ-quantized
    (g = 32) by the JAX package's writer, with the norm gammas moved off 0
    so that they count."""
    hf_cfg = hf_config(head_dim=head_dim)
    torch.manual_seed(seed)
    hf = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in hf.state_dict().items():
        w = val.detach().numpy().astype(np.float32)
        if key.endswith("norm.weight"):
            sd[key] = (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
        elif "proj" in key:
            base = key[:-len(".weight")]
            for name, t in jg.make_awq_tensors(w.T, GROUP).items():
                sd[f"{base}.{name}"] = t
        else:
            sd[key] = w
    return hf_cfg.to_dict(), sd


@pytest.fixture(scope="module", params=[32, 256], ids=["hd32", "hd256"])
def gemma(request):
    """(JAX params + cfg, the port's params by its own load_awq and by
    params_from_numpy, the port's cfg)."""
    hf, sd = _awq_checkpoint(head_dim=request.param)
    jparams, jcfg = jg.load_awq(sd, JModel.from_hf_config(hf))
    own, cfg = tg.load_awq(sd, ModelConfig.from_hf_config(hf), device="cpu")
    carried = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                       device="cpu")
    return jparams, jcfg, own, carried, cfg


def test_loader_matches_jax_tree(gemma):
    """The port's load_awq gives the JAX loader's Gemma-2 tree bit for bit:
    the (1 + w) gammas, the pre- and post-feedforward norms, the tied int8
    head."""
    _, jcfg, own, carried, cfg = gemma
    assert cfg.quant == "w4g" and jcfg.quant == "w4g" and cfg.post_norms
    for name in ("qkv", "o", "gate_up", "down"):
        for key in ("qw", "qs_g", "qo_g"):
            assert torch.equal(own["layers"][name][key], carried["layers"][name][key])
    for key in ("input_norm", "post_norm", "post_attn_norm", "post_ffw_norm"):
        assert torch.equal(own["layers"][key], carried["layers"][key]), key
    for key in ("embed", "final_norm", "rope_cache"):
        assert torch.equal(own[key], carried[key]), key
    assert set(own["lm_head"]) == {"qw8", "qs"}
    for key in ("qw8", "qs"):
        assert torch.equal(own["lm_head"][key], carried["lm_head"][key])


def _forward_inputs(T=40, S=16):
    rng = np.random.default_rng(9)
    toks = rng.integers(3, 256, size=(1, T)).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)[None]
    tables = np.arange(1, -(-T // S) + 1, dtype=np.int32)[None]
    return toks, pos, pos + S, tables, np.asarray([T], np.int32)


def test_logits_match_jax(gemma):
    """The port's Gemma-2 w4g forward (embedding scale, softcaps, post-block
    norms, GeGLU, the alternating window over T > window) against JAX
    model_forward on the same checkpoint, at every position."""
    jparams, jcfg, own, carried, cfg = gemma
    toks, pos, slots, tables, ctx = _forward_inputs()
    S, P = 16, tables.shape[1] + 1
    jcache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                            jcfg.cache_head_dim, P, S))
    jbatch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(tables),
                                   jnp.asarray(ctx))
    ref, _ = jllama.model_forward(jparams, jcfg, jnp.asarray(toks), jcache, jbatch,
                                  scheme="w4a16")
    ref = np32(ref)
    assert np.abs(ref).max() <= 30.0            # the final softcap bounds the logits
    for params in (own, carried):
        cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, P, S), "cpu")
        batch = tllama.AttentionBatch(*(torch.tensor(a) for a in (pos, slots, tables, ctx)))
        got, _ = tllama.model_forward(params, cfg, torch.tensor(toks), cache, batch,
                                      scheme="w4a16")
        got = np32(got)
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


# ---------------------------------------------------------------- the engine

SCHED = dict(max_num_seqs=2, max_model_len=128, prefill_chunk_size=32,
             decode_batch_buckets=(2,), prefill_token_buckets=(32,))


def _generate(eng, prompts, max_tokens, sp=SamplingParams):
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


def test_windowed_w4a16_draft_tokens_match_jax_engine(gemma):
    """Greedy tokens of the port's LLMEngine, QSpec with the windowed W4A16
    draft on its ring pool, against the JAX LLMEngine's on the same tiny
    AWQ Gemma-2: equal, or the first difference is a near-tie of the JAX
    logits."""
    from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
    from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
    jparams, jcfg, own, _, cfg = gemma
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(3, 256, size=n))) for n in (12, 27)]
    n_tok = 20
    jspec = JSpec(num_speculative_tokens=3, draft_scheme="w4a16", draft_kv_window=12)
    ref = _generate(JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                                       scheduler=JSched(**SCHED), speculative=jspec),
                               jparams), prompts, n_tok, JSamplingParams)
    spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a16",
                             draft_kv_window=12)
    eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                 scheduler=SchedulerConfig(**SCHED), speculative=spec),
                    own, device="cpu")
    # the draft's window: min(draft_kv_window, the model's 16), on every layer
    assert eng.runner.draft_cfg.sliding_window == 12
    assert eng.runner.draft_cfg.sliding_window_pattern == 1
    assert eng.runner._ring_pages == 3     # ceil((12 + 3 + 1) / 16) + 2
    got = _generate(eng, prompts, n_tok)
    assert eng.spec_metrics.num_spec_rounds > 0
    for p, a, b in zip(prompts, ref, got):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            ids = p + a[:diff[0]]
            S = 16
            n_pages = -(-len(ids) // S)
            cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                                   jcfg.cache_head_dim, n_pages + 1, S))
            pos = np.arange(len(ids), dtype=np.int32)[None]
            batch = jllama.AttentionBatch(
                jnp.asarray(pos), jnp.asarray(pos + S),
                jnp.asarray(np.arange(1, n_pages + 1, dtype=np.int32)[None]),
                jnp.asarray([len(ids)], jnp.int32))
            logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                                             cache, batch, scheme="w4a16")
            top2 = np.sort(np32(logits[0, -1]))[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (diff[0], top2)


def test_ring_bitexact_vs_full_pool_and_ar(monkeypatch):
    """The Gemma-2 slice's windowed W4A16 draft on its ring pool against the
    same draft on a full pool (QSPEC_RING_DRAFT=0) and greedy AR, bit for
    bit, long enough to wrap every ring; drafts are accepted."""
    hf = hf_config(layers=2).to_dict()
    cfg = dataclasses.replace(ModelConfig.from_hf_config(hf), quant="w4g")
    params = tllama.init_params(cfg, seed=0, device="cpu", group_size=GROUP)
    r = np.random.default_rng(5)
    ps = [list(map(int, r.integers(3, 256, size=int(r.integers(8, 40))))) for _ in range(3)]
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
        runs[ring] = (_generate(eng, ps, 90), eng)
    (full, e_full), (ring, e_ring), (ar, _) = runs["0"], runs["1"], runs[None]
    assert e_full.runner._ring_pages == 0 and e_ring.runner._ring_pages == 4
    assert ring == full == ar
    m_full, m_ring = e_full.spec_metrics, e_ring.spec_metrics
    assert m_ring.num_draft_tokens == m_full.num_draft_tokens
    assert m_ring.num_draft_accepted == m_full.num_draft_accepted > 0
    assert m_ring.num_emitted_tokens == m_full.num_emitted_tokens


def test_what_the_slice_does_not_serve_raises():
    """A QuaRot (w4) Gemma-2, and the quantized-activation drafts on a w4g
    one, raise."""
    hf = hf_config(layers=2).to_dict()
    quarot = ModelConfig.from_hf_config(hf)
    assert quarot.quant == "w4"
    with pytest.raises(NotImplementedError, match="Gemma-2"):
        tllama.init_params(quarot, device="cpu")
    cfg = dataclasses.replace(quarot, quant="w4g")
    params = tllama.init_params(cfg, seed=0, device="cpu", group_size=GROUP)
    with pytest.raises(NotImplementedError, match="Gemma-2"):
        LLMEngine(EngineConfig(model=quarot, scheduler=SchedulerConfig(**SCHED)),
                  params, device="cpu")
    for scheme in ("w4a4", "w4a8"):
        spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme=scheme)
        with pytest.raises(ValueError, match="w4g"):
            LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                   scheduler=SchedulerConfig(**SCHED), speculative=spec),
                      params, device="cpu")
