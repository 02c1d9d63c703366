"""EAGLE on weight-only-quantized Llama targets, on the CPU: AWQ (w4g) and
compressed-tensors int8 (w8) tiny targets against the JAX engine, and the
targets EAGLE still refuses.

The tiny targets' checkpoints are made by the JAX writers from one numpy
state dict and loaded by both packages; the EAGLE net is the JAX package's
random one, carried over. The port's greedy EAGLE equals its AR; its tokens
equal the JAX engine's up to a near-tie in the JAX logits (a top-2 gap under
TIE_GAP at the first differing position: the JAX CPU references scale the
weights before their dot, the port after), as in tests/test_torch_grouped.py;
on the prompts whose tokens agree, both engines' drafted / accepted /
emitted counts are equal.
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
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qspec_tpu.model_loader import ct as jct
from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams
from qspec_tpu.spec_decode import eagle as jeagle
from qspec_tpu_torch import ModelConfig
from qspec_tpu_torch.engine import model_runner as tmr
from qspec_tpu_torch.models import llama as tllama
from tests.test_torch_eagle import eagle, prompts, run_engine

TIE_GAP = 2e-2

SCHED = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quantized_sd(cfg, fmt, seed=0):
    """A float tiny-Llama state dict of ``cfg``'s shapes, its projections
    through the JAX AWQ (g = 64) or compressed-tensors int8 writer."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def d(i, o):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    def gamma():
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    sd = {"model.embed_tokens.weight": d(H, V), "model.norm.weight": gamma(),
          "lm_head.weight": d(H, V)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        for name, (a, b) in {"self_attn.q_proj": (H, cfg.q_size),
                             "self_attn.k_proj": (H, cfg.kv_size),
                             "self_attn.v_proj": (H, cfg.kv_size),
                             "self_attn.o_proj": (cfg.q_size, H),
                             "mlp.gate_proj": (H, I), "mlp.up_proj": (H, I),
                             "mlp.down_proj": (I, H)}.items():
            w = d(a, b).T                                     # [K, N]
            t = (jg.make_awq_tensors(w, 64) if fmt == "w4g" else
                 jct.make_ct_int8_tensors(w)[0])
            for key, val in t.items():
                sd[f"{p}{name}.{key}"] = val
        sd[p + "input_layernorm.weight"] = gamma()
        sd[p + "post_attention_layernorm.weight"] = gamma()
    return sd


@pytest.mark.parametrize("quant", ["w4g", "w8"])
def test_eagle_on_weight_only_target_matches_jax(quant):
    """Greedy EAGLE (k = 3) on a tiny AWQ / compressed-tensors int8 target
    equals AR; against the JAX engine on the same checkpoint and net its
    tokens agree up to a near-tie, and on the agreeing prompts the tokens and
    counts are equal; the target verifies at W4A16, the net
    stays bf16."""
    jcfg0 = JModel.tiny(quant="none", lm_head_quant="auto")
    sd = _quantized_sd(jcfg0, quant)
    load = jg.load_awq if quant == "w4g" else jct.load_ct_int8
    jparams, jcfg = load(dict(sd), jcfg0)
    jparams = {**jparams, "eagle": jeagle.init_eagle_params(jcfg, seed=4)}
    cfg = ModelConfig.tiny(quant=quant)
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    ps = prompts(4, seed=17)
    ar, _ = run_engine(cfg, params, SCHED, None, ps, max_tokens=16)
    sp, eng = run_engine(cfg, params, SCHED, eagle(3), ps, max_tokens=16)
    assert sp == ar
    assert eng.runner.verify_scheme == "w4a16" and eng.runner.draft_cfg.quant == "none"
    want, _ = _jax_eagle(jcfg, jparams, ps)
    agree = []
    for p, a, b in zip(ps, sp, want):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        if not diff:
            agree.append(p)
            continue
        gap = _jax_top2_gap(jparams, jcfg, p + b[:diff[0]])
        assert gap < TIE_GAP, (diff[0], gap)
    assert len(agree) >= 2
    sp, eng = run_engine(cfg, params, SCHED, eagle(3), agree, max_tokens=16)
    want, jeng = _jax_eagle(jcfg, jparams, agree)
    assert sp == want
    m, jm = eng.spec_metrics, jeng.spec_metrics
    assert ((m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens)
            == (jm.num_draft_tokens, jm.num_draft_accepted, jm.num_emitted_tokens))


def _jax_eagle(jcfg, jparams, ps):
    """The JAX engine's greedy EAGLE (k = 3) tokens of ``ps``, and the engine."""
    jeng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                              scheduler=JSched(**SCHED),
                              speculative=JSpec(num_speculative_tokens=3, method="eagle")),
                      jparams)
    for p in ps:
        jeng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True))
    want = {}
    while jeng.has_unfinished_requests():
        for o in jeng.step():
            if o.finished:
                want[o.request_id] = o.output_token_ids
    return [want[i] for i in range(len(ps))], jeng


def _jax_top2_gap(jparams, jcfg, ids) -> float:
    """The gap between the JAX model's two largest logits after ``ids``."""
    from qspec_tpu.models import llama as jllama
    from qspec_tpu.ops import kv_cache as jkv
    S = 16
    pages = -(-len(ids) // S)
    cache = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                           jcfg.cache_head_dim, pages + 1, S))
    pos = np.arange(len(ids), dtype=np.int32)[None]
    batch = jllama.AttentionBatch(jnp.asarray(pos), jnp.asarray(pos + S),
                                  jnp.asarray(np.arange(1, pages + 1, dtype=np.int32)[None]),
                                  jnp.asarray([len(ids)], jnp.int32))
    logits, _ = jllama.model_forward(jparams, jcfg, jnp.asarray([ids], jnp.int32), cache,
                                     batch, scheme="w4a16")
    top2 = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top2[1] - top2[0])


def test_eagle_refusals_name_item_7():
    """A Gemma-2 target (even as AWQ) and a non-Llama arch are still
    refused, naming ROADMAP queue 1 item 7."""
    g2 = ModelConfig.gemma2_9b(quant="w4g")
    with pytest.raises(NotImplementedError, match="item 7"):
        tmr._check_eagle(g2, {"eagle": {}})
    with pytest.raises(NotImplementedError, match="item 7"):
        tmr._check_eagle(ModelConfig.tiny(quant="none").__class__(
            **{**ModelConfig.tiny(quant="none").__dict__, "arch": "qwen2"}), {"eagle": {}})
