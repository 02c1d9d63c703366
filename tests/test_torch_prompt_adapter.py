"""Prompt embeddings and soft-prompt adapters in the port, on the CPU.

``tests/test_prompt_adapter.py``'s three cases on the port's engine (a soft
prompt changes the output and equals the same rows given as
``prompt_embeds``; the registry's lifecycle and errors; a PEFT
prompt-tuning checkpoint); ``model_forward``'s ``input_embeds`` against the
JAX package's, embedding rows mixed with table rows in one rectangle;
greedy QSpec with prompt embeddings == qspec_null (the shared-weights
draft's prefill takes them too); the refusals; and the QuaRot basis: the
float embedding rows of a prompt, given as a soft prompt on
``quantize_float(bits=None)``'s parameters, score as the prompt's tokens do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.prompt_adapter import PromptAdapterError
from tests.test_torch_model import REL_TOL, TIE_GAP
from tests.test_torch_quantize_float import CFG_KW, hf_model, state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MC = ModelConfig.tiny(quant="w4")
SCHED = dict(max_num_seqs=4, max_model_len=256, prefill_chunk_size=64,
             decode_batch_buckets=(4,), prefill_token_buckets=(64,))


def engine(params, cfg=MC, spec=None, **kw):
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                  scheduler=SchedulerConfig(**SCHED), speculative=spec),
                     params, device="cpu", **kw)


@pytest.fixture(scope="module")
def eng():
    return engine(tllama.init_params(MC, seed=0, device="cpu"))


def _run(eng, reqs, max_tokens=8):
    rids = [eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                              ignore_eos=True), **kw) for p, kw in reqs]
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[r] for r in rids]


# ------------------------------------ tests/test_prompt_adapter.py's cases

def test_adapter_changes_output_and_equals_manual_embeds(eng):
    rng = np.random.default_rng(0)
    H = MC.hidden_size
    soft = rng.standard_normal((6, H)).astype(np.float32) * 0.1
    assert eng.prompt_adapters.load("style", soft) == 6
    assert eng.prompt_adapters.list_adapters() == [{"name": "style", "virtual_tokens": 6}]
    prompt = list(map(int, rng.integers(1, 500, size=12)))
    base, adapted = _run(eng, [(prompt, {}), (prompt, {"prompt_adapter": "style"})])
    assert base != adapted, "soft prompt had no effect"
    table = eng.runner.params["embed"].float().numpy()
    embeds = np.concatenate([soft, table[np.asarray(prompt)]], axis=0)
    manual = _run(eng, [([0] * 6 + prompt, {"prompt_embeds": embeds})])[0]
    assert manual == adapted
    eng.prompt_adapters.unload("style")


def test_adapter_lifecycle_and_errors(eng):
    rng = np.random.default_rng(1)
    H = MC.hidden_size
    with pytest.raises(PromptAdapterError):
        eng.prompt_adapters.get("missing")
    with pytest.raises(PromptAdapterError):
        eng.prompt_adapters.load("bad", rng.standard_normal((4, H + 1)))
    eng.prompt_adapters.load("tmp", rng.standard_normal((2, H)))
    eng.prompt_adapters.unload("tmp")
    with pytest.raises(PromptAdapterError):
        eng.prompt_adapters.unload("tmp")


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_peft_checkpoint_ingestion(eng, tmp_path, fmt):
    from safetensors.numpy import save_file
    rng = np.random.default_rng(2)
    rows = {"prompt_embeddings": rng.standard_normal((5, MC.hidden_size)).astype(np.float32)}
    if fmt == "npz":
        np.savez(tmp_path / "adapter_model.npz", **rows)
    else:
        save_file(rows, str(tmp_path / "adapter_model.safetensors"))
    assert eng.prompt_adapters.load_path("peft", str(tmp_path)) == 5
    np.testing.assert_array_equal(eng.prompt_adapters.get("peft").numpy(),
                                  rows["prompt_embeddings"])
    eng.prompt_adapters.unload("peft")


# ---------------------------------------------------------- input_embeds

def test_input_embeds_match_jax_model_forward():
    """One rectangle whose first row takes given rows at positions 0-4 and
    table rows after, and whose second row is all table rows: the port's
    logits against the JAX package's (w4a16's tolerances)."""
    jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
    jparams = jllama.init_params(jcfg, seed=0)
    cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")
    rng = np.random.default_rng(4)
    B, Q, S, P = 2, 10, 16, 6
    toks = rng.integers(1, 512, size=(B, Q)).astype(np.int32)
    embeds = (rng.standard_normal((B, Q, cfg.hidden_size)) * 0.05).astype(np.float32)
    rows = np.zeros((B, Q), bool)
    rows[0, :5] = True
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    tables = np.array([[1], [2]], np.int32)
    slot = tables * S + pos
    ctx = np.full(B, Q, np.int32)
    jl, _ = jllama.model_forward(
        jparams, jcfg, jnp.asarray(toks),
        jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                       jcfg.cache_head_dim, P, S)),
        jllama.AttentionBatch(*map(jnp.asarray, (pos, slot, tables, ctx))), scheme="w4a16",
        input_embeds=jnp.asarray(embeds, jnp.bfloat16), embeds_rows=jnp.asarray(rows))
    tl, _ = tllama.model_forward(
        params, cfg, torch.tensor(toks),
        tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                       cfg.cache_head_dim, P, S), "cpu"),
        tllama.AttentionBatch(*map(torch.tensor, (pos, slot, tables, ctx))), scheme="w4a16",
        input_embeds=torch.tensor(embeds), embeds_rows=torch.tensor(rows))
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.linalg.norm(tl - jl) / np.linalg.norm(jl) <= REL_TOL["w4a16"]
    pick = tl.argmax(-1)
    gap = jl.max(-1) - np.take_along_axis(jl, pick[..., None], -1)[..., 0]
    assert gap.max() <= TIE_GAP["w4a16"]


@pytest.mark.parametrize("scheme", ["w4a4", "w4a8"])
def test_greedy_qspec_with_prompt_embeds_equals_oracle(eng, scheme):
    """The shared-weights draft prefills the same rows: greedy QSpec ==
    qspec_null with a soft prompt and raw prompt embeddings in the batch."""
    rng = np.random.default_rng(5)
    params = eng.runner.params
    prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in (12, 30, 7)]
    soft = rng.standard_normal((8, MC.hidden_size)).astype(np.float32) * 0.1
    raw = rng.standard_normal((9, MC.hidden_size)).astype(np.float32) * 0.1

    def go(method):
        e = engine(params, spec=SpeculativeConfig(num_speculative_tokens=3,
                                                  draft_scheme=scheme, method=method))
        e.prompt_adapters.load("soft", soft)
        return _run(e, [(prompts[0], {"prompt_adapter": "soft"}), (prompts[1], {}),
                        (None, {"prompt_embeds": raw}),
                        (prompts[2], {"prompt_adapter": "soft"})], max_tokens=12)
    assert go("qspec") == go("qspec_null")


def test_prompt_embeds_refusals(eng):
    from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
    params = eng.runner.params
    rows = np.zeros((3, MC.hidden_size), np.float32)
    with pytest.raises(ValueError, match=r"\[n, 256\]"):
        eng.add_request(None, prompt_embeds=rows[:, :8])
    with pytest.raises(ValueError, match="rows for"):
        eng.add_request([1, 2], prompt_embeds=rows)
    e = engine({**params, "eagle": init_eagle_params(MC, seed=0, device="cpu")},
               spec=SpeculativeConfig(num_speculative_tokens=2, method="eagle"))
    with pytest.raises(ValueError, match="EAGLE"):
        e.add_request(None, prompt_embeds=rows)
    dcfg = ModelConfig.tiny(quant="w4", num_layers=1)
    e = engine(params, spec=SpeculativeConfig(num_speculative_tokens=2, draft_model=dcfg),
               draft_params=tllama.init_params(dcfg, seed=1, device="cpu"))
    with pytest.raises(ValueError, match="separate draft model"):
        e.add_request(None, prompt_embeds=rows)


# ---------------------------------------------------------- the QuaRot basis

def test_soft_prompt_rotated_into_quantize_float_basis():
    """On quantize_float(bits=None)'s parameters, the float embedding rows
    of ids X given as a soft prompt before a prompt P score P's last
    position as the tokens X + P do (rows Q in f32, then bf16, as the
    rotated table was made: relative L2 of the logits 1e-2; measured
    0.0); the same rows unrotated do not."""
    hf = hf_model()
    cfg = ModelConfig(**CFG_KW)
    params, qcfg = tloader.quantize_float(state_dict(hf), cfg, bits=None, device="cpu")
    table = hf.model.embed_tokens.weight.detach().numpy()
    e = engine(params, cfg=qcfg)
    X, P = [5, 17, 99, 3], [44, 7, 120, 8, 31]
    e.prompt_adapters.load("x", table[X])
    ids, embeds = e.prompt_adapters.splice("x", P)
    assert ids == [0] * 4 + P

    def last_logits(tokens, input_embeds=None):
        T, S = len(tokens), 16
        cache = tkv.allocate(tkv.KVCacheConfig(qcfg.num_layers, qcfg.num_kv_heads,
                                               qcfg.cache_head_dim, 3, S), "cpu")
        pos = torch.arange(T)[None]
        batch = tllama.AttentionBatch(pos, pos + S, torch.tensor([[1]], dtype=torch.int32),
                                      torch.tensor([T], dtype=torch.int32))
        return tllama.model_forward(params, qcfg, torch.tensor([tokens]), cache, batch,
                                    scheme="w4a16", input_embeds=input_embeds,
                                    logits_indices=torch.tensor([T - 1]))[0][0, 0].numpy()
    ref = last_logits(X + P)
    got = last_logits(ids, embeds[None])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2
    unrot = torch.cat([torch.tensor(table[X]), embeds[4:]])[None]
    assert np.linalg.norm(last_logits(ids, unrot) - ref) / np.linalg.norm(ref) > 0.1
