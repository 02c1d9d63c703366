"""The residual add fused into the port's norms, on the CPU.

``rmsnorm`` / ``rmsnorm_quant`` with ``residual`` form h = x + residual
(torch's bf16 add), normalize h and return it beside the result; on the CPU
their plain versions run. They are held against the JAX package's
``x + residual`` followed by its norm (the jnp path at M <= 64, the Pallas
body in interpret mode at M = 72), at tests/test_torch_ops.py's tolerances:
rtol/atol 2e-2 for the normed rows, rmsnorm_quant scales rtol 1e-3 with
values within 1 and > 99% exact. h must be the bf16 sum bit for bit, and the
fused call the unfused pair's result bit for bit.

The forward (models/llama.py) hands each layer's ``down`` to the next norm
unadded, and fuses ``x + o`` into the post-attention norm and the last add
into the final norm. Its logits are held against JAX ``model_forward`` at
the tolerances of tests/test_torch_model.py (QuaRot: relative L2 2e-2 for
w4a16, 0.3 for w4a4, with their argmax rules), tests/test_torch_grouped.py
(w4g Llama: relative L2 2e-2, argmax differences only at near-ties) and
tests/test_torch_gemma2.py (rtol 2e-2, atol 2e-2 x max|ref|); greedy QSpec
through LLMEngine must equal its qspec_null oracle.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.model_loader import grouped as jg
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops.rmsnorm_quant import rmsnorm as j_rmsnorm
from qspec_tpu.ops.rmsnorm_quant import rmsnorm_quant as j_rmsnorm_quant
from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, ModelConfig,
                             SamplingParams, SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops import rmsnorm_quant as trq

TIE_GAP = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run faster on one thread, and the suite's parallel
    workers then do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_pair(a: np.ndarray):
    """The same bf16 values as a jax array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j, np.float32)).to(torch.bfloat16)


def np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _rows(rng, m, h, x_mag=3.0, r_mag=1.0):
    """x, residual and a gamma, each as a (jax, torch) pair."""
    return (bf16_pair(rng.standard_normal((m, h)).astype(np.float32) * x_mag),
            bf16_pair(rng.standard_normal((m, h)).astype(np.float32) * r_mag),
            bf16_pair(1 + 0.1 * rng.standard_normal(h).astype(np.float32)))


# ---------------------------------------------------------------- the ops

@pytest.mark.parametrize("form", ["rmsnorm", "rmsnorm_gamma", "quant4", "quant8"])
@pytest.mark.parametrize("m,h", [(4, 256), (64, 256), (72, 512)])   # 72 > 64: Pallas
def test_fused_plain_matches_jax(rng, form, m, h):
    (xj, xt), (rj, rt), (gj, gt) = _rows(rng, m, h)
    hj = xj + rj
    if form.startswith("rmsnorm"):
        gamma = form == "rmsnorm_gamma"
        out, hs = trq.rmsnorm(xt, gt if gamma else None, residual=rt)
        ref = j_rmsnorm(hj, gj if gamma else None)
        np.testing.assert_allclose(np32(out), np32(ref), rtol=2e-2, atol=2e-2)
    else:
        bits = int(form[-1])
        out, hs = trq.rmsnorm_quant(xt, bits=bits, residual=rt)
        ref = j_rmsnorm_quant(hj, bits=bits)
        np.testing.assert_allclose(out.scales.numpy(), np.asarray(ref.scales), rtol=1e-3)
        diff = np.abs(out.values.numpy().astype(np.int32) - np.asarray(ref.values, np.int32))
        assert (diff <= 1).all()
        assert (diff == 0).mean() > 0.99
    assert hs.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(hs), np32(hj))


@pytest.mark.parametrize("x_mag,r_mag", [(1.0, 1.0), (100.0, 0.01), (1e-3, 30.0)])
def test_h_is_the_bf16_sum(rng, x_mag, r_mag):
    """h is the f32 sum rounded to bf16 once, to nearest even: torch's bf16
    +, JAX's, and numpy's f32 sum rounded by hand, over operands whose
    exponents differ, so that many sums round."""
    (xj, xt), (rj, rt), _ = _rows(rng, 64, 512, x_mag, r_mag)
    _, hs = trq.rmsnorm(xt, residual=rt)
    assert hs.data_ptr() not in (xt.data_ptr(), rt.data_ptr())
    assert torch.equal(hs, xt + rt)
    np.testing.assert_array_equal(np32(hs), np32(xj + rj))
    s = (np32(xt) + np32(rt)).view(np.uint32)           # f32 sums (exact in f32 here or not)
    rne = ((s + 0x7FFF + ((s >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(np32(hs), rne)


@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("bits", [None, 4, 8])
def test_fused_equals_unfused_pair(rng, gamma, bits):
    """The fused plain version is the torch add then today's norm, bit for
    bit, and h is that add; the inputs are not written."""
    (_, xt), (_, rt), (_, gt) = _rows(rng, 16, 256)
    x0, r0 = xt.clone(), rt.clone()
    g = gt if gamma else None
    if bits is None:
        out, hs = trq.rmsnorm(xt, g, residual=rt)
        assert torch.equal(out, trq.rmsnorm(xt + rt, g))
        assert torch.equal(out, trq.rmsnorm_ref(xt + rt, g))
    else:
        out, hs = trq.rmsnorm_quant_ref(xt, g, bits=bits, residual=rt)
        pair = trq.rmsnorm_quant_ref(xt + rt, g, bits=bits)
        assert torch.equal(out.values, pair.values) and torch.equal(out.scales, pair.scales)
        if not gamma:          # the wrapper is weightless
            wq, wh = trq.rmsnorm_quant(xt, bits=bits, residual=rt)
            assert torch.equal(wq.values, pair.values) and torch.equal(wq.scales, pair.scales)
            assert torch.equal(wh, hs)
    assert torch.equal(hs, xt + rt)
    assert torch.equal(xt, x0) and torch.equal(rt, r0)


def test_unfused_calls_keep_their_results(rng):
    """Without a residual the entry points return what they returned
    before: a tensor, and a QuantizedActivation."""
    (_, xt), _, (_, gt) = _rows(rng, 8, 256)
    assert isinstance(trq.rmsnorm(xt, gt), torch.Tensor)
    assert isinstance(trq.rmsnorm_quant(xt, bits=4), trq.QuantizedActivation)


def test_fused_rejects_a_mismatched_residual():
    x = torch.zeros(4, 256, dtype=torch.bfloat16, device="meta")
    for bad in (torch.zeros(4, 128, dtype=torch.bfloat16, device="meta"),
                torch.zeros(4, 256, dtype=torch.float32, device="meta")):
        with pytest.raises(ValueError, match="residual"):
            trq._check_rows(x, bad, "rmsnorm")


# ---------------------------------------------------------------- the forward

GEMMA_HF = dict(model_type="gemma2", vocab_size=256, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=32, max_position_embeddings=128, rope_theta=10000.0,
                rms_norm_eps=1e-5, sliding_window=16, query_pre_attn_scalar=24,
                attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh")


@functools.lru_cache(maxsize=None)
def _model(kind):
    """(JAX params, JAX cfg, the port's params, the port's cfg) of a tiny
    QuaRot Llama (JAX init_params, carried over), a tiny AWQ Llama or a
    tiny AWQ Gemma-2 (the port's AWQ writer, g = 32, loaded by both
    packages' load_awq)."""
    if kind == "quarot":
        jcfg = JModel.tiny(quant="w4", lm_head_quant="bf16")
        cfg = ModelConfig.tiny(quant="w4", lm_head_quant="bf16")
        jparams = jllama.init_params(jcfg, seed=0)
        return jparams, jcfg, tllama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu"), cfg
    if kind == "w4g":
        jcfg = JModel.tiny(quant="w4g", lm_head_quant="bf16")
        cfg = ModelConfig.tiny(quant="w4g", lm_head_quant="bf16")
    else:
        jcfg, cfg = JModel.from_hf_config(GEMMA_HF), ModelConfig.from_hf_config(GEMMA_HF)
    sd = tg.make_grouped_state_dict(cfg, "awq", 32, seed=0, device="cpu")
    jparams, jcfg = jg.load_awq({k: v.numpy() for k, v in sd.items()}, jcfg)
    params, cfg = tg.load_awq(sd, cfg, device="cpu")
    return jparams, jcfg, params, cfg


def norm_spy(monkeypatch):
    """Record, for every norm the forward calls, whether it got a residual."""
    calls = []
    for name in ("rmsnorm", "rmsnorm_quant"):
        def spy(*a, _fn=getattr(tllama, name), **kw):
            calls.append(kw.get("residual") is not None)
            return _fn(*a, **kw)
        monkeypatch.setattr(tllama, name, spy)
    return calls


def norms_per_forward(cfg):
    """(fused, unfused) norm calls of one forward: every norm after a
    residual add takes it in (L - 1 input norms, L post-attention norms,
    the final norm); layer 0's input norm and Gemma-2's post-block norms
    have none."""
    L = cfg.num_layers
    return 2 * L, 1 + (2 * L if cfg.post_norms else 0)


def _check_logits(kind, scheme, got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    if kind == "gemma2":
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())
        return
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    pick = got.argmax(-1)
    if scheme == "w4a4":
        assert rel <= 0.3, rel
        assert (pick == ref.argmax(-1)).mean() >= 0.6
        return
    assert rel <= 2e-2, rel
    gap = ref.max(-1) - np.take_along_axis(ref, pick[..., None], -1)[..., 0]
    assert gap.max() < TIE_GAP, gap.max()


@pytest.mark.parametrize("kind,scheme", [("quarot", "w4a16"), ("quarot", "w4a4"),
                                         ("w4g", "w4a16"), ("gemma2", "w4a16")])
def test_forward_matches_jax_with_fused_adds(kind, scheme, monkeypatch):
    """A prefill rectangle, then a verify-shaped step on its cache, through
    both packages' model_forward; every add before a norm goes into the
    norm; logits_indices selects the same rows of both tensors before the
    final norm, bit for bit the full forward's rows."""
    jparams, jcfg, params, cfg = _model(kind)
    rng = np.random.default_rng(11)
    B, Q, S, P = 2, 12, 16, 10
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    steps = [(rng.integers(3, 256, size=(B, Q)), np.tile(np.arange(Q), (B, 1)))]
    steps.append((rng.integers(3, 256, size=(B, 4)), Q + np.tile(np.arange(4), (B, 1))))
    jc = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                        jcfg.cache_head_dim, P, S))
    tc = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                        cfg.cache_head_dim, P, S), "cpu")
    calls = norm_spy(monkeypatch)
    for toks, pos in steps:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        ctx = pos[:, -1] + 1
        slot = np.take_along_axis(tables, pos // S, axis=1) * S + pos % S
        jb = jllama.AttentionBatch(*(jnp.asarray(a) for a in (pos, slot, tables, ctx)))
        tb = tllama.AttentionBatch(*(torch.tensor(a) for a in (pos, slot, tables, ctx)))
        ref, jc = jllama.model_forward(jparams, jcfg, jnp.asarray(toks), jc, jb, scheme=scheme)
        got, tc = tllama.model_forward(params, cfg, torch.tensor(toks), tc, tb, scheme=scheme)
        _check_logits(kind, scheme, np32(got), np32(ref))
        idx = torch.tensor([toks.shape[1] - 1, 1])
        last, tc = tllama.model_forward(params, cfg, torch.tensor(toks), tc, tb, scheme=scheme,
                                        logits_indices=idx)
        assert torch.equal(last[:, 0], got[torch.arange(B), idx])
    fused, unfused = norms_per_forward(cfg)
    assert calls.count(True) == 2 * 2 * fused
    assert calls.count(False) == 2 * 2 * unfused


def _generate(eng, prompts, max_tokens):
    for p in prompts:
        eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=max_tokens,
                                          ignore_eos=True))
    outs, steps = {}, 0
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
        steps += 1
        assert steps < 500
    return [outs[i] for i in range(len(prompts))]


@pytest.mark.parametrize("kind", ["quarot", "w4g", "gemma2"])
def test_greedy_qspec_equals_oracle(kind, monkeypatch):
    """Greedy QSpec (k = 3; the W4A4 draft on QuaRot, the W4A16 draft on
    the AWQ models) through LLMEngine equals its qspec_null oracle, token
    for token, with every norm after an add taking the add in."""
    _, _, params, cfg = _model(kind)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(3, 256, size=n))) for n in (9, 30)]
    out = {}
    calls = norm_spy(monkeypatch)
    for method in ("qspec", "qspec_null"):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=method,
                                 draft_scheme="w4a4" if kind == "quarot" else "w4a16")
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16),
            scheduler=SchedulerConfig(max_num_seqs=2, max_model_len=128, prefill_chunk_size=32,
                                      decode_batch_buckets=(2,), prefill_token_buckets=(32,)),
            speculative=spec), params, device="cpu")
        out[method] = _generate(eng, prompts, 16)
        assert eng.spec_metrics.num_spec_rounds > 0
    assert out["qspec"] == out["qspec_null"]
    assert all(len(t) == 16 for t in out["qspec"])
    fused, unfused = norms_per_forward(cfg)
    forwards = len(calls) // (fused + unfused)
    assert forwards > 0 and len(calls) == forwards * (fused + unfused)
    assert calls.count(True) == forwards * fused
