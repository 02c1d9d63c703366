"""The port's float-checkpoint loaders against the JAX package's, on the CPU.

``random_hadamard_matrix``, ``repack_from_reference`` / ``unpack_int4_np``
and ``pack_proj_weight`` are held bit for bit. ``quantize_float`` is held on
the JAX test's Hugging Face config (tests/models/test_quantize_float.py:
intermediate 448 = 28 * 16, so the non-symmetric Paley H_28 factor is in
play) and on the trained checkpoint ``checkpoints/induction_lm_v2.npz``
(3 layers, hidden 512): the scales at rtol 1e-5, the int4 codes equal but
where the two packages' float32 sums, taken in different orders, put
w / scale on the other side of a rounding tie (a stated share, each such
code one step away), and the logits of the port's ``model_forward`` at
``tests/test_torch_model.py``'s tolerances against the JAX package's on its
own quantized parameters. The JAX tests of the rotation algebra and of the
quantized schemes against the float model, and of the bf16 Llama against
Hugging Face, run again on the port; and greedy QSpec with the W4A4 draft
on the trained checkpoint equals its oracle and accepts drafts.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.model_loader import loader as jloader
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import hadamard as jhad
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops import packing as jpack
from qspec_tpu_torch.config import (CacheConfig, EngineConfig, ModelConfig,
                                    SchedulerConfig, SpeculativeConfig)
from qspec_tpu_torch.engine.llm_engine import LLMEngine
from qspec_tpu_torch.model_loader import loader as tloader
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import hadamard as thad
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops import packing as tpack
from qspec_tpu_torch.sampling_params import SamplingParams
from tests.test_torch_model import REL_TOL, TIE_GAP, W4A4_ARGMAX_AGREE

ROOT = Path(__file__).resolve().parents[1]
INDUCTION = ROOT / "checkpoints" / "induction_lm_v2"
PROJ = ("qkv", "o", "gate_up", "down")
# the share of int4 codes that may differ from the JAX package's (each by
# one step): measured 0 on the JAX test's config and 0 on induction_lm_v2
# (the products agree bit for bit there); the bound leaves room for a BLAS
# that orders the float32 sums differently
CODE_DIFF_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HF_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=448, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
             attention_bias=False, tie_word_embeddings=False)
CFG_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=448, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, rope_theta=10000.0,
              max_position_embeddings=128)


def hf_model(seed=0, **over):
    """The JAX test's Hugging Face Llama (``build``), built in process."""
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(**{**HF_KW, **over})).eval()


def state_dict(hf) -> dict:
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def hf():
    return hf_model()


@pytest.fixture(scope="module")
def both(hf):
    """The JAX test's checkpoint quantized by both packages (default seed 0,
    int8 head)."""
    sd = state_dict(hf)
    jp, jc = jloader.quantize_float(dict(sd), JModelConfig(**CFG_KW))
    tp, tc = tloader.quantize_float(dict(sd), ModelConfig(**CFG_KW), device="cpu")
    return jp, jc, tp, tc


def port_logits(params, cfg, tokens, scheme):
    """The port's forward over one sequence (the JAX test's run_ours)."""
    T = len(tokens)
    S = 16
    P = -(-T // S) + 2
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, P, S), "cpu")
    pos = torch.arange(T)[None]
    batch = tllama.AttentionBatch(pos, pos + S, torch.arange(1, P, dtype=torch.int32)[None],
                                  torch.tensor([T], dtype=torch.int32))
    logits, _ = tllama.model_forward(params, cfg, torch.tensor(np.asarray(tokens))[None],
                                     cache, batch, scheme=scheme)
    return logits[0].numpy()


def jax_logits(params, cfg, tokens, scheme):
    T = len(tokens)
    S = 16
    P = -(-T // S) + 2
    cache = jkv.allocate(jkv.KVCacheConfig(num_layers=cfg.num_layers,
                                           num_kv_heads=cfg.num_kv_heads,
                                           head_dim=cfg.cache_head_dim, num_pages=P,
                                           page_size=S))
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    batch = jllama.AttentionBatch(pos, pos + S, jnp.arange(1, P, dtype=jnp.int32)[None],
                                  jnp.asarray([T], jnp.int32))
    logits, _ = jllama.model_forward(params, cfg, jnp.asarray(np.asarray(tokens)[None]),
                                     cache, batch, scheme=scheme)
    return np.asarray(logits[0], np.float32)


def assert_logits_close(ref, got, scheme):
    """``tests/test_torch_model.py``'s tolerances: the relative L2 error, and
    argmaxes that differ only at a near-tie of the reference (w4a16, w4a8)
    or agree on most positions (w4a4). The near-tie gap is TIE_GAP in units
    of the row's largest |logit| when that exceeds 1: the random models of
    tests/test_torch_model.py have rows of largest |logit| about 1, where
    this is its absolute gap, and the trained checkpoint about 13, where
    the forwards' rounding differences (the same on identical parameters:
    the port's model_forward on the JAX tree) scale with the logits."""
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < REL_TOL[scheme], (scheme, rel)
    ra, ga = ref.argmax(-1), got.argmax(-1)
    if scheme == "w4a4":
        assert (ra == ga).mean() >= W4A4_ARGMAX_AGREE
    else:
        for i in np.nonzero(ra != ga)[0]:
            gap = TIE_GAP[scheme] * max(1.0, float(np.abs(ref[i]).max()))
            assert ref[i, ra[i]] - ref[i, ga[i]] < gap, (scheme, i)


def codes(qw) -> np.ndarray:
    return tpack.unpack_int4(torch.as_tensor(np.array(qw))).numpy().astype(np.int32)


def assert_quantized_like_jax(jp, tp):
    """Scales at rtol 1e-5; int4 codes equal but a bounded share, each one
    step away; the rotated embedding and the head as JAX's. Returns the
    share of codes that differ."""
    n_diff = n = 0
    for name in PROJ:
        np.testing.assert_allclose(tp["layers"][name]["qs"].numpy(),
                                   np.asarray(jp["layers"][name]["qs"]), rtol=1e-5)
        d = np.abs(codes(tp["layers"][name]["qw"]) - codes(jp["layers"][name]["qw"]))
        assert d.max() <= 1, name
        n_diff += int((d > 0).sum())
        n += d.size
    assert n_diff <= CODE_DIFF_SHARE * n, (n_diff, n)
    np.testing.assert_allclose(tp["embed"].float().numpy(),
                               np.asarray(jp["embed"], np.float32), rtol=2 ** -7, atol=1e-6)
    jh, th = jp["lm_head"], tp["lm_head"]
    if isinstance(jh, dict):
        np.testing.assert_allclose(th["qs"].numpy(), np.asarray(jh["qs"]), rtol=1e-5)
        if "qw8" in jh:
            hd = th["qw8"].numpy().astype(np.int32) - np.asarray(jh["qw8"]).astype(np.int32)
        else:
            hd = codes(th["qw"]) - codes(jh["qw"])
        assert np.abs(hd).max() <= 1
    else:
        np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                                   rtol=2 ** -7, atol=1e-6)
    return n_diff / n


# --------------------------------------------------------------- the pieces


@pytest.mark.parametrize("n,seed", [(128, 0), (448, 0), (512, 3), (2048, 7)])
def test_random_hadamard_matrix_bit_equal(n, seed):
    q = thad.random_hadamard_matrix(n, seed=seed)
    assert q.dtype == np.float64
    np.testing.assert_array_equal(q, jhad.random_hadamard_matrix(n, seed=seed))
    np.testing.assert_allclose(q @ q.T, np.eye(n), atol=1e-12)


def test_repack_from_reference_matches_jax_and_round_trips(rng):
    ref = rng.integers(0, 256, size=(48, 40), dtype=np.uint8)     # [out, in // 2]
    ours = tpack.repack_from_reference(ref)
    np.testing.assert_array_equal(ours, jpack.repack_from_reference(ref))
    np.testing.assert_array_equal(tpack.repack_from_reference(torch.as_tensor(ref)), ours)
    vals = tpack.unpack_int4_np(ours)                               # [in, out]
    np.testing.assert_array_equal(vals, jpack.unpack_int4_np(ours))
    np.testing.assert_array_equal(vals, tpack.unpack_int4(torch.as_tensor(ours)).numpy())
    np.testing.assert_array_equal(tpack.pack_reference(torch.as_tensor(vals)).numpy(), ref)
    np.testing.assert_array_equal(tpack.pack_int4_np(vals), ours)


@pytest.mark.parametrize("kind", ["w4", "none"])
def test_pack_proj_weight_matches_jax(rng, kind):
    w = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    j = jllama.pack_proj_weight(w, kind, col_blocks=(64, 16, 16), bias=b)
    t = tllama.pack_proj_weight(w, kind, col_blocks=(64, 16, 16), bias=b)
    assert t.keys() == j.keys()
    for key in t:
        np.testing.assert_array_equal(t[key].float().numpy(), np.asarray(j[key], np.float32))
    on_tensor = tllama.pack_proj_weight(torch.as_tensor(w).t().contiguous().t(), kind)
    for key in on_tensor:
        assert torch.equal(on_tensor[key], t[key]) and on_tensor[key].is_contiguous()
    with pytest.raises(ValueError, match="col_blocks"):
        tllama.pack_proj_weight(w, kind, col_blocks=(64, 16))


# ------------------------------------------------------- quantize_float vs JAX


def test_quantize_float_matches_jax(both):
    jp, jc, tp, tc = both
    assert tc.quant == "w4" and tc.resolved_lm_head_quant == "int8"
    assert assert_quantized_like_jax(jp, tp) == 0.0      # measured: every code equal
    for name in PROJ:
        assert tp["layers"][name]["qw"].shape == np.asarray(jp["layers"][name]["qw"]).shape


@pytest.mark.parametrize("scheme", ["w4a16", "w4a4", "w4a8"])
def test_logits_match_jax(both, rng, scheme):
    jp, jc, tp, tc = both
    tokens = rng.integers(1, 256, size=12).astype(np.int32)
    assert_logits_close(jax_logits(jp, jc, tokens, scheme),
                        port_logits(tp, tc, tokens, scheme), scheme)


def test_quantize_float_fused_phi3_layout(hf):
    """phi-3's fused qkv_proj / gate_up_proj give the split layout's
    parameters."""
    sd = state_dict(hf)
    fused = dict(sd)
    for li in range(2):
        p = f"model.layers.{li}."
        fused[p + "self_attn.qkv_proj.weight"] = np.concatenate(
            [fused.pop(p + f"self_attn.{n}_proj.weight") for n in "qkv"])
        fused[p + "mlp.gate_up_proj.weight"] = np.concatenate(
            [fused.pop(p + "mlp.gate_proj.weight"), fused.pop(p + "mlp.up_proj.weight")])
    a, _ = tloader.quantize_float(dict(sd), ModelConfig(**CFG_KW), device="cpu")
    b, _ = tloader.quantize_float(fused, ModelConfig(**CFG_KW), device="cpu")
    assert not fused                                   # the dict was consumed
    for name in PROJ:
        for key in ("qw", "qs"):
            assert torch.equal(a["layers"][name][key], b["layers"][name][key])


# ---------------------------- ports of tests/models/test_quantize_float.py


def test_rotation_algebra_exact(hf, rng):
    """bits=None: rotated but not quantized, the online Hadamards undo the
    offline rotations (up to bf16 noise) against the float model."""
    params, cfg = tloader.quantize_float(state_dict(hf), ModelConfig(**CFG_KW), bits=None,
                                         device="cpu")
    assert "w" in params["layers"]["down"]
    tokens = rng.integers(1, 256, size=12).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens[None].astype(np.int64))).logits[0].numpy()
    ours = port_logits(params, cfg, tokens, "w4a16")
    assert (ref.argmax(-1) == ours.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(ours, ref, atol=0.35)


def test_w4a16_close_to_float(hf, both, rng):
    tokens = rng.integers(1, 256, size=12).astype(np.int32)
    with torch.no_grad():
        ref = hf(torch.tensor(tokens[None].astype(np.int64))).logits[0].numpy()
    ours = port_logits(both[2], both[3], tokens, "w4a16")
    assert np.corrcoef(ref.ravel(), ours.ravel())[0, 1] > 0.98


def test_w4a4_correlated(both, rng):
    tokens = rng.integers(1, 256, size=12).astype(np.int32)
    ref = port_logits(both[2], both[3], tokens, "w4a16")
    ours = port_logits(both[2], both[3], tokens, "w4a4")
    assert np.corrcoef(ref.ravel(), ours.ravel())[0, 1] > 0.9


def test_w4a8_correlated(both, rng):
    tokens = rng.integers(1, 256, size=12).astype(np.int32)
    ref = port_logits(both[2], both[3], tokens, "w4a16")
    ours = port_logits(both[2], both[3], tokens, "w4a8")
    corr = np.corrcoef(ref.ravel(), ours.ravel())[0, 1]
    assert corr > 0.97
    w4a4 = port_logits(both[2], both[3], tokens, "w4a4")
    assert corr >= np.corrcoef(ref.ravel(), w4a4.ravel())[0, 1] - 0.02


# ---------------------------- ports of tests/models/test_llama_vs_hf.py


@pytest.fixture(scope="module")
def hf_float():
    hf = hf_model(intermediate_size=224)
    params, cfg = tloader.load_hf_float(
        state_dict(hf), ModelConfig(**{**CFG_KW, "intermediate_size": 224}), device="cpu")
    return hf, params, cfg


def test_prefill_logits_match_hf(hf_float, rng):
    hf, params, cfg = hf_float
    assert cfg.quant == "none" and cfg.resolved_lm_head_quant == "bf16"
    tokens = rng.integers(1, 256, size=16).astype(np.int32)
    with torch.no_grad():
        hf_logits = hf(torch.tensor(tokens[None].astype(np.int64))).logits[0].numpy()
    ours = port_logits(params, cfg, tokens, "bf16")
    assert (hf_logits.argmax(-1) == ours.argmax(-1)).mean() >= 0.9
    np.testing.assert_allclose(ours - ours.max(-1, keepdims=True),
                               hf_logits - hf_logits.max(-1, keepdims=True), atol=0.35)


def test_decode_matches_prefill(hf_float, rng):
    """Token-by-token decode through the paged cache == one prefill."""
    _, params, cfg = hf_float
    T, S = 12, 4
    tokens = rng.integers(1, 256, size=T).astype(np.int32)
    kv = tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads, cfg.cache_head_dim, 8, S)
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    slot = torch.arange(T) // S * S + S + torch.arange(T) % S
    full, _ = tllama.model_forward(
        params, cfg, torch.tensor(tokens)[None], tkv.allocate(kv, "cpu"),
        tllama.AttentionBatch(torch.arange(T)[None], slot[None], tables,
                              torch.tensor([T], dtype=torch.int32)), scheme="bf16")
    cache = tkv.allocate(kv, "cpu")
    inc = []
    for i in range(T):
        lg, cache = tllama.model_forward(
            params, cfg, torch.tensor([[int(tokens[i])]]), cache,
            tllama.AttentionBatch(torch.tensor([[i]]), slot[i:i + 1][None], tables,
                                  torch.tensor([i + 1], dtype=torch.int32)), scheme="bf16")
        inc.append(lg[0, 0].numpy())
    np.testing.assert_allclose(np.stack(inc), full[0].numpy(), atol=0.05, rtol=0.05)


def test_load_hf_float_matches_jax(hf_float):
    """The bf16 tree equals the JAX load_hf_float's, weight for weight; a
    tied head is the embedding's storage."""
    hf, params, cfg = hf_float
    sd = state_dict(hf)
    jp, _ = jloader.load_hf_float(dict(sd), JModelConfig(**{**CFG_KW, "intermediate_size": 224}))
    for name in PROJ:
        np.testing.assert_array_equal(params["layers"][name]["w"].float().numpy(),
                                      np.asarray(jp["layers"][name]["w"], np.float32))
    for name in ("input_norm", "post_norm"):
        np.testing.assert_array_equal(params["layers"][name].float().numpy(),
                                      np.asarray(jp["layers"][name], np.float32))
    for name in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(params[name].float().numpy(),
                                      np.asarray(jp[name], np.float32))
    del sd["lm_head.weight"]
    tied, _ = tloader.load_hf_float(sd, cfg, device="cpu")
    assert tied["lm_head"].data_ptr() == tied["embed"].data_ptr()


# ------------------------------------------------------------ induction_lm_v2


def induction_prompts(n: int, prompt_len: int, vocab: int, seed: int = 0):
    """bench.py's ``induction_prompts``: a random segment (period 16..64)
    tiled to prompt_len, the trained checkpoint's distribution."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        period = int(rng.integers(16, 65))
        seg = rng.integers(2, vocab, size=period)
        out.append([int(x) for x in np.tile(seg, prompt_len // period + 1)[:prompt_len]])
    return out


def induction_cfg(cls):
    """The checkpoint's config (its .json ``cfg``) as ``cls``, without the
    fields ``cls`` lacks."""
    meta = json.loads(INDUCTION.with_suffix(".json").read_text())["cfg"]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in meta.items() if k in names})


@pytest.fixture(scope="module")
def induction():
    with np.load(INDUCTION.with_suffix(".npz")) as z:
        sd = {k: z[k] for k in z.files}
    jp, jc = jloader.quantize_float(dict(sd), induction_cfg(JModelConfig))
    tp, tc = tloader.quantize_float(sd, induction_cfg(ModelConfig), device="cpu")
    return jp, jc, tp, tc


def test_induction_quantized_like_jax(induction):
    jp, _, tp, tc = induction
    assert (tc.num_layers, tc.hidden_size, tc.resolved_lm_head_quant) == (3, 512, "bf16")
    assert assert_quantized_like_jax(jp, tp) == 0.0      # measured: every code equal


@pytest.mark.parametrize("scheme", ["w4a16", "w4a4", "w4a8"])
def test_induction_logits_match_jax(induction, scheme):
    jp, jc, tp, tc = induction
    tokens = induction_prompts(1, 48, tc.vocab_size, seed=5)[0]
    assert_logits_close(jax_logits(jp, jc, tokens, scheme),
                        port_logits(tp, tc, tokens, scheme), scheme)


def test_induction_qspec_w4a4_equals_oracle_and_accepts(induction):
    """Real weights: greedy QSpec with the W4A4 draft == the qspec_null
    oracle, and the draft is accepted (0.95833 on these prompts: 92 of 96
    drafts, 28 of the 32 rounds emitting k + 1 = 4 tokens)."""
    _, _, params, cfg = induction
    prompts = induction_prompts(4, 128, cfg.vocab_size)
    sched = SchedulerConfig(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                            decode_batch_buckets=(4,), prefill_token_buckets=(128,))
    out = {}
    for method in ("qspec", "qspec_null"):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=sched,
                                     speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                                   method=method)),
                        params, device="cpu")
        for p in prompts:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True))
        done = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        out[method] = ([done[i] for i in range(4)], eng.spec_metrics)
    assert out["qspec"][0] == out["qspec_null"][0]
    assert all(len(t) == 32 for t in out["qspec"][0])
    m = out["qspec"][1]
    assert m.draft_acceptance_rate > 0.5, m.summary()
    assert m.emitted_per_seq_round[4] > 0
