"""The BLOOM / MPT slice of the port against the JAX package and HF
transformers, on the CPU: ALiBi in attention, the float families' config,
converters and graph, the safetensors reader and the checkpoint-directory
entry point.

Inputs are made with numpy from a seed (or are tiny HF models built
in-process from a torch seed, as tests/models/test_alibi_family.py builds
them) and fed to both packages. The JAX Pallas kernel runs in interpret
mode; the port's wrappers run their plain versions on CPU tensors.
Tolerances:

- ``alibi_slopes``: exact (the same float32 numpy arithmetic);
- attention with ALiBi: 3e-2 against the JAX plain version
  (tests/kernels/test_attention.py's ALiBi case), and against the JAX
  kernel 3e-2 over a bf16 cache, 4e-2 over int8 / fp8_e4m3 and 8e-2 over
  fp8_e5m2 (tests/test_torch_kv8.py's: the kernel folds the scales into
  bf16 dots);
- logits of the tiny HF BLOOM / MPT: tests/models/test_alibi_family.py's
  atol 0.25, rtol 0.05, argmax agreement > 0.95 with its near-tie rule,
  against HF and against JAX ``model_forward(scheme="bf16")``;
- converted weights and read tensors: bit-equal;
- the JAX ``init_params`` tree carried across: relative L2 2e-2 (the W4A16
  tolerance of tests/test_torch_model.py; the bf16 GEMM sums in another
  order);
- greedy tokens of ``LLM(model=<dir>)``: equal to the JAX engine's up to
  near-ties (top-2 logits within 2e-2).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from qspec_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from qspec_tpu.engine.llm_engine import LLMEngine as JLLMEngine  # noqa: E402
from qspec_tpu.config import CacheConfig as JCache  # noqa: E402
from qspec_tpu.config import EngineConfig as JEngine  # noqa: E402
from qspec_tpu.config import SchedulerConfig as JSched  # noqa: E402
from qspec_tpu.model_loader import families as jfam  # noqa: E402
from qspec_tpu.model_loader.loader import _read_safetensors  # noqa: E402
from qspec_tpu.model_loader.loader import config_from_hf_dir as j_config_from_dir  # noqa: E402
from qspec_tpu.models import llama as jllama  # noqa: E402
from qspec_tpu.models.registry import resolve as j_resolve  # noqa: E402
from qspec_tpu.ops import kv_cache as jkv  # noqa: E402
from qspec_tpu.ops.attention import alibi_slopes as j_alibi_slopes  # noqa: E402
from qspec_tpu.ops.attention import paged_attention as j_attention  # noqa: E402
from qspec_tpu.ops.attention_pallas import paged_attention_pallas  # noqa: E402
from qspec_tpu.sampling_params import SamplingParams as JSamplingParams  # noqa: E402
from qspec_tpu_torch import LLM, SamplingParams  # noqa: E402
from qspec_tpu_torch.config import BLOOM_7B1_HF, MPT_7B_HF, ModelConfig  # noqa: E402
from qspec_tpu_torch.engine.arg_utils import EngineArgs  # noqa: E402
from qspec_tpu_torch.model_loader import families as tfam  # noqa: E402
from qspec_tpu_torch.model_loader.loader import (config_from_hf_dir,  # noqa: E402
                                                 read_safetensors, read_safetensors_file)
from qspec_tpu_torch.models import llama as tllama  # noqa: E402
from qspec_tpu_torch.models.registry import resolve  # noqa: E402
from qspec_tpu_torch.ops import kv_cache as tkv  # noqa: E402
from qspec_tpu_torch.ops.attention import (alibi_slopes, paged_attention,  # noqa: E402
                                           paged_attention_ref, tree_mask)
from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree  # noqa: E402

TIE_GAP = 2e-2
TOKENS = list(range(2, 14))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------- slopes

@pytest.mark.parametrize("n", [4, 6, 8, 12, 16, 32, 112])
def test_alibi_slopes_equal_jax(n):
    """Powers of two and not (112: BLOOM-176B's head count): the same bits."""
    got, want = alibi_slopes(n), j_alibi_slopes(n)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- attention

ATTN_CASES = [  # kv dtype, Hq, Hkv, Q, head dim
    ("bfloat16", 4, 4, 1, 128), ("bfloat16", 4, 4, 4, 128), ("bfloat16", 8, 2, 4, 128),
    ("bfloat16", 4, 4, 4, 64), ("bfloat16", 8, 2, 1, 64),
    ("int8", 4, 4, 4, 128), ("int8", 8, 2, 1, 128), ("int8", 4, 4, 4, 64),
    ("fp8_e4m3", 4, 4, 4, 128), ("fp8_e4m3", 8, 2, 4, 64),
    ("fp8_e5m2", 4, 4, 1, 128), ("fp8_e5m2", 8, 2, 4, 128)]
KERNEL_TOL = {"bfloat16": 3e-2, "int8": 4e-2, "fp8_e4m3": 4e-2, "fp8_e5m2": 8e-2}


def _alibi_case(kv_dtype, Hq, Hkv, Q, hd, seed, L=2, P=12, S=16, B=3):
    """One cache per package (head dim ``hd`` padded into 128) filled by
    update_layer with the same bf16 K/V; shuffled tables; contexts that cross
    pages. Returns the JAX and torch inputs and the slopes."""
    rng = np.random.default_rng(seed)
    T = (P - 1) * S
    k = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    slots = np.arange(T, dtype=np.int32) + S
    jc = jkv.allocate(jkv.KVCacheConfig(L, Hkv, 128, P, S, kv_dtype))
    tc = tkv.allocate(tkv.KVCacheConfig(L, Hkv, 128, P, S, kv_dtype), "cpu")
    kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jc = jkv.update_layer(jc, 1, kj, vj, jnp.asarray(slots))
    tkv.update_layer(tc, 1, torch.tensor(np32(kj)).to(torch.bfloat16),
                     torch.tensor(np32(vj)).to(torch.bfloat16), torch.tensor(slots))
    tables = rng.permutation(np.arange(1, P)).astype(np.int32)[:3 * 3].reshape(3, 3)
    ctx = np.array([Q + 3, S + Q + 2, 3 * S - 1], np.int32)
    q = jnp.asarray(rng.standard_normal((B, Q, Hq, hd)).astype(np.float32) * 2, jnp.bfloat16)
    slopes = j_alibi_slopes(Hq)
    return (q, jc, jnp.asarray(tables), jnp.asarray(ctx)), \
        (torch.tensor(np32(q)).to(torch.bfloat16), tc, torch.tensor(tables),
         torch.tensor(ctx)), slopes


@pytest.mark.parametrize("kv_dtype,Hq,Hkv,Q,hd", ATTN_CASES)
def test_alibi_attention_matches_jax(kv_dtype, Hq, Hkv, Q, hd):
    """The port's plain version with ALiBi (through ``paged_attention``,
    which pads a head dim of 64 into the 128-wide cache) against the JAX
    plain version and the JAX Pallas kernel in interpret mode: MHA and GQA,
    Q = 1 and 4, every cache entry type; and ALiBi changes the output."""
    (q, jc, jtab, jctx), (tq, tc, ttab, tctx), slopes = _alibi_case(
        kv_dtype, Hq, Hkv, Q, hd, seed=Hq * 100 + Q * 10 + hd)
    scale = hd ** -0.5
    got = paged_attention(tq, tc, 1, ttab, tctx, scale, alibi=torch.tensor(slopes))
    jref = j_attention(q, jc, 1, jtab, jctx, scale, alibi=jnp.asarray(slopes))
    np.testing.assert_allclose(np32(got), np32(jref), atol=3e-2, rtol=3e-2)
    qp = jnp.pad(q, ((0, 0), (0, 0), (0, 0), (0, 128 - hd)))
    kern = paged_attention_pallas(qp, jc.kv_pages, jtab, jctx, scale,
                                  layer=jnp.asarray(1, jnp.int32), kv_scales=jc.kv_scales,
                                  alibi=jnp.asarray(slopes))[..., :hd]
    tol = KERNEL_TOL[kv_dtype]
    np.testing.assert_allclose(np32(got), np32(kern), atol=tol, rtol=tol)
    plain = paged_attention(tq, tc, 1, ttab, tctx, scale)
    assert not np.allclose(np32(got), np32(plain), atol=3e-2)


def test_alibi_under_tree_raises():
    """ALiBi under the Medusa tree mask raises in both of the port's
    versions: the JAX kernel would bias a tree row by its slot's distance,
    AR by the node's position root + depth."""
    (_, _, _, _), (tq, tc, ttab, tctx), slopes = _alibi_case("bfloat16", 4, 4, 1, 128, 0)
    t = build_tree(DEFAULT_TREE)
    prefix = 2
    q = torch.zeros(3, prefix + t.num_nodes, 4, 128, dtype=torch.bfloat16)
    pos = torch.arange(prefix + t.num_nodes)[None].repeat(3, 1) + 20
    tree = tree_mask(prefix, t.ancestors, "cpu")
    for fn in (paged_attention, paged_attention_ref):
        with pytest.raises(NotImplementedError, match="tree"):
            fn(q, tc, 1, ttab, tctx + 40, 0.1, q_positions=pos, alibi=torch.tensor(slopes),
               tree=tree)


# ---------------------------------------------------------------- configs

def test_configs_and_registry():
    """BLOOM-7B1 and MPT-7B at their published widths, as the JAX package
    reads them; MPT's refusals; the bf16 head of a float checkpoint."""
    for hf in (BLOOM_7B1_HF, MPT_7B_HF):
        got, want = resolve(hf), j_resolve(hf)
        for f in ("arch", "vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "head_dim", "rms_norm_eps", "quant",
                  "norm_type", "mlp_gated", "position_embedding", "linear_bias",
                  "clip_qkv", "hidden_act", "tie_word_embeddings",
                  "max_position_embeddings", "resolved_lm_head_quant"):
            assert getattr(got, f) == getattr(want, f), (hf["model_type"], f)
    b = ModelConfig.bloom_7b1()
    assert (b.hidden_size, b.num_layers, b.vocab_size, b.head_dim) == (4096, 30, 250880, 128)
    assert b.resolved_lm_head_quant == "bf16" and b.cache_head_dim == 128
    for bad in ({"alibi": False}, {"qk_ln": True}):
        with pytest.raises(ValueError):
            ModelConfig.from_hf_config({**MPT_7B_HF, "attn_config": bad})
    with pytest.raises(NotImplementedError):
        ModelConfig(norm_type="batchnorm")


# ---------------------------------------------------------------- HF goldens

def _hf_bloom(seed=0):
    cfg = transformers.BloomConfig(vocab_size=256, hidden_size=64, n_layer=2, n_head=4,
                                   layer_norm_epsilon=1e-5)
    torch.manual_seed(seed)
    return transformers.BloomForCausalLM(cfg).eval(), {
        **cfg.to_dict(), "architectures": ["BloomForCausalLM"]}


def _hf_mpt(seed=0):
    cfg = transformers.MptConfig(
        d_model=64, n_heads=4, n_layers=2, expansion_ratio=4, max_seq_len=64, vocab_size=256,
        attn_config=transformers.models.mpt.configuration_mpt.MptAttentionConfig(alibi=True))
    torch.manual_seed(seed)
    return transformers.MptForCausalLM(cfg).eval(), {
        **cfg.to_dict(), "architectures": ["MPTForCausalLM"]}


def _port_logits(params, cfg, tokens):
    T = len(tokens)
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, 8, 16), "cpu")
    batch = tllama.AttentionBatch(torch.arange(T)[None], (torch.arange(T) + 16)[None],
                                  torch.tensor([[1, 2, 3, 4]], dtype=torch.int32),
                                  torch.tensor([T], dtype=torch.int32))
    logits, _ = tllama.model_forward(params, cfg, torch.tensor([tokens]), cache, batch,
                                     scheme="bf16")
    return logits[0].numpy()


def _jax_logits(params, cfg, tokens):
    T = len(tokens)
    cache = jkv.allocate(jkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, 8, 16))
    batch = jllama.AttentionBatch(jnp.arange(T, dtype=jnp.int32)[None],
                                  (jnp.arange(T, dtype=jnp.int32) + 16)[None],
                                  jnp.asarray([[1, 2, 3, 4]], jnp.int32),
                                  jnp.asarray([T], jnp.int32))
    logits, _ = jllama.model_forward(params, cfg, jnp.asarray([tokens], jnp.int32), cache,
                                     batch, scheme="bf16")
    return np.asarray(logits[0], np.float32)


def _agree(got, want, atol=0.25):
    """tests/models/test_alibi_family.py's rule: top-1 agreement > 0.95,
    near-ties (top-2 margin < 0.08) counting as agreement; every logit within
    atol 0.25, rtol 0.05."""
    top2 = np.sort(want, axis=-1)
    tied = (top2[:, -1] - top2[:, -2]) < 0.08
    agree = (got.argmax(-1) == want.argmax(-1)) | tied
    assert agree.mean() > 0.95, (got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0.05)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("family", ["bloom", "mpt"])
def test_family_vs_hf_and_jax(family):
    """Ports of test_bloom_vs_hf / test_mpt_vs_hf: the tiny HF model's state
    dict converted by the port's families.py and by the JAX
    load_family_float gives bit-equal weights (the de-interleaved BLOOM qkv
    and its bias, MPT's bias-free norms, the tied head), and the port's
    logits match HF's and JAX model_forward(scheme="bf16")'s."""
    hf, hf_dict = _hf_bloom() if family == "bloom" else _hf_mpt()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jparams, jcfg = jfam.load_family_float(sd, j_resolve(hf_dict))
    params, cfg = tfam.load_family_float(dict(sd), resolve(hf_dict))
    assert cfg.quant == "none" and cfg.position_embedding == "alibi"
    assert not cfg.mlp_gated and cfg.norm_type == "layernorm"
    assert cfg.linear_bias == (family == "bloom")
    jl = {k: v for k, v in _leaves(jparams).items() if k != "rope_cache"}
    tl = {k: v for k, v in _leaves(params).items() if k != "alibi_slopes"}
    assert set(jl) == set(tl)
    for k in jl:
        assert tuple(tl[k].shape) == tuple(jl[k].shape), k
        np.testing.assert_array_equal(np32(tl[k]), np32(jl[k]), err_msg=k)
    got = _port_logits(params, cfg, TOKENS)
    with torch.no_grad():
        want = hf(torch.tensor([TOKENS])).logits[0].numpy()
    _agree(got, want)
    _agree(got, _jax_logits(jparams, jcfg, TOKENS))


# config.json dicts of a tiny BLOOM and a tiny MPT (bias-free, clip_qkv 6)
TINY_HF = {
    "bloom": {"model_type": "bloom", "vocab_size": 256, "hidden_size": 128, "n_layer": 2,
              "n_head": 4},
    "mpt": {"model_type": "mpt", "vocab_size": 256, "d_model": 128, "n_heads": 4,
            "n_layers": 2, "expansion_ratio": 4, "max_seq_len": 128, "no_bias": True,
            "attn_config": {"alibi": True, "clip_qkv": 6.0}}}


def _jax_float_tree(family, seed):
    """The JAX init_params of a tiny BLOOM or MPT (quant "none"), its norms
    and betas randomized and, for BLOOM, an embedding LayerNorm added, as
    numpy leaves."""
    jcfg = JModelConfig.from_hf_config(TINY_HF[family])
    tree = jax_tree_to_numpy(jllama.init_params(jcfg, seed=seed))
    rng = np.random.default_rng(seed)
    H = jcfg.hidden_size

    def rand(shape, mean):
        return np.asarray(jnp.asarray(mean + 0.1 * rng.standard_normal(shape), jnp.bfloat16))
    for name in ("input_norm", "post_norm", "input_norm_b", "post_norm_b"):
        if name in tree["layers"]:
            tree["layers"][name] = rand(tree["layers"][name].shape, 0.0 if name.endswith("_b")
                                        else 1.0)
    for name in ("final_norm", "final_norm_b"):
        if name in tree:
            tree[name] = rand((H,), 0.0 if name.endswith("_b") else 1.0)
    if family == "bloom":
        tree["embed_norm"], tree["embed_norm_b"] = rand((H,), 1.0), rand((H,), 0.0)
    return jcfg, tree


def jax_tree_to_numpy(tree):
    return {k: jax_tree_to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("family", ["bloom", "mpt"])
def test_params_from_numpy_float(family):
    """The JAX init_params of a tiny BLOOM (biases, LayerNorm betas, an
    embedding LayerNorm) and of a tiny MPT (bias-free, clip_qkv 6), carried
    across by params_from_numpy, give the JAX model_forward's logits."""
    jcfg, tree = _jax_float_tree(family, seed=5)
    cfg = ModelConfig.from_hf_config(TINY_HF[family])
    assert cfg.clip_qkv == jcfg.clip_qkv
    params = tllama.params_from_numpy(tree, cfg, device="cpu")
    assert ("embed_norm" in params) == (family == "bloom")
    assert ("b" in params["layers"]["qkv"]) == (family == "bloom")
    assert ("input_norm_b" in params["layers"]) == ("input_norm_b" in tree["layers"])
    got = _port_logits(params, cfg, TOKENS + TOKENS[::-1])
    want = _jax_logits(jax_params(tree), jcfg, TOKENS + TOKENS[::-1])
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def jax_params(tree):
    return {k: jax_params(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------- directories

def test_reader_dtypes_and_shards(tmp_path):
    """The port's reader equals safetensors' own, tensor by tensor, on every
    dtype it takes (a scalar and an empty tensor among them) and across the
    files of a directory, read in sorted order."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "f16": torch.randn(7, generator=g).to(torch.float16),
               "f32": torch.randn(2, 2, 2, generator=g),
               "i32": torch.randint(-9, 9, (4,), generator=g, dtype=torch.int32),
               "i8": torch.randint(-9, 9, (5, 3), generator=g, dtype=torch.int8),
               "u8": torch.randint(0, 255, (9,), generator=g, dtype=torch.uint8),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    save_file(tensors, str(tmp_path / "a.safetensors"))
    save_file({"late": torch.arange(6, dtype=torch.int32)}, str(tmp_path / "b.safetensors"))
    got = read_safetensors_file(str(tmp_path / "a.safetensors"))
    want = load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    both = read_safetensors(str(tmp_path))
    assert set(both) == set(want) | {"late"} and torch.equal(both["late"], torch.arange(6,
                                                                                    dtype=torch.int32))


def _save(hf, path, **kw):
    hf.save_pretrained(str(path), safe_serialization=True, **kw)
    return path


@pytest.mark.parametrize("shard", [None, "150KB"], ids=["one-file", "sharded"])
def test_directory_reader_matches_safetensors(tmp_path, shard):
    """A tiny HF BLOOM saved by save_pretrained (one file, or sharded): the
    port's reader gives safetensors.numpy's tensors (and the JAX reader's
    values), and config_from_hf_dir the JAX package's config."""
    from safetensors.numpy import load_file
    hf, _ = _hf_bloom()
    d = _save(hf, tmp_path / "bloom", **({"max_shard_size": shard} if shard else {}))
    files = sorted(p.name for p in d.iterdir() if p.suffix == ".safetensors")
    assert (len(files) > 1) == (shard is not None)
    want = {}
    for f in files:
        want.update(load_file(str(d / f)))
    got = read_safetensors(str(d))
    assert set(got) == set(want)
    jread = _read_safetensors(str(d))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(np32(got[k]), jread[k], err_msg=k)
    cfg, jcfg = config_from_hf_dir(str(d)), j_config_from_dir(str(d))
    assert (cfg.arch, cfg.num_layers, cfg.hidden_size, cfg.position_embedding) == (
        jcfg.arch, jcfg.num_layers, jcfg.hidden_size, jcfg.position_embedding)


def _jax_engine_tokens(d, prompts, max_tokens):
    jcfg = j_config_from_dir(str(d))
    jparams, jcfg = jfam.load_family_float(_read_safetensors(str(d)), jcfg)
    eng = JLLMEngine(JEngine(model=jcfg, cache=JCache(page_size=16),
                             scheduler=JSched(**SCHED)), jparams)
    for p in prompts:
        eng.add_request(p, JSamplingParams(temperature=0.0, max_tokens=max_tokens,
                                           ignore_eos=True))
    outs = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                outs[o.request_id] = o.output_token_ids
    return [outs[i] for i in range(len(prompts))], jparams, jcfg


SCHED = dict(max_num_seqs=4, max_model_len=160, prefill_chunk_size=64,
             decode_batch_buckets=(2, 4), prefill_token_buckets=(64,))


def _agree_up_to_ties(jparams, jcfg, prompts, ref, got):
    """Token lists equal, or the first difference at a near-tie of the JAX
    model's logits (top-2 within TIE_GAP)."""
    for i, p in enumerate(prompts):
        diff = [j for j, (a, b) in enumerate(zip(ref[i], got[i])) if a != b]
        if diff:
            top2 = np.sort(_jax_logits(jparams, jcfg, p + ref[i][:diff[0]])[-1])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (i, diff[0], top2)


@pytest.mark.parametrize("family", ["bloom", "mpt"])
def test_llm_directory_equals_jax_engine(tmp_path, family):
    """LLM(model=<dir>, quantization=None, device="cpu") on a tiny HF
    checkpoint written by save_pretrained: greedy AR tokens equal the JAX
    engine's on the same directory (up to near-ties), and n-gram speculation
    (speculative_model="[ngram]") gives the AR tokens bit for bit."""
    hf, _ = _hf_bloom(1) if family == "bloom" else _hf_mpt(1)
    d = _save(hf, tmp_path / family)
    r = np.random.default_rng(3)
    prompts = [list(map(int, r.integers(1, 256, size=n))) for n in (5, 19, 40)]
    prompts[1] = prompts[1][:8] * 3          # a repeated span: n-gram proposals
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    kw = dict(device="cpu", quantization=None, block_size=16, max_num_seqs=4,
              max_model_len=160, prefill_chunk_size=64)
    ar = [o.output_token_ids for o in LLM(model=str(d), **kw).generate(prompts, sp)]
    llm = LLM(model=str(d), num_speculative_tokens=3, speculative_model="[ngram]", **kw)
    assert llm.engine_config.model.arch == family and llm.engine_config.model.quant == "none"
    assert [o.output_token_ids for o in llm.generate(prompts, sp)] == ar
    assert llm.spec_metrics.num_draft_tokens > 0
    ref, jparams, jcfg = _jax_engine_tokens(d, prompts, 16)
    _agree_up_to_ties(jparams, jcfg, prompts, ref, ar)


def test_directory_routes_not_ported(tmp_path):
    """A BLOOM directory under QuaRot quantization raises the port's
    check_served refusal (the JAX package's quantize_float finds no llama
    keys there); asked for as AWQ, a directory whose config.json names no
    AWQ / GPTQ quantization_config raises (AWQ / GPTQ directories load by
    their quant_method: tests/test_torch_grouped_dirs.py); a
    llama-keyed float directory at quantization=None loads and serves in
    bf16 (load_hf_float, tests/test_torch_checkpoint_routes.py)."""
    hf, _ = _hf_bloom()
    d = _save(hf, tmp_path / "bloom")
    with pytest.raises(NotImplementedError, match="served with bf16 weights"):
        LLM(model=str(d), device="cpu")                       # quantization="qspec"
    with pytest.raises(ValueError, match="no AWQ / GPTQ quantization_config"):
        EngineArgs(model=str(d), quantization="awq").model_config()
    lcfg = transformers.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=1, num_attention_heads=4)
    torch.manual_seed(0)
    ld = _save(transformers.LlamaForCausalLM(lcfg), tmp_path / "llama")
    assert json.loads((ld / "config.json").read_text())["architectures"] == ["LlamaForCausalLM"]
    llm = LLM(model=str(ld), device="cpu", quantization=None, block_size=16,
              max_model_len=128)
    assert llm.engine_config.model.quant == "none"
    out = llm.generate([[1, 2, 3, 4, 5]], SamplingParams(temperature=0.0, max_tokens=6,
                                                         ignore_eos=True))
    assert len(out[0].output_token_ids) == 6
