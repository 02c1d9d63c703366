"""The port's GGUF ingestion (model_loader/gguf.py) against the JAX
package's, on the CPU: the container round trip (the port's file is the JAX
writer's, byte for byte), every quant's dequantization bit for bit, the
port's torch Q4_0 writer against the JAX numpy one, and the prefill logits
of F16, Q4_0, Q8_0 and Q6_K files (and a Q4_0 file with llama.cpp's Q6_K
output head) against the JAX ``load_gguf``'s, at rtol / atol 2e-2 x
max|ref|, the JAX kernel tests' tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModel
from qspec_tpu.model_loader import gguf as jg
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader import gguf as tg
from qspec_tpu_torch.ops import kv_cache as tkv

TOL = 2e-2
# tests/models/test_gguf.py's tiny llama (its rope theta is the metadata's)
JCFG = JModel(vocab_size=512, hidden_size=128, intermediate_size=192, num_layers=2,
              num_heads=2, num_kv_heads=2, head_dim=64, quant="none",
              weightless_norm=False, lm_head_quant="bf16", max_position_embeddings=128,
              rope_theta=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _permute(w, n_head):
    """llama.cpp's convert_hf_to_gguf permute (HF -> gguf rows)."""
    return (w.reshape(n_head, 2, w.shape[0] // n_head // 2, *w.shape[1:])
            .swapaxes(1, 2).reshape(w.shape))


TRUNK = {"q4_0": (tg.GGML_Q4_0, tg.quantize_q4_0), "q8_0": (tg.GGML_Q8_0, tg.quantize_q8_0),
         "q6_k": (tg.GGML_Q6_K, tg.quantize_q6_k)}


def _write_model(path, quant, head=None, seed=0):
    """A float tiny llama written by the port's writers as a GGUF file:
    trunk projections in ``quant`` (F16 for "f16"), embeddings F16, the
    output head F16 or ``head`` ("q6_k"), norms F32."""
    rng = np.random.default_rng(seed)
    H, I, V = JCFG.hidden_size, JCFG.intermediate_size, JCFG.vocab_size

    def d(i, o):
        return (rng.standard_normal((o, i)) * 0.05).astype(np.float32)

    def gamma():
        return (1 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    def as_tensor(w, trunk=True, heads=None, kind=None):
        w = _permute(w, heads) if heads else w
        ne = list(reversed(w.shape))
        kind = kind or (quant if trunk else "f16")
        if kind in TRUNK:
            ty, write = TRUNK[kind]
            return ty, write(w), ne
        return tg.GGML_F16, w.astype(np.float16), ne

    tensors = {"token_embd.weight": as_tensor(d(H, V), trunk=False),
               "output.weight": as_tensor(d(H, V), trunk=False, kind=head),
               "output_norm.weight": (tg.GGML_F32, gamma(), [H])}
    for i in range(JCFG.num_layers):
        b = f"blk.{i}."
        tensors[b + "attn_q.weight"] = as_tensor(d(H, JCFG.q_size), heads=JCFG.num_heads)
        tensors[b + "attn_k.weight"] = as_tensor(d(H, JCFG.kv_size), heads=JCFG.num_kv_heads)
        tensors[b + "attn_v.weight"] = as_tensor(d(H, JCFG.kv_size))
        tensors[b + "attn_output.weight"] = as_tensor(d(JCFG.q_size, H))
        tensors[b + "ffn_gate.weight"] = as_tensor(d(H, I))
        tensors[b + "ffn_up.weight"] = as_tensor(d(H, I))
        tensors[b + "ffn_down.weight"] = as_tensor(d(I, H))
        tensors[b + "attn_norm.weight"] = (tg.GGML_F32, gamma(), [H])
        tensors[b + "ffn_norm.weight"] = (tg.GGML_F32, gamma(), [H])
    meta = {"general.architecture": "llama", "llama.embedding_length": H,
            "llama.block_count": JCFG.num_layers,
            "llama.attention.head_count": JCFG.num_heads,
            "llama.attention.head_count_kv": JCFG.num_kv_heads,
            "llama.feed_forward_length": I, "llama.context_length": 128,
            "llama.rope.freq_base": 10000.0,
            "llama.attention.layer_norm_rms_epsilon": 1e-5}
    tg.write_gguf(path, meta, tensors)
    return meta, tensors


# ---------------------------------------------------------------- container

def test_container_roundtrip(tmp_path):
    """The port's writer gives the JAX writer's file byte for byte; both
    readers read it back to the same metadata and tensors."""
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    meta = {"general.architecture": "llama", "x.n": 7, "x.f": 1.5, "x.b": True, "x.s": "hi"}
    tensors = {"a": (tg.GGML_F32, a, [8, 8]), "b": (tg.GGML_F16, a.astype(np.float16), [8, 8]),
               "c": (tg.GGML_Q4_0, jg.quantize_q4_0(a.reshape(2, 32)), [32, 2])}
    tg.write_gguf(str(tmp_path / "t.gguf"), meta, tensors)
    jg.write_gguf(str(tmp_path / "j.gguf"), meta, tensors)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    tmeta, tt = tg.read_gguf(str(tmp_path / "t.gguf"))
    jmeta, jt = jg.read_gguf(str(tmp_path / "t.gguf"))
    assert tmeta == jmeta and tmeta["x.b"] is True and tmeta["x.s"] == "hi"
    assert tt.keys() == jt.keys()
    for name in tt:
        assert tt[name]["shape"] == jt[name]["shape"] and tt[name]["data"] == jt[name]["data"]
    np.testing.assert_array_equal(tg.to_float(tt["a"]), a)


# ---------------------------------------------------------------- dequant

def _bf16_bytes(w):
    return (w.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16).tobytes()


QUANTS = {"F32": (tg.GGML_F32, lambda w: w.astype(np.float32).tobytes()),
          "F16": (tg.GGML_F16, lambda w: w.astype(np.float16).tobytes()),
          "BF16": (tg.GGML_BF16, _bf16_bytes),
          "Q4_0": (tg.GGML_Q4_0, jg.quantize_q4_0), "Q8_0": (tg.GGML_Q8_0, jg.quantize_q8_0),
          "Q4_K": (tg.GGML_Q4_K, jg.quantize_q4_k), "Q5_K": (tg.GGML_Q5_K, jg.quantize_q5_k),
          "Q6_K": (tg.GGML_Q6_K, jg.quantize_q6_k)}


@pytest.mark.parametrize("quant", list(QUANTS))
def test_to_float_bit_for_bit(quant):
    """Every quant's dequantization equals the JAX package's ``to_float``
    bit for bit, on the JAX quantizers' bytes."""
    ty, write = QUANTS[quant]
    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 512)).astype(np.float32)
    if not quant.endswith("_K"):
        w[1] = 0.0                  # an all-zero block (the K-quant writers divide by 0)
    rec = {"type": ty, "ne": [512, 6], "shape": (6, 512), "data": write(w)}
    got, want = tg.to_float(rec), jg.to_float(rec)
    assert got.dtype == want.dtype and got.shape == (6, 512)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(4, 64), (96, 128), (3, 4096)])
def test_q4_0_writer_bytes(shape):
    """The port's torch Q4_0 writer gives the JAX numpy writer's bytes, with
    a zero block and a block whose largest magnitude is a tie of signs."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1, 32)[0] = 0.0
    blk = w.reshape(-1, 32)[1]
    blk[3], blk[17] = -5.0, 5.0
    assert tg.quantize_q4_0(torch.from_numpy(w)) == jg.quantize_q4_0(w)
    assert tg.quantize_q4_0(w) == jg.quantize_q4_0(w)


# ---------------------------------------------------------------- models

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
                         jnp.asarray(tables), jnp.asarray(ctx), cfg=cfg,
                         scheme="bf16" if cfg.quant == "none" else "w4a16")
    return np.asarray(lg, np.float32)


def _port_logits(params, cfg):
    from qspec_tpu_torch.engine.model_runner import prefill_step
    cache = tkv.allocate(tkv.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                           cfg.cache_head_dim, 8, 16), "cpu")
    toks, pos, tables, ctx = (torch.tensor(a) for a in _prefill_inputs())
    lg, _ = prefill_step(params, cache, toks, pos, tables, ctx, cfg=cfg,
                         scheme="bf16" if cfg.quant == "none" else "w4a16")
    return lg.to(torch.float32).numpy()


@pytest.mark.parametrize("quant,head,want", [("f16", None, "none"), ("q4_0", None, "w4g"),
                                             ("q8_0", None, "none"), ("q6_k", None, "none"),
                                             ("q4_0", "q6_k", "w4g")])
def test_load_gguf_matches_jax(tmp_path, quant, head, want):
    """load_gguf of each file: the JAX loader's cfg and quant (Q4_0 trunks on
    the grouped-int4 path at g = 32, the rest bf16; a Q6_K output head
    leaves a Q4_0 trunk grouped) and its prefill logits."""
    path = str(tmp_path / "m.gguf")
    _write_model(path, quant, head=head)
    jparams, jcfg = jg.load_gguf(path)
    params, cfg = tg.load_gguf(path, device="cpu")
    assert cfg.quant == jcfg.quant == want
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "rope_theta", "rms_norm_eps",
              "max_position_embeddings", "tie_word_embeddings", "qkv_bias"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if want == "w4g":
        # group size 32: K // 32 scale rows
        assert params["layers"]["qkv"]["qs_g"].shape[1] == JCFG.hidden_size // 32
        for key in ("qw", "qs_g", "qo_g"):
            np.testing.assert_array_equal(params["layers"]["down"][key].numpy(),
                                          np.asarray(jparams["layers"]["down"][key]))
    ref = _jax_logits(jparams, jcfg)
    got = _port_logits(params, cfg)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max())


def test_unread_tensors_raise(tmp_path):
    """A tensor the llama tables do not name (Llama-3.1's rope_freqs.weight,
    a block tensor of another architecture) raises, naming it."""
    path = str(tmp_path / "m.gguf")
    meta, tensors = _write_model(path, "f16")
    for extra in ("rope_freqs.weight", "blk.0.attn_output.bias"):
        t = dict(tensors)
        t[extra] = (tg.GGML_F32, np.ones(64, np.float32), [64])
        tg.write_gguf(path, meta, t)
        with pytest.raises(NotImplementedError, match=extra.replace(".", r"\.")):
            tg.load_gguf(path, device="cpu")


def test_tied_and_qwen2_config():
    """config_from_gguf: no output.weight ties the head; qwen2's q bias sets
    qkv_bias; another architecture raises."""
    tensors = {"token_embd.weight": {"shape": (512, 128)},
               "blk.0.attn_q.bias": {"shape": (128,)}}
    meta = {"general.architecture": "qwen2", "qwen2.embedding_length": 128,
            "qwen2.attention.head_count": 2, "qwen2.feed_forward_length": 192,
            "qwen2.block_count": 1}
    cfg = tg.config_from_gguf(meta, tensors)
    assert cfg.tie_word_embeddings and cfg.qkv_bias and isinstance(cfg, ModelConfig)
    with pytest.raises(NotImplementedError, match="falcon"):
        tg.config_from_gguf({**meta, "general.architecture": "falcon"}, tensors)


@pytest.mark.parametrize("scaling", [
    {"rope.scaling.type": "linear", "rope.scaling.factor": 2.0},
    {"rope.scaling.type": "yarn", "rope.scaling.factor": 4.0,
     "rope.scaling.original_context_length": 32768},
    {"rope.scaling.factor": 8.0},
    {"rope.scale_linear": 2.0}])
def test_rope_scaling_raises(scaling):
    """A GGUF file's rope scaling raises (the JAX config_from_gguf drops it,
    serving plain rope past the original context); a type "none" at factor 1
    is plain rope, read as the JAX loader reads it."""
    tensors = {"token_embd.weight": {"shape": (512, 128)}}
    meta = {"general.architecture": "llama", "llama.embedding_length": 128,
            "llama.attention.head_count": 2, "llama.feed_forward_length": 192,
            "llama.block_count": 1}
    scaled = {**meta, **{f"llama.{k}": v for k, v in scaling.items()}}
    assert jg.config_from_gguf(scaled, tensors).rope_scaling is None
    with pytest.raises(NotImplementedError, match="rope scaling"):
        tg.config_from_gguf(scaled, tensors)
    plain = {**meta, "llama.rope.scaling.type": "none", "llama.rope.scaling.factor": 1.0}
    assert tg.config_from_gguf(plain, tensors).rope_scaling is None
