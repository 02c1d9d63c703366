"""The port's default configuration against the JAX package's, on the CPU:
the int8 lm_head (``matmul_w8a16``) and the int8 / fp8 paged KV caches.

Inputs are made with numpy from a seed and fed to both packages. The JAX
kernel entry points run their Pallas kernels in interpret mode here; the
port's wrappers run their plain PyTorch versions because the tensors lie on
the CPU. Tolerances are the JAX tests' own:

- ``quantize_weight_int8`` and the bytes and scales ``update_layer`` stores:
  bit-equal;
- ``matmul_w8a16``: rtol/atol 2e-2 (tests/kernels/test_linear_kernels.py);
- ``gather_layer``: the round-trip tolerances of
  tests/kernels/test_attention.py (int8 atol 0.03 / rtol 0.05, fp8_e4m3
  0.03 / 0.07, fp8_e5m2 0.2 / 0.25), and equal to the JAX gather;
- ``paged_attention`` over an 8-bit cache: 4e-2, 8e-2 for fp8_e5m2;
- ``model_forward`` with the int8 head and an int8 cache: the relative L2
  tolerances of tests/test_torch_model.py (2e-2 w4a16, 5e-2 w4a8, 0.3 w4a4,
  for the reasons given there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.config import ModelConfig as JModelConfig
from qspec_tpu.models import llama as jllama
from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops import packing as jpk
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu.ops.linear_kernels import matmul_w8a16 as j_w8a16
from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.models import llama as tllama
from qspec_tpu_torch.ops import kernel_wrappers
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops import linear_kernels as tlk
from qspec_tpu_torch.ops import packing as tpk
from qspec_tpu_torch.ops.attention import paged_attention

KV8 = ["int8", "fp8_e4m3", "fp8_e5m2"]
REL_TOL = {"w4a16": 2e-2, "w4a8": 5e-2, "w4a4": 0.3}


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


def as_bytes(t) -> np.ndarray:
    """The stored bytes of a cache tensor (torch or jax), as uint8."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    a = np.asarray(t)
    return a.view(np.uint8)


# ---------------------------------------------------------------- int8 head

def test_quantize_weight_int8_bit_equal(rng):
    w = rng.standard_normal((256, 192)).astype(np.float32) * 0.05
    w[:, 7] = 0.0                     # an all-zero channel takes the 1e-8 floor
    jq, js = jpk.quantize_weight_int8(w)
    q, s = tpk.quantize_weight_int8(w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    tq, ts = tpk.quantize_weight_int8_torch(torch.tensor(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (7, 512, 384), (16, 1024, 256)])
def test_w8a16_matches_jax_kernel(rng, m, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    qw, qs = jpk.quantize_weight_int8(w)
    xj, xt = bf16_pair(rng.standard_normal((m, k)).astype(np.float32))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = j_w8a16(xj, jnp.asarray(qw), jnp.asarray(qs), out_dtype=jdt)
        out = tlk.matmul_w8a16(xt, torch.tensor(qw), torch.tensor(qs), out_dtype=tdt)
        assert out.dtype == tdt and tuple(out.shape) == (m, n)
        np.testing.assert_allclose(np32(out), np32(ref), rtol=2e-2, atol=2e-2)


def test_w8a16_stacked_layer(rng):
    L, m, k, n = 3, 5, 256, 128
    ws = [jpk.quantize_weight_int8(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
          for _ in range(L)]
    qw = np.stack([w[0] for w in ws])
    qs = np.stack([w[1] for w in ws])
    xj, xt = bf16_pair(rng.standard_normal((m, k)).astype(np.float32))
    bias = rng.standard_normal(n).astype(np.float32)
    for li in range(L):
        ref = j_w8a16(xj, jnp.asarray(qw), jnp.asarray(qs), jnp.asarray(bias),
                      out_dtype=jnp.float32, layer_idx=jnp.int32(li))
        out = tlk.matmul_w8a16(xt, torch.tensor(qw), torch.tensor(qs),
                               torch.tensor(bias), out_dtype=torch.float32,
                               layer_idx=li)
        np.testing.assert_allclose(out.numpy(), np32(ref), rtol=2e-2, atol=2e-2)


def test_w8a16_plain_rows_independent_of_batch(rng):
    """The plain version's sums are exact (float64), so a row's logits do
    not depend on the batch: the CPU path's greedy QSpec == AR needs it."""
    qw, qs = tpk.quantize_weight_int8(rng.standard_normal((256, 96)).astype(np.float32))
    _, x = bf16_pair(rng.standard_normal((12, 256)).astype(np.float32))
    full = tlk.matmul_w8a16(x, torch.tensor(qw), torch.tensor(qs), out_dtype=torch.float32)
    part = tlk.matmul_w8a16(x[3:5], torch.tensor(qw), torch.tensor(qs),
                            out_dtype=torch.float32)
    assert torch.equal(part, full[3:5])


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
def test_pack_lm_head_matches_jax(rng, kind):
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.02
    jh = jllama.pack_lm_head(w, JModelConfig.tiny(quant="w4", lm_head_quant=kind))
    th = tllama.pack_lm_head(w, ModelConfig.tiny(lm_head_quant=kind))
    if kind == "bf16":
        np.testing.assert_array_equal(np32(th), np32(jh))
        return
    assert sorted(th) == sorted(jh)
    for key in th:
        np.testing.assert_array_equal(th[key].numpy(), np.asarray(jh[key]))


# ---------------------------------------------------------------- KV cache

def _fill(rng, kv_dtype, L=2, P=8, Hkv=2, S=16, D=128, T=40, layer=1, head_dim=None):
    """One cache per package, filled by update_layer with the same bf16
    K/V (head dim ``head_dim`` padded into the cache's D)."""
    hd = head_dim or D
    k = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, hd)).astype(np.float32)
    k[3] = 0.0                        # an all-zero token takes the 1e-8 floor
    slots = np.arange(T, dtype=np.int32) + S
    jc = jkv.allocate(jkv.KVCacheConfig(L, Hkv, D, P, S, kv_dtype))
    tc = tkv.allocate(tkv.KVCacheConfig(L, Hkv, D, P, S, kv_dtype), "cpu")
    kj, kt = bf16_pair(k)
    vj, vt = bf16_pair(v)
    jc = jkv.update_layer(jc, layer, kj, vj, jnp.asarray(slots))
    assert tkv.update_layer(tc, layer, kt, vt, torch.tensor(slots)) is tc
    return jc, tc, kj, vj


@pytest.mark.parametrize("kv_dtype", KV8)
def test_update_layer_stores_jax_bytes(rng, kv_dtype):
    """The quantized entries and their scales are bit-equal to the JAX
    package's (same f32 absmax, division and round-half-even / fp8 cast)."""
    jc, tc, _, _ = _fill(rng, kv_dtype, head_dim=64)
    assert tc.kv_pages.dtype == tkv.kv_entry_dtype(kv_dtype)
    np.testing.assert_array_equal(as_bytes(tc.kv_pages), as_bytes(jc.kv_pages))
    assert (tc.kv_scales is None) == (jc.kv_scales is None) \
        == (not tkv.kv_has_scales(kv_dtype))
    if tc.kv_scales is not None:
        np.testing.assert_array_equal(tc.kv_scales.numpy(), np.asarray(jc.kv_scales))


@pytest.mark.parametrize("kv_dtype", KV8)
def test_gather_layer_round_trip(rng, kv_dtype):
    jc, tc, kj, vj = _fill(rng, kv_dtype, T=32)
    tables = np.array([[1, 2], [2, 0]], np.int32)
    kd, vd = tkv.gather_layer(tc, 1, torch.tensor(tables))
    jk, jv = jkv.gather_layer(jc, 1, jnp.asarray(tables))
    assert kd.dtype == torch.bfloat16 and tuple(kd.shape) == (2, 2, 32, 128)
    np.testing.assert_array_equal(np32(kd), np32(jk))
    np.testing.assert_array_equal(np32(vd), np32(jv))
    atol, rtol = dict(int8=(0.03, 0.05), fp8_e4m3=(0.03, 0.07),
                      fp8_e5m2=(0.2, 0.25))[kv_dtype]
    # row 0 reads pages 1, 2: tokens 0..31 as written
    for got, want in ((kd, kj), (vd, vj)):
        np.testing.assert_allclose(np32(got[0]).transpose(1, 0, 2), np32(want),
                                   atol=atol, rtol=rtol)


def test_kv_cache_bytes_match_jax():
    for dt in tkv.KV_DTYPES:
        cfg = (3, 2, 128, 10, 16, dt)
        assert tkv.kv_cache_bytes(tkv.KVCacheConfig(*cfg)) == \
            jkv.kv_cache_bytes(jkv.KVCacheConfig(*cfg))
        assert tkv.kv_entry_bytes(dt) == jkv.kv_entry_bytes(dt)
    with pytest.raises(ValueError):
        tkv.allocate(tkv.KVCacheConfig(1, 1, 128, 2, 16, "fp16"), "cpu")


@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("kv_dtype", KV8)
def test_paged_attention_8bit_matches_jax_kernel(rng, kv_dtype, Q):
    jc, tc, _, _ = _fill(rng, kv_dtype, layer=0, T=64)
    B, Hq, D, S = 3, 4, 128, 16
    qj, qt = bf16_pair(rng.standard_normal((B, Q, Hq, D)).astype(np.float32))
    tables = np.tile(np.arange(1, 5, dtype=np.int32), (B, 1))
    ctx = np.array([Q + 3, S + Q, 3 * S + Q], np.int32)
    scale = D ** -0.5
    ref = paged_attention_pallas(qj, jc.kv_pages, jnp.asarray(tables), jnp.asarray(ctx),
                                 scale, kv_scales=jc.kv_scales)
    out = paged_attention(qt, tc, 0, torch.tensor(tables), torch.tensor(ctx), scale)
    tol = 8e-2 if kv_dtype == "fp8_e5m2" else 4e-2
    np.testing.assert_allclose(np32(out), np32(ref), atol=tol, rtol=tol)


def test_attention_counted_per_instantiation(rng):
    """Each KV entry type's instantiation of the attention kernel has a
    counter of its own under its own name; the plain path (CPU tensors)
    raises none of them."""
    counters = kernel_wrappers()
    names = ["paged_attention"] + [f"paged_attention_{dt}" for dt in KV8]
    assert len({id(counters[n]) for n in names}) == len(names)
    before = {n: c.launches for n, c in counters.items()}
    _, tc, _, _ = _fill(rng, "int8", layer=0, T=64)
    q = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16)
    paged_attention(q, tc, 0, torch.arange(1, 5, dtype=torch.int32)[None],
                    torch.tensor([20], dtype=torch.int32), 128 ** -0.5)
    assert {n: c.launches for n, c in counters.items()} == before


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module")
def default_models():
    """The JAX package's tiny QuaRot model at its defaults: the int8 head."""
    jcfg = JModelConfig.tiny(quant="w4")
    tcfg = ModelConfig.tiny(quant="w4")
    assert jcfg.resolved_lm_head_quant == tcfg.resolved_lm_head_quant == "int8"
    jparams = jllama.init_params(jcfg, seed=0)
    tparams = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_params_carry_int8_head_unchanged(default_models):
    _, jparams, _, tparams = default_models
    head = tparams["lm_head"]
    assert head["qw8"].dtype == torch.int8
    np.testing.assert_array_equal(head["qw8"].numpy(), np.asarray(jparams["lm_head"]["qw8"]))
    np.testing.assert_array_equal(head["qs"].numpy(), np.asarray(jparams["lm_head"]["qs"]))


@pytest.mark.parametrize("scheme,kv_dtype", [("w4a16", "bfloat16"), ("w4a16", "int8"),
                                             ("w4a8", "int8"), ("w4a4", "int8")])
def test_model_forward_int8_head_matches_jax(default_models, scheme, kv_dtype):
    """A prefill rectangle, then a verify-shaped step, through both
    packages with the int8 head, over an int8 cache for each scheme (and a
    bf16 cache, which isolates the head)."""
    jcfg, jparams, tcfg, tparams = default_models
    S, P = 16, 10
    rng = np.random.default_rng(11)
    B, Q = 2, 12
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    toks = rng.integers(1, 512, size=(B, Q)).astype(np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (B, 1))
    toks2 = rng.integers(1, 512, size=(B, 4)).astype(np.int32)
    pos2 = Q + np.tile(np.arange(4, dtype=np.int32), (B, 1))
    jc = jkv.allocate(jkv.KVCacheConfig(jcfg.num_layers, jcfg.num_kv_heads,
                                        jcfg.cache_head_dim, P, S, kv_dtype))
    tc = tkv.allocate(tkv.KVCacheConfig(tcfg.num_layers, tcfg.num_kv_heads,
                                        tcfg.cache_head_dim, P, S, kv_dtype), "cpu")
    for t, p, c in ((toks, pos, np.full(B, Q, np.int32)),
                    (toks2, pos2, np.full(B, Q + 4, np.int32))):
        slot = np.take_along_axis(tables, p // S, axis=1) * S + p % S
        jb = jllama.AttentionBatch(jnp.asarray(p), jnp.asarray(slot),
                                   jnp.asarray(tables), jnp.asarray(c))
        tb = tllama.AttentionBatch(torch.tensor(p), torch.tensor(slot),
                                   torch.tensor(tables), torch.tensor(c))
        jl, jc = jllama.model_forward(jparams, jcfg, jnp.asarray(t), jc, jb, scheme=scheme)
        tl, tc = tllama.model_forward(tparams, tcfg, torch.tensor(t), tc, tb, scheme=scheme)
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape and tl.dtype == np.float32 and np.isfinite(tl).all()
        rel = np.linalg.norm(tl - jl) / np.linalg.norm(jl)
        assert rel <= REL_TOL[scheme], rel


def test_init_params_builds_the_resolved_head():
    for kind, keys in (("auto", ["qs", "qw8"]), ("int8", ["qs", "qw8"]),
                       ("int4", ["qs", "qw"])):
        cfg = ModelConfig.tiny(lm_head_quant=kind)
        head = tllama.init_params(cfg, seed=2, device="cpu")["lm_head"]
        assert sorted(head) == keys
        assert tuple(head["qs"].shape) == (cfg.vocab_size,)
    # the int8 head is the bf16 head's float weights, quantized
    dense = tllama.init_params(ModelConfig.tiny(lm_head_quant="bf16"), seed=2,
                               device="cpu")["lm_head"]
    q8 = tllama.init_params(ModelConfig.tiny(), seed=2, device="cpu")["lm_head"]
    deq = q8["qw8"].to(torch.float32) * q8["qs"]
    assert (deq - dense.float()).abs().max() <= q8["qs"].max() * 0.51 + 1e-3
