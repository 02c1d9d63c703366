"""The port's ops (qspec_tpu_torch/ops) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
kernel entry points run their Pallas kernels in interpret mode here, as
tests/kernels/ runs them; the port's wrappers run their plain PyTorch
versions because the tensors lie on the CPU. Tolerances are the JAX kernel
tests' own: w4a16 and the norms rtol/atol 2e-2, w4a4 1e-2, attention 3e-2,
rmsnorm_quant scales rtol 1e-3 with values within 1 and > 99% exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qspec_tpu.ops import kv_cache as jkv
from qspec_tpu.ops import packing as jpk
from qspec_tpu.ops import quant as jq
from qspec_tpu.ops import rotary as jrot
from qspec_tpu.ops import sampling as jsmp
from qspec_tpu.ops.attention import paged_attention_ref as j_attn_ref
from qspec_tpu.ops.attention_pallas import paged_attention_pallas
from qspec_tpu.ops.hadamard import decompose_dim as j_decompose
from qspec_tpu.ops.hadamard import hadamard_matrix as j_hadamard
from qspec_tpu.ops.hadamard import hadamard_transform as j_hadamard_transform
from qspec_tpu.ops.linear_kernels import matmul_w4a4 as j_w4a4
from qspec_tpu.ops.linear_kernels import matmul_w4a16 as j_w4a16
from qspec_tpu.ops.rmsnorm_quant import rmsnorm as j_rmsnorm
from qspec_tpu.ops.rmsnorm_quant import rmsnorm_quant as j_rmsnorm_quant
from qspec_tpu_torch.ops import hadamard as th
from qspec_tpu_torch.ops import kv_cache as tkv
from qspec_tpu_torch.ops import linear_kernels as tlk
from qspec_tpu_torch.ops import packing as tpk
from qspec_tpu_torch.ops import quant as tq
from qspec_tpu_torch.ops import rmsnorm_quant as trq
from qspec_tpu_torch.ops import rotary as trot
from qspec_tpu_torch.ops import sampling as tsmp
from qspec_tpu_torch.ops.attention import paged_attention, paged_attention_ref


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


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("shape", [(8, 3), (64, 128), (448, 96)])
def test_pack_unpack_bit_equal(rng, shape):
    w = rng.integers(-8, 8, size=shape).astype(np.int8)
    packed = tpk.pack_int4(torch.tensor(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk.pack_int4(jnp.asarray(w))))
    np.testing.assert_array_equal(packed.numpy(), tpk.pack_int4_np(w))
    np.testing.assert_array_equal(packed.numpy(), jpk.pack_int4_np(w))
    np.testing.assert_array_equal(tpk.unpack_int4(packed).numpy(), w)
    np.testing.assert_array_equal(tpk.unpack_int4_low(packed).numpy(),
                                  np.asarray(jpk.unpack_int4_low(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(tpk.unpack_int4_high(packed).numpy(),
                                  np.asarray(jpk.unpack_int4_high(jnp.asarray(packed.numpy()))))


def test_quantize_weight_int4_bit_equal(rng):
    w = rng.standard_normal((256, 192)).astype(np.float32) * 0.05
    qw, qs = tpk.quantize_weight_int4(w)
    jqw, jqs = jpk.quantize_weight_int4(w)
    np.testing.assert_array_equal(qw, jqw)
    np.testing.assert_array_equal(qs, jqs)
    tqw, tqs = tpk.quantize_weight_int4_torch(torch.tensor(w))
    np.testing.assert_array_equal(tqw.numpy(), jqw)
    np.testing.assert_array_equal(tqs.numpy(), jqs)


def test_stacked_unpack_matches_per_layer(rng):
    w = rng.integers(-8, 8, size=(3, 64, 40)).astype(np.int8)
    stacked = torch.stack([tpk.pack_int4(torch.tensor(x)) for x in w])
    np.testing.assert_array_equal(tpk.unpack_int4(stacked).numpy(), w)


# ---------------------------------------------------------------- hadamard

@pytest.mark.parametrize("n", [1, 2, 4, 12, 20, 28, 32, 36, 52, 128, 512])
def test_hadamard_matrix_bit_equal(n):
    np.testing.assert_array_equal(th.hadamard_matrix(n), j_hadamard(n))


@pytest.mark.parametrize("n", [448, 14336, 4096, 32])
def test_decompose_dim_equal(n):
    assert th.decompose_dim(n) == j_decompose(n)


def test_hadamard_transform_close(rng):
    x = rng.standard_normal((5, 448)).astype(np.float32)
    out = th.hadamard_transform(torch.tensor(x))
    ref = np.asarray(j_hadamard_transform(jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- quant

@pytest.mark.parametrize("fn", ["sym_quant_int4", "sym_quant_int8"])
def test_sym_quant_equal(rng, fn):
    xj, xt = bf16_pair(rng.standard_normal((9, 256)).astype(np.float32) * 3)
    a = getattr(tq, fn)(xt)
    b = getattr(jq, fn)(xj)
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    np.testing.assert_array_equal(a.scales.numpy(), np.asarray(b.scales))


# ---------------------------------------------------------------- GEMMs

@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (7, 512, 256), (16, 1024, 384)])
def test_w4a16_matches_jax_kernel(rng, m, k, n):
    qw, qs = tpk.quantize_weight_int4(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    xj, xt = bf16_pair(rng.standard_normal((m, k)).astype(np.float32))
    out = tlk.matmul_w4a16(xt, torch.tensor(qw), torch.tensor(qs))
    ref = j_w4a16(xj, jnp.asarray(qw), jnp.asarray(qs))
    assert tuple(out.shape) == (m, n) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(out), np32(ref), rtol=2e-2, atol=2e-2)


def test_w4a16_stacked_layer(rng):
    k, n = 256, 128
    ws = [tpk.quantize_weight_int4(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
          for _ in range(3)]
    qw = np.stack([w[0] for w in ws])
    qs = np.stack([w[1] for w in ws])
    xj, xt = bf16_pair(rng.standard_normal((5, k)).astype(np.float32))
    out = tlk.matmul_w4a16(xt, torch.tensor(qw), torch.tensor(qs), layer_idx=2)
    ref = j_w4a16(xj, jnp.asarray(qw), jnp.asarray(qs), layer_idx=jnp.int32(2))
    np.testing.assert_allclose(np32(out), np32(ref), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (5, 512, 256), (32, 1024, 384)])
def test_w4a4_matches_jax_kernel(rng, bits, m, k, n):
    qw, qs = tpk.quantize_weight_int4(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    xj, xt = bf16_pair(rng.standard_normal((m, k)).astype(np.float32))
    jx = jq.sym_quant_int4(xj) if bits == 4 else jq.sym_quant_int8(xj)
    tx = tq.QuantizedActivation(torch.tensor(np.asarray(jx.values)),
                                torch.tensor(np.asarray(jx.scales)))
    out = tlk.matmul_w4a4(tx.values, tx.scales, torch.tensor(qw), torch.tensor(qs))
    ref = j_w4a4(jx.values, jx.scales, jnp.asarray(qw), jnp.asarray(qs))
    np.testing.assert_allclose(np32(out), np32(ref), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------- norms

@pytest.mark.parametrize("m,h", [(1, 256), (72, 512)])   # 72 > 64: the Pallas kernel
def test_rmsnorm_matches_jax_kernel(rng, m, h):
    xj, xt = bf16_pair(rng.standard_normal((m, h)).astype(np.float32))
    gj, gt = bf16_pair(rng.standard_normal(h).astype(np.float32))
    np.testing.assert_allclose(np32(trq.rmsnorm(xt, gt)), np32(j_rmsnorm(xj, gj)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np32(trq.rmsnorm(xt)), np32(j_rmsnorm(xj)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,h", [(13, 256), (72, 512)])
def test_rmsnorm_quant_matches_jax_kernel(rng, bits, m, h):
    xj, xt = bf16_pair(rng.standard_normal((m, h)).astype(np.float32) * 3)
    out = trq.rmsnorm_quant(xt, bits=bits)
    ref = j_rmsnorm_quant(xj, bits=bits)
    np.testing.assert_allclose(out.scales.numpy(), np.asarray(ref.scales), rtol=1e-3)
    diff = np.abs(out.values.numpy().astype(np.int32) - np.asarray(ref.values, np.int32))
    assert (diff <= 1).all()
    assert (diff == 0).mean() > 0.99
    lo, hi = (-8, 7) if bits == 4 else (-128, 127)
    assert out.values.min() >= lo and out.values.max() <= hi


# ---------------------------------------------------------------- KV cache

def _cache_pair(rng, L=2, P=12, Hkv=2, S=16, D=128):
    kv = rng.standard_normal((L, P, 2, Hkv, S, D)).astype(np.float32)
    j = jkv.PagedKVCache(jnp.asarray(kv, jnp.bfloat16))
    t = tkv.PagedKVCache(torch.tensor(np.asarray(j.kv_pages, np.float32)).to(torch.bfloat16))
    return j, t


def test_update_layer_bit_equal(rng):
    jc, tc = _cache_pair(rng)
    T, Hkv, D = 5, 2, 64     # head dim 64 pads into the 128-wide cache
    k = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    slots = np.array([17, 18, 0, 40, 191], np.int32)
    kj, kt = bf16_pair(k)
    vj, vt = bf16_pair(v)
    jc = jkv.update_layer(jc, 1, kj, vj, jnp.asarray(slots))
    keep = slots != 0        # slot 0 (null page) takes colliding padding writes
    tkv.update_layer(tc, 1, kt, vt, torch.tensor(slots))
    a = np32(tc.kv_pages)
    b = np.asarray(jc.kv_pages, np.float32)
    np.testing.assert_array_equal(a[:, 1:], b[:, 1:])
    assert keep.sum() == 4
    kg, vg = tkv.gather_layer(tc, 1, torch.tensor([[1, 2], [3, 11]]))
    jg = jkv.gather_layer(jc, 1, jnp.asarray([[1, 2], [3, 11]]))
    np.testing.assert_array_equal(np32(kg), np.asarray(jg[0], np.float32))
    np.testing.assert_array_equal(np32(vg), np.asarray(jg[1], np.float32))


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("Q", [1, 2, 4, 16])  # decode, draft backfill, verify, prefill chunk
def test_paged_attention_matches_jax_kernel(rng, Q):
    jc, tc = _cache_pair(rng, L=2)
    B, Hq, D, S = 3, 4, 128, 16
    qj, qt = bf16_pair(rng.standard_normal((B, Q, Hq, D)).astype(np.float32))
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0]], np.int32)
    ctx = np.array([Q + 5, 3 * S + Q, S + Q], np.int32)
    pos = ctx[:, None] - Q + np.arange(Q)[None, :]
    scale = D ** -0.5
    ref = paged_attention_pallas(qj, jc.kv_pages, jnp.asarray(tables),
                                 jnp.asarray(ctx), scale,
                                 q_positions=jnp.asarray(pos), layer=jnp.int32(1))
    out = paged_attention(qt, tc, 1, torch.tensor(tables), torch.tensor(ctx), scale,
                          q_positions=torch.tensor(pos))
    np.testing.assert_allclose(np32(out), np32(ref), atol=3e-2, rtol=3e-2)
    jref = j_attn_ref(qj, jc, 1, jnp.asarray(tables), jnp.asarray(ctx), scale)
    np.testing.assert_allclose(np32(paged_attention_ref(qt, tc, 1, torch.tensor(tables),
                                                        torch.tensor(ctx), scale)),
                               np32(jref), atol=3e-2, rtol=3e-2)


def test_paged_attention_pads_small_head_dim(rng):
    jc, tc = _cache_pair(rng, L=1)
    qj, qt = bf16_pair(rng.standard_normal((2, 3, 4, 64)).astype(np.float32))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    ctx = np.array([20, 9], np.int32)
    from qspec_tpu.ops.attention import paged_attention as j_dispatch
    ref = j_dispatch(qj, jc, 0, jnp.asarray(tables), jnp.asarray(ctx), 0.125)
    out = paged_attention(qt, tc, 0, torch.tensor(tables), torch.tensor(ctx), 0.125)
    assert tuple(out.shape) == (2, 3, 4, 64)
    np.testing.assert_allclose(np32(out), np32(ref), atol=3e-2, rtol=3e-2)


def test_paged_attention_options_not_ported(rng):
    _, tc = _cache_pair(rng, L=1)
    q = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        paged_attention(q, tc, 0, torch.tensor([[1]]), torch.tensor([1]), 0.1, window=8)


# ---------------------------------------------------------------- rope

def test_rope_matches_jax(rng):
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
    for rs in (None, scaling):
        jcache = jrot.make_rope_cache(64, 256, 10000.0, rope_scaling=rs)
        tcache = trot.make_rope_cache(64, 256, 10000.0, rope_scaling=rs)
        np.testing.assert_array_equal(tcache.numpy(), np.asarray(jcache))
    qj, qt = bf16_pair(rng.standard_normal((6, 4, 64)).astype(np.float32))
    kj, kt = bf16_pair(rng.standard_normal((6, 2, 64)).astype(np.float32))
    pos = np.array([0, 1, 5, 77, 200, 3], np.int32)
    a = trot.apply_rope(qt, kt, torch.tensor(pos), tcache)
    b = jrot.apply_rope(qj, kj, jnp.asarray(pos), jcache)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np32(x), np32(y), atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------- sampling

def _st_pair(temp, top_k, top_p, min_p):
    j = jsmp.SamplingTensors(jnp.asarray(temp, jnp.float32), jnp.asarray(top_k, jnp.int32),
                             jnp.asarray(top_p, jnp.float32), jnp.asarray(min_p, jnp.float32))
    t = tsmp.SamplingTensors(torch.tensor(temp, dtype=torch.float32),
                             torch.tensor(top_k, dtype=torch.int32),
                             torch.tensor(top_p, dtype=torch.float32),
                             torch.tensor(min_p, dtype=torch.float32))
    return j, t


def test_sampling_probs_match_jax(rng):
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 2
    js, ts = _st_pair([0.0, 0.7, 1.0, 1.3], [0, 5, 0, 0], [1.0, 1.0, 0.8, 1.0],
                      [0.0, 0.0, 0.0, 0.1])
    a = tsmp.sampling_probs(torch.tensor(logits), ts).numpy()
    b = np.asarray(jsmp.sampling_probs(jnp.asarray(logits), js))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert a[0].max() == 1.0 and a[0].argmax() == logits[0].argmax()


def test_rejection_sample_greedy_matches_jax(rng):
    """Greedy rows: one-hot p and q make the rule deterministic, so the two
    packages emit the same tokens whatever their random numbers."""
    B, k, V = 4, 3, 32
    tgt = rng.integers(0, V, size=(B, k + 1))
    drafts = tgt[:, :k].copy()
    drafts[1, 1] = (drafts[1, 1] + 1) % V        # rejected at slot 1
    drafts[2, 0] = (drafts[2, 0] + 3) % V        # rejected at slot 0
    drafts[3] = -1                               # no proposals (the oracle)
    p = np.eye(V, dtype=np.float32)[tgt]
    q = np.eye(V, dtype=np.float32)[np.maximum(drafts, 0)] * (drafts >= 0)[..., None]
    res_t = tsmp.rejection_sample(torch.tensor(drafts, dtype=torch.int32), torch.tensor(q),
                                  torch.tensor(p), torch.Generator().manual_seed(0))
    res_j = jsmp.rejection_sample(jnp.asarray(drafts, jnp.int32), jnp.asarray(q),
                                  jnp.asarray(p), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res_t.tokens.numpy(), np.asarray(res_j.tokens))
    np.testing.assert_array_equal(res_t.accepted_len.numpy(), np.asarray(res_j.accepted_len))
    assert res_t.accepted_len.tolist() == [4, 2, 1, 1]


def test_rejection_sample_injected_uniforms():
    """Accept d_i iff u_i < p(d_i) / q(d_i); the uniforms are injected."""
    p = torch.tensor([[[0.5, 0.5], [0.2, 0.8], [0.5, 0.5]]])
    q = torch.tensor([[[1.0, 0.0], [1.0, 0.0]]])
    d = torch.tensor([[0, 0]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    acc = tsmp.rejection_sample(d, q, p, gen, uniforms=torch.tensor([[0.4, 0.1]]))
    assert acc.accepted_len.item() == 3 and acc.tokens[0, :2].tolist() == [0, 0]
    rej = tsmp.rejection_sample(d, q, p, gen, uniforms=torch.tensor([[0.4, 0.3]]))
    # rejected at slot 1: recovery from max(p - q, 0) = [0, 0.8] -> token 1
    assert rej.accepted_len.item() == 2 and rej.tokens[0].tolist() == [0, 1, -1]
