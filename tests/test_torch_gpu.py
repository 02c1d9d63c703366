"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions (marker ``gpu``). Each test decides inside a fixture whether a card
is present and skips here, on a machine without one. On the H100:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -o addopts=""

(``--noconftest``: tests/conftest.py imports jax, which the port's machine
need not have; these tests use no fixture of it.)

Tolerances are those of tests/test_torch_ops.py (the JAX kernel tests'):
w8a16 and the grouped w4a16_g rtol/atol 2e-2; attention over an 8-bit cache
4e-2 (8e-2 for fp8_e5m2, which keeps 2 mantissa bits).
"""

import numpy as np
import pytest
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.model_loader import grouped as tg
from qspec_tpu_torch.ops import kernel_wrappers
from qspec_tpu_torch.ops import linear_kernels as lk
from qspec_tpu_torch.ops import rmsnorm_quant as rq
from qspec_tpu_torch.ops.attention import paged_attention_ref, tree_mask
from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
from qspec_tpu_torch.ops import kv_cache as kvc
from qspec_tpu_torch.ops.kv_cache import PagedKVCache
from qspec_tpu_torch.ops.packing import (quantize_weight_int4_torch,
                                         quantize_weight_int8_torch)
from qspec_tpu_torch.ops.quant import (QuantizedActivation, sym_dequant, sym_quant_int4,
                                       sym_quant_int8)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_gpu.py -m gpu on the H100)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("m,k,n", [(1, 256, 96), (16, 4096, 6144), (33, 448, 512),
                                   (200, 14336, 4096)])
def test_w4a16_and_w4a4_kernels(gen, m, k, n):
    qw, qs = quantize_weight_int4_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    torch.testing.assert_close(lk.matmul_w4a16(x, qw, qs).float(),
                               lk.matmul_w4a16_ref(x, qw, qs).float(), rtol=2e-2, atol=2e-2)
    for xq in (sym_quant_int4(x), sym_quant_int8(x)):
        torch.testing.assert_close(lk.matmul_w4a4(xq.values, xq.scales, qw, qs).float(),
                                   lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs).float(),
                                   rtol=1e-2, atol=1e-2)


def test_w4a16_rows_independent_of_batch(gen):
    """A row's result does not depend on M or on its place in the batch."""
    qw, qs = quantize_weight_int4_torch(torch.randn(4096, 4096, generator=gen, device="cuda") * 0.02)
    x = torch.randn(16, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    full = lk.matmul_w4a16(x, qw, qs)
    assert torch.equal(lk.matmul_w4a16(x[5:9].contiguous(), qw, qs), full[5:9])
    assert torch.equal(lk.matmul_w4a16(x.flip(0).contiguous(), qw, qs), full.flip(0))


def _w4_stacked(gen, k, n, layers=2):
    """Layer-stacked QuaRot weights [L, K/8, N], scales [L, N], made on the card."""
    ws = [quantize_weight_int4_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
          for _ in range(layers)]
    return torch.stack([w for w, _ in ws]), torch.stack([s for _, s in ws])


@pytest.mark.parametrize("k,n", [(256, 200), (256, 130), (4096, 200), (4096, 130),
                                 (14336, 200), (14336, 130), (4096, 4096)])
def test_w4a4_kernel_bits(gen, k, n):
    """csrc/w4.cu's int8 instantiations equal the plain version bit for bit
    (exact int32 sums, the plain epilogue's two f32 products) at M from 1
    to the draft prefill's 1024 (split mode up to 64 rows, whole mode past
    them), N not a multiple of 128 (and, at 130, of 4), int4 and int8
    activations, read in place from a layer stack (where N % 4 == 0: a
    stacked row of 130 scales is not 16-byte aligned, which the wrappers
    refuse); one launch a call."""
    qw, qs = _w4_stacked(gen, k, n)
    w = (qw, qs, 1) if n % 4 == 0 else (qw[1].clone(), qs[1].clone(), None)
    x = torch.randn(1024, k, generator=gen, device="cuda").to(torch.bfloat16) * 3
    for m in (1, 4, 8, 16, 17, 60, 64, 65, 200, 1024):
        for xq in (sym_quant_int4(x[:m]), sym_quant_int8(x[:m])):
            before = lk.matmul_w4a4.launches
            out = lk.matmul_w4a4(xq.values, xq.scales, w[0], w[1], layer_idx=w[2])
            assert lk.matmul_w4a4.launches == before + 1
            assert out.dtype == torch.bfloat16 and tuple(out.shape) == (m, n)
            ref = lk.matmul_w4a4_ref(xq.values, xq.scales, qw[1], qs[1])
            assert torch.equal(out, ref), (m, k, n)


# (K, N): Llama-3-8B's o (many segments a stripe), gate_up (one or two) and
# down (K = 14336, prefill branch past M = 182), and a 2-stripe shape
W4A16_BITS_SHAPES = [(4096, 4096), (4096, 28672), (14336, 4096), (448, 200)]


@pytest.mark.parametrize("k,n", W4A16_BITS_SHAPES)
def test_w4a16_kernel_row_bits(gen, k, n):
    """A w4a16 row's bits do not depend on M (1 to the largest M the kernel
    takes before the prefill branch: split mode to 64 rows, whole mode past
    them), on its place in the batch or the batch's order, and equal a
    second call's and a CUDA-graph replay's; the result agrees with the
    plain version (rtol = atol = 2e-2, bf16 and f32 out)."""
    qw, qs = _w4_stacked(gen, k, n)
    mbig = max(m for m in range(1, 1025) if not lk._bigm(m, k))
    x = torch.randn(mbig, k, generator=gen, device="cuda").to(torch.bfloat16)
    full = lk.matmul_w4a16(x, qw, qs, layer_idx=1, out_dtype=torch.float32)
    torch.testing.assert_close(full, lk.matmul_w4a16_ref(x, qw[1], qs[1], out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(lk.matmul_w4a16(x, qw, qs, layer_idx=1, out_dtype=torch.float32), full)
    for m in (1, 4, 8, 15, 16, 17, 33, 48, 60, 64, 65, 128, 200, 640):
        if m <= mbig:
            out = lk.matmul_w4a16(x[:m], qw, qs, layer_idx=1, out_dtype=torch.float32)
            assert torch.equal(out, full[:m]), m
    for rows in (slice(5, 9), slice(mbig // 2, mbig // 2 + 60), slice(3, mbig)):
        assert torch.equal(lk.matmul_w4a16(x[rows].contiguous(), qw, qs, layer_idx=1,
                                           out_dtype=torch.float32), full[rows])
    assert torch.equal(lk.matmul_w4a16(x.flip(0).contiguous(), qw, qs, layer_idx=1,
                                       out_dtype=torch.float32), full.flip(0))
    bf = lk.matmul_w4a16(x[:16], qw, qs, layer_idx=1)
    assert torch.equal(bf, full[:16].to(torch.bfloat16))
    for m in (4, 16, 60, min(mbig, 100)):
        want = full[:m].to(torch.bfloat16)
        assert _replayed(lambda m=m: lk.matmul_w4a16(x[:m], qw, qs, layer_idx=1), want), m


def test_w4a16_int4_head(gen):
    """The int4 head: matmul_w4a16 with an f32 out at K=4096, N=128256 (the
    Llama-3 vocabulary), M = 4 and 16, against its plain version; a w4a4
    call's graph replay on the same weights gives its eager bits."""
    k, n = 4096, 128256
    qw, qs = quantize_weight_int4_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    for m in (4, 16):
        before = lk.matmul_w4a16.launches
        out = lk.matmul_w4a16(x[:m], qw, qs, out_dtype=torch.float32)
        assert lk.matmul_w4a16.launches == before + 1
        torch.testing.assert_close(out, lk.matmul_w4a16_ref(x[:m], qw, qs, out_dtype=torch.float32),
                                   rtol=2e-2, atol=2e-2)
    xq = sym_quant_int8(x)
    want = lk.matmul_w4a4_ref(xq.values, xq.scales, qw, qs)
    assert torch.equal(lk.matmul_w4a4(xq.values, xq.scales, qw, qs), want)
    assert _replayed(lambda: lk.matmul_w4a4(xq.values, xq.scales, qw, qs), want)


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (7, 512, 384), (16, 1024, 256),
                                   (16, 4096, 128256), (33, 448, 200)])
def test_w8a16_kernel(gen, m, k, n):
    qw, qs = quantize_weight_int8_torch(torch.randn(k, n, generator=gen, device="cuda") * 0.05)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    before = lk.matmul_w8a16.launches
    for dt in (torch.float32, torch.bfloat16):
        out = lk.matmul_w8a16(x, qw, qs, out_dtype=dt)
        assert out.dtype == dt and tuple(out.shape) == (m, n)
        torch.testing.assert_close(out.float(), lk.matmul_w8a16_ref(x, qw, qs, out_dtype=dt).float(),
                                   rtol=2e-2, atol=2e-2)
    assert lk.matmul_w8a16.launches == before + 2


def test_w8a16_stacked_and_rows_independent(gen):
    """The stacked form reads layer ``layer_idx`` in place; a row's result
    does not depend on M or on its place in the batch."""
    L, k, n = 2, 4096, 14336
    w = torch.randn(L, k, n, generator=gen, device="cuda") * 0.05
    qw = torch.empty(L, k, n, dtype=torch.int8, device="cuda")
    qs = torch.empty(L, n, device="cuda")
    for li in range(L):
        qw[li], qs[li] = quantize_weight_int8_torch(w[li])
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    for li in range(L):
        out = lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32, layer_idx=li)
        torch.testing.assert_close(out, lk.matmul_w8a16_ref(x, qw[li], qs[li],
                                                            out_dtype=torch.float32),
                                   rtol=2e-2, atol=2e-2)
    full = lk.matmul_w8a16(x, qw[1], qs[1], out_dtype=torch.float32)
    assert torch.equal(lk.matmul_w8a16(x[5:9].contiguous(), qw[1], qs[1],
                                       out_dtype=torch.float32), full[5:9])
    assert torch.equal(lk.matmul_w8a16(x.flip(0).contiguous(), qw[1], qs[1],
                                       out_dtype=torch.float32), full.flip(0))


@pytest.mark.parametrize("m", [1, 16, 512])
def test_norm_kernels(gen, m):
    x = (torch.randn(m, 4096, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    g = torch.randn(4096, generator=gen, device="cuda").to(torch.bfloat16)
    torch.testing.assert_close(rq.rmsnorm(x, g).float(), rq.rmsnorm_ref(x, g).float(),
                               rtol=2e-2, atol=2e-2)
    for bits in (4, 8):
        a, b = rq.rmsnorm_quant(x, bits=bits), rq.rmsnorm_quant_ref(x, bits=bits)
        torch.testing.assert_close(a.scales, b.scales, rtol=1e-3, atol=0)
        d = (a.values.int() - b.values.int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() > 0.99


@pytest.mark.parametrize("q_len,S", [(1, 128), (2, 128), (4, 16), (128, 128)])
def test_paged_attention_kernel(gen, q_len, S):
    B, Hq, Hkv, D = 3, 32, 8, 128
    ctx = [max(c, q_len) for c in (S + 3, 3 * S, 5)]
    pages = [-(-c // S) for c in ctx]
    kv = torch.randn(2, 1 + sum(pages), 2, Hkv, S, D, generator=gen, device="cuda")
    cache = PagedKVCache(kv.to(torch.bfloat16))
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    start = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(start, start + n)
        start += n
    q = torch.randn(B, q_len, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    out = paged_attention_cuda(q, cache.kv_pages, tables.cuda(), ctx_t, D ** -0.5, layer=1)
    ref = paged_attention_ref(q, cache, 1, tables.cuda(), ctx_t, D ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
    # a padding row (ctx_len 0) reads nothing and writes zeros
    ctx_t[2] = 0
    out = paged_attention_cuda(q, cache.kv_pages, tables.cuda(), ctx_t, D ** -0.5, layer=1)
    assert torch.count_nonzero(out[2]) == 0


@pytest.mark.parametrize("q_len", [1, 4, 128])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_attention_kernel_8bit(gen, kv_dtype, q_len):
    """The 8-bit instantiations, on a cache filled through update_layer,
    against the plain version over the dequantized gather."""
    B, Hq, Hkv, D, S = 3, 32, 8, 128, 128
    ctx = [max(c, q_len) for c in (S + 3, 3 * S, 5)]
    pages = [-(-c // S) for c in ctx]
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, 1 + sum(pages), S, kv_dtype), "cuda")
    T = sum(pages) * S
    k_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    kvc.update_layer(cache, 1, k_new, v_new, torch.arange(T, device="cuda") + S)
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    start = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(start, start + n)
        start += n
    q = torch.randn(B, q_len, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    counters = kernel_wrappers()
    before = {n: c.launches for n, c in counters.items()}
    out = paged_attention_cuda(q, cache.kv_pages, tables.cuda(), ctx_t, D ** -0.5, layer=1,
                               kv_scales=cache.kv_scales)
    # only this entry type's instantiation counts the launch
    assert {n: c.launches - before[n] for n, c in counters.items() if c.launches != before[n]} \
        == {f"paged_attention_{kv_dtype}": 1}
    ref = paged_attention_ref(q, cache, 1, tables.cuda(), ctx_t, D ** -0.5)
    tol = 8e-2 if kv_dtype == "fp8_e5m2" else 4e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# the kernels each head's path launches over a bf16 cache; no other launches
TRUNK_KERNELS = ("matmul_w4a16", "matmul_w4a4", "rmsnorm", "rmsnorm_quant",
                 "paged_attention")


@pytest.mark.parametrize("lm_head_quant,expect", [
    ("bf16", TRUNK_KERNELS),
    (None, TRUNK_KERNELS + ("matmul_w8a16",)),
], ids=["bf16_head", "default_int8_head"])
def test_greedy_spec_equals_oracle_on_card(gen, lm_head_quant, expect):
    """The tiny model through the engine, with the dense bf16 head (rows
    padded so cuBLAS sees one shape) and at the defaults (int8 head): the
    kernels of that path launch, no other does, and greedy QSpec equals its
    oracle."""
    from qspec_tpu_torch import LLM, SamplingParams
    kw = dict(model="tiny", device="cuda", num_speculative_tokens=3,
              block_size=16, max_model_len=256, max_num_seqs=4, prefill_chunk_size=64)
    if lm_head_quant is not None:
        kw["lm_head_quant"] = lm_head_quant
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    llm = LLM(**kw)
    spec = [o.output_token_ids for o in llm.generate(prompts, sp)]
    assert {n for n, c in counters.items() if c.launches > 0} == set(expect)
    oracle = LLM(params=llm.llm_engine.runner.params, speculative_method="qspec_null", **kw)
    assert spec == [o.output_token_ids for o in oracle.generate(prompts, sp)]
    assert ModelConfig.tiny().vocab_size > max(max(t) for t in spec)


def _grouped(gen, k, n, g, layers=None):
    """AWQ weights made on the card (the torch writer), repacked by the
    loader's unpack / pack: the w4g layout, optionally layer-stacked."""
    def one():
        t = tg.make_awq_tensors(torch.randn(k, n, generator=gen, device="cuda") * 0.02, g)
        return tg.pack_grouped_proj(*tg.unpack_awq(t["qweight"], t["qzeros"], t["scales"]))
    if layers is None:
        p = one()
        return p["qw"], p["qs_g"], p["qo_g"]
    ps = [one() for _ in range(layers)]
    return tuple(torch.stack([p[key] for p in ps]) for key in ("qw", "qs_g", "qo_g"))


def _grouped_direct(gen, k, n, g):
    """Grouped weights of any width N (the AWQ writer packs 8 columns a
    word): q, zp, s of the writer's quantizer, packed by the loader."""
    q, zp, s = tg._group_quantize(torch.randn(k, n, generator=gen, device="cuda") * 0.02, g, 0)
    p = tg.pack_grouped_proj(q, zp, s)
    return p["qw"], p["qs_g"], p["qo_g"]


@pytest.mark.parametrize("m,k,n,g", [(1, 256, 128, 128), (8, 512, 384, 64),
                                     (33, 512, 1536, 128), (16, 14336, 4096, 128),
                                     (4, 4096, 6144, 32), (17, 4096, 4096, 128),
                                     (60, 3584, 8192, 128), (64, 4096, 3584, 64),
                                     (200, 3584, 8192, 128), (176, 14336, 3584, 128),
                                     (60, 1024, 200, 32), (5, 512, 130, 64)])
def test_w4a16_g_kernel(gen, m, k, n, g):
    """The grouped GEMM at the JAX kernel test's shapes and Llama-3-8B and
    Gemma-2-9B ones, M up to 200 (past the 64 rows of one block; 176 is the
    largest the kernel takes at K = 14336), g 32, 64 and 128, N not a
    multiple of the block's 128 columns (and, at 130, of 4), bf16 and f32
    out, against its plain version."""
    qw, qs, qo = _grouped(gen, k, n, g) if n % 8 == 0 else _grouped_direct(gen, k, n, g)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    before = lk.matmul_w4a16_g.launches
    for dt in (torch.float32, torch.bfloat16):
        out = lk.matmul_w4a16_g(x, qw, qs, qo, out_dtype=dt)
        assert out.dtype == dt and tuple(out.shape) == (m, n)
        torch.testing.assert_close(out.float(),
                                   lk.matmul_w4a16_g_ref(x, qw, qs, qo, out_dtype=dt).float(),
                                   rtol=2e-2, atol=2e-2)
    assert lk.matmul_w4a16_g.launches == before + 2


def test_w4a16_g_stacked_rows_independent_and_bigm(gen):
    """The stacked form reads layer ``layer_idx`` in place; a row's bits do
    not depend on M (1 to 64 and a prefill-size 640, the largest M the
    kernel takes at K = 4096) or on its place in the batch; the prefill
    branch (dequantize once, torch.mm) agrees with the plain version and
    launches no kernel."""
    L, k, n, g = 3, 4096, 4096, 128
    qw, qs, qo = _grouped(gen, k, n, g, layers=L)
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    for li in range(L):
        torch.testing.assert_close(lk.matmul_w4a16_g(x, qw, qs, qo, layer_idx=li).float(),
                                   lk.matmul_w4a16_g_ref(x, qw[li], qs[li], qo[li]).float(),
                                   rtol=2e-2, atol=2e-2)
    full = lk.matmul_w4a16_g(x, qw, qs, qo, layer_idx=1)
    for rows in (slice(5, 9), slice(0, 1), slice(3, 11)):
        assert torch.equal(lk.matmul_w4a16_g(x[rows].contiguous(), qw, qs, qo, layer_idx=1),
                           full[rows])
    assert torch.equal(lk.matmul_w4a16_g(x.flip(0).contiguous(), qw, qs, qo, layer_idx=1),
                       full.flip(0))
    assert not lk._bigm(640, k) and lk._bigm(641, k)
    xl = torch.randn(640, k, generator=gen, device="cuda").to(torch.bfloat16)
    full = lk.matmul_w4a16_g(xl, qw, qs, qo, layer_idx=1, out_dtype=torch.float32)
    for m in (1, 4, 15, 16, 17, 33, 48, 60, 64, 65, 200):
        assert torch.equal(lk.matmul_w4a16_g(xl[:m], qw, qs, qo, layer_idx=1,
                                             out_dtype=torch.float32), full[:m]), m
    assert torch.equal(lk.matmul_w4a16_g(xl[100:160].contiguous(), qw, qs, qo, layer_idx=1,
                                         out_dtype=torch.float32), full[100:160])
    assert torch.equal(lk.matmul_w4a16_g(xl.flip(0).contiguous(), qw, qs, qo, layer_idx=1,
                                         out_dtype=torch.float32), full.flip(0))
    big = torch.randn(1024, k, generator=gen, device="cuda").to(torch.bfloat16)
    before = lk.matmul_w4a16_g.launches
    out = lk.matmul_w4a16_g(big, qw, qs, qo, layer_idx=2)
    assert lk.matmul_w4a16_g.launches == before
    torch.testing.assert_close(out.float(), lk.matmul_w4a16_g_ref(big, qw[2], qs[2], qo[2]).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 28672), (14336, 3584)])
def test_w4a16_g_graph_replay_bits(gen, k, n):
    """A call captured in a CUDA graph replays to the bits of an eager call,
    twice (the split counters reset themselves), at projections with a K
    split (o, Gemma-2's down) and without (gate_up)."""
    qw, qs, qo = _grouped(gen, k, n, 128)
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    eager = lk.matmul_w4a16_g(x, qw, qs, qo)
    assert torch.equal(lk.matmul_w4a16_g(x, qw, qs, qo), eager)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        lk.matmul_w4a16_g(x, qw, qs, qo)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lk.matmul_w4a16_g(x, qw, qs, qo)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def _window_case(gen, q_len, kv_dtype, ctx, S=16, B=3, Hq=32, Hkv=8, D=128):
    """A cache of ``kv_dtype`` filled through update_layer, one row per
    context length, pages in a shuffled order."""
    pages = [-(-c // S) for c in ctx]
    P = 1 + sum(pages)
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cuda")
    T = (P - 1) * S
    k_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    kvc.update_layer(cache, 1, k_new, v_new, torch.arange(T, device="cuda") + S)
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    o = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    q = torch.randn(B, q_len, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, cache, tables.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("q_len,window", [(1, 8), (4, 8), (4, 21), (1, 40), (2, 64),
                                          (16, 33)])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_attention_kernel_window(gen, kv_dtype, q_len, window):
    """The sliding window (test_attention.py's windows, page 16) against the
    plain version; contexts long enough that leading pages are skipped; the
    windowed launches are counted apart."""
    S = 16
    q, cache, tables, ctx = _window_case(gen, q_len, kv_dtype,
                                         [q_len + 3, 4 * S + q_len, 8 * S - 2])
    counter = kernel_wrappers()["paged_attention" if kv_dtype == "bfloat16"
                                else "paged_attention_int8"]
    before = (counter.launches, counter.window_launches)
    out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, 128 ** -0.5, layer=1,
                               kv_scales=cache.kv_scales, window=window)
    assert (counter.launches, counter.window_launches) == (before[0] + 1, before[1] + 1)
    ref = paged_attention_ref(q, cache, 1, tables, ctx, 128 ** -0.5, window=window)
    tol = 3e-2 if kv_dtype == "bfloat16" else 4e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_paged_attention_window_skips_stale_pages(gen):
    """The pages before a row's first in-window page are never read (a ring
    holds newer tokens there): poisoning them with NaN changes no bit, and a
    ring table over the same logical pages gives the full pool's bits."""
    S, window, q_len = 16, 24, 2
    ctx = [200, 130, 47]
    q, cache, tables, ctx_t = _window_case(gen, q_len, "bfloat16", ctx, S=S)
    out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, 128 ** -0.5, layer=1,
                               window=window)
    poisoned = cache.kv_pages.clone()
    for b, c in enumerate(ctx):
        first = max(c - q_len - window + 1, 0) // S
        for lp in range(first):
            poisoned[1, tables[b, lp]] = float("nan")
    out2 = paged_attention_cuda(q, poisoned, tables, ctx_t, 128 ** -0.5, layer=1,
                                window=window)
    assert torch.equal(out, out2)
    # the same logical pages through a 4-page ring per row: copy each live
    # page to 1 + row * 4 + lp % 4, oldest first, so newer pages overwrite
    R = 4
    ring = torch.full_like(cache.kv_pages, float("nan"))
    rtab = torch.zeros_like(tables)
    for b, c in enumerate(ctx):
        for lp in range(-(-c // S)):
            ring[1, 1 + b * R + lp % R] = cache.kv_pages[1, tables[b, lp]]
        rtab[b] = 1 + b * R + torch.arange(tables.shape[1], device="cuda") % R
    out3 = paged_attention_cuda(q, ring, rtab, ctx_t, 128 ** -0.5, layer=1, window=window)
    assert torch.equal(out, out3)


@pytest.mark.parametrize("window", [None, 24])
def test_w4g_greedy_spec_equals_oracle_on_card(gen, window):
    """A tiny AWQ model (g = 128) through the engine with the W4A16 draft,
    windowed on its ring pool and not: greedy QSpec equals its oracle, and
    exactly the w4g path's kernels launch (the grouped GEMM, the gamma
    norm, the bf16-cache attention, the int8 head)."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SamplingParams,
                                 SchedulerConfig, SpeculativeConfig)
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.tiny(quant="w4g", intermediate_size=512)
    params = init_params(cfg, seed=0, device="cuda", group_size=128)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]

    def run(method):
        spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a16",
                                 draft_kv_window=window, method=method)
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=64),
            speculative=spec), params, device="cuda")
        for p in prompts:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=24))
        outs = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.output_token_ids
        return [outs[i] for i in range(len(prompts))], eng

    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    counters["paged_attention"].window_launches = 0
    spec, eng = run("qspec")
    assert {n for n, c in counters.items() if c.launches > 0} == {
        "matmul_w4a16_g", "rmsnorm", "paged_attention", "matmul_w8a16"}
    assert (counters["paged_attention"].window_launches > 0) == (window is not None)
    assert eng.runner._ring_pages == (0 if window is None else 4)
    assert eng.spec_metrics.num_draft_accepted > 0
    oracle, _ = run("qspec_null")
    assert spec == oracle


@pytest.mark.parametrize("q_len", [1, 4, 128])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_attention_kernel_d256_softcap(gen, kv_dtype, q_len):
    """The head-dim-256 instantiations with Gemma-2's logit softcap (50, and
    5, which bites at these scores), with and without a window, on every
    entry type, against the plain version; the launches are counted as D=256
    and softcapped; a row's bits do not depend on Q."""
    B, Hq, Hkv, D, S = 3, 16, 8, 256, 128
    ctx = [max(c, q_len) for c in (S + 3, 3 * S, 5)]
    pages = [-(-c // S) for c in ctx]
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, 1 + sum(pages), S, kv_dtype), "cuda")
    T = sum(pages) * S
    k_new = (2 * torch.randn(T, Hkv, D, generator=gen, device="cuda")).to(torch.bfloat16)
    v_new = torch.randn(T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    kvc.update_layer(cache, 1, k_new, v_new, torch.arange(T, device="cuda") + S)
    tables = torch.zeros(B, max(pages), dtype=torch.int32)
    start = 1
    for b, n in enumerate(pages):
        tables[b, :n] = torch.arange(start, start + n)
        start += n
    tables = tables.cuda()
    q = (2 * torch.randn(B, q_len, Hq, D, generator=gen, device="cuda")).to(torch.bfloat16)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    counter = kernel_wrappers()["paged_attention" if kv_dtype == "bfloat16"
                                else f"paged_attention_{kv_dtype}"]
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    scale = 256 ** -0.5
    for cap in (50.0, 5.0):
        for window in (None, 128):
            before = (counter.launches, counter.softcap_launches, counter.d256_launches)
            out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                       kv_scales=cache.kv_scales, window=window, softcap=cap)
            assert (counter.launches, counter.softcap_launches, counter.d256_launches) == \
                tuple(n + 1 for n in before)
            ref = paged_attention_ref(q, cache, 1, tables, ctx_t, scale, window=window,
                                      softcap=cap)
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if q_len > 1:
        # the row at the last position, alone (Q=1) and in its Q-block
        one = paged_attention_cuda(q[:, -1:].contiguous(), cache.kv_pages, tables, ctx_t,
                                   scale, layer=1, kv_scales=cache.kv_scales, softcap=50.0)
        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                   kv_scales=cache.kv_scales, softcap=50.0)
        assert torch.equal(one[:, 0], out[:, -1])


def test_paged_attention_kernel_refuses_other_head_dims(gen):
    cache = kvc.allocate(kvc.KVCacheConfig(1, 2, 192, 2, 16), "cuda")
    q = torch.zeros(1, 1, 4, 192, dtype=torch.bfloat16, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim 128 or 256"):
        paged_attention_cuda(q, cache.kv_pages, one[None], one, 0.1)


def _tiny_gemma2(head_dim):
    """A tiny Gemma-2 (every knob of the 9B: softcaps, post norms, the
    alternating window, tied int8 head) as an AWQ checkpoint, g = 128."""
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.from_hf_config(dict(
        model_type="gemma2", vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        head_dim=head_dim, query_pre_attn_scalar=24, sliding_window=16,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0, rms_norm_eps=1e-6,
        tie_word_embeddings=True, max_position_embeddings=256))
    cfg = ModelConfig(**{**cfg.__dict__, "quant": "w4g"})
    return cfg, init_params(cfg, seed=3, device="cpu", group_size=128)


@pytest.mark.parametrize("head_dim", [64, 256])
def test_tiny_gemma2_on_card_matches_cpu(gen, head_dim):
    """The tiny AWQ Gemma-2 on the card (kernels; head dim 64 pads to the
    128 instantiation, 256 takes its own) against the same weights on the
    CPU (plain versions): logits within a relative L2 of 2e-2, bounded by
    the final softcap; then through the engine on the card, greedy QSpec
    with the windowed W4A16 draft equals its oracle, with the D=256 and
    softcapped attention launched when head_dim is 256."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SamplingParams,
                                 SchedulerConfig, SpeculativeConfig)
    from qspec_tpu_torch.models.llama import AttentionBatch, model_forward
    cfg, cpu = _tiny_gemma2(head_dim)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    gpu = to(cpu, "cuda")
    B, Q, S = 2, 40, 16
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, size=(B, Q))
    outs = []
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, 8, S), dev)
        pos = torch.arange(Q, device=dev).repeat(B, 1)
        tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32, device=dev)
        slot = tables.to(torch.int64).gather(1, pos // S) * S + pos % S
        batch = AttentionBatch(pos, slot, tables,
                               torch.full((B,), Q, dtype=torch.int32, device=dev))
        logits, _ = model_forward(params, cfg, torch.tensor(toks, device=dev), cache, batch)
        outs.append(logits.float().cpu())
    ref, out = outs
    assert torch.isfinite(out).all() and out.abs().max() <= 30.0
    assert ((out - ref).norm() / ref.norm()).item() <= 2e-2

    prompts = [np.random.default_rng(7).integers(1, 500, size=int(n)).tolist()
               for n in (5, 17, 33, 9)]

    def run(method):
        spec = SpeculativeConfig(num_speculative_tokens=3, draft_scheme="w4a16",
                                 draft_kv_window=24, method=method)
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=64),
            speculative=spec), gpu, device="cuda")
        for p in prompts:
            eng.add_request(p, SamplingParams(temperature=0.0, max_tokens=24))
        res = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    res[o.request_id] = o.output_token_ids
        return [res[i] for i in range(len(prompts))]

    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    attn = counters["paged_attention"]
    attn.softcap_launches = attn.d256_launches = 0
    spec = run("qspec")
    assert {n for n, c in counters.items() if c.launches > 0} == {
        "matmul_w4a16_g", "rmsnorm", "paged_attention", "matmul_w8a16"}
    assert attn.softcap_launches == attn.launches
    assert attn.d256_launches == (attn.launches if head_dim == 256 else 0)
    assert spec == run("qspec_null")


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_attention_kernel_tree(gen, kv_dtype, D):
    """The Medusa tree mask (DEFAULT_TREE after prefix 3 and 5, roots 17 and
    30, page 16) on every entry type at head dims 128 and 256, with and
    without the softcap and a window shorter than the contexts, against the
    plain version; each launch counted as a tree launch."""
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    tspec = build_tree(DEFAULT_TREE)
    T, B, Hq, Hkv, S, P = tspec.num_nodes, 2, 4, 2, 16, 24
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, D, P, S, kv_dtype), "cuda")
    n = (P - 1) * S
    kvc.update_layer(cache, 1, torch.randn(n, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.randn(n, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.arange(n, device="cuda") + S)
    tables = (torch.randperm(20, generator=torch.Generator().manual_seed(D)) + 1
              ).reshape(2, 10).to(torch.int32).cuda()
    root = torch.tensor([17, 30], device="cuda")
    ctx = (root + 1 + T).to(torch.int32)
    counter = kernel_wrappers()["paged_attention" if kv_dtype == "bfloat16"
                                else f"paged_attention_{kv_dtype}"]
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    for prefix in (3, 5):
        positions = torch.cat([root[:, None] - (prefix - 1) + torch.arange(prefix, device="cuda"),
                               root[:, None] + torch.tensor(tspec.depth, device="cuda")[None]], 1)
        q = (3 * torch.randn(B, prefix + T, Hq, D, generator=gen, device="cuda")).to(torch.bfloat16)
        tree = tree_mask(prefix, tspec.ancestors, "cuda")
        for cap in (None, 50.0):
            for window in (None, 12):
                kw = dict(q_positions=positions, window=window, softcap=cap, tree=tree)
                before = counter.tree_launches
                out = paged_attention_cuda(q, cache.kv_pages, tables, ctx, D ** -0.5, layer=1,
                                           kv_scales=cache.kv_scales, **kw)
                assert counter.tree_launches == before + 1
                ref = paged_attention_ref(q, cache, 1, tables, ctx, D ** -0.5, **kw)
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("tree", [False, True], ids=["chain", "tree"])
def test_medusa_greedy_equals_oracle_on_card(gen, tree):
    """The tiny model with 4 lm_head-seeded Medusa heads through LLM on the
    card: greedy Medusa (chain or DEFAULT_TREE) equals its medusa_null
    oracle; only the verify path's kernels launch (no w4a4, no
    rmsnorm_quant), the tree mask on every layer of every tree round."""
    from qspec_tpu_torch import LLM, SamplingParams
    from qspec_tpu_torch.models.llama import init_params
    from qspec_tpu_torch.spec_decode.medusa import init_medusa_params, lm_head_weight
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0, device="cuda")
    params["medusa"] = init_medusa_params(cfg.hidden_size, cfg.vocab_size, 4,
                                          lm_head=lm_head_weight(params["lm_head"]))
    kw = dict(model="tiny", device="cuda", num_speculative_tokens=4, block_size=16,
              max_model_len=256, max_num_seqs=4, prefill_chunk_size=64,
              speculative_model="[medusa]", spec_medusa_tree="default" if tree else None)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    attn = counters["paged_attention"]
    attn.tree_launches = 0
    llm = LLM(params=params, **kw)
    spec = [o.output_token_ids for o in llm.generate(prompts, sp)]
    assert {n for n, c in counters.items() if c.launches > 0} == {
        "matmul_w4a16", "rmsnorm", "paged_attention", "matmul_w8a16"}
    rounds = llm.llm_engine.runner.spec_rounds_run
    assert attn.tree_launches == (cfg.num_layers * rounds if tree else 0) and rounds > 0
    oracle = LLM(params=params, speculative_method="medusa_null", **kw)
    assert spec == [o.output_token_ids for o in oracle.generate(prompts, sp)]


@pytest.mark.parametrize("q_len,S", [(1, 128), (4, 128), (4, 16), (128, 128)])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_attention_kernel_alibi(gen, kv_dtype, q_len, S):
    """The ALiBi instantiations against the plain version on every entry
    type: MHA (BLOOM's and MPT's layout: one live row of 8 per block at
    decode) and GQA, contexts of 1-4 pages; each launch counted as an ALiBi
    launch; the bias moves the output."""
    from qspec_tpu_torch.ops.attention import alibi_slopes
    counter = kernel_wrappers()["paged_attention" if kv_dtype == "bfloat16"
                                else f"paged_attention_{kv_dtype}"]
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    for Hq, Hkv in ((8, 8), (8, 2)):
        ctx = [max(c, q_len) for c in (3 * S - 5, 2 * S + 7, 4 * S, 40)]
        pages = [-(-c // S) for c in ctx]
        P = 1 + sum(pages)
        cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, 128, P, S, kv_dtype), "cuda")
        n = (P - 1) * S
        kvc.update_layer(cache, 1,
                         torch.randn(n, Hkv, 128, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.randn(n, Hkv, 128, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.arange(n, device="cuda") + S)
        ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
        tables = torch.zeros(4, max(pages), dtype=torch.int32)
        o = 0
        for b, m in enumerate(pages):
            tables[b, :m] = ids[o:o + m]
            o += m
        tables, ctx_t = tables.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda")
        q = (2 * torch.randn(4, q_len, Hq, 128, generator=gen, device="cuda")).to(torch.bfloat16)
        slopes = torch.as_tensor(alibi_slopes(Hq), device="cuda")
        before = (counter.launches, counter.alibi_launches)
        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, 128 ** -0.5, layer=1,
                                   kv_scales=cache.kv_scales, alibi=slopes)
        assert (counter.launches, counter.alibi_launches) == (before[0] + 1, before[1] + 1)
        ref = paged_attention_ref(q, cache, 1, tables, ctx_t, 128 ** -0.5, alibi=slopes)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        plain = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, 128 ** -0.5, layer=1,
                                     kv_scales=cache.kv_scales)
        assert not torch.allclose(out.float(), plain.float(), atol=tol)


def test_paged_attention_kernel_alibi_refusals(gen):
    """The CUDA wrapper takes ALiBi where the kernel is instantiated for it
    (head dim 128, no softcap, no tree) and refuses the rest."""
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    for D in (128, 256):
        cache = kvc.allocate(kvc.KVCacheConfig(1, 2, D, 4, 16, "bfloat16"), "cuda")
        tables = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
        ctx = torch.tensor([20], dtype=torch.int32, device="cuda")
        slopes = torch.ones(4, device="cuda")
        q = torch.zeros(1, 1, 4, D, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="ALiBi"):
            if D == 256:
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, 0.1, alibi=slopes)
            else:
                paged_attention_cuda(q, cache.kv_pages, tables, ctx, 0.1, alibi=slopes,
                                     softcap=50.0)
    t = build_tree(DEFAULT_TREE)
    q = torch.zeros(1, 1 + t.num_nodes, 4, 128, dtype=torch.bfloat16, device="cuda")
    cache = kvc.allocate(kvc.KVCacheConfig(1, 2, 128, 4, 16, "bfloat16"), "cuda")
    with pytest.raises(ValueError, match="ALiBi"):
        paged_attention_cuda(q, cache.kv_pages, torch.tensor([[1, 2]], dtype=torch.int32,
                                                             device="cuda"),
                             torch.tensor([20], dtype=torch.int32, device="cuda"), 0.1,
                             q_positions=torch.full((1, q.shape[1]), 9, device="cuda"),
                             alibi=torch.ones(4, device="cuda"),
                             tree=tree_mask(1, t.ancestors, "cuda"))


def _tree_rows_ar(q, cache, layer, tables, positions, tspec, prefix, scale, window):
    """AR's rows of a tree rectangle's nodes, f32 [B, T, Hq, D]: node t's
    query at position root + depth(t) over the context 0..root and its path
    at consecutive positions, under the window."""
    k, v = (x.double() for x in kvc.gather_layer(cache, layer, tables))
    B, _, Hq, D = q.shape
    group = Hq // k.shape[1]
    out = torch.zeros(B, tspec.num_nodes, Hq, D, dtype=torch.float64, device=q.device)
    for b in range(B):
        root = int(positions[b, prefix - 1])
        for t in range(tspec.num_nodes):
            path = sorted((j for j in range(tspec.num_nodes) if tspec.ancestors[t][j]),
                          key=lambda j: tspec.depth[j])
            slots = torch.tensor(list(range(root + 1)) + [root + 1 + j for j in path],
                                 device=q.device)
            p_q = root + tspec.depth[t]
            slots = slots[torch.arange(len(slots), device=q.device) > p_q - window]
            for h in range(Hq):
                kk, vv = k[b, h // group, slots], v[b, h // group, slots]
                out[b, t, h] = torch.softmax(kk @ q[b, prefix + t, h].double() * scale, 0) @ vv
    return out.float()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_attention_kernel_tree_window_is_ar(gen, kv_dtype):
    """Under a window shorter than the contexts the kernel's tree rows equal
    AR's (node t bounded by its own position root + depth(t)), and its
    prefix rows the plain version's."""
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    tspec = build_tree(DEFAULT_TREE)
    T, B, Hq, Hkv, S, P, prefix, W = tspec.num_nodes, 2, 4, 2, 16, 24, 5, 12
    cache = kvc.allocate(kvc.KVCacheConfig(2, Hkv, 128, P, S, kv_dtype), "cuda")
    n = (P - 1) * S
    kvc.update_layer(cache, 1, torch.randn(n, Hkv, 128, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.randn(n, Hkv, 128, generator=gen, device="cuda").to(torch.bfloat16),
                     torch.arange(n, device="cuda") + S)
    tables = (torch.randperm(20, generator=torch.Generator().manual_seed(3)) + 1
              ).reshape(2, 10).to(torch.int32).cuda()
    root = torch.tensor([17, 30], device="cuda")
    positions = torch.cat([root[:, None] - (prefix - 1) + torch.arange(prefix, device="cuda"),
                           root[:, None] + torch.tensor(tspec.depth, device="cuda")[None]], 1)
    q = (3 * torch.randn(B, prefix + T, Hq, 128, generator=gen, device="cuda")).to(torch.bfloat16)
    kw = dict(q_positions=positions, window=W, tree=tree_mask(prefix, tspec.ancestors, "cuda"))
    out = paged_attention_cuda(q, cache.kv_pages, tables, (root + 1 + T).to(torch.int32),
                               128 ** -0.5, layer=1, kv_scales=cache.kv_scales, **kw)
    ar = _tree_rows_ar(q, cache, 1, tables, positions, tspec, prefix, 128 ** -0.5, W)
    tol = 3e-2 if kv_dtype == "bfloat16" else 4e-2
    torch.testing.assert_close(out[:, prefix:].float(), ar, rtol=tol, atol=tol)
    ref = paged_attention_ref(q, cache, 1, tables, (root + 1 + T).to(torch.int32), 128 ** -0.5,
                              **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_tiny_bloom_ngram_equals_oracle_on_card(gen):
    """A tiny BLOOM (bf16, ALiBi, LayerNorm, biases, embedding LayerNorm) on
    the card: greedy n-gram == the "null" oracle; only the bf16 attention
    launches, every launch its ALiBi instantiation."""
    from qspec_tpu_torch import LLMEngine, SamplingParams
    from qspec_tpu_torch.config import (CacheConfig, EngineConfig, SchedulerConfig,
                                        SpeculativeConfig)
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.from_hf_config({"model_type": "bloom", "vocab_size": 512,
                                      "hidden_size": 256, "n_layer": 2, "n_head": 4})
    params = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]
    prompts[1] = prompts[1][:6] * 3
    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)

    def run(method):
        eng = LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                     scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256),
                                     speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                                   method=method)),
                        params, device="cuda")
        ids = [eng.add_request(p, sp) for p in prompts]
        outs = {}
        while eng.has_unfinished_requests():
            for o in eng.step():
                if o.finished:
                    outs[o.request_id] = o.output_token_ids
        return [outs[i] for i in ids], eng.runner.target_forwards

    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    attn = counters["paged_attention"]
    attn.alibi_launches = 0
    spec, forwards = run("ngram")
    assert {n for n, c in counters.items() if c.launches > 0} == {"paged_attention"}
    assert attn.alibi_launches == attn.launches == cfg.num_layers * forwards > 0
    assert spec == run("null")[0]


# contexts at page 128 (a split of the attention kernel is 256 tokens, two
# pages): 8192, the split boundaries k * 256 - 1, k * 256, k * 256 + 1 and a
# padding row
SPLIT_CTX = (8192, 255, 256, 257, 511, 512, 513, 0)


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("q_len", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_attention_kernel_splits(gen, kv_dtype, q_len, window):
    """Every entry type against the plain version at context 8192 (32
    splits, folded by the last block of each tile) and at split boundaries,
    with and without a window whose first token lies inside a split; the
    padding row (ctx_len 0) writes zeros."""
    ctx = [max(c, q_len) if c else 0 for c in SPLIT_CTX]
    q, cache, tables, ctx_t = _window_case(gen, q_len, kv_dtype, ctx, S=128, B=len(ctx))
    out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, 128 ** -0.5, layer=1,
                               kv_scales=cache.kv_scales, window=window)
    assert torch.count_nonzero(out[-1]) == 0
    ref = paged_attention_ref(q[:-1], cache, 1, tables[:-1], ctx_t[:-1], 128 ** -0.5,
                              window=window)
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    torch.testing.assert_close(out[:-1].float(), ref.float(), rtol=tol, atol=tol)


def _replayed(fn, want):
    """``fn()`` captured in a CUDA graph replays to ``want``'s bits, twice
    (the attention kernel and, where a tile spans splits, its merge kernel,
    with the split states in the graph's own memory)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            return False
    return True


@pytest.mark.parametrize("mode", ["d128", "d256", "alibi", "tree", "tree_d256"])
def test_paged_attention_kernel_row_bits(gen, mode):
    """A row's bits do not depend on Q (1, 2 and 4 last positions; the tree
    rows under prefix 3 and 5), on B, on its place in the batch, on a much
    longer row beside it (a wider block table: more splits in the grid), on
    a second call or on CUDA-graph replay; contexts across splits (page 16,
    256 tokens a split)."""
    from qspec_tpu_torch.ops.attention import alibi_slopes
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    D = 256 if mode.endswith("d256") else 128
    Hq, Hkv = {"d128": (32, 8), "alibi": (8, 8)}.get(mode, (16, 8))
    S, ctx = 16, [300, 700, 45, 256, 4000]
    tspec = build_tree(DEFAULT_TREE)
    tree = mode.startswith("tree")
    prefix = 5
    q_len = prefix + tspec.num_nodes if tree else 4
    if tree:   # the tree's slots end each context: root = ctx - 1 - T
        ctx = [c + tspec.num_nodes for c in ctx]
    q, cache, tables, ctx_t = _window_case(gen, q_len, "bfloat16", ctx, S=S, B=len(ctx),
                                           Hq=Hq, Hkv=Hkv, D=D)
    q = (2 * q.float()).to(torch.bfloat16)
    kw = {}
    if mode == "alibi":
        kw["alibi"] = torch.as_tensor(alibi_slopes(Hq), device="cuda")

    def positions(pre, rows):
        root = ctx_t[rows].long() - 1 - tspec.num_nodes
        return torch.cat([root[:, None] - (pre - 1) + torch.arange(pre, device="cuda"),
                          root[:, None] + torch.tensor(tspec.depth, device="cuda")[None]], 1)

    def inputs(rows, pre=prefix, width=None):
        """The launch's tensors, made before any graph capture."""
        rows = torch.as_tensor(rows, device="cuda")
        qq = q[rows][:, prefix - pre:] if tree else q[rows]
        tab = tables[rows][:, :width] if width else tables[rows]
        extra = dict(kw)
        if tree:
            extra.update(q_positions=positions(pre, rows), tree=tree_mask(pre, tspec.ancestors,
                                                                          "cuda"))
        return qq.contiguous(), tab.contiguous(), ctx_t[rows].contiguous(), extra

    def launch(args):
        qq, tab, c, extra = args
        return paged_attention_cuda(qq, cache.kv_pages, tab, c, D ** -0.5, layer=1, **extra)

    def run(rows, pre=prefix, width=None):
        return launch(inputs(rows, pre, width))

    narrow = -(-max(ctx[:4]) // S)          # the first four rows' table width
    full = run([0, 1, 2, 3, 4])
    four = run([0, 1, 2, 3], width=narrow)
    assert torch.equal(four, full[:4])                       # beside a longer row
    assert torch.equal(run([2, 0], width=narrow), full[[2, 0]])     # B and place
    assert torch.equal(run([4, 3, 2, 1, 0]), full.flip(0))
    assert torch.equal(run([0, 1, 2, 3, 4]), full)           # a second call
    if tree:
        # prefix 3: the same tree rows and the last three prefix rows
        assert torch.equal(run([0, 1, 2, 3, 4], pre=3), full[:, prefix - 3:])
        ref = paged_attention_ref(q, cache, 1, tables, ctx_t, D ** -0.5,
                                  q_positions=positions(prefix, torch.arange(5, device="cuda")),
                                  tree=tree_mask(prefix, tspec.ancestors, "cuda"))
    else:
        for ql in (1, 2):
            one = paged_attention_cuda(q[:, -ql:].contiguous(), cache.kv_pages, tables, ctx_t,
                                       D ** -0.5, layer=1, **kw)
            assert torch.equal(one, full[:, -ql:])
        ref = paged_attention_ref(q, cache, 1, tables, ctx_t, D ** -0.5, **kw)
    torch.testing.assert_close(full.float(), ref.float(), rtol=3e-2, atol=3e-2)
    every, first4 = inputs([0, 1, 2, 3, 4]), inputs([0, 1, 2, 3], width=narrow)
    assert _replayed(lambda: launch(every), full)
    assert _replayed(lambda: launch(first4), full[:4])


# the norms' timed shapes (chip_smoke.py time_norms): (kind, M, H, bits);
# "quant" rmsnorm_quant, "norm" the weightless rmsnorm, "gamma" with a gamma
NORM_CASES = ([("quant", m, 4096, bits) for m in (4, 8, 1024) for bits in (4, 8)]
              + [("norm", m, 4096, None) for m in (4, 16, 60, 512)]
              + [("gamma", m, 3584, None) for m in (4, 16)])


def _norm_inputs(gen, m, h):
    x = (torch.randn(m, h, generator=gen, device="cuda") * 3).to(torch.bfloat16)
    r = torch.randn(m, h, generator=gen, device="cuda").to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(torch.bfloat16)
    return x, r, g


def _norm(kind, x, g, bits, residual=None, ref=False):
    """The norm of ``kind`` (kernel or plain version) as a tuple of tensors:
    (values, scales) or (out,), then h when a residual is given."""
    if kind == "quant":
        fn = rq.rmsnorm_quant_ref if ref else rq.rmsnorm_quant
        res = fn(x, bits=bits or 4, residual=residual)
    else:
        fn = rq.rmsnorm_ref if ref else rq.rmsnorm
        res = fn(x, g if kind == "gamma" else None, residual=residual)
    out, h = (res, None) if residual is None else res
    return (tuple(out) if kind == "quant" else (out,)) + (() if h is None else (h,))


@pytest.mark.parametrize("kind,m,h,bits", NORM_CASES)
def test_norm_kernel_fused(gen, kind, m, h, bits):
    """The kernel with and without the residual add against its plain
    version at every timed shape (norm rtol = atol = 2e-2; quant scales
    rtol 1e-3, values within 1 and > 99% exact); h is the torch add, bit
    for bit."""
    x, r, g = _norm_inputs(gen, m, h)
    for residual in (None, r):
        got, want = _norm(kind, x, g, bits, residual), _norm(kind, x, g, bits, residual, True)
        if residual is not None:
            assert torch.equal(got[-1], x + r) and torch.equal(want[-1], x + r)
        if kind == "quant":
            torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)
            d = (got[0].int() - want[0].int()).abs()
            assert d.max().item() <= 1 and (d == 0).float().mean().item() > 0.99
        else:
            torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind,h", [("quant", 4096), ("norm", 4096), ("gamma", 3584)])
@pytest.mark.parametrize("fused", [False, True])
def test_norm_kernel_row_bits(gen, kind, h, fused):
    """A row's bits (output, scale, h) do not depend on M, on its place in
    the batch, on a second call or on CUDA-graph replay."""
    x, r, g = _norm_inputs(gen, 64, h)
    res = r if fused else None
    full = _norm(kind, x, g, 8, res)
    for lo, hi in ((0, 1), (5, 9), (17, 64), (63, 64)):
        part = _norm(kind, x[lo:hi].contiguous(), g, 8,
                     None if res is None else res[lo:hi].contiguous())
        assert all(torch.equal(a, b[lo:hi]) for a, b in zip(part, full)), (lo, hi)
    flipped = _norm(kind, x.flip(0).contiguous(), g, 8,
                    None if res is None else res.flip(0).contiguous())
    assert all(torch.equal(a, b.flip(0)) for a, b in zip(flipped, full))
    assert all(torch.equal(a, b) for a, b in zip(_norm(kind, x, g, 8, res), full))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _norm(kind, x, g, 8, res)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _norm(kind, x, g, 8, res)
    for _ in range(2):
        for t in outs:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, full))


def test_norm_kernel_refusals(gen):
    """What the kernel does not take raises: a row past 16384, a residual
    of another shape or type."""
    x, r, _ = _norm_inputs(gen, 4, 4096)
    with pytest.raises(ValueError, match="16384"):
        rq.rmsnorm(torch.zeros(2, 16392, dtype=torch.bfloat16, device="cuda"))
    with pytest.raises(ValueError, match="residual"):
        rq.rmsnorm(x, residual=r[:2])
    with pytest.raises(ValueError, match="residual"):
        rq.rmsnorm_quant(x, residual=r.float())


# ------------------------------------------- real weights and separate drafts

INDUCTION = "checkpoints/induction_lm_v2"


def _induction_prompts(n: int, prompt_len: int, vocab: int, seed: int = 0):
    """bench.py's ``induction_prompts`` (a random segment of period 16..64
    tiled to prompt_len), the trained checkpoint's distribution."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        period = int(rng.integers(16, 65))
        seg = rng.integers(2, vocab, size=period)
        out.append([int(x) for x in np.tile(seg, prompt_len // period + 1)[:prompt_len]])
    return out


def _greedy(eng, prompts, max_tokens):
    from qspec_tpu_torch import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    ids = [eng.add_request(p, sp) for p in prompts]
    done = {}
    while eng.has_unfinished_requests():
        for o in eng.step():
            if o.finished:
                done[o.request_id] = o.output_token_ids
    return [done[i] for i in ids]


def _qspec_engine(cfg, params, method, draft=None, **spec_kw):
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    spec = SpeculativeConfig(num_speculative_tokens=3, method=method,
                             draft_model=draft and draft[0], **spec_kw)
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                  scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=512,
                                                            prefill_chunk_size=128),
                                  speculative=spec), params, device="cuda", seed=0,
                     draft_params=draft and draft[1])


def test_induction_lm_w4a4_qspec_on_card(gen):
    """The trained checkpoint (3 layers, hidden 512) quantized by
    quantize_float on the card: greedy QSpec with the W4A4 draft equals the
    qspec_null oracle, the draft is accepted, and the QuaRot kernels (and
    only they) launch. The acceptance and the tokens a round go to stdout."""
    import dataclasses
    import json
    from qspec_tpu_torch.model_loader.loader import quantize_float
    with open(INDUCTION + ".json") as f:
        meta = json.load(f)["cfg"]
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in meta.items() if k in names})
    with np.load(INDUCTION + ".npz") as z:
        sd = {k: torch.as_tensor(z[k]).cuda() for k in z.files}
    params, cfg = quantize_float(sd, cfg, device="cuda")
    prompts = _induction_prompts(4, 128, cfg.vocab_size)
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    eng = _qspec_engine(cfg, params, "qspec")
    spec = _greedy(eng, prompts, 32)
    assert {n for n, c in counters.items() if c.launches > 0} == {
        "matmul_w4a16", "matmul_w4a4", "rmsnorm", "rmsnorm_quant", "paged_attention"}
    assert spec == _greedy(_qspec_engine(cfg, params, "qspec_null"), prompts, 32)
    m = eng.spec_metrics
    print(f"induction_lm_v2 W4A4 QSpec on the card: acceptance {m.draft_acceptance_rate}, "
          f"tokens a round per sequence {dict(sorted(m.emitted_per_seq_round.items()))}, "
          f"{m.num_emitted_tokens / max(m.num_emitted_tokens - m.num_draft_accepted, 1)} "
          "a round on average")
    assert m.draft_acceptance_rate > 0.5


@pytest.mark.parametrize("draft_quant", ["w4", "none"])
def test_separate_draft_and_forced_acceptance_on_card(gen, draft_quant):
    """The tiny QuaRot target with a separate 1-layer draft (W4A4, or bf16)
    on the card: greedy == qspec_null, the draft's forwards launch on its
    own layer only; force_accept_len=2 emits 3 tokens a round short of the
    budget, and 0 the oracle's tokens."""
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0, device="cuda")
    dcfg = ModelConfig.tiny(quant=draft_quant, num_layers=1, hidden_size=128,
                            intermediate_size=192, num_heads=2, num_kv_heads=2)
    draft = (dcfg, init_params(dcfg, seed=3, device="cuda"))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    eng = _qspec_engine(cfg, params, "qspec", draft)
    spec = _greedy(eng, prompts, 20)
    launches = {n: c.launches for n, c in counters.items()}
    oracle = _greedy(_qspec_engine(cfg, params, "qspec_null", draft), prompts, 20)
    assert spec == oracle
    d_fw = eng.runner.draft_forwards
    assert d_fw > 0
    if draft_quant == "w4":
        assert launches["matmul_w4a4"] == 4 * d_fw
        assert launches["rmsnorm_quant"] == 2 * d_fw
    else:
        assert launches["matmul_w4a4"] == launches["rmsnorm_quant"] == 0
    forced = _qspec_engine(cfg, params, "qspec", draft, force_accept_len=2)
    _greedy(forced, prompts, 20)
    assert dict(forced.spec_metrics.emitted_per_seq_round) == {3: 6 * 4, 1: 4}
    zero = _qspec_engine(cfg, params, "qspec", draft, force_accept_len=0)
    assert _greedy(zero, prompts, 20) == oracle


# ------------------------------------------------------ EAGLE and MLPSpeculator

EAGLE_NET = "checkpoints/induction_eagle_v1.npz"
# tests/test_torch_eagle.py::test_trained_pair_matches_jax_engine: the trained
# pair at k = 4, 2 rounds a step, on _induction_prompts(4, 128, seed=13), 32
# greedy tokens, TRAINED_SCHED; both packages on the CPU drafted 112 tokens,
# accepted 96 and emitted 124
TRAINED_COUNTS = (112, 96, 124)
TRAINED_SCHED = dict(max_num_seqs=4, max_model_len=512, prefill_chunk_size=128,
                     decode_batch_buckets=(4,), prefill_token_buckets=(128,))


def _engine(cfg, params, spec, **sched):
    from qspec_tpu_torch import CacheConfig, EngineConfig, LLMEngine, SchedulerConfig
    return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=16),
                                  scheduler=SchedulerConfig(**sched), speculative=spec),
                     params, device="cuda", seed=0)


def _launched(counters) -> dict:
    return {n: c.launches for n, c in counters.items() if c.launches}


def test_trained_eagle_pair_on_card(gen):
    """induction_lm_v2 quantized by quantize_float on the card with the
    trained induction_eagle_v1 net: greedy EAGLE (k = 4) == AR, the
    acceptance the CPU's (TRAINED_COUNTS), and only the verify scheme's
    kernels launched (EAGLE's layer: the gamma norm and the bf16 attention;
    the bf16 head of this checkpoint is a torch product)."""
    import dataclasses
    import json
    from qspec_tpu_torch import SpeculativeConfig
    from qspec_tpu_torch.model_loader.loader import quantize_float
    from qspec_tpu_torch.spec_decode.eagle import load_eagle
    with open(INDUCTION + ".json") as f:
        meta = json.load(f)["cfg"]
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in meta.items() if k in names})
    with np.load(INDUCTION + ".npz") as z:
        sd = {k: torch.as_tensor(z[k]).cuda() for k in z.files}
    params, cfg = quantize_float(sd, cfg, device="cuda")
    params["eagle"] = load_eagle(EAGLE_NET, cfg)
    assert params["eagle"]["fc"].is_cuda
    prompts = _induction_prompts(4, 128, cfg.vocab_size, seed=13)
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    rq.rmsnorm.gamma_launches = 0
    eng = _engine(cfg, params, SpeculativeConfig(num_speculative_tokens=4, method="eagle",
                                                 rounds_per_step=2), **TRAINED_SCHED)
    spec = _greedy(eng, prompts, 32)
    launched = _launched(counters)
    assert set(launched) == {"matmul_w4a16", "rmsnorm", "paged_attention"}
    assert rq.rmsnorm.gamma_launches == 2 * eng.runner.draft_forwards > 0
    assert spec == _greedy(_engine(cfg, params, None, **TRAINED_SCHED), prompts, 32)
    m = eng.spec_metrics
    print(f"trained EAGLE pair on the card: acceptance {m.draft_acceptance_rate}, tokens a "
          f"round per sequence {dict(sorted(m.emitted_per_seq_round.items()))}, drafted / "
          f"accepted / emitted {m.num_draft_tokens} {m.num_draft_accepted} "
          f"{m.num_emitted_tokens}")
    assert (m.num_draft_tokens, m.num_draft_accepted, m.num_emitted_tokens) == TRAINED_COUNTS


@pytest.mark.parametrize("method", ["eagle", "mlp_speculator"])
def test_proposers_at_8b_width_on_card(gen, method):
    """chip_smoke.py's (E1) / (E2) at Llama-3-8B widths cut to 2 layers:
    greedy EAGLE == AR and MLPSpeculator == medusa_null, with random nets
    made on the card, each launching only matmul_w4a16, the int8 head,
    rmsnorm and the bf16 attention."""
    import dataclasses
    from qspec_tpu_torch import SpeculativeConfig
    from qspec_tpu_torch.models.llama import init_params
    from qspec_tpu_torch.spec_decode.eagle import init_eagle_params
    from qspec_tpu_torch.spec_decode.mlp_speculator import init_mlp_speculator_params
    cfg = dataclasses.replace(ModelConfig.llama3_8b(), num_layers=2)
    params = init_params(cfg, seed=0, device="cuda")
    if method == "eagle":
        params["eagle"] = init_eagle_params(cfg, seed=5)
    else:
        params["mlp_spec"] = init_mlp_speculator_params(cfg.hidden_size, cfg.vocab_size, 3,
                                                        seed=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128000, size=int(n)).tolist() for n in (64, 100, 150, 192)]
    sched = dict(max_num_seqs=4, max_model_len=512)
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    eng = _engine(cfg, params, SpeculativeConfig(num_speculative_tokens=3, method=method),
                  **sched)
    spec = _greedy(eng, prompts, 24)
    assert set(_launched(counters)) == {"matmul_w4a16", "matmul_w8a16", "rmsnorm",
                                        "paged_attention"}
    oracle = (None if method == "eagle" else
              SpeculativeConfig(num_speculative_tokens=3, method="medusa_null"))
    assert spec == _greedy(_engine(cfg, params, oracle, **sched), prompts, 24)


def test_guided_qspec_at_8b_width_on_card(gen):
    """chip_smoke.py's (I1) W4A4 case at Llama-3-8B widths cut to 2 layers
    (random int4 weights made on the card, int8 head): the regex, JSON
    schema, choice and unguided requests over the byte-level vocabulary at
    V = 128256, greedy QSpec (k = 3) == qspec_null under the same grammars,
    every guided output walks its FSM, the grammar tables sit on the card,
    and only the QuaRot kernels launch."""
    import dataclasses
    import chip_smoke as cs
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    from qspec_tpu_torch.guided import GrammarCompiler
    from qspec_tpu_torch.models.llama import init_params
    cfg = dataclasses.replace(ModelConfig.llama3_8b(), num_layers=2)
    params = init_params(cfg, seed=0, device="cuda")
    vocab = cs.guided_vocab(cfg.vocab_size)
    sps, fsms = cs.guided_requests(GrammarCompiler(vocab, cs.GUIDED_EOS), 24)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128000, size=int(n)).tolist() for n in (64, 100, 150, 192)]

    def make(method):
        return LLMEngine(EngineConfig(model=cfg, cache=CacheConfig(page_size=128),
                                      scheduler=SchedulerConfig(max_num_seqs=4,
                                                                max_model_len=512),
                                      speculative=SpeculativeConfig(num_speculative_tokens=3,
                                                                    method=method)),
                         params, device="cuda", grammar_vocab=vocab,
                         eos_token_id=cs.GUIDED_EOS)
    oracle, _, _, _, _ = cs.guided_run(make, "qspec_null", prompts, sps)
    spec, launches, _, _, probe = cs.guided_run(make, "qspec", prompts, sps, count=True)
    assert spec == oracle and all(len(t) == 24 for t in spec)
    assert all(cs.fsm_walk(f, t) >= 0 for f, t in zip(fsms, spec) if f is not None)
    assert probe.devices == {"cuda"} and set(launches) == cs.QUAROT_KERNELS


def _to_cpu(t):
    """A copy of a tensor tree (dicts, QuantizedActivation) on the CPU."""
    if isinstance(t, torch.Tensor):
        return t.cpu()
    if isinstance(t, dict):
        return {k: _to_cpu(v) for k, v in t.items()}
    if isinstance(t, QuantizedActivation):
        return QuantizedActivation(*map(_to_cpu, t))
    return t


# the JAX block tolerances (tests/test_torch_moe.py), of the largest |delta|
MOE_CPU_TOL = {"w4a16": 2e-2, "w4a4": 1e-2, "w4a8": 1e-2}


@pytest.mark.parametrize("scheme", ["w4a16", "w4a4", "w4a8"])
def test_moe_block_at_qwen15_moe_widths(gen, scheme, monkeypatch):
    """_moe_block at Qwen1.5-MoE-A2.7B's widths (one layer: 60 experts of
    1408, top-4, the gated shared expert of 5632) on the card at the
    verify's 16 rows, its GEMMs the kernels (expert down at K = 1408, a
    half-full last stage; 2 x 61 launches), held

    - against the same block on the card with the GEMMs' plain versions:
      at W4A4 and W4A8 bit for bit (the kernel is exact, every other op the
      same), at W4A16 within the JAX kernel test's 2e-2 of the largest
      |delta|;
    - against the block on the CPU (the plain versions throughout): the
      same experts for every row, and MOE_CPU_TOL. At W4A4 an ulp of the
      card's eager silu can move one int4 code of a down GEMM's input a
      step (seen on one row of 16), so there an element may also be off by
      one such step, the largest over its row's GEMMs: 8 x the row's
      activation scale x the column's weight scale x the expert's combine
      weight (the shared expert's: its sigmoid gate); and every int4 code
      of every down GEMM's input is within one step of the CPU's."""
    from qspec_tpu_torch.models import llama as tl
    cfg = ModelConfig.qwen15_moe_a2_7b(quant="w4", num_layers=1)
    params = tl.init_params(cfg, seed=0, device="cuda")
    layers, had = params["layers"], params["hadamards"]
    x = torch.randn(16, cfg.hidden_size, generator=gen, device="cuda").to(torch.bfloat16)
    args = ((x, None) if scheme == "w4a16" else
            (None, (sym_quant_int4 if scheme == "w4a4" else sym_quant_int8)(x)))
    act_quant = tl._act_quant
    recorded = {"card": [], "cpu": []}   # each down GEMM's quantized input

    def recording(where):
        def quant(a, s):
            q = act_quant(a, s)
            recorded[where].append(q)
            return q
        return quant
    counters = kernel_wrappers()
    for c in counters.values():
        c.launches = 0
    monkeypatch.setattr(tl, "_act_quant", recording("card"))
    out = tl._moe_block(*args, layers, 0, cfg, scheme, had)
    gemm = "matmul_w4a16" if scheme == "w4a16" else "matmul_w4a4"
    assert counters[gemm].launches == 2 * (cfg.num_experts + 1)

    cpu_layers, cpu_args = _to_cpu(layers), tuple(map(_to_cpu, args))
    monkeypatch.setattr(tl, "_act_quant", recording("cpu"))
    cpu = tl._moe_block(*cpu_args, cpu_layers, 0, cfg, scheme, _to_cpu(had))
    monkeypatch.setattr(tl, "_act_quant", act_quant)
    x_fp = x if scheme == "w4a16" else sym_dequant(args[1])
    combine = tl.moe_combine(tl._f32_matmul(x_fp.cpu(), cpu_layers["router"][0]), cfg)
    assert torch.equal(
        tl.moe_combine(tl._f32_matmul(x_fp, layers["router"][0]), cfg).cpu() > 0, combine > 0)
    tol = MOE_CPU_TOL[scheme]
    err = (out.cpu() - cpu).abs()
    bound = tol * cpu.abs().max() + tol * cpu.abs()
    if scheme == "w4a4":
        qs = torch.cat([cpu_layers["experts_down"]["qs"][0], cpu_layers["shared_down"]["qs"][:1]])
        gate = torch.sigmoid(tl._f32_matmul(x_fp.cpu(), cpu_layers["shared_gate"][0]))
        weight = torch.cat([combine, gate], dim=1)
        scales = torch.stack([q.scales.reshape(-1) for q in recorded["cpu"]], dim=1)
        step = (8 * (weight * scales)[:, :, None] * qs[None]).amax(dim=1)
        assert bool((err <= bound + step).all())
        for card_q, cpu_q in zip(recorded["card"], recorded["cpu"], strict=True):
            codes = card_q.values.cpu().to(torch.int16) - cpu_q.values.to(torch.int16)
            assert int(codes.abs().max()) <= 1
    else:
        assert bool((err <= bound).all())

    monkeypatch.setattr(tl, "matmul_w4a16", lambda x, w, s, layer_idx=None:
                        lk.matmul_w4a16_ref(x, w[layer_idx], s[layer_idx]))
    monkeypatch.setattr(tl, "matmul_w4a4", lambda xv, xs, w, s, layer_idx=None:
                        lk.matmul_w4a4_ref(xv, xs, w[layer_idx], s[layer_idx]))
    ref = tl._moe_block(*args, layers, 0, cfg, scheme, had)
    assert counters[gemm].launches == 2 * (cfg.num_experts + 1)
    if scheme == "w4a16":
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2 * ref.abs().max().item())
    else:
        assert torch.equal(out, ref)


# ------------------------------------------------ Qwen2-7B's layer shapes

# one Qwen2-7B layer's projections (K, N): qkv (3584 + 2 x 512 with the
# bias), o, gate_up (2 x 18944) and down (K = 18944, 74 stages of 256)
QWEN2_7B_PROJ = [(3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584)]


@pytest.mark.parametrize("ctx", [(379, 263, 512, 40), (8192, 8191, 4097, 0)],
                         ids=["verify", "long"])
@pytest.mark.parametrize("q_len", [1, 2, 4])
def test_paged_attention_kernel_gqa_group7(gen, q_len, ctx):
    """Qwen2-7B's 28 query heads over 4 KV heads: G = 7 Q rows a KV head
    (7, 14 and 28: one or two 16-row tiles, the last one partial), at the
    verify's contexts and at long ones (32 splits), against the plain
    version; a padding row writes zeros."""
    ctx = [max(c, q_len) if c else 0 for c in ctx]
    q, cache, tables, ctx_t = _window_case(gen, q_len, "bfloat16", ctx, S=128, B=4, Hq=28,
                                           Hkv=4)
    out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, 128 ** -0.5, layer=1)
    live = ctx_t > 0
    ref = paged_attention_ref(q[live], cache, 1, tables[live], ctx_t[live], 128 ** -0.5)
    torch.testing.assert_close(out[live].float(), ref.float(), rtol=3e-2, atol=3e-2)
    assert torch.count_nonzero(out[~live]) == 0
    assert _replayed(lambda: paged_attention_cuda(q, cache.kv_pages, tables, ctx_t,
                                                  128 ** -0.5, layer=1), out)


@pytest.mark.parametrize("k,n", QWEN2_7B_PROJ)
def test_w4_kernels_at_qwen2_7b_shapes(gen, k, n):
    """matmul_w4a16 within 2e-2 of its plain version, a row's bits the same
    at every M up to 64, and matmul_w4a4 bit for bit (int4 and int8
    activations) at the draft's and the verify's M and past the split mode,
    read in place from a layer stack."""
    qw, qs = _w4_stacked(gen, k, n)
    x = torch.randn(64, k, generator=gen, device="cuda").to(torch.bfloat16) * 3
    full = lk.matmul_w4a16(x, qw, qs, layer_idx=1, out_dtype=torch.float32)
    torch.testing.assert_close(full, lk.matmul_w4a16_ref(x, qw[1], qs[1],
                                                         out_dtype=torch.float32),
                               rtol=2e-2, atol=2e-2)
    for m in (1, 4, 16, 60):
        out = lk.matmul_w4a16(x[:m], qw, qs, layer_idx=1, out_dtype=torch.float32)
        assert torch.equal(out, full[:m]), m
    for m in (4, 8, 16, 64):
        for xq in (sym_quant_int4(x[:m]), sym_quant_int8(x[:m])):
            out = lk.matmul_w4a4(xq.values, xq.scales, qw, qs, layer_idx=1)
            assert torch.equal(out, lk.matmul_w4a4_ref(xq.values, xq.scales, qw[1], qs[1])), m


@pytest.mark.parametrize("k,n", [(3584, 152064), (3072, 32064), (4096, 49155),
                                 (3072, 256000)])
def test_int8_head_at_published_vocabularies(gen, k, n):
    """The int8 head at Qwen2-7B's, Phi-3's (32064: half of the last
    128-column tile), Granite-3.0's (49155: padded at load to 49280, the
    logits sliced back) and Gemma's vocabularies: the logits of
    compute_logits through the kernel equal the plain version's on the
    unpadded head, M = 4 and 16, one launch a call."""
    from qspec_tpu_torch.models import llama as tl
    head = tl._make_lm_head(torch.randn(k, n, generator=gen, device="cuda") * 0.05, "int8")
    assert head["qw8"].shape[1] % 8 == 0
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    for m in (4, 16):
        before = lk.matmul_w8a16.launches
        out = tl.compute_logits(x[:m], head, n)
        assert lk.matmul_w8a16.launches == before + 1
        assert tuple(out.shape) == (m, n)
        ref = lk.matmul_w8a16_ref(x[:m], head["qw8"][:, :n], head["qs"][:n],
                                  out_dtype=torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("h", [3584, 3072])
def test_norm_kernels_at_qwen2_and_gemma_widths(gen, h):
    """Qwen2-7B's hidden 3584 and Gemma-7B's / Phi-3's 3072 (neither a
    multiple of 1024): both norms with and without the residual add against
    their plain versions (tests/test_torch_gpu.py's NORM_CASES tolerances)."""
    for kind, bits in (("quant", 4), ("quant", 8), ("norm", None), ("gamma", None)):
        for m in (4, 16):
            x, r, g = _norm_inputs(gen, m, h)
            for res in (None, r):
                got = _norm(kind, x, g, bits, res)
                want = _norm(kind, x, g, bits, res, ref=True)
                if kind == "quant":
                    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=0)
                    d = (got[0].int() - want[0].int()).abs()
                    assert d.max().item() <= 1 and (d == 0).float().mean().item() > 0.99
                else:
                    torch.testing.assert_close(got[0].float(), want[0].float(),
                                               rtol=2e-2, atol=2e-2)
                if res is not None:
                    assert torch.equal(got[-1], want[-1])


# ------------------------------------------ the remap and float families


def _tiny_family(family):
    """(cfg, state dict on the CPU in the family's own keys): a tiny
    InternLM2 (hidden 256, 4 heads of 64 over 2 KV heads, the wqkv rows
    interleaved per KV group, intermediate 448) or a tiny Falcon-40B layout
    (hidden 256, 4 heads of 64 over 2, ln_attn and ln_mlp perturbed)."""
    from qspec_tpu_torch.models.registry import resolve
    g = torch.Generator().manual_seed(11)

    def w(*shape, s=0.05):
        return torch.randn(shape, generator=g) * s
    H, V, L = 256, 512, 2
    if family == "internlm2":
        cfg = resolve(dict(architectures=["InternLM2ForCausalLM"], model_type="internlm2",
                           hidden_size=H, intermediate_size=448, num_attention_heads=4,
                           num_key_value_heads=2, num_hidden_layers=L, vocab_size=V,
                           rope_theta=1e6, rope_scaling={"type": "dynamic", "factor": 2.0},
                           max_position_embeddings=256))
        sd = {"model.tok_embeddings.weight": w(V, H), "model.norm.weight": 1 + w(H, s=0.1),
              "output.weight": w(V, H)}
        for li in range(L):
            p = f"model.layers.{li}."
            sd.update({p + "attention_norm.weight": 1 + w(H, s=0.1),
                       p + "attention.wqkv.weight": w(cfg.qkv_out, H),
                       p + "attention.wo.weight": w(H, H), p + "ffn_norm.weight": 1 + w(H, s=0.1),
                       p + "feed_forward.w1.weight": w(448, H),
                       p + "feed_forward.w3.weight": w(448, H),
                       p + "feed_forward.w2.weight": w(H, 448)})
        return cfg, sd
    cfg = resolve(dict(architectures=["FalconForCausalLM"], model_type="falcon", alibi=False,
                       bias=False, hidden_size=H, new_decoder_architecture=True,
                       num_attention_heads=4, num_kv_heads=2, num_hidden_layers=L,
                       parallel_attn=True, vocab_size=V, max_position_embeddings=256))
    sd = {"transformer.word_embeddings.weight": w(V, H),
          "transformer.ln_f.weight": 1 + w(H, s=0.3), "transformer.ln_f.bias": w(H, s=0.3)}
    for li in range(L):
        p = f"transformer.h.{li}."
        for n in ("ln_attn", "ln_mlp"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = 1 + w(H, s=0.3), w(H, s=0.3)
        sd.update({p + "self_attention.query_key_value.weight": w(cfg.qkv_out, H),
                   p + "self_attention.dense.weight": w(H, H),
                   p + "mlp.dense_h_to_4h.weight": w(4 * H, H),
                   p + "mlp.dense_4h_to_h.weight": w(H, 4 * H)})
    return cfg, sd


@pytest.mark.parametrize("family", ["internlm2", "falcon40b"])
def test_tiny_remap_and_falcon_on_card_match_cpu(gen, family):
    """A tiny InternLM2 (remapped and quantized by quantize_float on the
    CPU, QuaRot) and a tiny Falcon-40B layout (load_family_float, bf16, two
    parallel norms) on the card against the same parameters on the CPU:
    logits within a relative L2 of 2e-2; the CPU's greedy tokens,
    teacher-forced through the card's forward, are its argmax but at the
    CPU's near-ties (top-2 margin under 2e-2); through the engine on the
    card, greedy QSpec W4A4 (InternLM2) or n-gram (Falcon) equals its oracle
    and gives the CPU engine's tokens wherever the CPU's margins are
    clear."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SamplingParams,
                                 SchedulerConfig, SpeculativeConfig)
    from qspec_tpu_torch.model_loader.families import load_family_float
    from qspec_tpu_torch.model_loader.loader import quantize_float
    from qspec_tpu_torch.models.llama import AttentionBatch, model_forward
    cfg, sd = _tiny_family("internlm2" if family == "internlm2" else "falcon")
    if family == "internlm2":
        cpu, cfg = quantize_float(sd, cfg, device="cpu")
        method, scheme = "qspec", "w4a16"
    else:
        cpu, cfg = load_family_float(sd, cfg, device="cpu")
        method, scheme = "ngram", "bf16"

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
    card = to(cpu, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (9, 20, 31)]
    prompts[1] = prompts[1][:5] * 4

    def run(dev, params, m):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=m) if m else None
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16, num_pages=32),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=128, prefill_chunk_size=64),
            speculative=spec), params, device=dev, seed=0)
        return _greedy(eng, prompts, 12)

    def logits(dev, params, toks):
        S, T = 16, len(toks)
        cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, 8, S), dev)
        pos = torch.arange(T, device=dev)[None]
        batch = AttentionBatch(pos, pos + S, torch.arange(1, 8, dtype=torch.int32,
                                                          device=dev)[None],
                               torch.tensor([T], dtype=torch.int32, device=dev))
        out, _ = model_forward(params, cfg, torch.tensor([toks], device=dev), cache, batch,
                               scheme=scheme)
        return out[0].float().cpu()

    cpu_toks = run("cpu", cpu, None)
    card_spec = run("cuda", card, method)
    assert card_spec == run("cuda", card, "qspec_null" if method == "qspec" else "null")
    for p, got, want in zip(prompts, card_spec, cpu_toks):
        seq = p + want
        ref, out = logits("cpu", cpu, seq), logits("cuda", card, seq)
        assert ((out - ref).norm() / ref.norm()).item() <= 2e-2
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) >= 2e-2
        gen_pos = torch.arange(len(p) - 1, len(seq) - 1)
        assert (out.argmax(-1) == ref.argmax(-1))[clear].all()
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        assert first is None or not clear[gen_pos[first]], (got, want)


# ------------------------------- the gptj rope and the parallel-residual families


@pytest.mark.parametrize("q_len", [1, 2, 4])
@pytest.mark.parametrize("Hq,D", [(16, 256), (64, 96), (32, 80)],
                         ids=["gptj-d256", "neox20b-d96", "phi2-d80"])
def test_paged_attention_kernel_at_gptj_and_neox20b_shapes(gen, Hq, D, q_len):
    """GPT-J-6B's 16 heads of 256 (multi-head: one Q row a KV head), and
    GPT-NeoX-20B's 64 heads of 96 and Phi-2's 32 of 80, stored 128-padded
    (the pad lanes zero, as update_layer writes them) and called through
    ops.attention.paged_attention as the model calls it (q padded, the
    output sliced back): against the plain version at the verify's
    contexts, 3e-2; a padding row writes zeros."""
    from qspec_tpu_torch.ops.attention import paged_attention
    stored = -(-D // 128) * 128
    ctx = [max(c, q_len) if c else 0 for c in (379, 263, 512, 40)]
    q, cache, tables, ctx_t = _window_case(gen, q_len, "bfloat16", ctx, S=128, B=4, Hq=Hq,
                                           Hkv=Hq, D=stored)
    cache.kv_pages[..., D:] = 0
    q = q[..., :D].contiguous()
    out = paged_attention(q, cache, 1, tables, ctx_t, D ** -0.5)
    assert out.shape == q.shape
    ref = paged_attention_ref(torch.nn.functional.pad(q, (0, stored - D)), cache, 1, tables,
                              ctx_t, D ** -0.5)[..., :D]
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)


def test_tiny_gptj_ngram_equals_ar_on_card(gen):
    """A tiny GPT-J (hidden 512, 2 heads of 256, the interleaved rope over
    64 of them, the head's bias; its LayerNorms and biases perturbed)
    converted by load_family_float on the CPU and moved to the card: its
    logits within a relative L2 of 2e-2 of the CPU's, and through the engine
    on the card greedy n-gram (k = 3) == the null oracle == AR, every
    attention launch the D=256 instantiation."""
    from qspec_tpu_torch import (CacheConfig, EngineConfig, LLMEngine, SchedulerConfig,
                                 SpeculativeConfig)
    from qspec_tpu_torch.model_loader.families import load_family_float
    from qspec_tpu_torch.models.llama import AttentionBatch, model_forward
    from qspec_tpu_torch.models.registry import resolve
    cfg = resolve(dict(architectures=["GPTJForCausalLM"], model_type="gptj", n_embd=512,
                       n_head=2, n_layer=2, n_inner=1024, rotary_dim=64, vocab_size=512,
                       n_positions=256, activation_function="gelu_new"))
    assert cfg.head_dim == 256 and cfg.rotary_dim == 64 and cfg.rope_style == "gptj"
    g = torch.Generator().manual_seed(21)

    def w(*shape, s=0.05):
        return torch.randn(shape, generator=g) * s
    H, I, V = 512, 1024, 512
    sd = {"transformer.wte.weight": w(V, H), "transformer.ln_f.weight": 1 + w(H, s=0.3),
          "transformer.ln_f.bias": w(H, s=0.1), "lm_head.weight": w(V, H),
          "lm_head.bias": w(V, s=0.1)}
    for li in range(2):
        p = f"transformer.h.{li}."
        sd.update({p + "ln_1.weight": 1 + w(H, s=0.3), p + "ln_1.bias": w(H, s=0.1),
                   p + "mlp.fc_in.weight": w(I, H), p + "mlp.fc_in.bias": w(I, s=0.1),
                   p + "mlp.fc_out.weight": w(H, I), p + "mlp.fc_out.bias": w(H, s=0.1),
                   **{p + f"attn.{n}_proj.weight": w(H, H, s=0.2) for n in "qkv"},
                   p + "attn.out_proj.weight": w(H, H)})
    cpu, cfg = load_family_float(sd, cfg, device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
    card = to(cpu, "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, V, size=int(n)).tolist() for n in (9, 20, 31)]
    prompts[1] = prompts[1][:5] * 4
    toks = prompts[2]

    def logits(dev, params):
        S, T = 16, len(toks)
        cache = kvc.allocate(kvc.KVCacheConfig(cfg.num_layers, cfg.num_kv_heads,
                                               cfg.cache_head_dim, 8, S), dev)
        pos = torch.arange(T, device=dev)[None]
        batch = AttentionBatch(pos, pos + S, torch.arange(1, 8, dtype=torch.int32,
                                                          device=dev)[None],
                               torch.tensor([T], dtype=torch.int32, device=dev))
        out, _ = model_forward(params, cfg, torch.tensor([toks], device=dev), cache, batch,
                               scheme="bf16")
        return out[0].float().cpu()
    ref, out = logits("cpu", cpu), logits("cuda", card)
    assert ((out - ref).norm() / ref.norm()).item() <= 2e-2

    def run(method):
        spec = SpeculativeConfig(num_speculative_tokens=3, method=method) if method else None
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16, num_pages=32),
            scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=128, prefill_chunk_size=64),
            speculative=spec), card, device="cuda", seed=0)
        return _greedy(eng, prompts, 12)
    attn = kernel_wrappers()["paged_attention"]
    attn.launches = attn.d256_launches = 0
    spec = run("ngram")
    assert attn.launches > 0 and attn.d256_launches == attn.launches
    assert spec == run("null") == run(None)


@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("h", [2560, 4096])
def test_gamma_rmsnorm_at_helium_and_glm4_widths(gen, h, m):
    """The gamma rmsnorm at Helium's hidden 2560 (no multiple of 1024) and
    GLM-4's 4096, at the draft's and the verify's M, alone and with the
    residual add: against its plain version (NORM_CASES' tolerance), h bit
    for bit the torch add."""
    x, r, g = _norm_inputs(gen, m, h)
    for res in (None, r):
        got = _norm("gamma", x, g, None, res)
        want = _norm("gamma", x, g, None, res, ref=True)
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2, atol=2e-2)
        if res is not None:
            assert torch.equal(got[-1], x + r) and torch.equal(want[-1], x + r)


@pytest.mark.parametrize("h", [2560, 4096, 6144])
def test_layernorm_rows_independent_of_batch(gen, h):
    """models/llama.layernorm (torch ops, its statistics in float64): a
    row's bits do not depend on the batch's row count (M = 1 to 504, the
    first rows and the last), over rows of scales 1e-2 to 1e2, with a beta
    and without (Cohere). In float32 a GPT-J-6B row normed at 8 rows and at
    16 came out a bf16 step apart."""
    from qspec_tpu_torch.models.llama import layernorm
    scale = torch.logspace(-2, 2, 504, device="cuda")[:, None]
    x = (torch.randn(504, h, generator=gen, device="cuda") * scale).to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(torch.bfloat16)
    b = (0.01 * torch.randn(h, generator=gen, device="cuda")).to(torch.bfloat16)
    for beta in (b, None):
        full = layernorm(x, g, beta, 1e-5)
        for m in (1, 4, 8, 12, 16, 126):
            assert torch.equal(layernorm(x[:m], g, beta, 1e-5), full[:m]), m
            assert torch.equal(layernorm(x[-m:], g, beta, 1e-5), full[-m:]), m


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_swap_pages_round_trip(gen, kv_dtype):
    """Swap's page gather (the pages of every layer, as bytes, with the
    8-bit scales, into page-locked host memory) and its scatter into other
    pages, on the card: the scattered pages hold the gathered bits, and the
    other pages are untouched."""
    from qspec_tpu_torch.config import CacheConfig, EngineConfig
    from qspec_tpu_torch.engine.model_runner import ModelRunner
    from qspec_tpu_torch.models.llama import init_params
    cfg = ModelConfig.tiny(quant="w4")
    r = ModelRunner(EngineConfig(model=cfg, cache=CacheConfig(page_size=16,
                                                              kv_cache_dtype=kv_dtype)),
                    init_params(cfg, device="cuda"), num_pages=10, device="cuda")
    T = 10 * 16
    for li in range(cfg.num_layers):
        k = torch.randn(T, cfg.num_kv_heads, cfg.head_dim, generator=gen, device="cuda")
        v = torch.randn(T, cfg.num_kv_heads, cfg.head_dim, generator=gen, device="cuda")
        kvc.update_layer(r.cache, li, k.to(torch.bfloat16), v.to(torch.bfloat16),
                         torch.arange(T, device="cuda"))
    before = [t.clone() for t in r.cache if t is not None]
    pages, scales = r.gather_pages([3, 5, 7])
    assert pages.device.type == "cpu" and pages.is_pinned()
    assert (scales is not None) == (kv_dtype in ("int8", "fp8_e4m3"))
    r.write_pages([2, 4, 9], pages, scales)

    def bits(t):
        # torch.equal is not defined for the fp8 types: compare bytes
        return t if t.dtype == torch.float32 else t.view(torch.uint8)
    for old, new in zip(before, (t for t in r.cache if t is not None)):
        assert torch.equal(bits(new)[:, [2, 4, 9]], bits(old)[:, [3, 5, 7]])
        keep = [0, 1, 3, 5, 6, 7, 8]
        assert torch.equal(bits(new)[:, keep], bits(old)[:, keep])


# ------------------------------------------ the W8A16 trunk: int8 and fp8

# Llama-3-8B's four trunk projections (qkv, o, gate_up, down) and its head
W8_TRUNK = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
W8_HEAD = (4096, 128256)


def _w8_weights(gen, k, n, kind, layers=None):
    """Per-channel byte weights [K, N] (or [L, K, N]) and scales made on the
    card by the compressed-tensors writers: int8 or float8_e4m3fn."""
    from qspec_tpu_torch.model_loader import ct
    make = ct.make_ct_fp8_tensors if kind == "fp8" else ct.make_ct_int8_tensors
    ws, ss = [], []
    for _ in range(layers or 1):
        t, _ = make(torch.randn(k, n, generator=gen, device="cuda") * 0.02)
        ws.append(t["weight"].t().contiguous())
        ss.append(t["weight_scale"].reshape(-1))
    if layers is None:
        return ws[0], ss[0]
    return torch.stack(ws), torch.stack(ss)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("k,n", [*W8_TRUNK, W8_HEAD])
def test_w8a16_trunk_kernel(gen, kind, k, n):
    """Each weight type's instantiation against its plain version at the
    Llama-3-8B trunk shapes and the head, M = 4 and 16, bf16 and f32 out,
    plain and read in place from a 2-layer stack; each launch counted on its
    type's counter."""
    counters = kernel_wrappers()
    own = counters["matmul_w8a16_fp8" if kind == "fp8" else "matmul_w8a16"]
    other = counters["matmul_w8a16" if kind == "fp8" else "matmul_w8a16_fp8"]
    qw, qs = _w8_weights(gen, k, n, kind, layers=None if (k, n) == W8_HEAD else 2)
    before, before_other = own.launches, other.launches
    calls = 0
    for m in (4, 16):
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        for li in ((None,) if qw.dim() == 2 else (0, 1)):
            w, s = (qw, qs) if li is None else (qw[li], qs[li])
            for dt in (torch.float32, torch.bfloat16):
                out = lk.matmul_w8a16(x, qw, qs, out_dtype=dt, layer_idx=li)
                calls += 1
                assert out.dtype == dt and tuple(out.shape) == (m, n)
                torch.testing.assert_close(out.float(), lk.matmul_w8a16_ref(
                    x, w, s, out_dtype=dt).float(), rtol=2e-2, atol=2e-2)
    assert own.launches == before + calls and other.launches == before_other


def test_w8a16_fp8_decodes_every_code(gen):
    """All 256 e4m3 codes through the kernel: x = I picks row k of the
    weight, so out[k, n] is the decoded byte w[k, n] (scale 1). Every
    finite code decodes exactly to its float value; a NaN code (0x7F, 0xFF)
    gives NaN, and so does every row of its column (0 x NaN)."""
    K = N = 256
    codes = torch.arange(K, dtype=torch.int32, device="cuda")[:, None].expand(K, N).clone()
    nan_code = (codes == 0x7F) | (codes == 0xFF)
    # the NaN codes only in columns 0..7; elsewhere a zero there
    codes[nan_code & (torch.arange(N, device="cuda")[None, :] >= 8)] = 0
    w = codes.to(torch.uint8).view(torch.float8_e4m3fn)
    s = torch.ones(N, device="cuda")
    x = torch.eye(K, device="cuda").to(torch.bfloat16)
    out = lk.matmul_w8a16(x, w, s, out_dtype=torch.float32)
    want = w.to(torch.float32)
    assert torch.equal(out[:, 8:], want[:, 8:])
    assert out[:, :8].isnan().all()
    torch.testing.assert_close(out, lk.matmul_w8a16_ref(x, w, s, out_dtype=torch.float32),
                               rtol=0, atol=0, equal_nan=True)
    # every finite code once: 254 distinct values, the subnormals 2^-9 .. 7 x 2^-9 among them
    finite = want[:, 8][~want[:, 8].isnan()]
    assert finite.unique().numel() == 253      # +0 and -0 are one value
    assert (want[1:8, 8] == torch.arange(1, 8, device="cuda") * 2.0 ** -9).all()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_w8a16_rows_independent_of_m_and_place(gen, kind):
    """A row's bits do not depend on M (1 to 16) or on its place in the
    batch, for either weight type, at the down projection's shape."""
    k, n = W8_TRUNK[3]
    qw, qs = _w8_weights(gen, k, n, kind)
    x = torch.randn(16, k, generator=gen, device="cuda").to(torch.bfloat16)
    full = lk.matmul_w8a16(x, qw, qs)
    for m in range(1, 17):
        assert torch.equal(lk.matmul_w8a16(x[:m].contiguous(), qw, qs), full[:m])
    assert torch.equal(lk.matmul_w8a16(x.flip(0).contiguous(), qw, qs), full.flip(0))
    assert torch.equal(lk.matmul_w8a16(x[7:8].contiguous(), qw, qs), full[7:8])


# ------------------------------ matmul_w8a16's stream-K plan (csrc/w8a16.cu)

W8_KS = (256, 4096, 14336)
W8_NS = (200, 4096, 128256)            # 200: not a multiple of the 128-column stripe
W8_MS = (1, 4, 16, 17, 60, 64, 65, 200, 640)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("n", W8_NS)
@pytest.mark.parametrize("k", W8_KS)
def test_w8a16_kernel_against_plain_across_m(gen, kind, k, n):
    """Both weight types against the plain version at M = 1 .. 640 (split
    mode to 64 rows, whole mode past them, the torch.mm branch past the
    prefill threshold: M > 176 at K = 14336), read in place from a 2-layer
    stack, f32 and bf16 out (the JAX tests' rtol = atol = 2e-2)."""
    qw, qs = _w8_weights(gen, k, n, kind, layers=2)
    x = torch.randn(max(W8_MS), k, generator=gen, device="cuda").to(torch.bfloat16)
    for m in W8_MS:
        for dt in (torch.float32, torch.bfloat16):
            out = lk.matmul_w8a16(x[:m], qw, qs, out_dtype=dt, layer_idx=1)
            assert out.dtype == dt and tuple(out.shape) == (m, n)
            torch.testing.assert_close(out.float(), lk.matmul_w8a16_ref(
                x[:m], qw[1], qs[1], out_dtype=dt).float(), rtol=2e-2, atol=2e-2)


def _w8_integer_inputs(gen, m, k, n, kind):
    """Inputs whose every segment sum is an integer under 2^24, so the
    kernel's sums inside a segment are exact in f32 whatever their order,
    while a stripe's total (K = 14336: about 2^25) rounds where the segments
    are added: x in 128..255 (bf16 integers), weights in 8..15 (int8 and
    e4m3 integers alike), scales 1."""
    x = torch.randint(128, 256, (m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(8, 16, (k, n), generator=gen, device="cuda")
    w = w.float().to(torch.float8_e4m3fn) if kind == "fp8" else w.to(torch.int8)
    return x, w, torch.ones(n, device="cuda")


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("k,n", [*W8_TRUNK, W8_HEAD])
def test_w8a16_kernel_bits_equal_split_model(gen, kind, k, n):
    """The kernel is bit for bit matmul_w8_split_ref (its segments, added in
    block order) at the Llama-3-8B trunk and head shapes, M = 4, 16, 60 and
    100 (whole mode), f32 and bf16 out; at the down projection (K = 14336)
    the fold rounds, and the split model differs from the plain version."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    x, w, s = _w8_integer_inputs(gen, 100, k, n, kind)
    for m in (4, 16, 60, 100):
        want = lk.matmul_w8_split_ref(x[:m].cpu(), w.cpu(), s.cpu(), n_sm=n_sm,
                                      out_dtype=torch.float32)
        out = lk.matmul_w8a16(x[:m], w, s, out_dtype=torch.float32).cpu()
        assert torch.equal(out, want), (m, (out - want).abs().max().item())
        assert torch.equal(lk.matmul_w8a16(x[:m], w, s).cpu(), want.to(torch.bfloat16))
        if k == 14336:
            plain = lk.matmul_w8a16_ref(x[:m].cpu(), w.cpu(), s.cpu(), out_dtype=torch.float32)
            assert not torch.equal(want, plain)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 128256), (14336, 4096), (448, 200)])
def test_w8a16_kernel_row_bits(gen, kind, k, n):
    """A row's bits do not depend on M (1 to the largest M the kernel takes
    before the prefill branch: split mode to 64 rows, whole mode past
    them), on its place in the batch or the batch's order, and equal a
    second call's and a CUDA-graph replay's, at split shapes (o, down) and
    at the head's (most stripes one block's) and a 2-stripe one."""
    qw, qs = _w8_weights(gen, k, n, kind)
    mbig = max(m for m in range(1, 1025) if not lk._bigm(m, k))
    x = torch.randn(mbig, k, generator=gen, device="cuda").to(torch.bfloat16)
    full = lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32)
    assert torch.equal(lk.matmul_w8a16(x, qw, qs, out_dtype=torch.float32), full)
    for m in (1, 4, 8, 15, 16, 17, 33, 48, 60, 64, 65, 128, 200, 640):
        if m <= mbig:
            assert torch.equal(lk.matmul_w8a16(x[:m], qw, qs, out_dtype=torch.float32),
                               full[:m]), m
    for rows in (slice(5, 9), slice(mbig // 2, mbig // 2 + 60), slice(3, mbig)):
        assert torch.equal(lk.matmul_w8a16(x[rows].contiguous(), qw, qs,
                                           out_dtype=torch.float32), full[rows])
    assert torch.equal(lk.matmul_w8a16(x.flip(0).contiguous(), qw, qs, out_dtype=torch.float32),
                       full.flip(0))
    for m in (4, 16, 60, min(mbig, 100)):
        want = full[:m].to(torch.bfloat16)
        assert _replayed(lambda m=m: lk.matmul_w8a16(x[:m], qw, qs), want), m


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(1024, 4096, 4096), (256, 14336, 4096)])
def test_w8a16_torch_mm_branch(gen, kind, m, k, n):
    """Past BIGM_BYTES (M > 640 at K = 4096, M > 176 at 14336) matmul_w8a16
    is one torch.mm over the weights widened to bf16, f32 result: no kernel
    launch, and the plain version's result within rtol = atol = 2e-2."""
    qw, qs = _w8_weights(gen, k, n, kind)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    assert lk._bigm(m, k)
    counters = kernel_wrappers()
    before = (counters["matmul_w8a16"].launches, counters["matmul_w8a16_fp8"].launches)
    for dt in (torch.float32, torch.bfloat16):
        out = lk.matmul_w8a16(x, qw, qs, out_dtype=dt)
        assert out.dtype == dt and tuple(out.shape) == (m, n)
        torch.testing.assert_close(out.float(), lk.matmul_w8a16_ref(x, qw, qs, out_dtype=dt).float(),
                                   rtol=2e-2, atol=2e-2)
    assert (counters["matmul_w8a16"].launches, counters["matmul_w8a16_fp8"].launches) == before


# MLA's latent attention shapes: (query heads over one latent KV row, stored
# head dim, K lanes r + dr, V lanes r) of MiniCPM3-4B, DeepSeek-V2-Lite and
# DeepSeek-V2 / V3
MLA_SHAPES = {"minicpm3-4b": (40, 384, 288, 256), "deepseek-v2-lite": (16, 640, 576, 512),
              "deepseek-v3": (128, 640, 576, 512)}
MLA_CTX = (300, 700, 45, 4000)


def _mla_case(gen, q_len, kv_dtype, shape, ctx=MLA_CTX, S=16):
    """A latent cache as MLA writes it (update_layer of K rows [c, 0...] and
    V rows [c[:r], 0...] over one KV head, c random over the K lanes), one
    row per context (at least q_len), pages shuffled; q random over the K
    lanes, zero past them. Returns (q, cache, tables, ctx_t, scale, lanes)."""
    Hq, D, dk, dv = MLA_SHAPES[shape]
    ctx = [max(c, q_len) for c in ctx]
    pages = [-(-c // S) for c in ctx]
    P = 1 + sum(pages)
    cache = kvc.allocate(kvc.KVCacheConfig(2, 1, D, P, S, kv_dtype), "cuda")
    T = (P - 1) * S
    lat = torch.randn(T, 1, dk, generator=gen, device="cuda")
    k_new = torch.nn.functional.pad(lat, (0, D - dk)).to(torch.bfloat16)
    v_new = torch.nn.functional.pad(lat[..., :dv], (0, D - dv)).to(torch.bfloat16)
    kvc.update_layer(cache, 1, k_new, v_new, torch.arange(T, device="cuda") + S)
    ids = torch.randperm(P - 1, generator=torch.Generator().manual_seed(q_len)) + 1
    tables = torch.zeros(len(ctx), max(pages), dtype=torch.int32)
    o = 0
    for b, n in enumerate(pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    q = torch.randn(len(ctx), q_len, Hq, dk, generator=gen, device="cuda")
    q = torch.nn.functional.pad(q, (0, D - dk)).to(torch.bfloat16)
    scale = (96 if D == 384 else 192) ** -0.5     # (qk_nope + qk_rope) ** -0.5
    return (q, cache, tables.cuda(), torch.tensor(ctx, dtype=torch.int32, device="cuda"),
            scale, (dk, dv))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_paged_attention_kernel_mla(gen, shape, kv_dtype):
    """The MLA instantiations (head dims 384 and 640, every entry type) at
    MiniCPM3-4B's, DeepSeek-V2-Lite's and DeepSeek-V3's query groups, B = 4,
    contexts to 4000 (16 splits of 256), decode (Q = 1), the n-gram verify
    (Q = 4) and a prefill rectangle (Q = 64) against the plain version over
    the same lanes (rtol = atol 3e-2 over bf16, 4e-2 over int8 / fp8_e4m3,
    8e-2 over fp8_e5m2, as the other entry types' tests); each launch
    counted once on its entry type and head dim; the output zero past the V
    lanes; the last row's bits the same alone as in its Q = 4 block."""
    D = MLA_SHAPES[shape][1]
    name = "paged_attention" if kv_dtype == "bfloat16" else f"paged_attention_{kv_dtype}"
    counter = kernel_wrappers()[name]
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    for q_len in (1, 4, 64):
        q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, q_len, kv_dtype, shape)
        before = (counter.launches, getattr(counter, f"d{D}_launches"))
        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                   kv_scales=cache.kv_scales, lanes=lanes)
        assert (counter.launches, getattr(counter, f"d{D}_launches")) == \
            tuple(n + 1 for n in before)
        assert torch.count_nonzero(out[..., lanes[1]:]) == 0
        ref = paged_attention_ref(q, cache, 1, tables, ctx_t, scale, lanes=lanes)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        if q_len == 4:
            one = paged_attention_cuda(q[:, -1:].contiguous(), cache.kv_pages, tables, ctx_t,
                                       scale, layer=1, kv_scales=cache.kv_scales, lanes=lanes)
            assert torch.equal(one[:, 0], out[:, -1])


@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_paged_attention_kernel_mla_row_bits(gen, shape):
    """A latent row's bits do not depend on Q (1, 2 and 4 last positions:
    other schedules where the row tiles pass 4), on B, on its place in the
    batch, on a longer row beside it (a wider block table), on a second
    call, and equal a CUDA-graph replay's (the attention kernel and, where a
    tile spans splits, the merge kernel)."""
    q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, 4, "bfloat16", shape)

    def inputs(rows, width=None, ql=4):
        rows = torch.as_tensor(rows, device="cuda")
        tab = tables[rows][:, :width] if width else tables[rows]
        return q[rows][:, 4 - ql:].contiguous(), tab.contiguous(), ctx_t[rows].contiguous()

    def launch(args):
        qq, tab, c = args
        return paged_attention_cuda(qq, cache.kv_pages, tab, c, scale, layer=1, lanes=lanes)

    full = launch(inputs([0, 1, 2, 3]))
    narrow = -(-max(MLA_CTX[:3]) // 16)
    assert torch.equal(launch(inputs([0, 1, 2], width=narrow)), full[:3])
    assert torch.equal(launch(inputs([2, 0], width=narrow)), full[[2, 0]])
    assert torch.equal(launch(inputs([3, 2, 1, 0])), full.flip(0))
    assert torch.equal(launch(inputs([0, 1, 2, 3])), full)
    for ql in (1, 2):
        assert torch.equal(launch(inputs([0, 1, 2, 3], ql=ql)), full[:, -ql:])
    every, first3 = inputs([0, 1, 2, 3]), inputs([0, 1, 2], width=narrow)
    assert _replayed(lambda: launch(every), full)
    assert _replayed(lambda: launch(first3), full[:3])


# contexts past 4096 tokens: 33 to 40 splits of 128, a row's walk over
# several split blocks and the merge kernel
MLA_LONG_CTX = (4100, 4700, 45, 5000)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_paged_attention_kernel_mla_long_context(gen, shape, kv_dtype):
    """Every MLA instantiation at MiniCPM3-4B's, DeepSeek-V2-Lite's and
    DeepSeek-V3's query groups over contexts to 5000 tokens (MLA_LONG_CTX),
    decode (Q = 1) and the n-gram verify (Q = 4), against the plain version
    over the same lanes (the tolerances of test_paged_attention_kernel_mla),
    the output zero past the V lanes."""
    tol = {"bfloat16": 3e-2, "fp8_e5m2": 8e-2}.get(kv_dtype, 4e-2)
    for q_len in (1, 4):
        q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, q_len, kv_dtype, shape,
                                                          ctx=MLA_LONG_CTX)
        out = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                   kv_scales=cache.kv_scales, lanes=lanes)
        assert torch.count_nonzero(out[..., lanes[1]:]) == 0
        ref = paged_attention_ref(q, cache, 1, tables, ctx_t, scale, lanes=lanes)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape", ["minicpm3-4b", "deepseek-v2-lite"])
def test_paged_attention_kernel_mla_v_plane(gen, shape, kv_dtype):
    """Over bf16 and fp8_e5m2 the MLA kernel reads V's lanes from the K plane,
    whose first r lanes MLA writes with V's bits (update_layer): a V plane
    overwritten with other values leaves the output bit for bit unchanged.
    Over int8 and fp8_e4m3, whose V rows take scales of their own, the kernel
    reads the V plane: the same overwrite changes the output."""
    q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, 4, kv_dtype, shape)

    def run():
        return paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                    kv_scales=cache.kv_scales, lanes=lanes)
    before = run()
    v_plane = cache.kv_pages[1, :, 1]
    poison = torch.full(v_plane.shape, 7.0, device="cuda")
    poison[..., 1::2] = -3.0
    v_plane.copy_(poison.to(v_plane.dtype))
    after = run()
    assert torch.equal(after, before) == (kv_dtype in ("bfloat16", "fp8_e5m2"))


@pytest.mark.parametrize("shape", sorted(MLA_SHAPES))
def test_paged_attention_kernel_mla_schedule_bits(gen, shape):
    """A latent row's bits are the same whether its tile's splits are folded
    in the block through the block's slab (a Q = 64 prefill rectangle, whose
    row tiles fill the card, or whose one-split-a-block workspace would pass
    MLA_WS_BYTES) or by the merge kernel (the same rows' last one alone, Q =
    1, one split a block), at contexts to 4000 tokens."""
    from qspec_tpu_torch.ops.attention_cuda import attention_plan
    q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, 64, "bfloat16", shape)
    Hq, D = MLA_SHAPES[shape][:2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wide = attention_plan(4, 64, Hq, 1, D, 16, tables.shape[1], sms)
    one = attention_plan(4, 1, Hq, 1, D, 16, tables.shape[1], sms)
    assert wide.splits_per_block == wide.n_splits > 1 and one.splits_per_block == 1
    full = paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1, lanes=lanes)
    last = paged_attention_cuda(q[:, -1:].contiguous(), cache.kv_pages, tables, ctx_t, scale,
                                layer=1, lanes=lanes)
    assert torch.equal(last[:, 0], full[:, -1])


def test_paged_attention_kernel_mla_refusals(gen):
    """The MLA head dims take no window, softcap, ALiBi or tree (the JAX
    package reaches none of them there), and only K lanes % 32 == 0 and V
    lanes % 64 == 0 up to the head dim; the other head dims read all lanes."""
    from qspec_tpu_torch.ops.attention import alibi_slopes
    from qspec_tpu_torch.spec_decode.medusa_tree import DEFAULT_TREE, build_tree
    q, cache, tables, ctx_t, scale, lanes = _mla_case(gen, 4, "bfloat16", "deepseek-v2-lite")
    tspec = build_tree(DEFAULT_TREE)
    bad = [dict(window=64), dict(softcap=50.0),
           dict(alibi=torch.as_tensor(alibi_slopes(16), device="cuda")),
           dict(tree=tree_mask(1, tspec.ancestors, "cuda"))]
    for kw in bad:
        with pytest.raises(ValueError, match="MLA"):
            paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1,
                                 lanes=lanes, **kw)
    for wrong in ((560, 512), (576, 480), (672, 512)):
        with pytest.raises(ValueError, match="lanes"):
            paged_attention_cuda(q, cache.kv_pages, tables, ctx_t, scale, layer=1, lanes=wrong)
    cache128 = kvc.allocate(kvc.KVCacheConfig(2, 1, 128, 4, 16), "cuda")
    q128 = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="lanes"):
        paged_attention_cuda(q128, cache128.kv_pages, one[None], one, 0.1, lanes=(96, 64))
