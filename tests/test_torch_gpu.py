"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions (marker ``gpu``). Each test decides inside a fixture whether a card
is present and skips here, on a machine without one. On the H100:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -o addopts=""

(``--noconftest``: tests/conftest.py imports jax, which the port's machine
need not have; these tests use no fixture of it.)

Tolerances are those of tests/test_torch_ops.py (the JAX kernel tests').
"""

import numpy as np
import pytest
import torch

from qspec_tpu_torch.config import ModelConfig
from qspec_tpu_torch.ops import kernel_wrappers
from qspec_tpu_torch.ops import linear_kernels as lk
from qspec_tpu_torch.ops import rmsnorm_quant as rq
from qspec_tpu_torch.ops.attention import paged_attention_ref
from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
from qspec_tpu_torch.ops.kv_cache import PagedKVCache
from qspec_tpu_torch.ops.packing import quantize_weight_int4_torch
from qspec_tpu_torch.ops.quant import sym_quant_int4, sym_quant_int8

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


def test_greedy_spec_equals_oracle_on_card(gen):
    from qspec_tpu_torch import LLM, SamplingParams
    kw = dict(model="tiny", device="cuda", lm_head_quant="bf16", num_speculative_tokens=3,
              block_size=16, max_model_len=256, max_num_seqs=4, prefill_chunk_size=64)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, size=int(n)).tolist() for n in (5, 17, 33, 9)]
    sp = SamplingParams(temperature=0.0, max_tokens=24)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    llm = LLM(**kw)
    spec = [o.output_token_ids for o in llm.generate(prompts, sp)]
    assert all(fn.launches > 0 for fn in wrappers.values())
    oracle = LLM(params=llm.llm_engine.runner.params, speculative_method="qspec_null", **kw)
    assert spec == [o.output_token_ids for o in oracle.generate(prompts, sp)]
    assert ModelConfig.tiny().vocab_size > max(max(t) for t in spec)
